"""End-to-end fault-tolerant training driver (``repro.launch.train_loop``).

Ordering-aware pipeline -> train step (the UDA transition) -> checkpoint
manager (atomic, keep-k, async) -> watchdog (straggler accounting).
Deterministic resume: the pipeline state rides in the checkpoint meta, so
a killed and restarted run reproduces the uninterrupted run.

The step clock is ``timing.Stopwatch`` read after ``timing.sync`` (the
reference's ``block_until_ready``): on the card it is the step's wall
time with the device's work done.

With a ``mesh`` (a ``DeviceMesh``, ``launch.mesh.make_host_mesh``; every
rank runs ``fit``): the activation context is installed for the run (and
the previous one put back at its end), the params and optimizer state
are distributed by ``param_specs``, each batch by ``batch_specs``, and the
step is ``make_train_step(param_shardings=...)``. A resume restores
through ``elastic_restore``, onto this mesh whatever mesh wrote the
checkpoint. A checkpoint stores logical arrays: every rank gathers them
(``sharding.full``, a collective), rank 0 writes and waits for the write,
and the ranks then meet at a barrier.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import timing
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.tree import leaves, tree_map
from repro_torch.data.pipeline import EpochPipeline, PipelineState
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.launch.elastic import elastic_restore
from repro_torch.launch.train import make_train_step
from repro_torch.models import lm as lm_mod


@dataclasses.dataclass
class FitResult:
    params: Any
    opt_state: Any
    step: int
    losses: list
    resumed_from: Optional[int]
    straggler_events: int


def fit(
    cfg,
    data: dict,
    *,
    optimizer,
    steps: int,
    global_batch: int,
    grad_accum: int = 1,
    ordering: str = "shuffle_once",
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    keep: int = 3,
    mesh=None,
    seed: int = 0,
    straggler_timeout_s: Optional[float] = None,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
    params: Optional[dict] = None,
    device=None,
) -> FitResult:
    """Train ``cfg`` for ``steps`` steps of ``global_batch`` rows of
    ``data`` ({"tokens": [N, S]} on the device it is gathered on), resuming
    from the latest checkpoint under ``ckpt_dir`` when there is one.

    The reference's arguments, plus: ``params``, the initial params (copied;
    default ``lm.init_lm`` from a generator seeded with ``seed``, which
    cannot give the reference's threefry draws), and ``device`` (the card
    unless ``"cpu"``; with a mesh, its ranks' device kind). ``mesh``: a
    ``DeviceMesh`` to train across (see the module's docstring); anything
    else but ``None`` raises ``TypeError``."""
    if mesh is not None and not hasattr(mesh, "get_group"):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh (launch.mesh.make_host_mesh), "
                        f"got {type(mesh).__name__}")
    previous_mesh, previous_seq_shard = shd.activation_ctx()
    if mesh is not None:
        shd.set_activation_ctx(mesh)
    try:
        device = resolve_device(device)
        if params is None:
            params = lm_mod.init_lm(cfg, torch.Generator(device=device).manual_seed(seed), device)
        else:
            params = tree_map(lambda x: x.detach().to(device, copy=True), params)
        opt_state = optimizer.init(params)
        pshard = bshard = None
        if mesh is not None:
            pshard = shd.shardings(shd.param_specs(params, cfg, mesh), mesh)
            bshard = shd.shardings(shd.batch_specs(cfg, "train", mesh, global_batch), mesh)
            params = shd.distribute(params, pshard)
            opt_state = tuple(shd.distribute(t, pshard) for t in opt_state)
        step_fn = make_train_step(cfg, optimizer, grad_accum, param_shardings=pshard)
        writer = mesh is None or dist.get_rank() == 0

        pipe = EpochPipeline(data, global_batch, ordering=ordering)
        pstate = PipelineState(seed=seed)
        start_step, resumed_from, mgr = 0, None, None
        if ckpt_dir is not None:
            mgr = CheckpointManager(ckpt_dir, keep=keep)
            if mesh is not None:
                rp, ro, meta = elastic_restore(ckpt_dir, cfg, optimizer, mesh)
                restored = None if rp is None else {"params": rp, "opt": ro}
            else:
                restored, meta = mgr.restore_latest({"params": params, "opt": opt_state})
            if restored is not None:
                with torch.no_grad():  # into the tensors the optimizer updates
                    for dst, src in zip(leaves({"params": params, "opt": opt_state}), leaves(restored)):
                        dst.copy_(src)
                start_step = meta["step"]
                pstate = PipelineState.from_meta(meta["meta"]["pipeline"])
                resumed_from = start_step
                log_fn(f"[resume] from step {start_step}, epoch {pstate.epoch}")

        def save(step_no):
            tree = shd.full({"params": params, "opt": opt_state}) if mesh is not None else \
                {"params": params, "opt": opt_state}
            if writer:
                mgr.save(step_no, tree, meta={"pipeline": pstate.to_meta()})
            if mesh is not None:
                if writer:
                    mgr.wait()
                dist.barrier()

        losses, straggler_events = [], 0
        it = pipe.batches(pstate)
        step = start_step
        for step in range(start_step, steps):
            batch, pstate = next(it)
            if bshard is not None:
                batch = shd.distribute(batch, {k: bshard[k] for k in batch})
            watch = timing.Stopwatch()
            params, opt_state, metrics = step_fn(params, opt_state, batch, step)
            timing.sync(device)
            dt = watch.lap()
            if straggler_timeout_s is not None and dt > straggler_timeout_s:
                # one controller: the event is recorded for the watchdog
                straggler_events += 1
                log_fn(f"[watchdog] step {step} took {dt:.2f}s (> timeout)")
            losses.append(float(metrics["loss"]))
            if log_every and (step + 1) % log_every == 0:
                log_fn(f"step {step + 1}: loss={losses[-1]:.4f} ({dt * 1e3:.0f} ms)")
            if mgr is not None and (step + 1) % ckpt_every == 0:
                save(step + 1)
        if mgr is not None:
            save(steps)
            mgr.wait()
        return FitResult(params=params, opt_state=opt_state, step=step + 1 if steps > start_step else start_step,
                         losses=losses, resumed_from=resumed_from, straggler_events=straggler_events)
    finally:
        shd.set_activation_ctx(previous_mesh, seq_shard=previous_seq_shard)
