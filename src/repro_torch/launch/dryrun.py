"""Multi-pod dry run (``repro.launch.dryrun``): build every (architecture x
input-shape) cell on the production mesh with NO device memory, run its
step once on fake tensors, and record memory, FLOPs and collectives for
the roofline.

Where the reference lowers and compiles the step on 512 forced host
devices, the port runs it eagerly, on rank 0 of a fake process group of
256 or 512 ranks (``launch.mesh.fake_mesh``: PyTorch's ``"fake"``
backend, over which a collective moves nothing and returns outputs of the
right shapes). The params, optimizer state, batch and cache are DTensors
placed by the sharding policy (``dist.sharding``) whose local shards are
fake tensors (``dist.sharding.fake_with_sharding``: a ``FakeTensorMode``,
no storage). The step is the one a user calls: ``launch.train.
make_train_step(param_shardings=...)``, ``launch.serve.make_prefill_step``
or ``make_decode_step``. ``launch.hlo_analysis.StepCounter`` counts what
rank 0 executes.

The step traces the CPU plain versions of ``mha`` and ``decode_attention``
on fake tensors, as the reference's CPU compile traces its plain einsum:
nothing here builds or launches a kernel, and nothing runs on a card. The
dry run allocates on no device, so it takes no ``device``; its fake shards
lie on ``"cpu"`` only so that the plain versions trace. So ``temp_bytes``
is the plain path's peak: the plain attention holds its [S, S] logits,
which the kernels never materialise. A decode cell decodes the cache's
last position, so it reads the whole cache, as the reference's step
(masked over the whole cache) does.

A record keeps the reference's keys where a value exists. ``lower_s`` is
the seconds to build the cell (meta trees, specs, fake shards) and
``compile_s`` the seconds of the traced step; ``argument_bytes`` and
``output_bytes`` are the local shards' bytes of what goes in and comes out
(the train step updates its params and state in place, so they are in
both, as the reference's donated buffers are). XLA's cost analysis
(``flops``, ``bytes_accessed``), ``hlo_hbm_upper_bytes`` and ``hlo_chars``
have no counterpart (``launch.hlo_analysis``).

Importing this module starts no process group and sets no environment
variable; each cell starts its fake group and destroys it at its end.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k --mesh single            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out build/dryrun.jsonl                   # the full 40-cell table
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import traceback
import warnings

import torch

from repro_torch import timing
from repro_torch.configs import SHAPES, all_archs, get_arch, shape_applicable
from repro_torch.core import igd as igd_lib
from repro_torch.core.tree import tree_map
from repro_torch.dist import sharding as shd
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.serve import make_decode_step, make_prefill_step
from repro_torch.launch.train import make_train_step
from repro_torch.models import lm
from repro_torch.optim import IGD, AdamW


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    # the tensors the step makes on the spot (RoPE angles, positions) are
    # real; the mode takes them in as fakes
    return FakeTensorMode(allow_non_fake_inputs=True)


def _optimizer(optimizer):
    if not isinstance(optimizer, str):
        return optimizer
    return {"sgd": lambda: IGD(igd_lib.constant(1e-2)), "adamw": AdamW}[optimizer]()


def build_cell(cfg, shape, mesh, fake_mode, *, grad_accum=8, optimizer="sgd", compress_grads=False,
               seq_shard=False, igd_microsteps=False, cast_bf16=False):
    """Returns (step_fn, args) for one cell: ``step_fn(*args)`` runs its
    step on ``mesh`` (a ``DeviceMesh``) over DTensors with fake shards of
    ``fake_mode``. ``optimizer``: "sgd" (IGD at a constant 1e-2, as the
    reference's), "adamw", or an optimizer object."""
    shd.set_activation_ctx(mesh, seq_shard=seq_shard)
    params_abs = lm.init_lm(cfg, torch.Generator(), "meta")
    pspecs = shd.param_specs(params_abs, cfg, mesh)
    params_in = shd.fake_with_sharding(params_abs, pspecs, mesh, fake_mode)
    batch_abs = input_specs(cfg, shape)
    bspecs = shd.batch_specs(cfg, shape.kind, mesh, shape.global_batch)

    if shape.kind == "train":
        opt = _optimizer(optimizer)
        # optimizer state shards like its param
        opt_in = tuple(shd.fake_with_sharding(o, pspecs, mesh, fake_mode) for o in opt.init(params_abs))
        step_fn = make_train_step(cfg, opt, min(grad_accum, shape.global_batch), compress_grads=compress_grads,
                                  igd_microsteps=igd_microsteps, cast_bf16=cast_bf16,
                                  param_shardings=shd.shardings(pspecs, mesh))
        batch_in = shd.fake_with_sharding(batch_abs, bspecs, mesh, fake_mode)
        return step_fn, (params_in, opt_in, batch_in, 0)

    if shape.kind == "prefill":
        return make_prefill_step(cfg), (params_in, shd.fake_with_sharding(batch_abs, bspecs, mesh, fake_mode))

    # decode: one token at the cache's last position
    cache_abs = dict(batch_abs["cache"])
    index = cache_abs.pop("index")
    cspecs = shd.cache_specs(cfg, mesh, shape.global_batch, cache_abs)
    batch_in = shd.fake_with_sharding({"tokens": batch_abs["tokens"]}, {"tokens": bspecs["tokens"]}, mesh, fake_mode)
    batch_in["cache"] = shd.fake_with_sharding(cache_abs, cspecs, mesh, fake_mode)
    batch_in["cache"]["index"] = index + shape.seq_len - 1
    return make_decode_step(cfg), (params_in, batch_in)


def analyze_step(fn, args, fake_mode, *, count=True):
    """Run ``fn(*args)`` once; returns (``hlo_analysis.StepAnalysis`` of
    what rank 0 executed, or None without ``count``; the local bytes of
    its outputs)."""
    if not count:
        return None, hlo.local_bytes(fn(*args))
    counter = hlo.StepCounter(fake_mode)
    counter.hold(args)
    with counter:
        out = fn(*args)
    return counter.analysis(), hlo.local_bytes(out)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, grad_accum=8, optimizer="sgd",
             compress_grads=False, collect_hlo=True, seq_shard=False, igd_microsteps=False,
             cast_bf16=False, cfg_overrides=None, tag=None, shape_overrides=None, mesh_shape=None):
    """One cell's record. Beyond the reference's arguments:
    ``shape_overrides`` replaces fields of the shape (a cut batch, say) and
    ``mesh_shape`` ({axis: size}) replaces the production mesh."""
    cfg = get_arch(arch)
    if cfg_overrides:
        cfg = cfg.scaled(**cfg_overrides)
    shape = SHAPES[shape_name]
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    amesh = mesh_lib.AbstractMesh(mesh_shape) if mesh_shape else make_production_mesh(multi_pod=multi_pod)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(v) for v in amesh.shape.values()),
        "kind": shape.kind,
    }
    if tag:
        rec["tag"] = tag
    if not shape_applicable(cfg, shape):
        rec["status"] = "SKIP"
        rec["reason"] = "long_500k scoped to sub-quadratic families"
        return rec

    watch = timing.Stopwatch()
    fake_mode = _fake_mode()
    with mesh_lib.fake_mesh(amesh.shape) as mesh, warnings.catch_warnings():
        # DTensor's notes on its CPU fallbacks, and data_ptr reads of fakes
        warnings.simplefilter("ignore")
        try:
            fn, args = build_cell(
                cfg, shape, mesh, fake_mode, grad_accum=grad_accum, optimizer=optimizer,
                compress_grads=compress_grads, seq_shard=seq_shard, igd_microsteps=igd_microsteps,
                cast_bf16=cast_bf16,
            )
            lower_s = watch.lap()
            rec.update(status="OK", lower_s=round(lower_s, 1), n_chips=mesh.size(),
                       argument_bytes=hlo.local_bytes(args))
            stats, out_bytes = analyze_step(fn, args, fake_mode, count=collect_hlo)
            rec.update(compile_s=round(watch.lap(), 1), output_bytes=out_bytes)
            if stats is not None:
                rec.update(
                    temp_bytes=stats.temp_bytes,
                    hlo_flops=stats.flops,
                    hlo_hbm_bytes=stats.hbm_bytes,
                    hlo_hbm_bytes_proj=stats.hbm_bytes_proj,
                    collective_operand_bytes=stats.collective_operand_bytes,
                    collective_traffic_bytes=stats.collective_traffic_bytes,
                    collective_traffic_bytes_proj=stats.collective_traffic_bytes_proj,
                    collectives_by_kind=stats.collectives_by_kind,
                    dot_count=stats.dot_count,
                )
        finally:
            shd.set_activation_ctx(None)

    total, active = hlo.count_params(lm.init_lm(cfg, torch.Generator(), "meta"), cfg)
    rec["n_params"] = total
    rec["n_params_active"] = int(active)
    rec["model_flops"] = hlo.model_flops(cfg, shape, total, int(active))
    return rec


def run_localsgd_cell(arch: str, *, grad_accum=8, merge_period=16, seq_shard=True, tag=None, cfg_overrides=None):
    """Multi-pod local-SGD dry run (the paper's pure-UDA merge at pod
    granularity): per-pod model instances (a leading bank dim sharded over
    "pod", FSDP over "data" within a pod) train independently; every
    ``merge_period`` steps the instances are averaged. Cross-pod traffic
    only flows at merges. The cell's step is the one at a merge.
    ``cfg_overrides`` (beyond the reference's arguments) replaces fields of
    the config, as ``run_cell``'s does (a cut depth, say)."""
    from repro_torch.launch.train import make_localsgd_step

    cfg = get_arch(arch)
    if cfg_overrides:
        cfg = cfg.scaled(**cfg_overrides)
    shape = SHAPES["train_4k"]
    amesh = make_production_mesh(multi_pod=True)
    n_pods = amesh.shape["pod"]
    rec = {"arch": arch, "shape": "train_4k", "mesh": "x".join(str(v) for v in amesh.shape.values()),
           "kind": "train", "tag": tag or f"localsgd-H{merge_period}"}
    watch = timing.Stopwatch()
    fake_mode = _fake_mode()
    with mesh_lib.fake_mesh(amesh.shape) as mesh, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # each pod's instance steps on the pod's own ("data", "model") submesh
        inner = mesh[tuple(name for name in amesh.shape if name != "pod")]
        shd.set_activation_ctx(inner, seq_shard=seq_shard)
        try:
            params_abs = lm.init_lm(cfg, torch.Generator(), "meta")
            # per-pod specs: FSDP over "data" only, leading bank dim over "pod"
            inner_specs = shd.param_specs(params_abs, cfg, inner)
            bank_specs = shd.map_specs(lambda s: shd.P(*(("pod",) + tuple(s))), inner_specs)
            bank_abs = tree_map(lambda a: torch.empty((n_pods,) + tuple(a.shape), dtype=a.dtype, device="meta"),
                                params_abs)
            bank_in = shd.fake_with_sharding(bank_abs, bank_specs, mesh, fake_mode)
            step_fn = make_localsgd_step(cfg, IGD(igd_lib.constant(1e-2)), grad_accum, merge_period,
                                         param_shardings=shd.shardings(inner_specs, inner))
            b_per_pod = shape.global_batch // n_pods
            tokens = torch.empty((n_pods, b_per_pod, shape.seq_len), dtype=torch.int32, device="meta")
            batch_in = shd.fake_with_sharding({"tokens": tokens}, {"tokens": shd.P("pod", "data", None)}, mesh,
                                              fake_mode)
            # a merge step: the one whose traffic crosses pods
            stats, _ = analyze_step(step_fn, (bank_in, (), batch_in, merge_period - 1), fake_mode)
            rec.update(
                status="OK",
                compile_s=round(watch.lap(), 1),
                n_chips=mesh.size(),
                temp_bytes=stats.temp_bytes,
                hlo_flops=stats.flops,
                hlo_hbm_bytes_proj=stats.hbm_bytes_proj,
                collective_traffic_bytes=stats.collective_traffic_bytes,
                collective_traffic_bytes_proj=stats.collective_traffic_bytes_proj,
                collectives_by_kind=stats.collectives_by_kind,
            )
        finally:
            shd.set_activation_ctx(None)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--grad-accum", type=int, default=8)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--igd-microsteps", action="store_true")
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--no-hlo", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [
            (a, s)
            for a in sorted(all_archs())
            for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")
        ]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_f = open(args.out, "a") if args.out else None
    n_fail = 0
    try:
        for arch, shape in cells:
            for mp in meshes:
                try:
                    rec = run_cell(
                        arch, shape, mp,
                        grad_accum=args.grad_accum,
                        optimizer=args.optimizer,
                        compress_grads=args.compress_grads,
                        collect_hlo=not args.no_hlo,
                        seq_shard=args.seq_shard,
                        igd_microsteps=args.igd_microsteps,
                    )
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                    n_fail += 1
                line = json.dumps(rec)
                print(line[:400], flush=True)
                if out_f:
                    out_f.write(line + "\n")
                    out_f.flush()
    finally:
        if out_f:
            out_f.close()
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
