"""repro_torch.engine.program — the EpochProgram IR and its compiler.

The IR composes a physical ``Plan``'s axes (ordering × parallelism ×
batch × source × implementation) and ``build_program`` lowers it to the
callables its driver runs. The port lowers the singleton parallelism
under every ordering, every scheme of paper §3.3–3.4, both data sources
and any batch width:

* ``serial`` — the serial lane body, by implementation:

  * ``torch_fold`` — the eager ``uda.fold`` loop (the counterpart of the
    reference's ``xla_fold``);
  * ``cuda_fused`` — the fused-IGD CUDA kernel's per-tuple lane
    (``repro_torch.kernels.igd_fused``: the model held on chip while rows
    stream past — the paper's Bismarck inner loop as a real kernel);
  * ``cuda_minibatch`` — one mean-gradient step per 256-row tile, a
    DIFFERENT algorithm (hint-only; never auto-chosen);

* ``segmented`` — ``uda.segmented_fold`` (shared-nothing lanes, merged);
* ``shared_memory`` — ``parallel.hogwild_fold`` (the Lock/AIG/NoLock
  simulator);
* ``mrs`` — ``mrs.mrs_epoch`` (buffered reservoir sampling), whose epoch
  carries ``(state, buf_a, buf_b, active)``.

The non-serial schemes run eagerly and have no kernel form: a ``cuda_*``
implementation with any scheme but ``serial`` is refused, as the
reference refuses ``pallas_*``.

* **parallelism** — ``singleton`` (one device runs the scheme above) or
  ``sharded(k, H)`` (paper §3.3 at device scale): k contiguous
  shared-nothing segments trained as merge-period-H local SGD with the
  compensated schedule ``k * alpha(k * t)``, laid out over d devices
  (:func:`build_shard_block`, driven by ``repro_torch.engine.shard``).
  Each device's k/d shards are the lanes of ONE fused-IGD kernel launch
  an epoch (``cuda_*``) or of one ``torch.func.vmap`` over the eager fold
  (``torch_fold``); k = 1 is the singleton run bit for bit.

* **data source** — ``memory`` (one resident table) or ``table`` (a
  stored table's chunk stream, ``repro_torch.engine.table``): the
  serial fold over each chunk in stored order with carried state
  (:func:`build_chunk_epoch_fn`); kernel lanes continue their alphas
  from ``state.step``, so chunk boundaries change nothing but the
  working set (and, for ``cuda_fused``, where the tiled kernel starts a
  launch's first margins from ``X·w``, the rounding).
* **query batching** — ``B`` fused query lanes, each with its own draws
  (``core.draws.lane_streams``) and its own *epoch budget*: a fused run
  takes ``budgets[B]`` and keeps a lane's state once its budget is spent
  (``torch.where`` with a mask made on the device), so queries that
  differ only in ``epochs`` fuse into one run (:func:`_build_fused`).
  Kernel lanes are ONE lane launch of the fused-IGD kernel an epoch (a
  block, or a cluster, a lane: the counterpart of ``jax.vmap`` over the
  Pallas call); eager serial lanes are ``torch.func.vmap`` over the
  eager fold (one lane runs the fold itself: B = 1 is the singleton run
  bit for bit); the non-serial schemes run their epoch lane by lane
  (their draws are per-lane objects and the shared-memory simulator
  writes its ring in place, which ``vmap`` refuses).

Eligibility for the kernel lanes is a catalog property
(``TaskSpec.kernel_loss`` + identity prox — :func:`kernel_eligibility`).

Build counting
==============

PyTorch runs eagerly: there is nothing to trace. What a warm repeat query
must not redo is building its plan's epoch callable, so
``build_program`` counts each build through
``repro_torch.core.tracecount.count_build``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core import mrs as mrs_lib, ordering as ordering_lib
from repro_torch.core import parallel as parallel_lib, tree, uda as uda_lib
from repro_torch.core.tracecount import count_build, fresh_counter
from repro_torch.core.tree import tree_map
from repro_torch.dist import data_parallel as dp

# "sequential" is the stored order by another name (the storage layer
# just didn't cluster it); the IR canonicalizes so downstream code has
# exactly three physical orderings.
ORDERING_ALIASES = {"sequential": "clustered"}

# The implementation axis: how a serial lane body is lowered.
IMPLEMENTATIONS = ("torch_fold", "cuda_fused", "cuda_minibatch")


def canonical_ordering(name: str) -> str:
    return ORDERING_ALIASES.get(name, name)


def kernel_eligibility(task, agg) -> Tuple[Optional[str], str]:
    """(kernel loss name, "") when the aggregate can lower through the
    fused-IGD kernel, else (None, reason). Eligibility is a catalog
    property: the task's exact class must be registered with a
    ``kernel_loss`` (lr/svm/lsq) AND the aggregate must carry the
    identity prox — the kernel's transition has no prox hook, so an L1
    prox would silently be skipped."""
    from repro_torch.core import igd as igd_lib
    from repro_torch.engine import catalog

    loss = catalog.kernel_loss_for(task)
    if loss is None:
        return None, (
            f"task {type(task).__name__} has no kernel_loss in the catalog "
            "(only dense lr/svm/lsq transitions match the kernel)"
        )
    if agg.prox is not igd_lib.identity_prox:
        return None, (
            "the fused kernel's transition has no prox hook; this "
            "aggregate carries a non-identity prox"
        )
    return loss, ""


def require_kernel_loss(task, agg, implementation: str) -> str:
    """The kernel loss of a ``cuda_*`` lowering, or ValueError when the
    aggregate is not kernel-eligible or the kernel cannot take the task's
    D (``igd_fused.supports``: only D < 1): a forced plan that bypassed
    the planner must not reach a launch the kernel refuses, and on the
    CPU, whose plain versions take any D, it is refused alike."""
    from repro_torch.kernels import igd_fused

    loss, why = kernel_eligibility(task, agg)
    if loss is None:
        raise ValueError(
            f"implementation={implementation!r} needs a kernel-eligible "
            f"aggregate: {why}"
        )
    why_not = igd_fused.supports(implementation, task.dim)
    if why_not is not None:
        raise ValueError(why_not)
    return loss


# ---------------------------------------------------------------------------
# the IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpochProgram:
    """One composed execution: a physical ``Plan`` plus the serving-time
    batching axis. Hashable."""

    plan: Any  # planner.Plan (duck-typed: this module never imports it)
    batch: int = 1  # B fused query lanes (1 = driver-paced singleton)
    shared_table: bool = True  # lanes read one table vs a stacked bank
    # the epoch bound of a fused run; per-lane budgets <= epochs mask the
    # tail. 0 = driver-paced.
    epochs: int = 0

    def describe(self) -> str:
        b = f"B={self.batch}"
        if self.batch > 1 and self.epochs:
            b += " (per-lane budgets)"
        return self.plan.axes(batch=b)


@dataclasses.dataclass
class CompiledProgram:
    """``build_program``'s output, by the axes it lowers:

    * driver-paced (``batch == 1``, ``epochs == 0``) — ``epoch_fn(state,
      examples, draws) -> state``, one epoch of the plan's scheme over
      the epoch's stream (for ``source="table"`` an iterable of chunks);
      ``draws`` is the epoch's ``core.draws.EpochDraws``. For MRS plans
      the state is the carry ``(state, buf_a, buf_b, active)``. A sharded
      plan has a ``runner`` (:class:`ShardedRunner`) instead, driven by
      ``repro_torch.engine.shard``;
    * fused (``epochs >= 1``) — ``run_fn(states, examples, lane_draws,
      budgets)`` runs the WHOLE masked multi-epoch batch; ``init_fn``,
      ``loss_fn`` and (mode ``"fixed"`` under shuffle_once) ``prep_fn``
      beside it, see :func:`_build_fused`. A fused sharded batch (mode
      ``"sharded"``) carries only ``init_fn`` and ``loss_fn``: its blocks
      are the singleton compile's runner's (``runner.block(..., batch=B)``)."""

    program: EpochProgram
    task: Any
    agg: Any
    trace_counter: Dict[str, int]
    epoch_fn: Optional[Callable] = None
    # a sharded plan's blocks (driver-paced, batch == 1)
    runner: Optional["ShardedRunner"] = None
    # fused-batch fields
    mode: Optional[str] = None  # "fused" | "fixed" | "sharded"
    run_fn: Optional[Callable] = None
    prep_fn: Optional[Callable] = None
    init_fn: Optional[Callable] = None
    loss_fn: Optional[Callable] = None

    @property
    def plan(self):
        return self.program.plan

    @property
    def trace_count(self) -> int:
        return self.trace_counter["traces"]


# ---------------------------------------------------------------------------
# singleton epoch bodies (B=1, driver-paced)
# ---------------------------------------------------------------------------


def build_epoch_fn(task, agg, plan) -> Callable:
    """The plan's epoch function ``(state_or_carry, examples, draws) ->
    state_or_carry`` — the singleton lane body of its scheme."""
    impl = plan.implementation
    if impl not in IMPLEMENTATIONS:
        raise ValueError(
            f"unknown implementation {impl!r}; valid: {IMPLEMENTATIONS}"
        )
    if impl != "torch_fold" and plan.scheme != "serial":
        raise ValueError(
            f"implementation={impl!r} lowers the serial lane body; "
            f"scheme={plan.scheme!r} has no kernel form (use "
            "scheme='serial' or implementation='torch_fold')"
        )
    if plan.scheme == "serial":
        if impl != "torch_fold":
            lane = _kernel_lane_for(task, agg, impl)
            return lambda s, ex, draws: lane(s, ex)
        return lambda s, ex, draws: uda_lib.fold(agg, s, ex)
    if plan.scheme == "segmented":
        return lambda s, ex, draws: uda_lib.segmented_fold(
            agg, s, ex, plan.num_segments
        )
    if plan.scheme == "shared_memory":
        cfg = parallel_lib.SharedMemoryConfig(
            scheme=plan.sm_scheme, workers=plan.sm_workers
        )

        def sm_epoch(state, ex, draws):
            versions, keep = parallel_lib.hogwild_draws(
                draws, cfg, tree.size(state.model)
            )
            model = parallel_lib.hogwild_fold(
                task, agg.step_size, state.model, ex, cfg, versions, keep,
                prox=agg.prox,
            )
            n = next(iter(ex.values())).shape[0]
            return uda_lib.IGDState(model, state.step + n, state.weight + n)

        return sm_epoch
    if plan.scheme == "mrs":
        if plan.mrs_buffer <= 0:
            raise ValueError(
                "an MRS plan needs mrs_buffer > 0 (the planner sizes "
                "it from the memory budget)"
            )
        cfg = mrs_lib.MRSConfig(buffer_size=plan.mrs_buffer,
                                ratio=plan.mrs_ratio)

        def mrs_epoch(carry, ex, draws):
            state, buf_a, buf_b, active = carry
            state, buf_a = mrs_lib.mrs_epoch(
                agg, state, ex, buf_a, buf_b, active, cfg, draws.reservoir()
            )
            return (state, buf_a, buf_b, active)

        return mrs_epoch
    raise ValueError(f"unknown scheme {plan.scheme!r}")


def build_chunk_epoch_fn(task, agg, plan) -> Callable:
    """The ``source='table'`` epoch: the serial fold over each chunk of
    the stored order with carried state, ``(state, chunks, draws) ->
    state``; ``chunks`` yields the chunks on the run's device (the
    executor moves them as the fold takes them). The eager fold's result
    is bit-identical to folding the concatenated table; the working set
    is one chunk, which is the point of the axis."""
    if plan.scheme != "serial" or plan.ordering != "clustered":
        raise ValueError(
            "source='table' streams the stored order through the serial "
            f"fold; got scheme={plan.scheme!r}, ordering={plan.ordering!r} "
            "(the planner materializes for every other combination)"
        )
    if plan.implementation != "torch_fold":
        # alphas continue from state.step: the chunk is one more stretch
        # of the same sequential schedule
        fold_chunk = _kernel_lane_for(task, agg, plan.implementation)
    else:
        def fold_chunk(state, chunk):
            return uda_lib.fold(agg, state, chunk)

    def epoch(state, chunks, draws):
        del draws  # the stored order consumes no randomness
        for chunk in chunks:
            state = fold_chunk(state, chunk)
        return state

    return epoch


# ---------------------------------------------------------------------------
# kernel lane bodies (the implementation axis's cuda_* lowerings)
# ---------------------------------------------------------------------------


def kernel_lane_fold(agg, loss: str, *, minibatch: bool = False):
    """The serial lane body lowered through the fused-IGD kernel:
    ``(state, ex) -> state`` over a dense ``{"x": [n, d], "y": [n]}``
    epoch stream, advancing step/weight exactly like ``uda.fold`` (one
    per example). The per-example step sizes are the sequential
    schedule's exact values — transition i reads ``step_size(step0 + i)``
    and ``StepSize`` is elementwise over the step vector, so the kernel
    sees the same alphas the eager fold computes one at a time.

    The same body runs B lanes in ONE launch over stacked states (model
    [B, d], step [B], weight [B]) and a stream shared by every lane
    (``x [n, d]``) or stacked (``x [B, n, d]``, ``y [B, n]``): lane b's
    alphas are its own schedule from its own step, and the lane launch
    does each lane's arithmetic as a one-lane launch would, so lane b is
    its singleton run bit for bit."""
    from repro_torch.kernels.igd_fused import ops as igd_ops

    op = igd_ops.igd_fold_minibatch if minibatch else igd_ops.igd_fold

    def lane(state, ex):
        x, y = ex["x"], ex["y"]
        n = x.shape[-2]
        steps = state.step[..., None] + torch.arange(n, dtype=torch.int32, device=x.device)
        alphas = agg.step_size(steps)
        model = op(x, y, alphas, state.model, loss=loss)
        return uda_lib.IGDState(model, state.step + n, state.weight + n)

    return lane


def kernel_permuted_lane(agg, loss: str, *, minibatch: bool = False):
    """The kernel lane behind a permutation: the kernel streams rows in
    array order, so the permutation is applied as one gather up front
    (same rows, same order, same floats as folding ``data[perm]``)."""
    lane = kernel_lane_fold(agg, loss, minibatch=minibatch)

    def permuted(state, data, perm):
        return lane(state, ordering_lib._permute(data, perm))

    return permuted


def _kernel_lane_for(task, agg, implementation: str):
    """Build the lane body for a cuda_* implementation (validated)."""
    loss = require_kernel_loss(task, agg, implementation)
    return kernel_lane_fold(
        agg, loss, minibatch=implementation == "cuda_minibatch"
    )


# ---------------------------------------------------------------------------
# sharded compositions: step compensation + the local-SGD blocks
# ---------------------------------------------------------------------------

# the epoch stream of each ordering under the sharded parallelism
SHARD_MODES = {
    "clustered": "segments",
    "shuffle_once": "perm_once",
    "shuffle_always": "perm_epoch",
}


def compensated_step_size(step_size: Callable, num_shards: int) -> Callable:
    """The linear-scaling schedule for k-way model averaging: shard step
    counters advance once per *local* example and averaging k lane
    displacements shrinks the effective step by ~k, so shards run
    ``alpha'(t) = k * alpha(k * t)`` (in float32, in the reference's
    order: the int32 product ``k * t``, then the schedule, then the
    product by k). Identity at k=1 — the singleton path is untouched."""
    if num_shards == 1:
        return step_size

    def compensated(t):
        return num_shards * step_size(num_shards * torch.as_tensor(t))

    return compensated


def compensated_aggregate(agg, num_shards: int):
    """The aggregate the shards fold with: same transition/merge, the
    compensated schedule."""
    if num_shards == 1:
        return agg
    return dataclasses.replace(
        agg, step_size=compensated_step_size(agg.step_size, num_shards)
    )


def _bank_select(keep, new, old):
    """``_lane_select`` over the query axis of a lane bank: every leaf is
    ``[lanes, B, ...]`` and ``keep[B]`` gates axis 1."""
    return tree_map(
        lambda a, b: torch.where(keep.view((1, -1) + (1,) * (a.dim() - 2)), a, b),
        new, old,
    )


def _flat_lanes(bank):
    """A ``[lanes, B, ...]`` bank as ``[lanes * B, ...]`` (shard-major)."""
    return tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), bank)


def _kernel_bank(agg, loss: str, minibatch: bool):
    """The kernel lane body over a bank of lane states (every leaf
    ``[L, ...]``) and segments ``x [S, rows, d]``, ``y [S, rows]`` with S
    dividing L: ONE lane launch, lane l reading segment ``l // (L / S)``
    (``kernel.lanes_per_xy``). A bank of one lane is the singleton launch
    itself, so k = 1 is the singleton run bit for bit."""
    lane = kernel_lane_fold(agg, loss, minibatch=minibatch)

    def run(bank, x, y):
        if x.shape[0] == 1 and bank.step.shape[0] == 1:
            one = lane(tree_map(lambda v: v[0], bank), {"x": x[0], "y": y[0]})
            return tree_map(lambda v: v[None], one)
        return lane(bank, {"x": x, "y": y})

    return run


def _gather_rows(table, perm):
    """``table``'s rows at ``perm`` (any index shape), one gather a column."""
    return {k: v[perm] for k, v in table.items()}


def build_shard_block(
    agg,
    devices,
    *,
    num_shards: int,
    block_len: int,
    mode: str,
    n_rows: int,
    batch: int = 0,
    implementation: str = "torch_fold",
    kernel_loss: Optional[str] = None,
) -> Callable:
    """One merge-period block: ``block_len`` local epochs on every shard
    lane, then one global merge, over ``devices`` (d devices, k/d lanes
    each; single controller). ``agg`` is the compensated aggregate.

    ``mode`` selects the epoch stream (mirroring the ordering axis); the
    inputs are per device, as ``repro_torch.engine.shard`` places them:

    * ``"segments"``   — ``block(state, segs)``: contiguous per-lane
      segments ``[lanes, rows, ...]`` on each device (clustered
      ordering; the kernel lanes' shuffle_once too, whose permuted rows
      the placement gathers once);
    * ``"perm_once"``  — ``block(state, tables, perms)``: the table
      replicated, per-lane permutation slices ``[lanes, rows]`` re-used
      every epoch (shuffle_once of the eager lanes);
    * ``"perm_epoch"`` — ``block(state, tables, draws)``: a fresh
      permutation every epoch from the run's draws, in the singleton
      executor's order (the permutation, then ``epoch()``) — the
      shuffle_always stream. ``draws`` is the run's ``RunDraws`` (a list
      of B of them for a batch).

    ``state`` is ONE aggregate state in and out, on the first device:
    lanes start from it with their weight zeroed (a partial state carries
    only its own contribution — see ``uda.segmented_fold``), and the
    block ends with the merge tree (each device's lanes left to right,
    then the d device partials; ``dist.data_parallel``) and the weight
    restored to ``weight_in + block_len * n_rows``.

    ``batch = B > 0`` is the fused-serving variant: the state carries a
    leading query axis of B lanes (a lane bank is ``[lanes, B, ...]``)
    and the block takes two more arguments ``(budgets, done)``: the
    lanes' epoch budgets (a tensor on the first device) and the epochs
    completed before this block. An epoch keeps a query's old lane
    states once its budget is spent, so a frozen query's partials stop
    moving and the block-end merge is the one its own shorter run makes.

    Lane bodies, by ``implementation``:

    * ``torch_fold`` — ``torch.func.vmap`` over the eager fold (or
      ``uda.gather_fold`` through the permutation), as
      ``uda.segmented_fold`` does; one lane runs the fold itself, so
      k = 1 is the singleton run bit for bit;
    * ``cuda_fused`` / ``cuda_minibatch`` — ONE lane launch of the
      fused-IGD kernel a device an epoch, over the stacked segments
      (``x [lanes, rows, d]``, a view of the table for clustered). The
      B queries of a batch share each segment: lane ``s * B + q`` reads
      segment s (``kernel.lanes_per_xy``), so no segment is copied.
      Permuted modes gather each lane's rows first, one permuted copy of
      the table per query (``perm_epoch`` every epoch; ``perm_once``
      once, at placement).
    """
    d = len(devices)
    if num_shards % d:
        raise ValueError(f"{num_shards} shards not divisible by {d} devices")
    if mode not in ("segments", "perm_once", "perm_epoch"):
        raise ValueError(f"unknown block mode {mode!r}")
    lanes = num_shards // d
    rows = n_rows // num_shards
    batched = batch > 0
    kernel = implementation != "torch_fold"
    if kernel:
        if kernel_loss is None:
            raise ValueError(
                f"implementation={implementation!r} shard blocks need the "
                "kernel_loss resolved by the caller (require_kernel_loss)"
            )
        bank_fn = _kernel_bank(agg, kernel_loss, implementation == "cuda_minibatch")
        if mode == "perm_once":
            raise ValueError("kernel lanes take shuffle_once as gathered segments (mode 'segments')")

    def fold(s, ex):
        return uda_lib.fold(agg, s, ex)

    def gfold(s, table, p):
        return uda_lib.gather_fold(agg, s, table, p)

    def eager_epoch(bank, ex, perms, table):
        """One eager epoch of a device's lane bank: ``ex`` segments
        ``[lanes, rows, ...]`` (shared by the B queries) or ``perms``
        ``[lanes, (B,) rows]`` through ``table``."""
        one = lanes == 1 and (not batched or batch == 1)
        if one:
            s0 = tree_map(lambda v: v.reshape(v.shape[2:] if batched else v.shape[1:]), bank)
            if perms is None:
                out = fold(s0, tree_map(lambda v: v[0], ex))
            else:
                out = gfold(s0, table, perms.reshape(-1))
            return tree_map(lambda v: v.reshape((1,) * (2 if batched else 1) + tuple(v.shape)), out)
        if perms is None:
            inner = torch.func.vmap(fold, in_dims=(0, None)) if batched else fold
            return torch.func.vmap(inner, in_dims=(0, 0))(bank, ex)
        one_perm = lambda s, p: gfold(s, table, p)  # noqa: E731
        inner = torch.func.vmap(one_perm) if batched else one_perm
        return torch.func.vmap(inner)(bank, perms)

    def kernel_epoch(bank, x, y):
        """One lane launch over a device's bank: ``x [lanes, rows, d]``
        shared by the B queries, or ``[lanes, B, rows, d]`` per query."""
        flat = _flat_lanes(bank) if batched else bank
        out = bank_fn(flat, x.reshape((-1,) + tuple(x.shape[-2:])), y.reshape(-1, y.shape[-1]))
        if batched:
            out = tree_map(lambda v: v.reshape((lanes, batch) + tuple(v.shape[1:])), out)
        return out

    def lane_start(state, dev):
        # partial states carry only their own contribution to the merge
        state = tree_map(lambda v: v.to(dev), state)
        if isinstance(state, uda_lib.IGDState):
            state = uda_lib.IGDState(state.model, state.step, torch.zeros_like(state.weight))
        return tree_map(lambda v: v[None].expand((lanes,) + tuple(v.shape)).contiguous(), state)

    def lane_end(merged, state_in):
        if isinstance(merged, uda_lib.IGDState):
            folded = torch.tensor(float(block_len * n_rows), dtype=torch.float32,
                                  device=state_in.weight.device)
            return uda_lib.IGDState(merged.model, merged.step, state_in.weight + folded)
        return merged

    def merge_tree(banks):
        partials = [dp.merge_stacked(agg, b, lanes, batched=batched) for b in banks]
        return dp.device_merge(agg, partials, batched=batched)

    def local_perm(perm, i):
        """Device i's lanes' slice of a permutation ``[..., n]`` as
        ``[lanes, (B,) rows]`` on that device."""
        part = perm[..., i * lanes * rows:(i + 1) * lanes * rows]
        if batched:
            return part.reshape(batch, lanes, rows).transpose(0, 1).to(devices[i])
        return part.reshape(lanes, rows).to(devices[i])

    def run(state_in, step_devices, budgets=None, done=0):
        banks = [lane_start(state_in, dev) for dev in devices]
        for t in range(block_len):
            new = step_devices(banks)
            if batched:
                keep = (done + t) < budgets
                banks = [_bank_select(keep.to(dev), n_, o_) for dev, n_, o_ in zip(devices, new, banks)]
            else:
                banks = new
        return lane_end(merge_tree(banks), state_in)

    def draw(draws):
        """This epoch's permutation(s), in the singleton executor's order:
        the ordering's draw, then the epoch's."""
        if batched:
            perm = torch.stack([ld.permutation() for ld in draws])
            for ld in draws:
                ld.epoch()
        else:
            perm = draws.permutation()
            draws.epoch()
        return perm

    if mode == "segments":
        def block(state, segs, *masks):
            if kernel:
                step = lambda banks: [kernel_epoch(b, s["x"], s["y"]) for b, s in zip(banks, segs)]  # noqa: E731
            else:
                step = lambda banks: [eager_epoch(b, s, None, None) for b, s in zip(banks, segs)]  # noqa: E731
            return run(state, step, *masks)
    elif mode == "perm_once":
        def block(state, tables, perms, *masks):
            return run(state, lambda banks: [eager_epoch(b, None, p, tab)
                                             for b, p, tab in zip(banks, perms, tables)], *masks)
    else:
        def block(state, tables, draws, *masks):
            def step(banks):
                perm = draw(draws)
                out = []
                for i, (b, tab) in enumerate(zip(banks, tables)):
                    p = local_perm(perm, i)
                    if kernel:
                        g = _gather_rows(tab, p)
                        out.append(kernel_epoch(b, g["x"], g["y"]))
                    else:
                        out.append(eager_epoch(b, None, p, tab))
                return out
            return run(state, step, *masks)

    return block


class ShardedRunner:
    """The sharded blocks of one (query key, plan), on the engine's
    device and the devices after it.

    Lives in the executor's compiled-plan cache as the plan's runner:
    repeat queries reuse the built blocks (the build counter stays flat —
    the same observable as the singleton executor). Blocks are keyed by
    ``(mode, block_len, n_rows, batch)``: the last block of a run may be
    shorter (``epochs % H``), and fused batches share the cache."""

    def __init__(self, task, agg, plan, trace_counter: Dict[str, int], device):
        from repro_torch.launch import mesh as mesh_lib

        self.task = task
        self.agg = agg  # the registered aggregate (merges, init, terminate)
        self.agg_sharded = compensated_aggregate(agg, plan.num_shards)
        self.plan = plan
        self.trace_counter = trace_counter
        self.devices = mesh_lib.shard_devices(plan.shard_devices, device)
        self.implementation = plan.implementation
        if self.implementation not in IMPLEMENTATIONS:
            raise ValueError(
                f"unknown implementation {self.implementation!r}; valid: {IMPLEMENTATIONS}"
            )
        self.kernel_loss = (
            require_kernel_loss(task, self.agg_sharded, self.implementation)
            if self.implementation != "torch_fold" else None
        )
        self._blocks: Dict[Tuple, Callable] = {}
        # repeat queries over the same live table skip re-partitioning /
        # re-placing it (leaf identity, like Engine._reports; entries pin
        # their leaves so ids cannot be recycled)
        self._placed: Dict[Tuple, Tuple] = {}

    @property
    def kernel(self) -> bool:
        return self.implementation != "torch_fold"

    def placed(self, key: Tuple, leaves_: Tuple, build: Callable):
        hit = self._placed.get(key)
        if hit is not None:
            return hit[1]
        value = build()
        while len(self._placed) >= 8:
            self._placed.pop(next(iter(self._placed)))
        self._placed[key] = (leaves_, value)
        return value

    def block(self, mode: str, block_len: int, n_rows: int, batch: int = 0) -> Callable:
        """The block of ``block_len`` epochs in ``mode``; ``batch = B``
        is the fused-serving variant (a query axis of B lanes with
        per-lane epoch budgets, for every ordering)."""
        key = (mode, block_len, n_rows, batch)
        fn = self._blocks.get(key)
        if fn is None:
            fn = build_shard_block(
                self.agg_sharded, self.devices, num_shards=self.plan.num_shards,
                block_len=block_len, mode=mode, n_rows=n_rows, batch=batch,
                implementation=self.implementation, kernel_loss=self.kernel_loss,
            )
            count_build(self.trace_counter)
            self._blocks[key] = fn
        return fn


# ---------------------------------------------------------------------------
# fused batches (B lanes, singleton parallelism)
# ---------------------------------------------------------------------------


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _lane(tree_, b: int):
    return tree_map(lambda x: x[b], tree_)


def _lane_select(keep, new, old):
    """Per-lane mask select: ``keep[B]`` gates the leading lane axis of
    every state leaf (a lane whose budget is spent keeps its state — the
    masked-epoch mechanism of the batching axis)."""
    return tree_map(
        lambda a, b: torch.where(keep.view((-1,) + (1,) * (a.dim() - 1)), a, b),
        new, old,
    )


def _gather_lanes(data, perms, shared: bool):
    """Each lane's permuted copy, stacked: ``data[perms[b]]`` for lane b
    (the same rows, gathered once up front, that its singleton run's
    ``index_select`` gathers)."""
    if shared:
        return {k: v[perms] for k, v in data.items()}
    lanes = torch.arange(perms.shape[0], device=perms.device)[:, None]
    return {k: v[lanes, perms] for k, v in data.items()}


def _build_fused(task, agg, prog: EpochProgram, counter: Dict[str, int]) -> CompiledProgram:
    """Stack B query lanes and run the ENTIRE multi-epoch batch as one
    call, with per-lane draws and per-lane epoch budgets. ``run_fn``'s
    contract:

    * mode ``"fused"`` (serial shuffle_always, and eager serial
      shuffle_once): ``run_fn(states, data, lane_draws, budgets)`` —
      each lane draws its permutations in-run, in its singleton run's
      order (shuffle_once's one draw, or one an epoch), and folds
      through them: kernel lanes gather the B permuted copies an epoch
      and launch once (the reference's ``kernel_permuted_lane`` under
      ``vmap``); eager lanes ``vmap`` ``uda.gather_fold`` through the
      indices, writing no copy;
    * mode ``"fixed"`` (clustered, kernel or non-serial shuffle_once):
      the epoch stream is prepared once outside (``prep_fn(data,
      lane_draws)`` draws each lane's one permutation and gathers the
      B copies; clustered lanes read the table as it is) and
      ``run_fn(states, examples, lane_draws, budgets)`` only takes the
      per-epoch draws;
    * non-serial shuffle_always is mode ``"fused"`` too: each lane's
      permuted copy an epoch, then the scheme's epoch lane by lane.

    ``examples``/``data`` is the one table every lane reads
    (``prog.shared_table``) or a stacked bank with a leading lane axis.
    ``budgets`` (host ints) keep lane i's state after ``budgets[i]``
    epochs: the mask is made once on the device, and a spent lane's
    draws go on in its own stream, where they shift no other lane's.
    All-equal budgets select the new state everywhere. ``init_fn``
    stacks each lane's initial state from its draws; ``loss_fn(models,
    data)`` evaluates each lane's objective as its singleton run does."""
    plan = prog.plan
    epochs, shared = prog.epochs, prog.shared_table
    ordering = plan.ordering
    serial = plan.scheme == "serial"
    data_dim = None if shared else 0
    impl = plan.implementation
    kernel = impl != "torch_fold"
    if kernel:
        lanes = kernel_lane_fold(agg, require_kernel_loss(task, agg, impl),
                                 minibatch=impl == "cuda_minibatch")
    raw = build_epoch_fn(task, agg, plan)

    def lane_by_lane(states, examples, eds):
        """The plan's singleton epoch, once a lane."""
        return _stack([
            raw(_lane(states, b), examples if shared and ordering == "clustered"
                else _lane(examples, b), ed)
            for b, ed in enumerate(eds)
        ])

    def draw_perms(lane_draws):
        return torch.stack([ld.permutation() for ld in lane_draws])

    # eager serial lanes vmap the fold; one lane runs the singleton fold
    # itself, so B = 1 is the singleton run bit for bit (vmap's batched
    # dots round differently)
    vmapped = serial and not kernel and prog.batch > 1
    prep_fn = None
    # kernel lanes read rows in array order: under shuffle_once their B
    # permuted copies are gathered once, in prep_fn ("fixed")
    if serial and (ordering == "shuffle_always" or ordering == "shuffle_once" and not kernel):
        mode = "fused"
        if kernel:
            def step(states, data, perms, eds):
                return lanes(states, _gather_lanes(data, perms, shared))
        elif vmapped:
            vfold = torch.func.vmap(
                lambda s, d, p: uda_lib.gather_fold(agg, s, d, p),
                in_dims=(0, data_dim, 0),
            )

            def step(states, data, perms, eds):
                return vfold(states, data, perms)
    elif ordering == "shuffle_always":
        mode = "fused"
    else:
        mode = "fixed"
        if ordering == "shuffle_once":
            def prep_fn(data, lane_draws):
                return _gather_lanes(data, draw_perms(lane_draws), shared)
        if kernel:
            def step(states, examples, perms, eds):
                return lanes(states, examples)
        elif vmapped:
            ex_dim = None if shared and ordering == "clustered" else 0
            vfold = torch.func.vmap(lambda s, ex: uda_lib.fold(agg, s, ex), in_dims=(0, ex_dim))

            def step(states, examples, perms, eds):
                return vfold(states, examples)
    if not kernel and not vmapped:
        # the scheme's singleton epoch, once a lane
        def step(states, data, perms, eds):
            examples = data if mode == "fixed" else _gather_lanes(data, perms, shared)
            return lane_by_lane(states, examples, eds)

    def run(states, data, lane_draws, budgets):
        device = tree.leaves(states)[0].device
        budgets_dev = torch.tensor(list(budgets), dtype=torch.int64, device=device)
        perms = None
        if mode == "fused" and ordering == "shuffle_once":
            perms = draw_perms(lane_draws)  # ShuffleOnce's one draw
        for t in range(epochs):
            if mode == "fused" and ordering == "shuffle_always":
                perms = draw_perms(lane_draws)
            eds = [ld.epoch() for ld in lane_draws]
            states = _lane_select(budgets_dev > t, step(states, data, perms, eds), states)
        return states

    def init_fn(lane_draws):
        return _stack([uda_lib.initial_state(ld.initial_model(task)) for ld in lane_draws])

    def loss_fn(models, data):
        return torch.stack([
            task.full_loss(_lane(models, b), data if shared else _lane(data, b))
            for b in range(prog.batch)
        ])

    return CompiledProgram(
        program=prog, task=task, agg=agg, trace_counter=counter,
        mode=mode, run_fn=run, prep_fn=prep_fn, init_fn=init_fn,
        loss_fn=loss_fn,
    )


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------


def build_program(
    task,
    agg,
    prog: EpochProgram,
    *,
    counter: Optional[Dict[str, int]] = None,
    device=None,
) -> CompiledProgram:
    """Lower ``prog`` to its callables: the executor's driver-paced
    epoch (``batch == 1``, ``epochs == 0``; a stored table's chunk stream
    for ``source='table'``; a sharded plan's runner, whose blocks are laid
    out from ``device``, the engine's device, on) or the serving front
    end's fused run (``epochs >= 1``; B = 1 is a valid single-lane run).
    The one entry point every driver builds through, counted by the
    ``program.builds`` counter under a ``program.build`` span."""
    obs.metrics.inc("program.builds")
    with obs.span("program.build", axes=prog.plan.axes(), batch=prog.batch):
        return _build_program(task, agg, prog, counter=counter, device=device)


def _build_program(task, agg, prog: EpochProgram, *, counter, device) -> CompiledProgram:
    counter = counter if counter is not None else fresh_counter()
    plan = prog.plan
    if prog.batch < 1:
        raise ValueError(f"batch must be >= 1, got {prog.batch}")
    sharded = getattr(plan, "parallelism", "singleton") == "sharded"
    if sharded and plan.scheme != "serial":
        raise ValueError(
            f"a sharded plan runs the serial fold on each shard; got scheme={plan.scheme!r}"
        )
    if prog.batch == 1 and prog.epochs == 0 and sharded:
        # driver-paced: repro_torch.engine.shard loops blocks (and stop
        # rules) around the runner's blocks, which count their builds
        return CompiledProgram(
            program=prog, task=task, agg=agg, trace_counter=counter,
            runner=ShardedRunner(task, agg, plan, counter, device),
        )
    if prog.batch == 1 and prog.epochs == 0:
        if plan.source == "table":
            epoch_fn = build_chunk_epoch_fn(task, agg, plan)
        else:
            epoch_fn = build_epoch_fn(task, agg, plan)
        count_build(counter)
        return CompiledProgram(
            program=prog, task=task, agg=agg, trace_counter=counter,
            epoch_fn=epoch_fn,
        )
    if plan.scheme == "mrs":
        raise ValueError("MRS plans carry per-query reservoirs and cannot be fused")
    if plan.source == "table":
        raise ValueError("a stored table's chunk stream is not fused: its queries run singleton")
    if prog.epochs < 1:
        raise ValueError(
            f"a fused program runs a fixed epoch bound: epochs must be >= 1, got {prog.epochs}"
        )
    if sharded:
        if not prog.shared_table:
            raise ValueError(
                "fused sharded batches require one shared table (per-query "
                "segment banks would multiply the partitioned footprint)"
            )
        # the blocks come from the singleton compile's runner
        # (runner.block(..., batch=B)), so fused and singleton queries share
        # them; this program carries the lane-wise init and loss
        compiled = CompiledProgram(
            program=prog, task=task, agg=agg, trace_counter=counter, mode="sharded",
            init_fn=lambda lane_draws: _stack([
                uda_lib.initial_state(ld.initial_model(task)) for ld in lane_draws]),
            loss_fn=lambda models, data: torch.stack([
                task.full_loss(_lane(models, b), data) for b in range(prog.batch)]),
        )
        count_build(counter)
        return compiled
    compiled = _build_fused(task, agg, prog, counter)
    count_build(counter)
    return compiled
