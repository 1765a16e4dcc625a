"""Micro-probe calibration for the cost-based planner.

The planner's constants are MEASURED, not guessed: on first contact with
a (task, table-signature) pair the engine times, on a probe slab of the
table, (a) a random shuffle-gather, (b) one eager serial fold
(``torch_fold``), (c) one pairwise merge, (d) the batched segmented fold
at its largest feasible segment count, and (e) for kernel-eligible
aggregates the fused-IGD kernel lanes of the implementation axis. Each
is the median of a few timed calls; on a card the time comes from CUDA
events. Results are cached on the engine, once per signature.

A stored table hands over its head rows (``probe_slab``), moved to the
engine's device: the probe measures time, not values, and must not
materialize the table.

(f) — only when the engine's kind has more than one device
(``launch.mesh.shard_device_count``), as the reference probes only a
multi-device mesh — times the sharded local-SGD blocks over the
placements {1, 2, d} (min of 9 calls through ``timing.seconds``,
blocks of 1 and 8 epochs) and keeps the fastest as the shard count's
``ShardPoint``. On one device no sharded point exists and the planner
enumerates a sharded plan only when a hint names it.

Not applicable here: the reference's ``probe_batch_unroll`` (the fused
batch's scan unroll, re-probed on a stacked slab) and its
``_SHARD_LANE_UNROLL`` (the unroll probe (f) builds its lanes with):
PyTorch runs the eager fold as a Python loop with no scan unroll to
choose, and the kernel lanes have no unroll knob either.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch import obs, timing


def time_call(fn, *args, device, warmup: int = 1, iters: int = 3) -> float:
    """Median time (seconds) of ``fn(*args)`` on ``device``: CUDA events
    on a card, the host clock after a sync on the CPU."""
    for _ in range(warmup):
        fn(*args)
    timing.sync(device)
    times = sorted(timing.seconds(lambda: fn(*args), device) for _ in range(iters))
    return times[len(times) // 2]


# Slab size: one slab for every per-row constant, so the rankings
# compare rates amortized over the same row count.
PROBE_ROWS = 2048
# Segment counts the batched segmented fold is probed at (the planner's
# SEGMENT_CANDIDATES, largest first): the largest that divides the slab
# is measured, the rest interpolate (Calibration.seg_per_row_at). Probe
# (f) takes its shard count from the same list.
_SEG_PROBE_CANDIDATES = (8, 4, 2)


@dataclasses.dataclass(frozen=True)
class ShardPoint:
    """Measured cost of one sharded(k) decomposition on the live devices."""

    num_shards: int
    devices: int  # probed placement: shards / devices lanes each
    epoch_seconds_per_row: float  # steady-state local-epoch cost
    block_seconds: float  # fixed per-block cost (launches + merge tree)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ShardPoint":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-(task, signature) measured constants (seconds)."""

    shuffle_per_row: float
    # the eager serial fold (torch_fold). PyTorch runs eagerly: there is
    # no scan unroll to probe per candidate, so this is one rate.
    fold_per_row: float
    merge_seconds: float
    probe_rows: int
    # measured batched segmented fold (num_segments -> seconds/row)
    seg_per_row: Dict[int, float] = dataclasses.field(default_factory=dict)
    # measured fused-IGD kernel lanes (implementation -> seconds/row:
    # "cuda_fused", "cuda_minibatch"), probed on the SAME slab as the
    # eager fold; empty when the aggregate is not kernel-eligible
    impl_per_row: Dict[str, float] = dataclasses.field(default_factory=dict)
    # measured sharded-block costs (num_shards -> ShardPoint); empty with
    # one device of the engine's kind, where probe (f) does not run
    shard: Dict[int, ShardPoint] = dataclasses.field(default_factory=dict)
    device_count: int = 1

    def seg_per_row_at(self, k: int) -> float:
        """Per-row cost of a k-segment batched fold. The largest candidate
        is measured; other k interpolate between the serial fold (k=1) and
        the measured point on the (1 - 1/k) scan-shortening curve."""
        if k in self.seg_per_row:
            return self.seg_per_row[k]
        if not self.seg_per_row:
            return self.fold_per_row  # nothing measured: no claimed speedup
        k_ref, ref = max(self.seg_per_row.items())
        frac = (1.0 - 1.0 / k) / (1.0 - 1.0 / k_ref)
        return self.fold_per_row + (ref - self.fold_per_row) * frac

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # JSON keys are strings; from_dict restores the int keys
        d["seg_per_row"] = {str(k): v for k, v in self.seg_per_row.items()}
        # asdict already recursed into the ShardPoint dataclasses
        d["shard"] = {str(k): dict(v) for k, v in d["shard"].items()}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        d = dict(d)
        d["seg_per_row"] = {int(k): v for k, v in d.get("seg_per_row", {}).items()}
        d["shard"] = {int(k): ShardPoint.from_dict(p) for k, p in d.get("shard", {}).items()}
        d.setdefault("device_count", 1)
        d.setdefault("impl_per_row", {})
        return cls(**d)


def calibrate(agg, data, *, device, cache: Dict[Tuple, Calibration],
              key: Tuple, stats: Dict[str, int]) -> Calibration:
    """Measure the planner's constants on a probe slab of ``data``,
    memoized in ``cache`` under ``key``; ``stats['probe_runs']`` and the
    ``probes.runs`` counter count real measurements, each under a
    ``probe.calibrate`` span timed into ``probes.calibrate_s`` (the probes
    sync the device, so the span covers their kernels)."""
    if key in cache:
        return cache[key]
    stats["probe_runs"] += 1
    obs.metrics.inc("probes.runs")
    watch = timing.Stopwatch()
    with obs.span("probe.calibrate", task=key[0] if key else ""):
        cal = _measure(agg, data, device=device, key=key)
    cache[key] = cal
    obs.metrics.observe("probes.calibrate_s", watch.lap())
    return cal


def _measure(agg, data, *, device, key: Tuple) -> Calibration:
    """Probes (a)-(f) on a slab of ``data`` (see the module's note)."""
    from repro_torch.core import uda as uda_lib
    from repro_torch.engine import table as table_lib

    if table_lib.is_stored_table(data):
        rows = min(data.n_rows, PROBE_ROWS)
        slab = {k: v.to(device) for k, v in data.probe_slab(rows).items()}
    else:
        rows = min(next(iter(data.values())).shape[0], PROBE_ROWS)
        slab = {k: v[:rows] for k, v in data.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    # (a) shuffle: permutation + gather, the per-epoch ShuffleAlways cost
    perm = torch.randperm(rows, generator=gen, device=device)
    t_shuffle = time_call(
        lambda d, p: {k: torch.index_select(v, 0, p) for k, v in d.items()},
        slab, perm, device=device,
    )

    # (b) the eager serial fold (the transition's real cost)
    state0 = agg.initialize(gen)
    fold_per_row = time_call(
        lambda s, ex: uda_lib.fold(agg, s, ex), state0, slab, device=device
    ) / rows

    # (c) one pairwise merge
    t_merge = time_call(agg.merge, state0, state0, device=device)

    # (d) the batched segmented fold at its largest feasible segment count
    # (the rest interpolate — see seg_per_row_at)
    seg_per_row = {}
    k_seg = next((k for k in _SEG_PROBE_CANDIDATES if rows % k == 0), None)
    if k_seg is not None:
        seg_per_row[k_seg] = time_call(
            lambda s, ex: uda_lib.segmented_fold(agg, s, ex, k_seg),
            state0, slab, device=device,
        ) / rows

    # (e) the fused-IGD kernel lanes (the implementation axis), on the
    # SAME slab as the eager fold
    impl_per_row = _probe_implementations(agg, slab, state0, rows, device)

    # (f) the sharded local-SGD blocks on the live devices (more than one
    # only): placement efficiency is a property of the machine, the one
    # constant that cannot be modeled
    from repro_torch.launch import mesh as mesh_lib

    shard = {}
    device_count = mesh_lib.shard_device_count(device)
    if device_count > 1:
        shard = _probe_sharded(agg, slab, state0, device, task_name=key[0] if key else "")

    return Calibration(
        shuffle_per_row=t_shuffle / rows,
        fold_per_row=fold_per_row,
        merge_seconds=t_merge,
        probe_rows=rows,
        seg_per_row=seg_per_row,
        impl_per_row=impl_per_row,
        shard=shard,
        device_count=device_count,
    )


def _probe_implementations(agg, slab, state0, rows: int, device) -> Dict[str, float]:
    """Time the fused-IGD kernel lanes (seconds/row) for the
    implementation axis: only those whose kernel takes the slab's D
    (``igd_fused.supports``, the same answer on every device). Empty when
    the aggregate is not kernel-eligible or the slab is not dense (x, y)
    rows — the planner then never enumerates a cuda_* candidate."""
    from repro_torch.engine import program as program_lib
    from repro_torch.kernels import igd_fused
    from repro_torch.kernels.igd_fused import ops as igd_ops

    loss, _why = program_lib.kernel_eligibility(agg.task, agg)
    if loss is None or set(slab) != {"x", "y"} or slab["x"].dim() != 2:
        return {}
    # the sequential schedule's exact per-row alphas, like the kernel lane
    steps = state0.step + torch.arange(rows, dtype=torch.int32, device=device)
    alphas = agg.step_size(steps)
    out = {}
    for name, op in (
        ("cuda_fused", igd_ops.igd_fold),
        ("cuda_minibatch", igd_ops.igd_fold_minibatch),
    ):
        if igd_fused.supports(name, slab["x"].shape[1]) is not None:
            continue
        out[name] = time_call(
            lambda x, y, a, w, op=op: op(x, y, a, w, loss=loss),
            slab["x"], slab["y"], alphas, state0.model, device=device,
        ) / rows
    return out


def _min_of(fn, *args, device, iters: int = 9) -> float:
    """Min-of-k time: shard probes run on busy hosts where load only ever
    inflates a sample (the reference's estimator), after one warm-up."""
    fn(*args)
    timing.sync(device)
    return min(timing.seconds(lambda: fn(*args), device) for _ in range(iters))


def _probe_sharded(agg, slab, state0, device, task_name: str = "") -> Dict[int, ShardPoint]:
    """Measure sharded(k) block costs for the largest feasible shard count
    over the placements {1, 2, d}. Two block lengths (1 and 8 epochs)
    split the measurement into a steady-state per-epoch cost and a fixed
    per-block overhead (launches and the merge tree) — the two constants
    the planner's merge-period-H cost model needs. The blocks come from
    the one program compiler (``program.build_shard_block``), with the
    eager lanes the planner enumerates, so the probe times what will run.

    Non-convex tasks probe at their capped shard count (the planner only
    enumerates k <= NONCONVEX_SHARD_CAP for them)."""
    from repro_torch.dist import data_parallel as dp
    from repro_torch.engine import catalog, planner, program as program_lib
    from repro_torch.launch import mesh as mesh_lib

    k_cap = None
    if task_name:
        try:
            if catalog.get(task_name).nonconvex:
                k_cap = planner.NONCONVEX_SHARD_CAP
        except KeyError:
            pass
    devices = mesh_lib.shard_device_count(device)
    rows = next(iter(slab.values())).shape[0]
    k = next(
        (k for k in _SEG_PROBE_CANDIDATES
         if rows % k == 0 and k > 1 and (k_cap is None or k <= k_cap)),
        None,
    )
    if k is None:
        return {}
    best, best_t8 = None, float("inf")
    for d in sorted({d for d in (1, 2, devices) if d <= devices and k % d == 0}):
        devs = mesh_lib.shard_devices(d, device)
        segs = dp.scatter_lanes(dp.partition_rows(slab, k), devs)
        timings = {}
        for block_len in (1, 8):
            blk = program_lib.build_shard_block(
                agg, devs, num_shards=k, block_len=block_len, mode="segments", n_rows=rows,
            )
            timings[block_len] = _min_of(blk, state0, segs, device=device)
        # placements are ranked by the long block itself; the (epoch,
        # overhead) split only extrapolates the chosen one to other merge
        # periods, and biases the per-epoch share UP (t8/8 includes an
        # eighth of the overhead) so the claimed speedup stays conservative
        if timings[8] < best_t8:
            best_t8 = timings[8]
            epoch_s = max(timings[8] / 8.0, 1e-9)
            best = ShardPoint(
                num_shards=k, devices=d, epoch_seconds_per_row=epoch_s / rows,
                block_seconds=max(timings[1] - epoch_s, 0.0),
            )
    return {k: best} if best is not None else {}
