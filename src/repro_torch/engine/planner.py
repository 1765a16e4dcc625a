"""Cost-based physical planning for analytics queries.

The planner enumerates the physical-plan space the paper studies as
independent knobs —

    ordering policy (§3.2)  x  execution scheme (§3.3: serial fold,
    shared-nothing segmented fold, shared-memory concurrency; §3.4:
    buffered MRS)  x  parallelism (one device, or sharded(k, H): k
    shared-nothing shards as merge-period-H local SGD over d devices)
    x  implementation of the serial lane body (``torch_fold`` |
    ``cuda_fused`` | ``cuda_minibatch``) —

and picks the cheapest plan under a cost model whose constants are
measured by micro-probes (``repro_torch.engine.probes``) rather than
assumed. Statistics about the table (label-clusteredness via a
Wald–Wolfowitz runs statistic) feed the convergence-rate term, so the
pathological clustered scan on label-sorted data is costed out, not
special-cased. A table over the query's memory budget makes every
shuffled plan infeasible, which leaves MRS (§3.4).

The data-source axis: over a stored table (``repro_torch.engine.table``)
the clustered serial plan streams the chunk order (``source="table"``);
every other plan materializes the table once through ``table.resolve``,
which the source term prices.

The sharded parallelism (``repro_torch.engine.shard``) is enumerated
from probe (f)'s measured mesh points, which exist only when the
engine's kind has more than one device (``launch.mesh.shard_device_count``),
or from a ``num_shards`` hint on any device count; the reference plans
the same way.

``PlanReport.describe()`` renders the choice and every rejected
candidate with its estimated cost — the engine's EXPLAIN.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from repro_torch.engine import catalog, probes, table as table_lib
from repro_torch.engine.program import IMPLEMENTATIONS, canonical_ordering
from repro_torch.engine.query import AnalyticsQuery
from repro_torch.kernels import igd_fused

ORDERINGS = ("clustered", "shuffle_once", "shuffle_always")
SCHEMES = ("serial", "segmented", "shared_memory", "mrs")
PARALLELISMS = ("singleton", "sharded")
SOURCES = ("memory", "table")
SEGMENT_CANDIDATES = (2, 4, 8)
SM_SCHEMES = ("lock", "aig", "nolock")
SM_WORKERS = 8
MRS_RATIO = 2
# Convergence-penalty cap for a fully label-clustered scan (paper Fig. 5:
# orders of magnitude more epochs; 50x is enough to always reject it).
CLUSTERED_PENALTY_CAP = 50.0
# Per-step overhead factor of the shared-memory simulator (ring reads and
# writes around each transition). The simulator runs on ONE device — its
# cost model claims no parallel speedup (it exists to reproduce Fig. 9's
# convergence behavior, not to be fast).
SM_OVERHEAD = 3.0
# Merge periods enumerated for sharded plans (filtered to divisors of the
# epoch budget so a run builds ONE block length).
MERGE_PERIOD_CANDIDATES = (1, 5, 10, 20)
# Non-convex tasks (catalog ``nonconvex=True``): model averaging of
# misaligned factors can cancel instead of combine — cap the shard count
# (the reference measured tuple-partitioned lmf diverging at k=8 and
# holding at k<=4).
NONCONVEX_SHARD_CAP = 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """A fully physical execution plan. Hashable: part of the compiled-
    plan cache key."""

    ordering: str  # clustered | shuffle_once | shuffle_always
    scheme: str = "serial"  # serial | segmented | shared_memory | mrs
    num_segments: int = 1
    sm_scheme: str = "nolock"
    sm_workers: int = SM_WORKERS
    mrs_buffer: int = 0
    mrs_ratio: int = MRS_RATIO
    # torch_fold: the eager uda.fold loop. cuda_fused: the fused-IGD
    # kernel's per-tuple lane (probe-priced against the loop for
    # kernel-eligible serial plans). cuda_minibatch: one mean-gradient
    # step per tile — different algorithm semantics, hint-only.
    implementation: str = "torch_fold"
    # -- the parallel-execution axis (repro_torch.engine.shard) ------------
    # singleton: one device runs the scheme above. sharded: the table is
    # partitioned into num_shards shared-nothing segments laid out over
    # shard_devices devices, trained as merge-period-H local SGD (serial
    # folds per shard, the lanes of one kernel launch or one vmap a
    # device; pure-UDA model-averaging merges).
    parallelism: str = "singleton"  # singleton | sharded
    num_shards: int = 1
    merge_period: int = 1  # H: epochs between cross-shard merges
    shard_devices: int = 1  # probed placement (shards / devices lanes each)
    # memory: the table is (or is materialized as) one resident table.
    # table: a stored table's chunk stream is folded in stored order —
    # picked for clustered serial plans over a stored table, where it
    # avoids the materialization entirely.
    source: str = "memory"

    def axes(self, batch: str = "1") -> str:
        """The composed-axes line (EXPLAIN's ``why``)."""
        if self.parallelism == "sharded":
            par = (
                f"sharded(k={self.num_shards}, H={self.merge_period}, "
                f"{self.shard_devices} dev)"
            )
        else:
            par = f"singleton/{self.scheme}"
        return (
            f"ordering={self.ordering} × parallelism={par} × "
            f"batch={batch} × source={self.source} × "
            f"implementation={self.implementation}"
        )

    def describe(self) -> str:
        if self.parallelism == "sharded":
            ex = (
                f"sharded fold ({self.num_shards} shards over "
                f"{self.shard_devices} device(s), merge every "
                f"{self.merge_period} epoch(s))"
            )
        elif self.scheme == "serial":
            ex = "serial fold"
        elif self.scheme == "segmented":
            ex = (
                f"segmented fold ({self.num_segments} shared-nothing "
                "segments, merge=model-averaging)"
            )
        elif self.scheme == "shared_memory":
            ex = (
                f"shared-memory fold ({self.sm_scheme}, "
                f"{self.sm_workers} workers)"
            )
        else:
            ex = (
                f"buffered MRS (reservoir={self.mrs_buffer}, "
                f"{self.mrs_ratio} memory steps/tuple)"
            )
        src = " · source=table stream" if self.source == "table" else ""
        impl = (
            f" · impl={self.implementation} (fused-IGD kernel)"
            if self.implementation != "torch_fold" else ""
        )
        return f"ordering={self.ordering} · {ex}{src}{impl}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Candidate:
    plan: Plan
    cost_seconds: float
    est_epochs: float
    note: str = ""

    def to_dict(self) -> dict:
        return {
            "plan": self.plan.to_dict(),
            # inf (infeasible) is not valid JSON: round-trip as None
            "cost_seconds": None if math.isinf(self.cost_seconds) else self.cost_seconds,
            "est_epochs": self.est_epochs,
            "note": self.note,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        cost = d["cost_seconds"]
        return cls(
            plan=Plan.from_dict(d["plan"]),
            cost_seconds=float("inf") if cost is None else cost,
            est_epochs=d["est_epochs"],
            note=d.get("note", ""),
        )


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """The planner's EXPLAIN output: the choice plus the whole ranking."""

    chosen: Plan
    cost_seconds: float
    candidates: Tuple[Candidate, ...]
    clusteredness: float
    calibration: probes.Calibration
    axes: str = ""

    def describe(self) -> str:
        lines = [
            f"plan   : {self.chosen.describe()}",
            f"cost   : {self.cost_seconds * 1e3:.2f} ms (est)"
            f"   [clusteredness={self.clusteredness:.2f}, "
            f"fold={self.calibration.fold_per_row * 1e6:.2f}"
            f" us/row, shuffle={self.calibration.shuffle_per_row * 1e6:.2f}"
            f" us/row]",
        ]
        chosen_note = next(
            (c.note for c in self.candidates
             if c.plan == self.chosen and c.note), "",
        )
        why = f"axes: {self.axes or self.chosen.axes()}"
        if chosen_note:
            why += f" — {chosen_note}"
        lines.insert(1, f"why    : {why}")
        for c in sorted(self.candidates, key=lambda c: c.cost_seconds)[1:]:
            cost = (
                "infeasible"
                if math.isinf(c.cost_seconds)
                else f"{c.cost_seconds * 1e3:.2f} ms"
            )
            note = f"  — {c.note}" if c.note else ""
            lines.append(f"reject : {c.plan.describe()} ({cost}){note}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """JSON-serializable form (the on-disk plan cache's payload)."""
        return {
            "chosen": self.chosen.to_dict(),
            "cost_seconds": self.cost_seconds,
            "candidates": [c.to_dict() for c in self.candidates],
            "clusteredness": self.clusteredness,
            "calibration": self.calibration.to_dict(),
            "axes": self.axes,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PlanReport":
        return cls(
            chosen=Plan.from_dict(d["chosen"]),
            cost_seconds=d["cost_seconds"],
            candidates=tuple(Candidate.from_dict(c) for c in d["candidates"]),
            clusteredness=d["clusteredness"],
            calibration=probes.Calibration.from_dict(d["calibration"]),
            axes=d.get("axes", ""),
        )


# ---------------------------------------------------------------------------
# table statistics
# ---------------------------------------------------------------------------


def label_clusteredness(data) -> float:
    """Wald–Wolfowitz runs statistic on the label column, mapped to
    [0, 1]: 0 = order indistinguishable from random, 1 = fully clustered
    (the CA-TX pathology). 0 when no label-like column exists."""
    if not isinstance(data, dict) or "y" not in data:
        return 0.0
    y = data["y"].detach().cpu().numpy()
    if y.ndim != 1 or y.shape[0] < 8:
        return 0.0
    # binarize: sign for real labels, equality-runs for ints
    if np.issubdtype(y.dtype, np.floating):
        b = y >= np.median(y)
    else:
        b = y == y[0]
    n1 = int(b.sum())
    n2 = b.size - n1
    if n1 == 0 or n2 == 0:
        return 0.0
    runs = 1 + int(np.count_nonzero(b[1:] != b[:-1]))
    expected = 2.0 * n1 * n2 / (n1 + n2) + 1.0
    return float(np.clip(1.0 - runs / expected, 0.0, 1.0))


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


def _conv_multiplier(
    plan: Plan, clusteredness: float, nonconvex: bool = False
) -> Tuple[float, str]:
    """Relative epochs-to-tolerance vs the shuffle-once serial baseline."""
    mult = 1.0
    note = ""
    if plan.scheme == "mrs":
        # the reservoir randomizes the gradient order itself, so MRS is
        # immune to the stored order (that is its whole point, §3.4)
        return 1.25, note  # reservoir ~ shuffle-once rate (paper Fig. 10)
    if plan.ordering == "clustered":
        # runs-starved gradient order: rate degrades sharply with c
        penalty = 1.0 / max(1.0 - clusteredness, 1.0 / CLUSTERED_PENALTY_CAP)
        mult *= penalty
        if penalty > 2.0:
            note = f"label-clustered scan: ~{penalty:.0f}x more epochs"
    elif plan.ordering == "shuffle_always":
        mult *= 0.95  # marginally better per-epoch rate (paper Fig. 5)
    if plan.parallelism == "sharded":
        # the compensated step schedule keeps the averaged trajectory at
        # the serial rate; a small staleness/averaging guard still breaks
        # ties toward simpler plans when the measured speedup is marginal
        mult *= (1.0 + 0.02 * (1.0 - 1.0 / plan.num_shards)
                 + 0.02 * (1.0 - 1.0 / plan.merge_period))
        if nonconvex:
            # averaged non-convex factors lose real progress per merge
            mult *= 1.0 + 0.1 * (plan.num_shards - 1)
    elif plan.scheme == "segmented":
        mult *= 1.0 + 0.1 * (plan.num_segments - 1)  # model-averaging loss
    elif plan.scheme == "shared_memory":
        mult *= 1.1 if plan.sm_scheme != "lock" else 1.0
    return mult, note


def cost_components(
    plan: Plan,
    query: AnalyticsQuery,
    cal: probes.Calibration,
    est_epochs: float,
    *,
    note: str = "",
) -> Tuple[dict, str]:
    """The cost model's arithmetic, decomposed along the EpochProgram
    axes it prices: ``{"ordering": s, "parallelism": s, "source": s,
    "implementation": s}`` whose sum is :func:`program_cost`'s total.

    A serial singleton plan's lane body sits on the implementation axis,
    priced at the probed rate of the chosen lowering (and the note gains
    the measured us/epoch of every probed lane implementation);
    parallelism is 0 there. Every other scheme, and the sharded
    parallelism, keeps its compute under parallelism with
    implementation = 0 (a sharded plan's note names its mesh probe).
    Source is the one materialization of a stored table by a plan that
    does not stream it."""
    n = query.n_examples
    fold_row = cal.fold_per_row

    # -- ordering axis: the cost of imposing the scan order --------------
    if plan.parallelism == "sharded":
        # shuffle orderings on the sharded path gather through the
        # permutation every epoch, surcharged per epoch
        gather_row = cal.shuffle_per_row if plan.ordering != "clustered" else 0.0
        ordering = gather_row * n * est_epochs
    else:
        shuffles = {"clustered": 0.0, "shuffle_once": 1.0,
                    "shuffle_always": est_epochs}[plan.ordering]
        ordering = cal.shuffle_per_row * n * shuffles

    # -- source axis: getting the rows resident ---------------------------
    if table_lib.is_stored_table(query.data) and plan.source != "table":
        source = cal.shuffle_per_row * n
    else:
        source = 0.0

    # -- parallelism axis: the epoch compute + merges --------------------
    if plan.parallelism == "sharded":
        point = cal.shard.get(plan.num_shards)
        if point is not None:
            # mesh-probed, not modeled: steady-state local-epoch cost plus
            # the fixed per-block cost at merge period H
            blocks = math.ceil(est_epochs / plan.merge_period)
            parallelism = point.epoch_seconds_per_row * n * est_epochs
            parallelism += point.block_seconds * blocks
            speedup = fold_row / max(point.epoch_seconds_per_row, 1e-12)
            probe_note = (
                f"mesh-probed {speedup:.2f}x/epoch over "
                f"{point.devices} device(s)"
            )
        else:
            # hint-forced without a probed mesh point (one device or an
            # un-probed k): no claimed speedup
            parallelism = fold_row * n * est_epochs
            parallelism += cal.merge_seconds * plan.num_shards * math.ceil(
                est_epochs / plan.merge_period
            )
            probe_note = "sharded without a mesh probe: modeled at serial cost"
        note = f"{note}; {probe_note}" if note else probe_note
    elif plan.scheme == "serial":
        parallelism = 0.0  # the lane body is priced on the impl axis below
    elif plan.scheme == "segmented":
        # measured batched segmented fold (interpolated off the probed
        # point), plus the k-1 merges an epoch
        per_epoch = cal.seg_per_row_at(plan.num_segments) * n
        per_epoch += cal.merge_seconds * (plan.num_segments - 1)
        parallelism = per_epoch * est_epochs
    elif plan.scheme == "shared_memory":
        parallelism = SM_OVERHEAD * fold_row * n * est_epochs
    else:  # mrs: 1 I/O step + ratio memory steps per streamed tuple
        parallelism = fold_row * n * (1 + plan.mrs_ratio) * est_epochs

    # -- implementation axis: the serial singleton lane body -------------
    implementation = 0.0
    if plan.parallelism != "sharded" and plan.scheme == "serial":
        impl_row = (
            cal.impl_per_row.get(plan.implementation, fold_row)
            if plan.implementation != "torch_fold" else fold_row
        )
        implementation = impl_row * n * est_epochs
        if cal.impl_per_row:
            # the probe-derived choice, shown in EXPLAIN: measured
            # us/epoch for every lane lowering probed on this device
            rates = {"torch_fold": fold_row, **cal.impl_per_row}
            probed = ", ".join(
                f"{name} {rate * n * 1e6:.0f} us/epoch"
                for name, rate in rates.items()
            )
            impl_note = f"impl-probed: {probed}"
            note = f"{note}; {impl_note}" if note else impl_note

    return (
        {
            "ordering": ordering,
            "parallelism": parallelism,
            "source": source,
            "implementation": implementation,
        },
        note,
    )


def program_cost(
    plan: Plan,
    query: AnalyticsQuery,
    cal: probes.Calibration,
    clusteredness: float,
    shuffle_feasible: bool,
    nonconvex: bool = False,
) -> Candidate:
    """THE cost model: one function costs every point of the plan space
    from the same measured constants. A
    shuffled plan is infeasible (cost ``inf``) when the shuffled copy
    does not fit the query's memory budget."""
    epochs = max(query.epochs, 1)
    mult, note = _conv_multiplier(plan, clusteredness, nonconvex)
    est_epochs = min(epochs * mult, epochs * CLUSTERED_PENALTY_CAP)
    if plan.ordering != "clustered" and not shuffle_feasible:
        return Candidate(
            plan, float("inf"), est_epochs,
            "shuffled copy exceeds memory budget",
        )
    comps, note = cost_components(plan, query, cal, est_epochs, note=note)
    cost = (
        comps["ordering"] + comps["source"] + comps["parallelism"]
        + comps["implementation"]
    )
    return Candidate(plan, cost, est_epochs, note)


# ---------------------------------------------------------------------------
# enumeration + choice
# ---------------------------------------------------------------------------


def _mrs_buffer_rows(query: AnalyticsQuery) -> int:
    """Reservoir rows: half the memory budget (buffers A and B), at least
    8; a tenth of the table without a budget; never more than the table."""
    n = query.n_examples
    if query.memory_budget_bytes:
        per_row = max(query.data_bytes // max(n, 1), 1)
        rows = max(int(query.memory_budget_bytes // (2 * per_row)), 8)
    else:
        rows = max(n // 10, 8)
    return int(min(rows, n))


def _dense_dim(query: AnalyticsQuery):
    """D of a dense ``{"x": [n, d], "y": [n]}`` table, else None."""
    cols = {name: shape for name, shape, *_ in query.data_signature()}
    x = cols.get("x")
    return x[1] if set(cols) == {"x", "y"} and len(x) == 2 else None


def _check_hints(query: AnalyticsQuery, hints: dict, cal) -> None:
    """Reject unknown and contradictory hints (ValueError)."""
    if hints.get("source") == "table" and not table_lib.is_stored_table(query.data):
        raise ValueError(
            "source='table' needs the query's data to be a stored Table "
            "(duck-typed: is_stored_table)"
        )
    for key, valid in (("ordering", ORDERINGS), ("scheme", SCHEMES),
                       ("parallelism", PARALLELISMS), ("source", SOURCES),
                       ("implementation", IMPLEMENTATIONS)):
        if key in hints and hints[key] not in valid:
            raise ValueError(
                f"unknown {key} hint {hints[key]!r}; valid: {valid}"
            )
    impl_hint = hints.get("implementation")
    if impl_hint not in (None, "torch_fold"):
        if hints.get("scheme") not in (None, "serial"):
            raise ValueError(
                f"implementation={impl_hint!r} lowers the serial lane "
                "body (each lane streams the fused-IGD kernel); "
                f"conflicting scheme hint {hints['scheme']!r}"
            )
        if cal is not None and impl_hint not in cal.impl_per_row:
            d = _dense_dim(query)
            why = igd_fused.supports(impl_hint, d) if d is not None else None
            if why is not None:
                raise ValueError(f"implementation={impl_hint!r} forced for a width its kernel cannot take: {why}")
            raise ValueError(
                f"implementation={impl_hint!r} forced for a query whose "
                "aggregate is not kernel-eligible (catalog kernel_loss + "
                "identity prox + dense (x, y) rows — see "
                "program.kernel_eligibility)"
            )
    k = hints.get("num_segments")
    if k is not None and (not isinstance(k, int) or k < 1):
        raise ValueError(f"num_segments hint must be an int >= 1, got {k!r}")
    if hints.get("scheme") == "mrs" and hints.get("ordering") not in (
        None, "clustered",
    ):
        raise ValueError(
            "scheme='mrs' streams the stored order (its point is avoiding "
            "the shuffle); it cannot be combined with an ordering hint of "
            f"{hints['ordering']!r}"
        )
    if hints.get("parallelism") == "sharded" and hints.get("scheme") not in (None, "serial"):
        raise ValueError(
            "parallelism='sharded' implies scheme='serial' (each shard "
            "runs the serial fold; segmentation IS the parallelism) — "
            f"conflicting scheme hint {hints['scheme']!r}"
        )


def _merge_periods(epochs: int, hints: dict) -> List[int]:
    if "merge_period" in hints:
        h = int(hints["merge_period"])
        if h < 1:
            raise ValueError(f"merge_period hint must be >= 1 epoch, got {h}")
        return [h]
    epochs = max(epochs, 1)
    cands = [h for h in MERGE_PERIOD_CANDIDATES if h <= epochs and epochs % h == 0]
    return cands or [1]


def _sharded_plans(query: AnalyticsQuery, cal, hints: dict, orderings: List[str]) -> List[Plan]:
    """Sharded candidates: mesh-probed shard counts that divide the table
    (or a hint-forced configuration), one per merge period. The intra-
    shard epoch is the serial fold — segmentation IS the parallelism.
    Non-convex tasks are capped at NONCONVEX_SHARD_CAP shards (an
    explicit num_shards hint overrides)."""
    n = query.n_examples
    plans: List[Plan] = []
    if "num_shards" in hints:
        ks = [int(hints["num_shards"])]
    elif cal is not None:
        ks = sorted(cal.shard)
        try:
            if catalog.get(query.task).nonconvex:
                ks = [min(k, NONCONVEX_SHARD_CAP) for k in ks]
        except KeyError:
            pass
    else:
        ks = []
    for k in dict.fromkeys(ks):
        if k < 1 or n % k:
            continue
        point = cal.shard.get(k) if cal is not None else None
        d = point.devices if point is not None else 1
        # placement is normally mesh-probed; the hint is the escape
        # hatch for forced-topology smokes and experiments
        d = int(hints.get("shard_devices", d))
        if d < 1 or k % d:
            if "num_shards" in hints:
                # both sides explicitly forced and incompatible: say so
                raise ValueError(f"shard_devices={d} must divide num_shards={k}")
            continue  # a probe-derived k this hint can't place: skip it
        for o in orderings:
            for h in _merge_periods(query.epochs, hints):
                plans.append(Plan(
                    o, "serial", parallelism="sharded", num_shards=k,
                    merge_period=h, shard_devices=d,
                ))
    return plans


def enumerate_plans(query: AnalyticsQuery, cal=None) -> List[Plan]:
    """Every plan the hints admit: ordering × scheme (the segment counts
    that divide the table, each shared-memory scheme, one MRS plan over
    the stored order) × parallelism (the sharded plans of the probed
    mesh points or of a ``num_shards`` hint, one per merge period) × the
    data source (a stored table's clustered serial singleton plan streams
    its chunks) × the implementation of the serial lane body."""
    hints = dict(query.hints)
    if "ordering" in hints:
        # one source of truth for the IR's ordering names
        hints["ordering"] = canonical_ordering(hints["ordering"])
    _check_hints(query, hints, cal)
    impl_hint = hints.get("implementation")
    if impl_hint not in (None, "torch_fold"):
        hints["scheme"] = "serial"
    n = query.n_examples
    orderings = [hints["ordering"]] if "ordering" in hints else list(ORDERINGS)
    schemes = [hints["scheme"]] if "scheme" in hints else list(SCHEMES)
    plans: List[Plan] = []
    if hints.get("parallelism") != "sharded":
        for o in orderings:
            for s in schemes:
                if s == "serial":
                    plans.append(Plan(o))
                elif s == "segmented":
                    ks = (
                        [hints["num_segments"]]
                        if "num_segments" in hints
                        else [k for k in SEGMENT_CANDIDATES if n % k == 0]
                    )
                    plans.extend(Plan(o, "segmented", num_segments=k) for k in ks)
                elif s == "shared_memory":
                    plans.extend(
                        Plan(o, "shared_memory", sm_scheme=sm) for sm in SM_SCHEMES
                    )
                elif s == "mrs" and (o == "clustered" or "scheme" in hints):
                    # MRS exists to avoid the shuffle: stream stored order
                    plans.append(Plan(
                        "clustered", "mrs", mrs_buffer=_mrs_buffer_rows(query),
                    ))
    if (
        hints.get("parallelism") in (None, "sharded")
        and hints.get("scheme") in (None, "serial")
        and query.epochs >= 1
    ):
        plans.extend(_sharded_plans(query, cal, hints, orderings))
    if hints.get("parallelism") == "sharded" and not plans:
        raise ValueError(
            "parallelism='sharded' needs a probed mesh point or an explicit "
            "num_shards hint that divides the table"
        )
    # -- the data-source axis: a stored table's clustered serial singleton
    # plan streams the chunk order; every other plan needs random access
    # and materializes
    if table_lib.is_stored_table(query.data):
        def streams(p: Plan) -> bool:
            return (p.ordering == "clustered" and p.scheme == "serial"
                    and p.parallelism == "singleton")

        plans = [dataclasses.replace(p, source="table") if streams(p) else p for p in plans]
        if hints.get("source") == "table":
            plans = [p for p in plans if p.source == "table"]
            if not plans:
                raise ValueError(
                    "source='table' streams the stored chunk order: it "
                    "requires ordering='clustered' (or 'sequential'), "
                    "scheme='serial', parallelism='singleton' — the "
                    "other hints exclude every streaming plan"
                )
        elif hints.get("source") == "memory":
            plans = [dataclasses.replace(p, source="memory") for p in plans]
    # -- the implementation axis: lane-body lowering ----------------------
    if impl_hint not in (None, "torch_fold"):
        # forced: every admitted plan is serial (validated above)
        plans = [dataclasses.replace(p, implementation=impl_hint) for p in plans]
    elif impl_hint is None and cal is not None and cal.impl_per_row.get(
        "cuda_fused"
    ) is not None:
        # auto: enumerate the kernel lane next to the eager fold for serial
        # singleton plans — the probe-derived choice falls out of the
        # ranking. cuda_minibatch is never auto-chosen (one averaged step
        # per tile is a different algorithm, not a faster identical one)
        # and sharded plans keep their mesh-probed eager lanes, as the
        # reference's keep their xla lanes.
        plans.extend([
            dataclasses.replace(p, implementation="cuda_fused")
            for p in plans if p.scheme == "serial" and p.parallelism == "singleton"
        ])
    return list(dict.fromkeys(plans))  # Plan is frozen/hashable


def batchable(query: AnalyticsQuery, chosen: Plan) -> bool:
    """Whether the serving front end may fuse this query into a batched
    lane (the batching axis): fixed-epoch, unbudgeted, in memory,
    non-MRS."""
    return (
        query.target_loss is None
        and not query.tolerance
        and query.epochs >= 1
        and query.memory_budget_bytes is None
        and chosen.scheme != "mrs"
        and not table_lib.is_stored_table(query.data)
    )


def plan(query: AnalyticsQuery, cal: probes.Calibration) -> PlanReport:
    """Choose a physical plan for ``query`` from the calibration ``cal``
    the engine probed for its aggregate. Statistics read a head sample of
    a stored table: ranking plans must not materialize it."""
    stats_data = (
        query.data.probe_slab(min(query.n_examples, 4096))
        if table_lib.is_stored_table(query.data) else query.data
    )
    clustered = label_clusteredness(stats_data)
    shuffle_feasible = (
        query.memory_budget_bytes is None
        or query.data_bytes <= query.memory_budget_bytes
    )
    try:
        nonconvex = catalog.get(query.task).nonconvex
    except KeyError:
        nonconvex = False
    cands = [
        program_cost(p, query, cal, clustered, shuffle_feasible, nonconvex)
        for p in enumerate_plans(query, cal)
    ]
    if not cands:
        raise ValueError(
            f"hints {dict(query.hints)!r} admit no physical plan"
        )
    cands.sort(key=lambda c: c.cost_seconds)
    best = cands[0]
    if math.isinf(best.cost_seconds):
        raise RuntimeError(
            f"no feasible plan for query (budget="
            f"{query.memory_budget_bytes}); candidates: {cands}"
        )
    return PlanReport(
        chosen=best.plan,
        cost_seconds=best.cost_seconds,
        candidates=tuple(cands),
        clusteredness=clustered,
        calibration=cal,
        axes=best.plan.axes(batch="fusable" if batchable(query, best.plan) else "1"),
    )
