"""Cost-based physical planning for analytics queries.

The planner enumerates the physical-plan space the paper studies as
independent knobs and picks the cheapest plan under a cost model whose
constants are measured by micro-probes (``repro_torch.engine.probes``)
rather than assumed. Statistics about the table (label-clusteredness via
a Wald–Wolfowitz runs statistic) feed the convergence-rate term, so the
pathological clustered scan on label-sorted data is costed out, not
special-cased.

This slice of the port plans the serial scheme on one device over an
in-memory table: ordering (§3.2) × implementation (``torch_fold`` |
``cuda_fused`` | ``cuda_minibatch``). A hint for a scheme, parallelism
or source that a later slice brings raises ``NotImplementedError``.

``PlanReport.describe()`` renders the choice and every rejected
candidate with its estimated cost — the engine's EXPLAIN.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from repro_torch.engine import probes
from repro_torch.engine.program import IMPLEMENTATIONS, canonical_ordering
from repro_torch.engine.query import AnalyticsQuery

ORDERINGS = ("clustered", "shuffle_once", "shuffle_always")
SCHEMES = ("serial", "segmented", "shared_memory", "mrs")
PARALLELISMS = ("singleton", "sharded")
SOURCES = ("memory", "table")
# Convergence-penalty cap for a fully label-clustered scan (paper Fig. 5:
# orders of magnitude more epochs; 50x is enough to always reject it).
CLUSTERED_PENALTY_CAP = 50.0

# What each not-yet-ported axis value waits for (ROADMAP queue 1).
_LATER = {
    "segmented": "the schemes slice (segmented fold)",
    "shared_memory": "the schemes slice (shared-memory simulator)",
    "mrs": "the schemes slice (buffered MRS)",
    "sharded": "the sharding slice (engine/shard.py)",
    "table": "the stored-table slice (engine/table.py)",
}
# hint keys that only the later schemes read
_LATER_HINT_KEYS = {
    "num_segments": "segmented", "num_shards": "sharded",
    "merge_period": "sharded", "shard_devices": "sharded",
}


def _not_ported(what: str, value: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}={value!r} is not in this slice of the port; it comes with "
        f"{_LATER[value]}"
    )


@dataclasses.dataclass(frozen=True)
class Plan:
    """A fully physical execution plan. Hashable: part of the compiled-
    plan cache key. In this slice every plan is a serial fold on one
    device over the in-memory table; the other axes join the plan with
    the slices that bring a second value for them."""

    ordering: str  # clustered | shuffle_once | shuffle_always
    # torch_fold: the eager uda.fold loop. cuda_fused: the fused-IGD
    # kernel's per-tuple lane (probe-priced against the loop for
    # kernel-eligible plans). cuda_minibatch: one mean-gradient step per
    # tile — different algorithm semantics, hint-only.
    implementation: str = "torch_fold"

    def axes(self, batch: str = "1") -> str:
        """The composed-axes line (EXPLAIN's ``why``)."""
        return (
            f"ordering={self.ordering} × parallelism=singleton/serial × "
            f"batch={batch} × source=memory × "
            f"implementation={self.implementation}"
        )

    def describe(self) -> str:
        impl = (
            f" · impl={self.implementation} (fused-IGD kernel)"
            if self.implementation != "torch_fold" else ""
        )
        return f"ordering={self.ordering} · serial fold{impl}"


@dataclasses.dataclass(frozen=True)
class Candidate:
    plan: Plan
    cost_seconds: float
    est_epochs: float
    note: str = ""


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


def _conv_multiplier(plan: Plan, clusteredness: float) -> Tuple[float, str]:
    """Relative epochs-to-tolerance vs the shuffle-once serial baseline."""
    mult = 1.0
    note = ""
    if plan.ordering == "clustered":
        # runs-starved gradient order: rate degrades sharply with c
        penalty = 1.0 / max(1.0 - clusteredness, 1.0 / CLUSTERED_PENALTY_CAP)
        mult *= penalty
        if penalty > 2.0:
            note = f"label-clustered scan: ~{penalty:.0f}x more epochs"
    elif plan.ordering == "shuffle_always":
        mult *= 0.95  # marginally better per-epoch rate (paper Fig. 5)
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
    The serial lane body's compute sits on the implementation axis,
    priced at the probed rate of the chosen lowering; parallelism and
    source are 0 in this slice's plan space. The note gains the measured
    us/epoch of every probed lane implementation."""
    n = query.n_examples
    fold_row = cal.fold_per_row

    # -- ordering axis: the cost of imposing the scan order --------------
    shuffles = {"clustered": 0.0, "shuffle_once": 1.0,
                "shuffle_always": est_epochs}[plan.ordering]
    ordering = cal.shuffle_per_row * n * shuffles

    # -- implementation axis: the serial lane body -----------------------
    impl_row = (
        cal.impl_per_row.get(plan.implementation, fold_row)
        if plan.implementation != "torch_fold" else fold_row
    )
    implementation = impl_row * n * est_epochs
    if cal.impl_per_row:
        # the probe-derived choice, shown in EXPLAIN: measured us/epoch
        # for every lane lowering probed on this device
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
            "parallelism": 0.0,
            "source": 0.0,
            "implementation": implementation,
        },
        note,
    )


def program_cost(
    plan: Plan,
    query: AnalyticsQuery,
    cal: probes.Calibration,
    clusteredness: float,
) -> Candidate:
    """THE cost model: one function costs every point of the plan space
    from the same measured constants."""
    epochs = max(query.epochs, 1)
    mult, note = _conv_multiplier(plan, clusteredness)
    est_epochs = min(epochs * mult, epochs * CLUSTERED_PENALTY_CAP)
    comps, note = cost_components(plan, query, cal, est_epochs, note=note)
    return Candidate(plan, sum(comps.values()), est_epochs, note)


# ---------------------------------------------------------------------------
# enumeration + choice
# ---------------------------------------------------------------------------


def _check_hints(query: AnalyticsQuery, hints: dict, cal) -> None:
    """Reject unknown and contradictory hints (ValueError), then hints
    that name what a later slice brings (NotImplementedError)."""
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
        if cal is not None and not cal.impl_per_row:
            raise ValueError(
                f"implementation={impl_hint!r} forced for a query whose "
                "aggregate is not kernel-eligible (catalog kernel_loss + "
                "identity prox + dense (x, y) rows — see "
                "program.kernel_eligibility)"
            )
    if hints.get("scheme") == "mrs" and hints.get("ordering") not in (
        None, "clustered",
    ):
        raise ValueError(
            "scheme='mrs' streams the stored order (its point is avoiding "
            "the shuffle); it cannot be combined with an ordering hint of "
            f"{hints['ordering']!r}"
        )
    for key, default in (("scheme", "serial"), ("parallelism", "singleton"),
                         ("source", "memory")):
        if hints.get(key, default) != default:
            raise _not_ported(key, hints[key])
    for key, value in _LATER_HINT_KEYS.items():
        if key in hints:
            raise _not_ported(f"{key} hint implies scheme", value)
    if (
        query.memory_budget_bytes is not None
        and query.data_bytes > query.memory_budget_bytes
    ):
        raise _not_ported("a table over memory_budget_bytes needs scheme", "mrs")


def enumerate_plans(query: AnalyticsQuery, cal=None) -> List[Plan]:
    hints = dict(query.hints)
    if "ordering" in hints:
        # one source of truth for the IR's ordering names
        hints["ordering"] = canonical_ordering(hints["ordering"])
    _check_hints(query, hints, cal)
    orderings = [hints["ordering"]] if "ordering" in hints else list(ORDERINGS)
    impl_hint = hints.get("implementation")
    if impl_hint is not None:
        impls = [impl_hint]
    elif cal is not None and cal.impl_per_row.get("cuda_fused") is not None:
        # auto: enumerate the kernel lane next to the eager fold — the
        # probe-derived choice falls out of the ranking. cuda_minibatch is
        # never auto-chosen (one averaged step per tile is a different
        # algorithm, not a faster identical one).
        impls = ["torch_fold", "cuda_fused"]
    else:
        impls = ["torch_fold"]
    return [Plan(o, implementation=i) for o in orderings for i in impls]


def plan(query: AnalyticsQuery, cal: probes.Calibration) -> PlanReport:
    """Choose a physical plan for ``query`` from the calibration ``cal``
    the engine probed for its aggregate."""
    clustered = label_clusteredness(query.data)
    cands = [
        program_cost(p, query, cal, clustered)
        for p in enumerate_plans(query, cal)
    ]
    cands.sort(key=lambda c: c.cost_seconds)
    best = cands[0]
    return PlanReport(
        chosen=best.plan,
        cost_seconds=best.cost_seconds,
        candidates=tuple(cands),
        clusteredness=clustered,
        calibration=cal,
        axes=best.plan.axes(),
    )
