"""Predicted-vs-measured cost tables with drift ratios (the port's copy of
``repro.obs.drift``: the same JSON, so either package loads the other's
reports).

``engine.explain_analyze(query)`` runs the chosen plan under the span
tracer and fills one of these: per composed EpochProgram axis (ordering,
parallelism, batching, source, implementation) the planner's predicted seconds sit next
to the measured seconds, with a drift ratio (measured/predicted). The
total drift answers the question the micro-probe calibration cannot:
*did the cost model predict the run it chose?* A total outside
``[1/DRIFT_STALE_RATIO, DRIFT_STALE_RATIO]`` marks the calibration
stale — the machine changed (contention, different hardware, a thermal
throttle) since the constants were measured, and persisted plans should
be re-probed (a fresh ``Engine`` in-process, whose probe cache is its
own; delete the PlanStore entry or bump its ``FORMAT_VERSION`` across
processes).

The report is JSON-serializable and is persisted by ``PlanStore`` next
to the plan entry, so staleness is detectable across processes: a fresh
process can load the last measured run and compare before trusting the
stored plan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Beyond this total measured/predicted ratio (either direction) the
# calibration is considered stale. Micro-probes extrapolate a ~2048-row
# slab to the full run, so honest drift of 1.5-2x is normal; 3x means
# the constants no longer describe this machine.
DRIFT_STALE_RATIO = 3.0

# What a STALE verdict tells the operator to do. The port keeps its probed
# calibrations on the engine (Engine.clear_cache keeps them), so a fresh
# Engine re-probes in-process; across processes the PlanStore entry goes.
STALE_REMEDY = "a fresh engine.Engine() / invalidate the PlanStore entry"

# Below this many seconds a component is dispatch noise on any host
# (one launch and a sync run tens of microseconds even for a no-op) and
# its ratio is reported as 1.0 instead of flagging a zero-priced axis as
# infinitely drifted over jitter.
_NOISE_FLOOR_S = 1e-4


def drift_ratio(predicted_s: float, measured_s: float) -> float:
    """measured/predicted with noise handling: both under the floor is
    perfect agreement (1.0); a truly zero prediction with real measured
    time is infinite drift (the model priced the axis at zero and it
    wasn't); a tiny-but-nonzero prediction divides honestly."""
    if predicted_s <= _NOISE_FLOOR_S and measured_s <= _NOISE_FLOOR_S:
        return 1.0
    if predicted_s <= 0.0:
        return math.inf
    return measured_s / predicted_s


@dataclasses.dataclass(frozen=True)
class AxisCost:
    """One composed axis's predicted vs measured cost."""

    axis: str  # ordering | parallelism | batching | source
    predicted_s: float
    measured_s: float
    detail: str = ""  # what was measured, e.g. "shuffle+gather walls"

    @property
    def ratio(self) -> float:
        return drift_ratio(self.predicted_s, self.measured_s)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AxisCost":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """EXPLAIN ANALYZE's payload: the side-by-side axis table."""

    axes: str  # the composed-axes line of the plan analyzed
    plan: dict  # planner.Plan.to_dict()
    rows: Tuple[AxisCost, ...]
    epochs_run: int
    predicted_total_s: float
    measured_total_s: float
    # critical-path phase decomposition of the analyzed run
    # (attribution.PhaseReport.to_dict()); None on pre-attribution
    # entries loaded from an old PlanStore
    attribution: Optional[dict] = None

    @property
    def drift(self) -> float:
        return drift_ratio(self.predicted_total_s, self.measured_total_s)

    @property
    def stale(self) -> bool:
        d = self.drift
        return not (1.0 / DRIFT_STALE_RATIO <= d <= DRIFT_STALE_RATIO)

    def describe(self) -> str:
        def ms(s: float) -> str:
            return f"{s * 1e3:10.2f} ms"

        def ratio(r: float) -> str:
            return "   inf" if math.isinf(r) else f"{r:5.2f}x"

        lines = [
            f"EXPLAIN ANALYZE  ({self.axes})",
            f"{'axis':<12}{'predicted':>13}{'measured':>13}{'drift':>8}"
            "  measured as",
        ]
        for r in self.rows:
            lines.append(
                f"{r.axis:<12}{ms(r.predicted_s)}{ms(r.measured_s)}"
                f"{ratio(r.ratio):>8}  {r.detail}"
            )
        verdict = (
            f"STALE (outside {1 / DRIFT_STALE_RATIO:.2f}-"
            f"{DRIFT_STALE_RATIO:.1f}x) — re-probe: {STALE_REMEDY}"
            if self.stale
            else "ok"
        )
        lines.append(
            f"{'total':<12}{ms(self.predicted_total_s)}"
            f"{ms(self.measured_total_s)}{ratio(self.drift):>8}"
            f"  over {self.epochs_run} epoch(s); calibration: {verdict}"
        )
        if self.attribution is not None:
            from repro_torch.obs import attribution as attribution_lib

            lines.append(
                attribution_lib.PhaseReport.from_dict(
                    self.attribution
                ).describe()
            )
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "axes": self.axes,
            "plan": self.plan,
            "rows": [r.to_dict() for r in self.rows],
            "epochs_run": self.epochs_run,
            "predicted_total_s": self.predicted_total_s,
            "measured_total_s": self.measured_total_s,
            "attribution": self.attribution,
            # derived fields persisted for grep-ability of stored entries
            "drift": None if math.isinf(self.drift) else self.drift,
            "stale": self.stale,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DriftReport":
        return cls(
            axes=d["axes"],
            plan=d["plan"],
            rows=tuple(AxisCost.from_dict(r) for r in d["rows"]),
            epochs_run=d["epochs_run"],
            predicted_total_s=d["predicted_total_s"],
            measured_total_s=d["measured_total_s"],
            # absent on entries persisted before the attribution field
            attribution=d.get("attribution"),
        )
