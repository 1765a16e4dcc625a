"""SLO monitors: declarative rules over the metrics registry (the port's
copy of ``repro.obs.slo``; its cadence runs on ``timing.monotonic`` and an
incident's ``ts`` is ``timing.wall``).

A serving loop for millions of users is judged by objectives — "p99
latency under X", "shed rate under Y" — not by eyeballing snapshots.
An :class:`SLORule` names a registry metric (exact, or a ``prefix.*``
glob over e.g. the per-task latency histograms), the statistic to read
(``p99``/``p50``/``mean``/``max``/``count`` for histograms, ``value``
for counters/gauges, optionally divided by a ``per`` denominator metric
to express rates), and a threshold. :class:`SLOMonitor` evaluates the
rules on a cadence (``ServingEngine.pump`` calls ``maybe_evaluate``
between groups, so monitoring never blocks the hot path mid-batch).

A breach emits a **structured event** (appended to the monitor, a
bounded process-global recent-breach log the ``/snapshot`` endpoint
reads, and the ``slo.breaches`` counter) and — when the monitor has an
``incident_dir`` — dumps the flight recorder into an **incident file**:
one JSONL file whose first line is the breach header (rule, observed vs
threshold, the full metrics snapshot at breach time) and whose
remaining lines are the last-N spans from the flight ring, schema-valid
against ``trace.JSONL_SCHEMA``. That file is the post-hoc debugging
story: what the engine was doing in the seconds before the objective
was missed, captured without anyone having enabled tracing in advance.

Per-rule cooldowns keep a sustained breach from writing an incident per
pump; ``validate_incident`` is the schema check the tests and the obs
smoke run against every dump.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch import timing
from repro_torch.obs import flight as flight_lib
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import trace as trace_lib

# Statistics readable off a histogram snapshot (all exact or
# bucket-interpolated exactly as Histogram reports them).
_HIST_STATS = ("p50", "p99", "mean", "max", "min", "count", "sum")

# Keys every incident header must carry (validate_incident enforces).
INCIDENT_HEADER_SCHEMA = {
    "kind": str,
    "rule": str,
    "metric": str,
    "stat": str,
    "op": str,
    "observed": (int, float),
    "threshold": (int, float),
    "ts": (int, float),
    "flight_spans": int,
    "metrics": dict,
}


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One objective: ``stat(metric) op threshold`` breaches.

    ``metric`` may end in ``.*`` to match every registry name under the
    prefix (each match is evaluated independently — the way to express
    "p99 per task" without enumerating tasks). ``per`` divides the
    observed value by another metric's value/count (rates: shed per
    accepted query). Histograms with fewer than ``min_count``
    observations are skipped — one slow warm-up query is not a breach.
    """

    name: str
    metric: str
    stat: str = "value"
    op: str = ">"
    threshold: float = 0.0
    per: Optional[str] = None
    min_count: int = 1

    def __post_init__(self):
        if self.op not in (">", "<", ">=", "<="):
            raise ValueError(f"bad op {self.op!r}")
        if self.stat not in _HIST_STATS + ("value",):
            raise ValueError(f"bad stat {self.stat!r}")


def default_serve_rules(
    *,
    p99_latency_s: float = 1.0,
    max_queue_depth: int = 64,
    max_shed_rate: float = 0.05,
    flag_stale_calibration: bool = True,
) -> Tuple[SLORule, ...]:
    """The serving loop's standard objectives: per-task p99 latency,
    live queue depth, shed rate (queue-full sheds per accepted query),
    and the EXPLAIN ANALYZE stale-calibration flag."""
    rules = [
        SLORule("latency_p99", "serve.latency_s.*", stat="p99",
                threshold=p99_latency_s, min_count=3),
        SLORule("queue_depth", "serve.queue_depth", stat="value",
                threshold=float(max_queue_depth)),
        SLORule("shed_rate", "serve.shed.queue_full", stat="value",
                per="serve.accepted", threshold=max_shed_rate),
    ]
    if flag_stale_calibration:
        rules.append(
            SLORule("calibration_stale", "engine.calibration_stale",
                    stat="value", threshold=0.5)
        )
    return tuple(rules)


# Process-global recent-breach log (the /snapshot endpoint reads it):
# bounded so a flapping rule cannot grow it; cleared by the test
# fixtures alongside the registry.
_RECENT: collections.deque = collections.deque(maxlen=64)
_LOCK = threading.Lock()
_INCIDENT_SEQ = 0


def recent_breaches() -> Tuple[dict, ...]:
    with _LOCK:
        return tuple(_RECENT)


def clear_breaches() -> None:
    with _LOCK:
        _RECENT.clear()


def _numeric(snap: Optional[dict]) -> Optional[float]:
    """A snapshot's scalar reading (counter/gauge value, histogram
    count), or None when absent/non-numeric."""
    if snap is None:
        return None
    if snap.get("type") == "histogram":
        return float(snap["count"])
    value = snap.get("value")
    if isinstance(value, bool):
        return float(value)
    return float(value) if isinstance(value, (int, float)) else None


class SLOMonitor:
    """Evaluate rules against the registry on a cadence.

    ``interval_s`` rate-limits ``maybe_evaluate`` (the pump calls it
    after every group); ``cooldown_s`` rate-limits incident emission
    per (rule, metric) so a sustained breach produces one incident per
    window, not one per pump. ``incident_dir`` is created lazily on the
    first dump — a monitor without one still records structured events.
    """

    def __init__(
        self,
        rules: Sequence[SLORule],
        *,
        registry: metrics_lib.Registry = metrics_lib.REGISTRY,
        interval_s: float = 1.0,
        cooldown_s: float = 30.0,
        incident_dir: Optional[str] = None,
    ):
        self.rules = tuple(rules)
        self.registry = registry
        self.interval_s = interval_s
        self.cooldown_s = cooldown_s
        self.incident_dir = incident_dir
        self.breaches: List[dict] = []
        self._last_eval = -float("inf")
        self._last_fire: Dict[Tuple[str, str], float] = {}

    # -- cadence ----------------------------------------------------------

    def maybe_evaluate(self) -> List[dict]:
        """Evaluate if at least ``interval_s`` has passed; else no-op."""
        now = timing.monotonic()
        if now - self._last_eval < self.interval_s:
            return []
        return self.evaluate()

    # -- evaluation -------------------------------------------------------

    def _targets(
        self, rule: SLORule, snapshot: Dict[str, dict]
    ) -> Iterator[Tuple[str, dict]]:
        if rule.metric.endswith(".*"):
            prefix = rule.metric[:-1]  # keep the trailing dot
            for name in sorted(snapshot):
                if name.startswith(prefix):
                    yield name, snapshot[name]
        elif rule.metric in snapshot:
            yield rule.metric, snapshot[rule.metric]

    def _observe(
        self, rule: SLORule, name: str, snap: dict,
        snapshot: Dict[str, dict],
    ) -> Optional[float]:
        if snap.get("type") == "histogram":
            if snap["count"] < rule.min_count:
                return None
            observed = snap[rule.stat] if rule.stat in _HIST_STATS \
                else None
        else:
            observed = _numeric(snap) if rule.stat == "value" else None
        if observed is None:
            return None
        if rule.per is not None:
            denom = _numeric(snapshot.get(rule.per))
            if denom is None:
                return None
            observed = observed / max(denom, 1.0)
        return observed

    @staticmethod
    def _breached(observed: float, op: str, threshold: float) -> bool:
        return {
            ">": observed > threshold,
            ">=": observed >= threshold,
            "<": observed < threshold,
            "<=": observed <= threshold,
        }[op]

    def evaluate(self) -> List[dict]:
        """One full pass over the rules. Returns this pass's breach
        events (cooldown-suppressed repeats excluded)."""
        now = timing.monotonic()
        self._last_eval = now
        snapshot = self.registry.snapshot()
        fired: List[dict] = []
        for rule in self.rules:
            for name, snap in self._targets(rule, snapshot):
                observed = self._observe(rule, name, snap, snapshot)
                if observed is None or not self._breached(
                    observed, rule.op, rule.threshold
                ):
                    continue
                fire_key = (rule.name, name)
                last = self._last_fire.get(fire_key)
                if last is not None and now - last < self.cooldown_s:
                    continue
                self._last_fire[fire_key] = now
                event = self._emit(rule, name, observed, snapshot)
                fired.append(event)
        return fired

    # -- breach emission --------------------------------------------------

    def _emit(
        self, rule: SLORule, metric: str, observed: float,
        snapshot: Dict[str, dict],
    ) -> dict:
        fl = flight_lib.get()
        spans = fl.snapshot_spans() if fl is not None else []
        event = {
            "kind": "incident",
            "rule": rule.name,
            "metric": metric,
            "stat": rule.stat,
            "op": rule.op,
            "observed": float(observed),
            "threshold": float(rule.threshold),
            "ts": timing.wall(),
            "flight_spans": len(spans),
            "metrics": snapshot,
        }
        metrics_lib.inc("slo.breaches")
        metrics_lib.inc(f"slo.breach.{rule.name}")
        event["incident_path"] = self._dump(event, spans)
        self.breaches.append(event)
        with _LOCK:
            # the /snapshot copy drops the bulky registry dump — the
            # incident file keeps the full record
            _RECENT.append({
                k: v for k, v in event.items() if k != "metrics"
            })
        return event

    def _dump(self, event: dict, spans: List[dict]) -> Optional[str]:
        global _INCIDENT_SEQ
        if self.incident_dir is None:
            return None
        os.makedirs(self.incident_dir, exist_ok=True)
        with _LOCK:
            _INCIDENT_SEQ += 1
            seq = _INCIDENT_SEQ
        path = os.path.join(
            self.incident_dir,
            f"incident_{int(event['ts'] * 1e3)}_{seq:04d}_"
            f"{event['rule']}.jsonl",
        )
        try:
            with open(path, "w") as f:
                f.write(json.dumps(event, default=str) + "\n")
                for span in spans:
                    f.write(json.dumps(span, default=str) + "\n")
        except OSError:
            # incident persistence is best-effort: a full disk must not
            # take the serving loop down with it
            return None
        return path


def validate_incident(path: str) -> Tuple[dict, int]:
    """Validate an incident file: header line against
    :data:`INCIDENT_HEADER_SCHEMA` (including that ``flight_spans``
    equals the span-line count), every span line against the trace
    JSONL schema. Returns ``(header, span_count)``; raises ValueError.
    """
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty incident file")
    header = json.loads(lines[0])
    for key, typ in INCIDENT_HEADER_SCHEMA.items():
        if key not in header:
            raise ValueError(f"{path}: header missing {key!r}")
        if not isinstance(header[key], typ):
            raise ValueError(
                f"{path}: header {key!r} is "
                f"{type(header[key]).__name__}"
            )
    if header["kind"] != "incident":
        raise ValueError(f"{path}: header kind {header['kind']!r}")
    span_count = 0
    for lineno, line in enumerate(lines[1:], 2):
        rec = json.loads(line)
        for key, typ in trace_lib.JSONL_SCHEMA.items():
            if key not in rec:
                raise ValueError(
                    f"{path}:{lineno}: span missing {key!r}"
                )
            val = rec[key]
            if typ is float and isinstance(val, int):
                continue
            if not isinstance(val, typ):
                raise ValueError(
                    f"{path}:{lineno}: span {key!r} is "
                    f"{type(val).__name__}"
                )
        span_count += 1
    if header["flight_spans"] != span_count:
        raise ValueError(
            f"{path}: header claims {header['flight_spans']} spans, "
            f"file holds {span_count}"
        )
    return header, span_count
