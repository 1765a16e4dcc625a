"""The metrics registry: counters, gauges, and log-bucketed histograms
(the port's copy of ``repro.obs.metrics``: its own ``REGISTRY``, so a
process that loads both packages keeps two registries, and a port run
touches only this one).

Metrics are always on (unlike the span tracer): they are in-process
aggregates whose per-observation cost is one bisect + two adds — noise
next to an epoch of folds — and the serving front-end's p50/p99 surface
must exist without anyone remembering to enable it. The registry is
process-global (one ``REGISTRY``), mirroring the compiled-plan cache's
"shared by construction" design.

Instrument types:

* :class:`Counter` — monotone event counts (queries shed, lanes fused,
  probe runs).
* :class:`Gauge` — last-set values, or *callback* gauges that read a
  live source at snapshot time (the process-wide build tally from
  ``repro_torch.core.tracecount``, the serving queue's depth).
* :class:`Histogram` — latency distributions over **fixed log-spaced
  buckets** (4 per decade, 1 µs .. 100 s), with p50/p99 estimated by
  geometric interpolation inside the bucket. Fixed buckets mean two
  processes' histograms are mergeable and a snapshot is a few ints —
  no reservoir, no per-sample storage.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Callable, Dict, Optional

# Fixed log-spaced latency buckets: 4 per decade from 1 µs to 100 s.
# Upper bounds in seconds; observations above the last bound land in a
# final overflow bucket.
_BUCKETS_PER_DECADE = 4
_FIRST_EXP = -6  # 1e-6 s
_LAST_EXP = 2  # 1e2 s
BUCKET_BOUNDS = tuple(
    10.0 ** (_FIRST_EXP + i / _BUCKETS_PER_DECADE)
    for i in range((_LAST_EXP - _FIRST_EXP) * _BUCKETS_PER_DECADE + 1)
)


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-set value, or a callback read at snapshot time."""

    __slots__ = ("_value", "fn")

    def __init__(self, fn: Optional[Callable[[], Any]] = None):
        self._value: Any = None
        self.fn = fn

    def set(self, value) -> None:
        self._value = value

    def read(self):
        return self.fn() if self.fn is not None else self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.read()}


class Histogram:
    """Fixed-log-bucket latency histogram with quantile estimates."""

    __slots__ = ("counts", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(BUCKET_BOUNDS, value)] += 1
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value

    def quantile(self, q: float) -> float:
        """Bucket-walk quantile: geometric interpolation inside the
        containing bucket, clamped to the observed min/max so a
        single-sample histogram reports the sample, not a bucket edge."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                lo = BUCKET_BOUNDS[i - 1] if i > 0 else BUCKET_BOUNDS[0] / 10
                hi = (
                    BUCKET_BOUNDS[i]
                    if i < len(BUCKET_BOUNDS)
                    else self.vmax
                )
                frac = (target - (seen - c)) / c
                est = lo * (max(hi, lo) / lo) ** frac if lo > 0 else hi
                return min(max(est, self.vmin), self.vmax)
        return self.vmax

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def mean(self) -> float:
        """Exact mean off the tracked sum — never bucket-midpoint
        interpolation (quantiles interpolate; the mean must not)."""
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        # Additive keys only: "sum" (the exact tracked sum, Prometheus
        # naming), "bucket_bounds"/"bucket_counts" (per-bucket raw counts,
        # last entry = overflow past the final bound) feed the /metrics
        # exposition; everything the pre-exposition schema had is kept.
        return {
            "type": "histogram",
            "count": self.count,
            "total": self.total,
            "sum": self.total,
            "mean": self.mean,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "p50": self.p50,
            "p99": self.p99,
            "bucket_bounds": list(BUCKET_BOUNDS),
            "bucket_counts": list(self.counts),
        }


class Registry:
    """Name -> instrument, create-on-first-use, type-checked."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(**kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    f"not a {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str, fn: Optional[Callable] = None) -> Gauge:
        g = self._get(name, Gauge)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # -- one-line instrumentation hooks -----------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, value) -> None:
        self.gauge(name).set(value)

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    # -- read side ---------------------------------------------------------

    def snapshot(self, prefix: str = "") -> Dict[str, dict]:
        """{name: instrument.snapshot()} for every metric matching the
        prefix. Callback gauges are read live."""
        with self._lock:
            items = [
                (k, v) for k, v in self._metrics.items()
                if k.startswith(prefix)
            ]
        return {k: v.snapshot() for k, v in items}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


REGISTRY = Registry()

# module-level conveniences: the instrumentation call sites read as
# obs.metrics.observe("engine.epoch_s", dt)
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
inc = REGISTRY.inc
set_gauge = REGISTRY.set
observe = REGISTRY.observe
snapshot = REGISTRY.snapshot
