"""The flight recorder: a bounded always-on span ring (the port's copy of
``repro.obs.flight``).

Full tracing (:mod:`repro_torch.obs.trace`) is off by default because an
unbounded recorder cannot be left on a serving loop. The flight
recorder is the production counterpart: a fixed-size deque of completed
span records that IS cheap enough to leave on — per span it pays one
``Span`` allocation, two ``timing.now`` reads and a lock-guarded
deque append (the ``maxlen`` bound makes eviction free), so the last N
spans of engine/serve activity are always dumpable *after* something
went wrong, without anyone having enabled tracing *before*.

Cost discipline mirrors the disabled tracer's:
``recording_span_cost()`` measures the per-span price the same way
``trace.disabled_span_cost()`` prices the no-op path; ``chip_smoke.py``
phase 3f prints both beside an epoch's wall with tracing off, with the
ring only and with full tracing on the card.

Typical use::

    from repro_torch.obs import flight

    flight.enable(capacity=256)        # ServingEngine does this for you
    ...serve traffic...
    flight.dump_jsonl("last_spans.jsonl")   # post-hoc: the last N spans

The SLO monitor (:mod:`repro_torch.obs.slo`) dumps this ring into every
incident file, which is what makes a p99 breach debuggable after the
fact.
"""

from __future__ import annotations

import collections
from typing import List, Optional

from repro_torch import timing
from repro_torch.obs import trace

DEFAULT_CAPACITY = 256


class FlightRecorder(trace.Recorder):
    """A :class:`trace.Recorder` whose span store is a bounded ring.

    Inherits the parent-stack/id machinery (flight spans still nest and
    carry parents) and the JSONL/Chrome exports; only retention differs:
    ``maxlen`` evicts the oldest record on append, so memory is fixed at
    ``capacity`` span dicts no matter how long the server runs."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        super().__init__()
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.spans = collections.deque(maxlen=capacity)

    def push(self, record: dict) -> None:
        """Mirror an already-closed span record into the ring (used by
        the full tracer so the window stays continuous while tracing)."""
        with self._lock:
            self.spans.append(record)

    def snapshot_spans(self) -> List[dict]:
        """A consistent copy of the ring, oldest first."""
        with self._lock:
            return list(self.spans)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()


# ---------------------------------------------------------------------------
# module state: the installed ring
# ---------------------------------------------------------------------------

_FLIGHT: Optional[FlightRecorder] = None


def enable(capacity: int = DEFAULT_CAPACITY) -> FlightRecorder:
    """Install the flight ring (idempotent: an already-installed ring is
    kept unless the requested capacity differs, which swaps in a fresh
    one — capacity is the ring's identity, not a mutable knob)."""
    global _FLIGHT
    if _FLIGHT is None or _FLIGHT.capacity != capacity:
        _FLIGHT = FlightRecorder(capacity)
        trace._install_flight(_FLIGHT)
    return _FLIGHT


def disable() -> Optional[FlightRecorder]:
    """Uninstall the ring; returns it (spans stay readable)."""
    global _FLIGHT
    fl = _FLIGHT
    _FLIGHT = None
    trace._install_flight(None)
    return fl


def get() -> Optional[FlightRecorder]:
    """The installed ring, or None when the flight recorder is off."""
    return _FLIGHT


def enabled() -> bool:
    return _FLIGHT is not None


def dump_jsonl(path: str) -> int:
    """Write the ring's spans (oldest first) as schema-valid JSONL.
    Returns the span count; 0 (and an empty file) when disabled."""
    fl = _FLIGHT
    if fl is None:
        open(path, "w").close()
        return 0
    return fl.export_jsonl(path)


def recording_span_cost(iters: int = 20_000) -> float:
    """Measured per-call cost (seconds) of ``span()`` while the flight
    recorder is on and full tracing is off — times the spans a warm run
    emits, the ring's cost on that run. Raises unless exactly that path
    is live."""
    if trace.enabled():
        raise RuntimeError("recording_span_cost measures the tracing-OFF path")
    if _FLIGHT is None:
        raise RuntimeError("recording_span_cost needs the flight ring on")
    t0 = timing.now()
    for _ in range(iters):
        with trace.span("flight_overhead_probe"):
            pass
    return (timing.now() - t0) / iters
