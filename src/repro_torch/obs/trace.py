"""The span tracer: structured wall-clock spans with near-zero cost off
(the port's copy of ``repro.obs.trace``, clocked through
``repro_torch.timing.now``).

A span is host time. PyTorch returns before the card finishes, so a span
that should cover device work closes after a sync the caller already
makes (the executor's epoch sync, the serving pump's phase syncs, the
sharded driver's block sync); no span syncs or reads a device tensor.

Design constraints, in order:

1. **The disabled path is a no-op.** ``span()`` is called on the warm
   serving path (per epoch, per batch); when tracing is off it must cost
   one module-global check and return a shared null context manager —
   no allocation beyond the kwargs dict, no branching downstream.
   ``disabled_span_cost`` prices it (``chip_smoke.py`` phase 3f prints
   it beside the epoch walls on the card).
2. **One process-global recorder.** Every subsystem (executor, serving
   front-end, sharded driver, probes, program compiler) traces into the
   same recorder, so one export shows where a query's time actually
   went across layers.
3. **Boring, greppable output.** JSONL (one span per line, fixed
   schema) for machines; Chrome-trace JSON (``chrome://tracing`` /
   Perfetto) for eyeballs.

Typical use::

    from repro_torch import obs

    with obs.tracing() as rec:
        engine.run(query)
    rec.export_jsonl("trace.jsonl")
    rec.export_chrome_trace("trace.json")

Span schema (each JSONL line)::

    {"name": str, "id": int, "parent": int | null,
     "ts": float seconds since recorder start, "dur": float seconds,
     "tid": int, "attrs": {str: json}}
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Any, Dict, List, Optional

from repro_torch import timing

# The fixed JSONL schema the smoke test validates: key -> required type.
JSONL_SCHEMA = {
    "name": str,
    "id": int,
    "parent": (int, type(None)),
    "ts": float,
    "dur": float,
    "tid": int,
    "attrs": dict,
}


class Span:
    """One live span (context manager). ``set(**attrs)`` attaches
    attributes at any point before exit."""

    __slots__ = ("_rec", "name", "attrs", "id", "parent", "ts", "_t0")

    def __init__(self, rec: "Recorder", name: str, attrs: Dict[str, Any]):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self.id = -1
        self.parent: Optional[int] = None
        self.ts = 0.0
        self._t0 = 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._rec._open(self)
        self._t0 = timing.now()
        return self

    def __exit__(self, *exc) -> bool:
        dur = timing.now() - self._t0
        self._rec._close(self, dur)
        return False


class _NullSpan:
    """The disabled path: one shared, stateless context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Recorder:
    """Process-global span sink. Finished spans are plain dicts (the
    JSONL schema above); thread-safe (the parent stack is thread-local,
    the finished list is lock-guarded)."""

    def __init__(self):
        self.spans: List[dict] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._next_id = 0
        self.epoch = timing.now()

    # -- span lifecycle (called by Span) ----------------------------------

    def _stack(self) -> List[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _open(self, span: Span) -> None:
        with self._lock:
            span.id = self._next_id
            self._next_id += 1
        stack = self._stack()
        span.parent = stack[-1] if stack else None
        stack.append(span.id)
        span.ts = timing.now() - self.epoch

    def _close(self, span: Span, dur: float) -> None:
        stack = self._stack()
        if stack and stack[-1] == span.id:
            stack.pop()
        record = {
            "name": span.name,
            "id": span.id,
            "parent": span.parent,
            "ts": span.ts,
            "dur": dur,
            "tid": threading.get_ident() & 0xFFFF,
            "attrs": span.attrs,
        }
        with self._lock:
            self.spans.append(record)
        # mirror into the always-on flight ring (when installed) so the
        # last-N window stays continuous across tracing on/off
        fl = _FLIGHT
        if fl is not None and fl is not self:
            fl.push(record)

    # -- queries ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.spans)

    def find(self, name: str) -> List[dict]:
        """All finished spans with this name, in completion order."""
        return [s for s in self.spans if s["name"] == name]

    def total(self, name: str) -> float:
        """Summed duration (seconds) of every span with this name."""
        return sum(s["dur"] for s in self.spans if s["name"] == name)

    # -- export -----------------------------------------------------------

    def export_jsonl(self, path: str) -> int:
        """One span per line (schema above). Returns the span count."""
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps(s, default=str) + "\n")
        return len(self.spans)

    def export_chrome_trace(self, path: str) -> int:
        """Chrome-trace ("X" complete events, microseconds) — load in
        chrome://tracing or Perfetto. Returns the event count."""
        events = [
            {
                "name": s["name"],
                "ph": "X",
                "ts": s["ts"] * 1e6,
                "dur": s["dur"] * 1e6,
                "pid": os.getpid(),
                "tid": s["tid"],
                "args": s["attrs"],
            }
            for s in self.spans
        ]
        with open(path, "w") as f:
            json.dump(
                {"traceEvents": events, "displayTimeUnit": "ms"},
                f, default=str,
            )
        return len(events)


# ---------------------------------------------------------------------------
# module state: the global on/off flag + recorder
# ---------------------------------------------------------------------------

_ENABLED = False
_RECORDER: Optional[Recorder] = None
# The flight recorder (repro_torch.obs.flight) installs itself here: a bounded
# ring that keeps recording completed spans while full tracing is OFF.
# None (the default) keeps span() the no-op the warm path relies on.
_FLIGHT = None


def span(name: str, **attrs):
    """A wall-clock span context manager. THE tracing entry point —
    with tracing disabled and no flight recorder installed this is two
    module-global checks returning the shared null span (the no-op
    closure the warm path relies on); with the flight recorder on, the
    span records into its bounded ring instead (priced by
    ``flight.recording_span_cost``)."""
    if _ENABLED:
        return Span(_RECORDER, name, attrs)
    if _FLIGHT is not None:
        return Span(_FLIGHT, name, attrs)
    return NULL_SPAN


def _install_flight(recorder) -> None:
    """Called only by :mod:`repro_torch.obs.flight` (un/install the ring)."""
    global _FLIGHT
    _FLIGHT = recorder


def enabled() -> bool:
    return _ENABLED


def get_recorder() -> Optional[Recorder]:
    """The live recorder, or None when tracing has never been enabled."""
    return _RECORDER


def enable(recorder: Optional[Recorder] = None) -> Recorder:
    """Turn tracing on (idempotent). A fresh :class:`Recorder` is
    installed unless one is passed or already live."""
    global _ENABLED, _RECORDER
    if recorder is not None:
        _RECORDER = recorder
    elif _RECORDER is None:
        _RECORDER = Recorder()
    _ENABLED = True
    return _RECORDER


def disable() -> Optional[Recorder]:
    """Turn tracing off; returns the recorder (spans stay readable)."""
    global _ENABLED
    _ENABLED = False
    return _RECORDER


@contextlib.contextmanager
def tracing(recorder: Optional[Recorder] = None):
    """Scoped tracing: enable (fresh recorder unless given), yield it,
    restore the previous enabled/recorder state on exit."""
    global _ENABLED, _RECORDER
    prev = (_ENABLED, _RECORDER)
    rec = enable(recorder if recorder is not None else Recorder())
    try:
        yield rec
    finally:
        _ENABLED, _RECORDER = prev


def disabled_span_cost(iters: int = 50_000) -> float:
    """Measured per-call cost (seconds) of ``span()`` while tracing is
    off — times the spans a warm run emits, the instrumentation's cost
    on that run. Raises if called with tracing enabled or the
    flight recorder installed (either would measure the wrong path;
    flight's own path is priced by ``flight.recording_span_cost``)."""
    if _ENABLED or _FLIGHT is not None:
        raise RuntimeError(
            "disabled_span_cost measures the fully-OFF path "
            "(tracing disabled, no flight recorder)"
        )
    t0 = timing.now()
    for _ in range(iters):
        with span("overhead_probe"):
            pass
    return (timing.now() - t0) / iters


def validate_jsonl(path: str) -> int:
    """Validate an exported JSONL trace against :data:`JSONL_SCHEMA`.
    Returns the line count; raises ValueError on the first bad line."""
    count = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from e
            for key, typ in JSONL_SCHEMA.items():
                if key not in rec:
                    raise ValueError(f"{path}:{lineno}: missing {key!r}")
                val = rec[key]
                # ints are valid floats in JSON
                if typ is float and isinstance(val, int):
                    continue
                if not isinstance(val, typ):
                    raise ValueError(
                        f"{path}:{lineno}: {key!r} is {type(val).__name__}, "
                        f"wanted {typ}"
                    )
            if rec["dur"] < 0 or rec["ts"] < 0:
                raise ValueError(f"{path}:{lineno}: negative ts/dur")
            count += 1
    return count
