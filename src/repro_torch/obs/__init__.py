"""repro_torch.obs — the port's tracing/metrics layer.

The port's own copy of ``repro.obs`` (pure Python, no JAX; the port
imports nothing of ``repro``): the same span names, metric names, JSONL
schema, histogram buckets and report JSON, so traces, dashboards, SLO
rules and stored EXPLAIN ANALYZE reports carry over between the
packages. Its registry and recorder are its own: a process that loads
both packages (the parity tests) keeps two of each. Every clock goes
through ``repro_torch.timing``.

* **Span tracer** (``obs.span("compile")``, ``obs.span("epoch",
  index=i)``) — a process-global recorder with JSONL and Chrome-trace
  export; disabled (the default) it returns a shared null context
  manager. See :mod:`repro_torch.obs.trace`. A span is host time: on the
  card, the spans that cover device work close after the sync the
  executor, the serving pump and the sharded driver already make.
* **Metrics registry** (``obs.metrics``) — counters, gauges and
  fixed-log-bucket latency histograms with p50/p99, always on. The
  built-in callback gauge ``core.retraces`` keeps the reference's name
  and reads ``repro_torch.core.tracecount.GLOBAL["traces"]``: in the
  port it counts built epoch callables (PyTorch traces nothing).
* **Drift detection** (``Engine.explain_analyze(query)``) — the chosen
  plan run under the tracer, predicted-vs-measured cost per composed
  axis, persisted next to the plan in ``PlanStore``. See
  :mod:`repro_torch.obs.drift`.

The operational tier: Prometheus and JSON exposition
(:mod:`repro_torch.obs.export`, served by
:mod:`repro_torch.launch.obs_server`), the always-on flight ring
(:mod:`repro_torch.obs.flight`), SLO monitors with incident files
(:mod:`repro_torch.obs.slo`) and critical-path attribution
(:mod:`repro_torch.obs.attribution`).

Typical use::

    from repro_torch import obs

    with obs.tracing() as rec:
        engine.run(query)
    rec.export_jsonl("trace.jsonl")
    print(obs.metrics.snapshot("engine."))
"""

from repro_torch.obs import (  # noqa: F401
    attribution,
    drift,
    export,
    flight,
    metrics,
    slo,
    trace,
)
from repro_torch.obs.attribution import PhaseReport  # noqa: F401
from repro_torch.obs.drift import AxisCost, DriftReport  # noqa: F401
from repro_torch.obs.flight import FlightRecorder  # noqa: F401
from repro_torch.obs.slo import SLOMonitor, SLORule  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    NULL_SPAN,
    Recorder,
    disable,
    enable,
    enabled,
    get_recorder,
    span,
    tracing,
)


def _install_sources() -> None:
    """Register the process-wide callback-gauge sources (re-run after a
    registry reset): the build tally under the reference's name
    ``core.retraces``, so dashboards and SLO rules carry over; in the
    port it counts built epoch callables."""
    from repro_torch.core import tracecount

    metrics.gauge("core.retraces", fn=lambda: tracecount.GLOBAL["traces"])


def reset_metrics() -> None:
    """Clear every metric, then re-register the built-in sources. The
    test fixtures use this so aggregates cannot leak between tests."""
    metrics.REGISTRY.reset()
    _install_sources()


def reset_operational() -> None:
    """Tear down the operational tier's process-global state (the test
    fixtures' other half): tracer off, flight ring uninstalled, recent
    SLO breaches cleared, and the obs HTTP server stopped if its module
    was ever imported (checked via ``sys.modules`` so tests that never
    start a server don't pay the import)."""
    import sys

    disable()
    flight.disable()
    slo.clear_breaches()
    server_mod = sys.modules.get("repro_torch.launch.obs_server")
    if server_mod is not None:
        server_mod.stop()


_install_sources()
