"""Registry exposition: Prometheus text format + the JSON snapshot (the
port's copy of ``repro.obs.export``, over the port's registry).

``render_prometheus()`` turns the metrics registry into the Prometheus
text exposition format (version 0.0.4) — the lingua franca every scrape
stack (Prometheus, VictoriaMetrics, Grafana Agent, a curl in a shell)
already speaks, which is what makes the serving loop watchable without
inventing a dashboard protocol:

* ``Counter``   -> ``# TYPE <name>_total counter`` + one sample.
* ``Gauge``     -> ``# TYPE <name> gauge`` (callback gauges are read
  live; non-numeric gauges are skipped here but kept in the JSON
  snapshot, which carries arbitrary values).
* ``Histogram`` -> the full cumulative ``_bucket{le="..."}`` series off
  the fixed log-spaced bounds, plus ``_sum`` (the exact tracked sum)
  and ``_count`` — two processes' exports are mergeable because every
  histogram shares :data:`repro_torch.obs.metrics.BUCKET_BOUNDS`.

Metric names are sanitized (dots -> underscores) since the registry's
dotted namespace (``serve.latency_s.logreg``) is not a valid Prometheus
metric name. ``parse_prometheus`` is the minimal inverse used by the
tests and the obs smoke to prove the output actually parses.

``snapshot_payload()`` builds the ``/snapshot`` JSON: the raw registry
snapshot plus the operational state that is not a metric — flight-ring
status, recent SLO breaches, and the critical-path attribution of the
flight ring's spans (:mod:`repro_torch.obs.attribution`).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

from repro_torch import timing
from repro_torch.obs import metrics as metrics_lib

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})?\s+(\S+)$"
)


def sanitize(name: str) -> str:
    """Registry name -> valid Prometheus metric name."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not _NAME_OK.match(out):
        out = "_" + out
    return out


def _fmt(value: float) -> str:
    """Prometheus sample value: ``+Inf``/``-Inf``/``NaN`` literals, and
    ``repr`` otherwise (full float precision, parses back exactly)."""
    if isinstance(value, bool):
        return "1" if value else "0"
    value = float(value)
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return repr(value)


def _le(bound: float) -> str:
    """Bucket boundary label: short general format (stable, readable)."""
    return f"{bound:g}"


def render_prometheus(
    snapshot: Optional[Dict[str, dict]] = None, *, prefix: str = ""
) -> str:
    """The registry (or a pre-taken ``Registry.snapshot()``) in
    Prometheus text exposition format, names sorted for diffability."""
    if snapshot is None:
        snapshot = metrics_lib.REGISTRY.snapshot(prefix)
    lines = []
    for name in sorted(snapshot):
        snap = snapshot[name]
        kind = snap.get("type")
        pname = sanitize(name)
        if kind == "counter":
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {_fmt(snap['value'])}")
        elif kind == "gauge":
            value = snap.get("value")
            if isinstance(value, bool) or isinstance(value, (int, float)):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_fmt(value)}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            bounds = snap["bucket_bounds"]
            counts = snap["bucket_counts"]
            cum = 0
            for bound, c in zip(bounds, counts):
                cum += c
                lines.append(
                    f'{pname}_bucket{{le="{_le(bound)}"}} {cum}'
                )
            # the overflow bucket: everything past the last bound
            lines.append(f'{pname}_bucket{{le="+Inf"}} {snap["count"]}')
            lines.append(f"{pname}_sum {_fmt(snap['sum'])}")
            lines.append(f"{pname}_count {snap['count']}")
    return "\n".join(lines) + "\n"


def parse_prometheus(
    text: str,
) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Minimal exposition-format parser (the test oracle): comment and
    blank lines are skipped, every sample line must match
    ``name{labels} value`` and parse to a float. Returns
    ``{(metric_name, sorted_label_items): value}``; raises ValueError on
    the first malformed line."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: not a sample: {line!r}")
        name, labels_raw, value_raw = m.groups()
        labels = []
        for part in filter(None, (labels_raw or "").split(",")):
            k, _, v = part.partition("=")
            if not v.startswith('"') or not v.endswith('"'):
                raise ValueError(f"line {lineno}: bad label {part!r}")
            labels.append((k.strip(), v[1:-1]))
        try:
            value = float(value_raw)
        except ValueError as e:
            raise ValueError(
                f"line {lineno}: bad value {value_raw!r}"
            ) from e
        out[(name, tuple(sorted(labels)))] = value
    return out


def snapshot_payload() -> dict:
    """The ``/snapshot`` endpoint's JSON: metrics + operational state."""
    from repro_torch.obs import attribution, flight, slo

    fl = flight.get()
    spans = fl.snapshot_spans() if fl is not None else []
    attr = attribution.attribute(spans) if spans else None
    return {
        "ts": timing.wall(),
        "metrics": metrics_lib.REGISTRY.snapshot(),
        "flight": {
            "enabled": fl is not None,
            "capacity": fl.capacity if fl is not None else 0,
            "spans": len(spans),
        },
        "slo": {"recent_breaches": list(slo.recent_breaches())},
        "attribution": attr.to_dict() if attr is not None else None,
    }
