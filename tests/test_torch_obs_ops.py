"""The port's obs operational tier against repro.obs's, on the CPU:
Prometheus exposition and the obs HTTP server, the always-on flight
recorder, SLO monitors with incident dumps, critical-path attribution,
and the isolation fixture that keeps that process-global state from
leaking between tests.

The port's counterparts of tests/test_obs_ops.py, plus parity cases: the
same registry contents render the reference's Prometheus text, the same
span lists give its critical path and PhaseReport, and a port incident
file passes the reference's ``validate_incident``. The serving cases run
the port on the CPU at 2,048 x 16."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_obs import torch_obs_isolation  # noqa: F401  (autouse)
from repro.obs import attribution as ref_attribution, export as ref_export
from repro.obs import metrics as ref_metrics, slo as ref_slo
from repro_torch import engine, obs
from repro_torch.data import synthetic
from repro_torch.engine import serve
from repro_torch.launch import obs_server
from repro_torch.obs import attribution, export, flight, metrics, slo, trace

torch.set_num_threads(1)

ROWS, DIM = 2_048, 16


def _data(n=ROWS, d=DIM, seed=0):
    return synthetic.dense_classification(torch.Generator().manual_seed(seed), n, d)


def _q(data, seed=0, **kw):
    kw.setdefault("epochs", 2)
    kw.setdefault("tolerance", 0.0)
    kw.setdefault("hints", {"ordering": "shuffle_once", "scheme": "serial"})
    return engine.AnalyticsQuery(task="logreg", data=data, task_args={"dim": DIM}, seed=seed, **kw)


def _server(**kw):
    return serve.ServingEngine(serve.ServeConfig(**kw), engine=engine.Engine(device="cpu"))


def _get(url: str) -> bytes:
    return urllib.request.urlopen(url, timeout=10).read()


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------


def test_prometheus_render_counter_gauge_histogram():
    obs.metrics.inc("t.requests", 3)
    obs.metrics.set_gauge("t.depth", 7)
    obs.metrics.gauge("t.live", fn=lambda: 1.5)
    for v in (1e-4, 2e-4, 0.5):
        obs.metrics.observe("t.lat", v)
    text = export.render_prometheus(prefix="t.")
    parsed = export.parse_prometheus(text)
    assert parsed[("t_requests_total", ())] == 3
    assert parsed[("t_depth", ())] == 7
    assert parsed[("t_live", ())] == 1.5
    assert parsed[("t_lat_count", ())] == 3
    assert parsed[("t_lat_sum", ())] == pytest.approx(1e-4 + 2e-4 + 0.5)
    assert parsed[("t_lat_bucket", (("le", "+Inf"),))] == 3
    buckets = sorted(
        (float(labels[0][1]) if labels[0][1] != "+Inf" else float("inf"), v)
        for (name, labels), v in parsed.items()
        if name == "t_lat_bucket"
    )
    assert len(buckets) == len(metrics.BUCKET_BOUNDS) + 1
    counts = [c for _, c in buckets]
    assert counts == sorted(counts) and counts[-1] == 3
    le_1ms = next(c for b, c in buckets if b >= 1e-3)
    assert le_1ms == 2


def test_prometheus_text_equals_the_references():
    """The same registry contents render to the reference's text, and
    each package's parser reads the other's output."""
    ours, theirs = metrics.Registry(), ref_metrics.Registry()
    r = np.random.default_rng(1)
    for reg in (ours, theirs):
        reg.inc("serve.accepted", 24)
        reg.inc("serve.fused_lanes", 16)
        reg.set("engine.drift_ratio", 1.25)
        reg.set("engine.calibration_stale", 0.0)
        reg.set("t.label", "not-a-number")
        reg.set("t.inf", float("inf"))
    for v in 10.0 ** r.uniform(-5, 1, size=200):
        ours.observe("serve.latency_s.logreg", float(v))
        theirs.observe("serve.latency_s.logreg", float(v))
    text = export.render_prometheus(ours.snapshot())
    assert text == ref_export.render_prometheus(theirs.snapshot())
    assert export.parse_prometheus(text) == ref_export.parse_prometheus(text)


def test_prometheus_skips_non_numeric_gauges_keeps_them_in_json():
    obs.metrics.set_gauge("t.label", "not-a-number")
    obs.metrics.set_gauge("t.num", 2)
    parsed = export.parse_prometheus(export.render_prometheus(prefix="t."))
    assert ("t_label", ()) not in parsed
    assert parsed[("t_num", ())] == 2
    payload = export.snapshot_payload()
    assert payload["metrics"]["t.label"]["value"] == "not-a-number"


def test_prometheus_name_sanitization_and_inf():
    assert export.sanitize("serve.latency_s.logreg") == "serve_latency_s_logreg"
    assert export.sanitize("0weird name") == "_0weird_name"
    obs.metrics.set_gauge("t.inf", float("inf"))
    text = export.render_prometheus(prefix="t.")
    assert "t_inf +Inf" in text
    assert export.parse_prometheus(text)[("t_inf", ())] == float("inf")


def test_parse_prometheus_rejects_garbage():
    with pytest.raises(ValueError, match="not a sample"):
        export.parse_prometheus("this is not exposition format")


def test_histogram_snapshot_exposes_buckets_and_exact_sum():
    h = metrics.Histogram()
    h.observe(1.1e-3)
    h.observe(1.3e-3)
    snap = h.snapshot()
    assert snap["sum"] == 1.1e-3 + 1.3e-3
    assert snap["mean"] == (1.1e-3 + 1.3e-3) / 2
    assert snap["bucket_bounds"] == list(metrics.BUCKET_BOUNDS)
    assert len(snap["bucket_counts"]) == len(metrics.BUCKET_BOUNDS) + 1
    assert sum(snap["bucket_counts"]) == 2
    for key in ("count", "total", "mean", "min", "max", "p50", "p99"):
        assert key in snap


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_flight_records_while_tracing_is_off():
    assert not obs.enabled()
    fl = flight.enable(capacity=8)
    with obs.span("flight.outer", tag=1):
        with obs.span("flight.inner"):
            pass
    spans = fl.snapshot_spans()
    assert [s["name"] for s in spans] == ["flight.inner", "flight.outer"]
    assert spans[0]["parent"] == spans[1]["id"]
    assert obs.get_recorder() is None or len(obs.get_recorder()) == 0


def test_flight_ring_is_bounded():
    fl = flight.enable(capacity=4)
    for i in range(10):
        with obs.span("ring", i=i):
            pass
    spans = fl.snapshot_spans()
    assert len(spans) == 4
    assert [s["attrs"]["i"] for s in spans] == [6, 7, 8, 9]


def test_flight_mirrors_full_tracing():
    fl = flight.enable(capacity=8)
    with obs.tracing() as rec:
        with obs.span("both"):
            pass
    assert len(rec.find("both")) == 1
    assert [s["name"] for s in fl.snapshot_spans()] == ["both"]
    assert fl.snapshot_spans()[0] is rec.spans[0]


def test_flight_dump_is_schema_valid_jsonl(tmp_path):
    flight.enable(capacity=8)
    engine.Engine(device="cpu").run(_q(_data(256), hints={}))
    path = tmp_path / "flight.jsonl"
    n = flight.dump_jsonl(str(path))
    assert 0 < n <= 8
    assert trace.validate_jsonl(str(path)) == n
    flight.disable()
    assert flight.dump_jsonl(str(path)) == 0


def test_flight_enable_is_idempotent_and_capacity_swaps():
    a = flight.enable(capacity=8)
    assert flight.enable(capacity=8) is a
    b = flight.enable(capacity=16)
    assert b is not a and flight.get() is b


def test_span_cost_probes_guard_their_paths():
    flight.enable()
    with pytest.raises(RuntimeError):
        trace.disabled_span_cost(iters=10)
    cost = flight.recording_span_cost(iters=500)
    assert 0 < cost < 1e-3
    flight.disable()
    with pytest.raises(RuntimeError):
        flight.recording_span_cost(iters=10)
    assert trace.disabled_span_cost(iters=500) > 0


# ---------------------------------------------------------------------------
# tail-latency attribution
# ---------------------------------------------------------------------------


def _span(name, id_, parent, ts, dur, **attrs):
    return {"name": name, "id": id_, "parent": parent, "ts": ts, "dur": dur, "tid": 1, "attrs": attrs}


SPAN_LISTS = {
    "serve": [
        _span("serve.pump", 0, None, 0.0, 1.0, queue_wait_s=0.25),
        _span("serve.assemble", 1, 0, 0.0, 0.2),
        _span("serve.execute", 2, 0, 0.2, 0.7),
        _span("engine.compile", 3, 2, 0.2, 0.5),
        _span("epoch", 4, 2, 0.7, 0.1),
    ],
    "engine": [
        _span("probe.calibrate", 0, None, 0.0, 9.0),
        _span("engine.run", 1, None, 9.0, 1.0),
        _span("engine.compile", 2, 1, 9.0, 0.1),
        _span("program.build", 3, 2, 9.0, 0.05),
        _span("epoch", 4, 1, 9.1, 0.4),
        _span("engine.kernel", 5, 4, 9.1, 0.35),
        _span("engine.loss", 6, 1, 9.5, 0.2),
    ],
    "sharded": [
        _span("engine.run", 0, None, 0.0, 2.0),
        _span("shard.place", 1, 0, 0.0, 0.3),
        _span("shard.block", 2, 0, 0.3, 1.2, epochs=3, k=4),
        _span("shard.merge", 3, 2, 1.4, 0.1),
    ],
}


def test_critical_path_follows_longest_children():
    spans = SPAN_LISTS["serve"]
    path = attribution.critical_path(spans)
    assert [s["name"] for s in path] == ["serve.pump", "serve.execute", "engine.compile"]
    rep = attribution.attribute(spans)
    assert rep.root == "serve.pump"
    assert rep.total_s == pytest.approx(1.25)
    assert rep.phase_s["queue_wait"] == pytest.approx(0.25)
    assert rep.phase_s["compile"] == pytest.approx(0.5)
    assert rep.phase_s["execute"] == pytest.approx(0.2)
    assert rep.phase_s["other"] == pytest.approx(0.3)
    assert sum(rep.phase_s.values()) == pytest.approx(rep.total_s)
    assert rep.share("compile") == pytest.approx(0.4)
    text = rep.describe()
    assert "compile 40%" in text and "serve.pump" in text


@pytest.mark.parametrize("root", [None, "engine.run", "serve.pump", "shard.block", "missing"])
@pytest.mark.parametrize("case", sorted(SPAN_LISTS))
def test_attribution_equals_the_references(case, root):
    spans = SPAN_LISTS[case]
    assert attribution.critical_path(spans, root) == ref_attribution.critical_path(spans, root)
    ours, theirs = attribution.attribute(spans, root), ref_attribution.attribute(spans, root)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours.to_dict() == theirs.to_dict() and ours.describe() == theirs.describe()
    assert attribution.PHASE_OF == ref_attribution.PHASE_OF


def test_attribution_round_trips_and_handles_empty():
    assert attribution.attribute([]) is None
    rep = attribution.attribute([_span("engine.run", 0, None, 0.0, 0.5)])
    back = attribution.PhaseReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert back == rep


def test_attribution_root_name_picks_named_root():
    spans = [
        _span("probe.calibrate", 0, None, 0.0, 9.0),
        _span("engine.run", 1, None, 9.0, 1.0),
    ]
    rep = attribution.attribute(spans, root_name="engine.run")
    assert rep.root == "engine.run" and rep.total_s == pytest.approx(1.0)


def test_explain_analyze_embeds_attribution_and_sets_drift_gauges():
    rep = engine.Engine(device="cpu").explain_analyze(_q(_data(), hints={}, epochs=3))
    assert rep.attribution is not None
    phase = attribution.PhaseReport.from_dict(rep.attribution)
    assert phase.root == "engine.run"
    assert phase.total_s > 0 and phase.phase_s
    assert "critical path" in rep.describe()
    snap = obs.metrics.snapshot("engine.")
    assert snap["engine.drift_ratio"]["value"] == pytest.approx(rep.drift)
    assert snap["engine.calibration_stale"]["value"] == float(rep.stale)
    back = obs.DriftReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert back == rep


# ---------------------------------------------------------------------------
# SLO monitors
# ---------------------------------------------------------------------------


def test_slo_rule_histogram_glob_and_threshold():
    for v in (0.01, 0.02, 0.5):
        obs.metrics.observe("serve.latency_s.logreg", v)
    obs.metrics.observe("serve.latency_s.svm", 0.001)
    mon = slo.SLOMonitor(
        [slo.SLORule("latency_p99", "serve.latency_s.*", stat="p99", threshold=0.1)],
        interval_s=0.0, cooldown_s=0.0,
    )
    fired = mon.evaluate()
    assert [e["metric"] for e in fired] == ["serve.latency_s.logreg"]
    event = fired[0]
    assert event["rule"] == "latency_p99" and event["observed"] > 0.1
    assert obs.metrics.snapshot("slo.")["slo.breaches"]["value"] == 1
    assert slo.recent_breaches()[-1]["rule"] == "latency_p99"


def test_slo_rule_min_count_and_ratio():
    obs.metrics.observe("serve.latency_s.logreg", 99.0)
    obs.metrics.inc("serve.shed.queue_full", 10)
    obs.metrics.inc("serve.accepted", 100)
    mon = slo.SLOMonitor(
        [
            slo.SLORule("latency_p99", "serve.latency_s.*", stat="p99", threshold=0.1, min_count=3),
            slo.SLORule("shed_rate", "serve.shed.queue_full", per="serve.accepted", threshold=0.05),
        ],
        interval_s=0.0, cooldown_s=0.0,
    )
    fired = mon.evaluate()
    assert [e["rule"] for e in fired] == ["shed_rate"]
    assert fired[0]["observed"] == pytest.approx(0.1)


def test_slo_cooldown_suppresses_repeat_incidents():
    obs.metrics.set_gauge("serve.queue_depth", 100)
    mon = slo.SLOMonitor(
        [slo.SLORule("queue_depth", "serve.queue_depth", threshold=10)],
        interval_s=0.0, cooldown_s=3600.0,
    )
    assert len(mon.evaluate()) == 1
    assert len(mon.evaluate()) == 0
    assert len(mon.breaches) == 1


def test_slo_interval_rate_limits_evaluation():
    obs.metrics.set_gauge("serve.queue_depth", 100)
    mon = slo.SLOMonitor([slo.SLORule("queue_depth", "serve.queue_depth", threshold=10)],
                         interval_s=3600.0, cooldown_s=0.0)
    assert len(mon.maybe_evaluate()) == 1
    assert mon.maybe_evaluate() == []  # inside the interval: no pass at all


def test_slo_incident_file_contains_flight_spans_and_passes_the_references_check(tmp_path):
    flight.enable(capacity=32)
    with obs.span("incident.context"):
        pass
    obs.metrics.set_gauge("serve.queue_depth", 100)
    mon = slo.SLOMonitor(
        [slo.SLORule("queue_depth", "serve.queue_depth", threshold=10)],
        interval_s=0.0, incident_dir=str(tmp_path / "incidents"),
    )
    (event,) = mon.evaluate()
    assert event["incident_path"] is not None
    header, span_count = slo.validate_incident(event["incident_path"])
    assert ref_slo.validate_incident(event["incident_path"]) == (header, span_count)
    assert slo.INCIDENT_HEADER_SCHEMA == ref_slo.INCIDENT_HEADER_SCHEMA
    assert header["rule"] == "queue_depth"
    assert header["observed"] == 100.0 and header["threshold"] == 10.0
    assert span_count == header["flight_spans"] >= 1
    assert header["metrics"]["serve.queue_depth"]["value"] == 100
    with open(event["incident_path"]) as f:
        names = [json.loads(ln)["name"] for ln in f.read().splitlines()[1:]]
    assert "incident.context" in names


def test_validate_incident_rejects_bad_files(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text("")
    with pytest.raises(ValueError, match="empty"):
        slo.validate_incident(str(bad))
    bad.write_text('{"kind": "incident", "rule": "r"}\n')
    with pytest.raises(ValueError, match="missing"):
        slo.validate_incident(str(bad))


def test_default_serve_rules_shape():
    rules = slo.default_serve_rules(p99_latency_s=0.5)
    assert [r.name for r in rules] == ["latency_p99", "queue_depth", "shed_rate", "calibration_stale"]
    assert all(isinstance(r, slo.SLORule) for r in rules)
    for ours, theirs in zip(rules, ref_slo.default_serve_rules(p99_latency_s=0.5)):
        assert (ours.name, ours.metric, ours.stat, ours.op, ours.threshold, ours.per, ours.min_count) == (
            theirs.name, theirs.metric, theirs.stat, theirs.op, theirs.threshold, theirs.per, theirs.min_count)
    with pytest.raises(ValueError, match="bad op"):
        slo.SLORule("x", "m", op="!=")


def test_serving_engine_breach_dumps_incident_next_to_plan_store(tmp_path):
    """Tiny queue + burst -> shed -> pump's SLO cadence fires -> an
    incident JSONL (with the flight ring's spans) lands in
    <cache_dir>/incidents, beside the plan store's torch/ directory."""
    data = _data()
    srv = _server(
        max_queue=2, max_batch=4, cache_dir=str(tmp_path),
        slo_rules=(slo.SLORule("shed_rate", "serve.shed.queue_full", per="serve.accepted", threshold=0.2),),
        slo_interval_s=0.0,
    )
    assert flight.enabled()  # the serving engine turned the ring on
    tickets = [srv.submit(_q(data, seed=s)) for s in range(6)]
    assert sum(not t.accepted for t in tickets) == 4
    srv.drain()
    assert srv.slo is not None and len(srv.slo.breaches) >= 1
    event = srv.slo.breaches[0]
    assert event["rule"] == "shed_rate"
    header, span_count = slo.validate_incident(event["incident_path"])
    assert ref_slo.validate_incident(event["incident_path"])[1] == span_count >= 1
    assert str(tmp_path / "incidents") in event["incident_path"]
    assert (tmp_path / serve.STORE_DIR).is_dir()
    assert srv.metrics()["slo_breaches"] >= 1
    assert srv.metrics()["obs"]["serve.accepted"]["value"] == 2


def test_serving_engine_without_rules_or_ring(tmp_path):
    srv = _server(flight_capacity=0, incident_dir=str(tmp_path / "inc"))
    assert srv.slo is None and not flight.enabled()
    srv.submit(_q(_data(256)))
    assert srv.drain() == 1 and srv.metrics()["slo_breaches"] == 0


# ---------------------------------------------------------------------------
# obs HTTP server
# ---------------------------------------------------------------------------


def test_metrics_endpoint_parses_during_a_fused_serve_burst(tmp_path):
    server = obs_server.start(0)
    data = _data()
    srv = _server(max_batch=4, cache_dir=str(tmp_path))
    for s in range(6):
        srv.submit(_q(data, seed=s))
    srv.pump()  # one fused batch of 4 completes; 2 still queued
    mid = export.parse_prometheus(_get(server.url + "/metrics").decode())
    assert mid[("serve_queue_depth", ())] == 2
    assert mid[("serve_fused_lanes_total", ())] == 4
    assert mid[("serve_accepted_total", ())] == 6
    srv.drain()
    done = export.parse_prometheus(_get(server.url + "/metrics").decode())
    assert done[("serve_queue_depth", ())] == 0
    assert done[("serve_plan_store_entries", ())] >= 1
    assert done[("serve_latency_s_logreg_count", ())] == 6
    assert done[("serve_latency_s_logreg_bucket", (("le", "+Inf"),))] == 6
    assert done[("serve_latency_s_logreg_sum", ())] > 0
    assert done[("serve_fused_lanes_total", ())] == 6


def test_metrics_scraped_from_a_thread_while_the_pump_runs(tmp_path):
    """A scraper thread reads /metrics while a fused burst is being
    served: every scrape parses, and the counters only move forward."""
    server = obs_server.start(0)
    data = _data()
    srv = _server(max_batch=4, cache_dir=str(tmp_path))
    for s in range(8):
        srv.submit(_q(data, seed=s, hints={"ordering": "shuffle_always", "scheme": "serial",
                                            "implementation": "cuda_fused"}))
    scrapes, stop = [], threading.Event()

    def scrape():
        while not scrapes or not stop.wait(0.05):
            scrapes.append(export.parse_prometheus(_get(server.url + "/metrics").decode()))

    thread = threading.Thread(target=scrape)
    thread.start()
    try:
        srv.drain()
    finally:
        stop.set()
        thread.join(timeout=30)
    assert not thread.is_alive() and scrapes
    lanes = [s.get(("serve_fused_lanes_total", ()), 0) for s in scrapes]
    assert lanes == sorted(lanes) and all(s[("serve_accepted_total", ())] == 8 for s in scrapes)
    final = export.parse_prometheus(_get(server.url + "/metrics").decode())
    assert final[("serve_fused_lanes_total", ())] == 8
    assert final[("serve_latency_s_logreg_count", ())] == 8


def test_snapshot_and_healthz_endpoints():
    server = obs_server.start(0)
    flight.enable(capacity=16)
    with obs.span("snapshot.span"):
        pass
    assert _get(server.url + "/healthz") == b"ok\n"
    payload = json.loads(_get(server.url + "/snapshot"))
    assert payload["flight"] == {"enabled": True, "capacity": 16, "spans": 1}
    assert "core.retraces" in payload["metrics"]
    assert payload["slo"]["recent_breaches"] == []
    assert payload["attribution"]["root"] == "snapshot.span"
    with pytest.raises(urllib.error.HTTPError):
        _get(server.url + "/nope")


def test_obs_server_start_is_idempotent_and_stop_frees():
    a = obs_server.start(0)
    assert obs_server.start(0) is a
    port = a.port
    obs_server.stop()
    assert obs_server.get() is None
    b = obs_server.start(port)
    assert b.port == port
    obs_server.stop()


def test_obs_server_that_cannot_bind_raises():
    a = obs_server.start(0)
    with pytest.raises(OSError):
        obs_server.ObsServer(a.port)


def test_serve_analytics_traces_and_serves_metrics(tmp_path):
    from repro_torch.launch.serve import make_analytics_server, serve_analytics

    srv = make_analytics_server(max_batch=4, device="cpu", slo_rules=slo.default_serve_rules(),
                                cache_dir=str(tmp_path / "cache"))
    data = _data(512)
    tickets = serve_analytics([_q(data, seed=s) for s in range(3)], server=srv,
                              trace_dir=str(tmp_path / "trace"), obs_port=0)
    assert all(t.result.batch_size == 3 for t in tickets)
    n = trace.validate_jsonl(str(tmp_path / "trace" / "serve.jsonl"))
    assert n > 0 and (tmp_path / "trace" / "serve.trace.json").exists()
    assert srv.slo is not None and srv.slo.incident_dir == str(tmp_path / "cache" / "incidents")
    parsed = export.parse_prometheus(_get(obs_server.get().url + "/metrics").decode())
    assert parsed[("serve_accepted_total", ())] == 3


# ---------------------------------------------------------------------------
# fixture isolation (part one leaves every piece of operational state
# dirty mid-trace; the port's autouse fixture must restore a clean world
# before part two runs)
# ---------------------------------------------------------------------------


def test_ops_state_isolation_part_one():
    obs_server.start(0)
    flight.enable(capacity=8)
    obs.enable()
    with obs.span("leak.span"):
        obs.metrics.inc("leak.counter")
    obs.metrics.set_gauge("serve.queue_depth", 1)
    mon = slo.SLOMonitor([slo.SLORule("queue_depth", "serve.queue_depth", threshold=0)], interval_s=0.0)
    assert mon.evaluate()
    assert obs.enabled() and flight.enabled()
    assert obs_server.get() is not None


def test_ops_state_isolation_part_two():
    assert not obs.enabled(), "tracer leaked"
    assert flight.get() is None, "flight ring leaked"
    assert obs_server.get() is None, "obs server leaked"
    assert slo.recent_breaches() == (), "breach log leaked"
    assert obs.metrics.snapshot("leak.") == {}, "registry leaked"
    assert obs.metrics.snapshot("slo.") == {}, "breach counter leaked"
    assert obs.span("x") is trace.NULL_SPAN
