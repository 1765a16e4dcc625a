"""repro_torch.obs against repro.obs, on the CPU: the span tracer
(enable/disable/nesting/export + schema), the metrics registry
(counters/gauges/histograms + quantiles), the build tally's gauge,
EXPLAIN ANALYZE drift reports with their PlanStore persistence, and the
names every instrumented path emits.

The port's counterparts of tests/test_obs.py, plus parity cases: the same
observations give the reference's histogram snapshot, the same span
lists its critical path, a port trace passes the reference's schema
check, the reports load in both packages, each instrumented path emits
the reference's span and metric names, and a port run leaves the
reference's registry untouched. The engine cases run at 2,048 x 16."""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from _threefry_replay import ThreefryReplay
from _torch_obs import torch_obs_isolation  # noqa: F401  (autouse)
from repro import engine as ref_engine, obs as ref_obs
from repro.engine import probes as ref_probes, serve as ref_serve
from repro.obs import drift as ref_drift, metrics as ref_metrics, trace as ref_trace
from repro_torch import convert, engine, obs
from repro_torch.core import tracecount
from repro_torch.data import synthetic
from repro_torch.engine import serve
from repro_torch.obs import attribution, drift, metrics, trace

torch.set_num_threads(1)

ROWS, DIM = 2_048, 16


def _data(n=ROWS, d=DIM, seed=0):
    return synthetic.dense_classification(torch.Generator().manual_seed(seed), n, d)


def _q(data, dim=DIM, **kw):
    kw.setdefault("epochs", 2)
    kw.setdefault("tolerance", 0.0)
    return engine.AnalyticsQuery(task="logreg", data=data, task_args={"dim": dim}, **kw)


def _eng(**kw):
    return engine.Engine(device="cpu", **kw)


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------


def test_spans_nest_and_carry_attrs():
    with obs.tracing() as rec:
        with obs.span("outer", layer="test"):
            with obs.span("inner") as s:
                s.set(extra=1)
    assert len(rec) == 2
    inner, outer = rec.spans  # completion order: inner closes first
    assert inner["name"] == "inner" and outer["name"] == "outer"
    assert inner["parent"] == outer["id"]
    assert outer["parent"] is None
    assert outer["attrs"] == {"layer": "test"}
    assert inner["attrs"] == {"extra": 1}
    assert inner["dur"] >= 0 and inner["ts"] >= outer["ts"]


def test_tracing_restores_prior_state():
    assert not obs.enabled()
    with obs.tracing() as outer_rec:
        with obs.tracing() as inner_rec:
            assert obs.get_recorder() is inner_rec
        assert obs.enabled() and obs.get_recorder() is outer_rec
        with obs.span("after-inner"):
            pass
        assert len(outer_rec) == 1 and len(inner_rec) == 0
    assert not obs.enabled()


def test_disabled_path_records_zero_spans():
    """With tracing off, span() returns the shared null context manager
    and no recorder gains anything — including from an engine run, which
    is instrumented throughout."""
    rec = obs.enable()
    obs.disable()
    before = len(rec)
    with obs.span("not-recorded", attr=1):
        pass
    _eng().run(_q(_data(256)))
    assert len(rec) == before
    assert obs.span("x") is trace.NULL_SPAN


def test_disabled_span_cost_measures_off_path_only():
    cost = trace.disabled_span_cost(iters=2000)
    assert 0 < cost < 1e-4
    with obs.tracing():
        with pytest.raises(RuntimeError):
            trace.disabled_span_cost(iters=10)


def test_jsonl_export_validates_in_both_packages_and_chrome_trace_loads(tmp_path):
    with obs.tracing() as rec:
        with obs.span("a", task="logreg"):
            with obs.span("b"):
                pass
        _eng().run(_q(_data(256)))
    jsonl = tmp_path / "trace.jsonl"
    chrome = tmp_path / "trace.json"
    n = rec.export_jsonl(str(jsonl))
    assert n == len(rec) > 2
    assert trace.validate_jsonl(str(jsonl)) == n
    assert ref_trace.validate_jsonl(str(jsonl)) == n  # the reference's schema
    assert trace.JSONL_SCHEMA == ref_trace.JSONL_SCHEMA
    assert rec.export_chrome_trace(str(chrome)) == n
    events = json.loads(chrome.read_text())["traceEvents"]
    assert {e["ph"] for e in events} == {"X"}
    assert {"a", "b", "engine.run", "epoch"} <= {e["name"] for e in events}


def test_validate_jsonl_rejects_bad_lines(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"name": "x", "id": 0}\n')
    with pytest.raises(ValueError, match="missing"):
        trace.validate_jsonl(str(bad))
    bad.write_text(
        '{"name": "x", "id": 0, "parent": null, "ts": -1.0, "dur": 0.0, '
        '"tid": 1, "attrs": {}}\n'
    )
    with pytest.raises(ValueError, match="negative"):
        trace.validate_jsonl(str(bad))


def test_recorder_find_and_total():
    with obs.tracing() as rec:
        for _ in range(3):
            with obs.span("loop"):
                pass
    assert len(rec.find("loop")) == 3
    assert rec.total("loop") == pytest.approx(sum(s["dur"] for s in rec.spans))
    assert rec.find("missing") == [] and rec.total("missing") == 0.0


# ---------------------------------------------------------------------------
# the build tally (the port's counterpart of the retrace tally)
# ---------------------------------------------------------------------------


def test_build_tally_counts_and_restores():
    before = tracecount.GLOBAL["traces"]
    tracecount.count_build()
    assert tracecount.GLOBAL["traces"] == before + 1
    tracecount.GLOBAL["traces"] = before
    assert obs.metrics.snapshot("core.")["core.retraces"]["value"] == before


def test_build_tally_isolation_fixture_part_one():
    """Bumps the process-wide tally; the autouse fixture must restore it
    before the companion test below runs (file order, one process)."""
    global _TALLY_SEEN
    _TALLY_SEEN = tracecount.GLOBAL["traces"]
    tracecount.count_build()
    assert tracecount.GLOBAL["traces"] == _TALLY_SEEN + 1


def test_build_tally_isolation_fixture_part_two():
    assert tracecount.GLOBAL["traces"] == _TALLY_SEEN


def test_builds_surface_as_the_retraces_metric():
    """``core.retraces`` keeps the reference's name; in the port it reads
    the build tally, which a cold engine run bumps."""
    before = obs.metrics.snapshot("core.")["core.retraces"]["value"]
    _eng().run(_q(_data(256)))
    after = obs.metrics.snapshot("core.")["core.retraces"]["value"]
    assert after == tracecount.GLOBAL["traces"] > before


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_counter_gauge_and_callback_gauge():
    obs.metrics.inc("t.count")
    obs.metrics.inc("t.count", 4)
    obs.metrics.set_gauge("t.gauge", 7)
    obs.metrics.gauge("t.live", fn=lambda: 42)
    snap = obs.metrics.snapshot("t.")
    assert snap["t.count"] == {"type": "counter", "value": 5}
    assert snap["t.gauge"]["value"] == 7
    assert snap["t.live"]["value"] == 42


def test_metric_type_conflicts_raise():
    obs.metrics.inc("t.name")
    with pytest.raises(TypeError, match="Counter"):
        obs.metrics.observe("t.name", 1.0)


def test_histogram_quantiles_and_stats():
    h = metrics.Histogram()
    for v in [1e-3] * 98 + [0.5, 1.0]:
        h.observe(v)
    assert h.count == 100
    assert h.mean == pytest.approx((0.098 + 1.5) / 100)
    assert h.vmin == 1e-3 and h.vmax == 1.0
    assert h.p50 == pytest.approx(1e-3, rel=0.8)
    assert h.p99 >= 0.5
    assert h.quantile(1.0) == 1.0
    empty = metrics.Histogram()
    assert empty.p50 == 0.0 and empty.mean == 0.0
    single = metrics.Histogram()
    single.observe(3e-4)
    assert single.p50 == 3e-4 and single.p99 == 3e-4


@pytest.mark.parametrize("case", ["spread", "one_bucket", "single", "overflow", "tail", "empty"])
def test_histogram_snapshot_equals_the_references(case):
    """The same observations give the reference's snapshot exactly: the
    buckets, the exact sum and the interpolated p50/p99 dashboards and
    SLO thresholds read."""
    r = np.random.default_rng(3)
    values = {
        "spread": list(10.0 ** r.uniform(-6.5, 2.5, size=500)),
        "one_bucket": [1.1e-3, 1.3e-3, 1.2e-3],
        "single": [3e-4],
        "overflow": [150.0, 1e3, 0.5],
        "tail": [1e-3] * 98 + [0.5, 1.0],
        "empty": [],
    }[case]
    ours, theirs = metrics.Histogram(), ref_metrics.Histogram()
    for v in values:
        ours.observe(float(v))
        theirs.observe(float(v))
    assert metrics.BUCKET_BOUNDS == ref_metrics.BUCKET_BOUNDS
    assert ours.snapshot() == theirs.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)


def test_reset_metrics_reinstalls_builtin_sources():
    obs.metrics.inc("t.junk")
    obs.reset_metrics()
    assert obs.metrics.snapshot("t.") == {}
    assert "core.retraces" in obs.metrics.snapshot("core.")


def test_engine_run_feeds_epoch_histograms():
    _eng().run(_q(_data(), epochs=3, hints={"implementation": "torch_fold"}))
    snap = obs.metrics.snapshot("engine.")
    assert snap["engine.epoch.grad_s"]["count"] == 3
    assert snap["engine.epoch.shuffle_s"]["count"] == 3
    assert snap["engine.compile_s"]["count"] >= 1
    assert snap["engine.loss_s"]["count"] == 1
    assert "engine.kernel_us_per_epoch" not in snap  # an eager lane body
    _eng().run(_q(_data(), epochs=3, hints={"implementation": "cuda_fused"}))
    snap = obs.metrics.snapshot("engine.")
    assert snap["engine.kernel_us_per_epoch"]["count"] == 3
    assert snap["engine.epoch.grad_s"]["count"] == 6


def test_port_run_leaves_the_reference_registry_untouched():
    before = ref_metrics.REGISTRY.snapshot()
    with obs.tracing():
        _eng().explain_analyze(_q(_data(256)))
    srv = serve.ServingEngine(serve.ServeConfig(max_batch=4), engine=_eng())
    for s in range(3):
        srv.submit(_q(_data(256), seed=s))
    srv.drain()
    assert ref_metrics.REGISTRY.snapshot() == before
    assert ref_trace.get_recorder() is None or len(ref_trace.get_recorder()) == 0
    assert obs.metrics.snapshot("serve.")["serve.accepted"]["value"] == 3
    assert metrics.REGISTRY is not ref_metrics.REGISTRY


# ---------------------------------------------------------------------------
# every instrumented path emits the reference's names
# ---------------------------------------------------------------------------

_REF_IMPLS = {"torch_fold": "xla_fold", "cuda_fused": "pallas_fused", "cuda_minibatch": "pallas_minibatch"}

# one run of each path: (hints, stored table?, served group size)
PATHS = {
    "singleton_eager": ({"ordering": "shuffle_always", "scheme": "serial", "implementation": "torch_fold"},
                        False, 0),
    "singleton_kernel": ({"ordering": "shuffle_once", "scheme": "serial", "implementation": "cuda_fused"},
                         False, 0),
    "stored_table": ({"ordering": "shuffle_once", "scheme": "serial", "implementation": "torch_fold"},
                     True, 0),
    "sharded": ({"parallelism": "sharded", "num_shards": 2, "merge_period": 1,
                 "implementation": "torch_fold"}, False, 0),
    "served_fused": ({"ordering": "shuffle_always", "scheme": "serial", "implementation": "cuda_fused"},
                     False, 3),
    "served_sharded": ({"parallelism": "sharded", "num_shards": 2, "merge_period": 1,
                        "implementation": "torch_fold"}, False, 3),
}


def _names(spans, snapshot):
    return {s["name"] for s in spans}, set(snapshot)


def _run_port(arrays, hints, stored, served):
    table = convert.table_from_numpy(arrays, "cpu")
    if stored:
        table = engine.ChunkedTable.from_arrays(table, 64)
    eng = engine.Engine(device="cpu", draws=ThreefryReplay())
    qs = [_q(table, dim=4, seed=s, epochs=2, hints=dict(hints)) for s in range(max(served, 1))]
    with obs.tracing() as rec:
        if served:
            srv = serve.ServingEngine(serve.ServeConfig(max_batch=4), engine=eng)
            tickets = [srv.submit(q) for q in qs]
            srv.drain()
            assert all(t.result.batch_size == served for t in tickets)
        else:
            eng.run(qs[0])
    return _names(rec.spans, obs.metrics.snapshot())


def _run_ref(arrays, hints, stored, served):
    table = {k: jax.numpy.asarray(v) for k, v in arrays.items()}
    if stored:
        table = ref_engine.ChunkedTable.from_arrays(table, 64)
    hints = dict(hints, implementation=_REF_IMPLS[hints["implementation"]])
    qs = [ref_engine.AnalyticsQuery(task="logreg", data=table, task_args={"dim": 4}, seed=s, epochs=2,
                                    tolerance=0.0, hints=dict(hints)) for s in range(max(served, 1))]
    ref_probes.clear_cache()
    ref_obs.reset_metrics()
    with ref_obs.tracing() as rec:
        if served:
            srv = ref_serve.ServingEngine(ref_serve.ServeConfig(max_batch=4))
            tickets = [srv.submit(q) for q in qs]
            srv.drain()
            assert all(t.result.batch_size == served for t in tickets)
        else:
            ref_engine.Engine().run(qs[0])
    return _names(rec.spans, ref_obs.metrics.snapshot())


@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_path_emits_the_references_span_and_metric_names(path):
    """One run of each path in both packages from a cold engine: the port
    emits exactly the reference's span names and metric names (probes,
    program builds, the executor, the sharded driver, the serving front
    end)."""
    hints, stored, served = PATHS[path]
    r = np.random.default_rng(5)
    x = (r.normal(size=(128, 4)) / 2).astype(np.float32)
    arrays = {"x": x, "y": np.sign(x @ r.normal(size=4) + 0.1).astype(np.float32)}
    spans, names = _run_port(arrays, hints, stored, served)
    ref_spans, ref_names = _run_ref(arrays, hints, stored, served)
    assert spans == ref_spans
    assert names == ref_names
    want = {"singleton_eager": {"engine.run", "engine.compile", "epoch", "engine.loss", "program.build",
                                "probe.calibrate"},
            "singleton_kernel": {"engine.kernel"},
            "stored_table": {"engine.materialize"},
            "sharded": {"shard.place", "shard.block"},
            "served_fused": {"serve.pump", "serve.assemble", "serve.execute"},
            "served_sharded": {"serve.pump", "serve.assemble", "serve.execute"}}[path]
    assert want <= spans


# ---------------------------------------------------------------------------
# drift reports / EXPLAIN ANALYZE
# ---------------------------------------------------------------------------


def test_drift_ratio_noise_handling():
    assert drift.drift_ratio(0.0, 0.0) == 1.0
    assert drift.drift_ratio(0.0, 1e-6) == 1.0
    assert math.isinf(drift.drift_ratio(0.0, 0.5))
    assert drift.drift_ratio(0.1, 0.2) == pytest.approx(2.0)
    for p, m in ((0.0, 0.0), (0.0, 1e-6), (0.0, 0.5), (0.1, 0.2), (3e-5, 2e-4)):
        assert drift.drift_ratio(p, m) == ref_drift.drift_ratio(p, m)


def test_drift_report_describe_and_staleness():
    rows = (
        obs.AxisCost("ordering", 0.010, 0.012, "walls"),
        obs.AxisCost("parallelism", 0.100, 0.110, "walls"),
    )
    rep = obs.DriftReport(
        axes="ordering=clustered", plan={}, rows=rows, epochs_run=2,
        predicted_total_s=0.110, measured_total_s=0.122,
    )
    assert not rep.stale and rep.drift == pytest.approx(0.122 / 0.110)
    text = rep.describe()
    assert "EXPLAIN ANALYZE" in text and "calibration: ok" in text
    bad = obs.DriftReport(
        axes="x", plan={}, rows=rows, epochs_run=2,
        predicted_total_s=0.010, measured_total_s=0.200,
    )
    assert bad.stale and "STALE" in bad.describe()


def test_drift_report_round_trips_through_json():
    rows = (obs.AxisCost("source", 0.0, 0.0, "materialize"),)
    rep = obs.DriftReport(
        axes="a", plan={"ordering": "clustered"}, rows=rows, epochs_run=1,
        predicted_total_s=0.0, measured_total_s=0.0,
    )
    back = obs.DriftReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert back == rep


def test_drift_reports_load_in_both_packages():
    """A port report's JSON loads in repro.obs.DriftReport.from_dict and
    the reverse, with the same drift, verdict and text. The timed run's
    total is pinned to its prediction, so its verdict is "ok" on any host:
    the STALE verdict names each package's own remedy (tested below)."""
    rep = _eng().explain_analyze(_q(_data(512), epochs=2))
    rep = dataclasses.replace(rep, measured_total_s=rep.predicted_total_s)
    assert not rep.stale
    theirs = ref_obs.DriftReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert theirs.to_dict() == rep.to_dict()
    assert theirs.describe() == rep.describe()
    ref_rows = (ref_obs.AxisCost("ordering", 0.01, 0.02, "w"), ref_obs.AxisCost("source", 0.0, 0.0, "m"))
    ref_rep = ref_obs.DriftReport(axes="x", plan={"ordering": "clustered"}, rows=ref_rows, epochs_run=3,
                                  predicted_total_s=0.01, measured_total_s=0.02,
                                  attribution={"root": "engine.run", "total_s": 0.5,
                                               "phase_s": {"execute": 0.5}, "path": [["engine.run", 0.5]]})
    ours = obs.DriftReport.from_dict(json.loads(json.dumps(ref_rep.to_dict())))
    assert ours.to_dict() == ref_rep.to_dict() and ours.stale == ref_rep.stale
    assert ours.describe() == ref_rep.describe()


def test_drift_stale_verdict_names_the_ports_remedy():
    """A STALE report reads as the reference's, line for line, but for its
    remedy: the port's names a fresh ``engine.Engine()`` (the port keeps its
    calibrations on the engine; it has no ``probes.clear_cache``), and
    following it re-probes where ``Engine.clear_cache`` does not."""
    ref_rows = (ref_obs.AxisCost("ordering", 0.01, 0.15, "w"), ref_obs.AxisCost("source", 0.0, 0.05, "m"))
    ref_rep = ref_obs.DriftReport(axes="x", plan={"ordering": "clustered"}, rows=ref_rows, epochs_run=3,
                                  predicted_total_s=0.01, measured_total_s=0.2,
                                  attribution={"root": "engine.run", "total_s": 0.5,
                                               "phase_s": {"execute": 0.5}, "path": [["engine.run", 0.5]]})
    ours = obs.DriftReport.from_dict(json.loads(json.dumps(ref_rep.to_dict())))
    assert ours.stale and ref_rep.stale
    mine, theirs = ours.describe().splitlines(), ref_rep.describe().splitlines()
    assert len(mine) == len(theirs)
    cut = " — re-probe: "
    for a, b in zip(mine, theirs):
        if cut in b:
            assert a.split(cut)[0] == b.split(cut)[0] and "STALE" in a
            assert a.split(cut)[1] == drift.STALE_REMEDY != b.split(cut)[1]
        else:
            assert a == b
    assert sum(cut in line for line in mine) == 1
    # the remedy names what the port has
    assert "engine.Engine()" in drift.STALE_REMEDY and "PlanStore" in drift.STALE_REMEDY
    assert callable(engine.Engine) and callable(engine.PlanStore)
    assert not hasattr(engine.probes, "clear_cache")
    # and following it re-probes
    q = _q(_data(512), epochs=1)
    eng = _eng()
    eng.explain(q)
    assert eng.stats["probe_runs"] == 1
    eng.clear_cache()
    eng.explain(q)
    assert eng.stats["probe_runs"] == 0
    fresh = _eng()
    fresh.explain(q)
    assert fresh.stats["probe_runs"] == 1


def test_explain_analyze_reports_per_axis_drift():
    eng = _eng()
    q = _q(_data(), epochs=3)
    rep = eng.explain_analyze(q)
    assert [r.axis for r in rep.rows] == [
        "ordering", "parallelism", "batching", "source", "implementation",
    ]
    assert rep.epochs_run == 3
    assert rep.measured_total_s > 0 and rep.predicted_total_s > 0
    assert rep.predicted_total_s == pytest.approx(sum(r.predicted_s for r in rep.rows))
    assert all(r.ratio > 0 for r in rep.rows)
    assert "EXPLAIN ANALYZE" in rep.describe()
    assert rep.plan == eng.explain(q).chosen.to_dict()
    assert not obs.enabled()  # the analyzed run restored the caller's tracer state


def test_explain_analyze_of_a_stored_table_measures_the_source_axis():
    table = engine.ChunkedTable.from_arrays(_data(512), 128)
    rep = _eng().explain_analyze(_q(table, hints={"ordering": "shuffle_once", "scheme": "serial"}))
    source = next(r for r in rep.rows if r.axis == "source")
    assert source.measured_s > 0 and source.predicted_s > 0


def test_explain_analyze_persists_next_to_plan(tmp_path):
    data = _data(512)
    store = serve.PlanStore(str(tmp_path))
    rep = _eng(plan_store=store).explain_analyze(_q(data))
    fresh = _eng(plan_store=store)
    loaded = fresh.load_analysis(_q(data))
    assert loaded is not None and loaded == rep
    names = sorted(p.name for p in (tmp_path / serve.STORE_DIR).iterdir())
    assert any(n.endswith(".analyze.json") for n in names)
    assert any(n.endswith(".json") and ".analyze" not in n for n in names)
    assert store.size() == 1  # the analysis file is not a plan
    assert fresh.load_analysis(_q(_data(512, seed=9))) is None  # another table: a miss
    assert _eng().load_analysis(_q(data)) is None  # no store


def test_module_level_explain_analyze_uses_the_default_engine(monkeypatch):
    monkeypatch.setattr(engine, "_DEFAULT", _eng())
    rep = engine.explain_analyze(_q(_data(256)))
    assert rep.epochs_run == 2 and engine.cache_info()["compiled_plans"] == 1


def test_attribution_equals_the_references_on_a_port_trace():
    with obs.tracing() as rec:
        _eng().run(_q(_data(256), epochs=2))
    for root in (None, "engine.run", "epoch"):
        ours = attribution.attribute(rec.spans, root_name=root)
        theirs = ref_obs.attribution.attribute(rec.spans, root_name=root)
        assert ours.to_dict() == theirs.to_dict()
        assert attribution.critical_path(rec.spans, root) == ref_obs.attribution.critical_path(rec.spans, root)
