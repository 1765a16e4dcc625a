"""repro_torch.engine.serve (admission control, masked-lane query
fusion, the persistent plan cache) against repro.engine.serve, on the
CPU.

The port's counterparts of tests/test_serve.py's non-obs cases and of
tests/test_implementation.py::test_serve_fused_batch_pallas_matches_singleton.
The same numpy table goes through both serving engines; the port's
engine replays the reference's threefry streams (``_threefry_replay``)
lane by lane, so each fused lane is held to the reference's fused lane
and to the port's own singleton ``Engine.run`` within the reference's
serving tolerance (rtol 1e-5, atol 1e-7). The kernel lanes run their
plain versions here (the reference its Pallas kernels in interpret
mode); on the card they are held bit for bit (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _threefry_replay import ThreefryReplay
from _torch_obs import torch_obs_isolation  # noqa: F401  (autouse: the port's obs state, reset per test)
from repro import engine as ref_engine
from repro.engine import serve as ref_serve
from repro_torch import convert, engine
from repro_torch.engine import planner, program, serve
from repro_torch.launch import serve as launch_serve

torch.set_num_threads(1)

# the reference's serving tolerance (tests/test_serve.py)
RTOL, ATOL = 1e-5, 1e-7
IMPLS = {"torch_fold": "xla_fold", "cuda_fused": "pallas_fused", "cuda_minibatch": "pallas_minibatch"}


def _table(n=96, d=4, seed=0):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(x @ r.normal(size=d) + 0.3 * r.normal(size=n)).astype(np.float32)
    return {"x": x, "y": y}


def _q(data, seed=0, **kw):
    kw.setdefault("epochs", 2)
    kw.setdefault("tolerance", 0.0)
    return engine.AnalyticsQuery(task="logreg", data=data, task_args={"dim": 4}, seed=seed, **kw)


def _engine():
    return engine.Engine(device="cpu", draws=ThreefryReplay())


def _server(**kw):
    kw.setdefault("max_batch", 4)
    return serve.ServingEngine(serve.ServeConfig(**kw), engine=_engine())


def _fuse_both(arrays, hints, budgets, *, tables=None):
    """The same group through the reference's server and the port's,
    and the port's singleton runs; returns (port tickets, reference
    tickets, port singleton results, port server)."""
    tables = tables or [arrays] * len(budgets)
    mem = {id(a): convert.table_from_numpy(a, "cpu") for a in tables}
    ref_mem = {id(a): {k: jax.numpy.asarray(v) for k, v in a.items()} for a in tables}
    queries = [_q(mem[id(a)], seed=s, epochs=e, hints=dict(hints)) for s, (a, e) in enumerate(zip(tables, budgets))]
    ref_srv = ref_serve.ServingEngine(ref_serve.ServeConfig(max_batch=4))
    ref_hints = dict(hints)
    if "implementation" in ref_hints:
        ref_hints["implementation"] = IMPLS[ref_hints["implementation"]]
    ref_tickets = [ref_srv.submit(ref_engine.AnalyticsQuery(
        task="logreg", data=ref_mem[id(a)], task_args={"dim": 4}, seed=s, epochs=e, tolerance=0.0,
        hints=dict(ref_hints))) for s, (a, e) in enumerate(zip(tables, budgets))]
    ref_srv.drain()
    singles = [_engine().run(q) for q in queries]
    srv = _server()
    tickets = [srv.submit(q) for q in queries]
    srv.drain()
    return tickets, ref_tickets, singles, srv


def _assert_lanes(tickets, ref_tickets, singles):
    for t, rt, single in zip(tickets, ref_tickets, singles):
        assert t.error is None and rt.error is None, (t.error, rt.error)
        assert t.result.epochs == single.epochs == rt.result.epochs
        np.testing.assert_allclose(t.result.model.numpy(), single.model.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t.result.model.numpy(), np.asarray(rt.result.model), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t.result.losses[-1], single.losses[-1], rtol=RTOL)
        np.testing.assert_allclose(t.result.losses[-1], rt.result.losses[-1], rtol=RTOL)


# -- cross-query batching --------------------------------------------------------


@pytest.mark.parametrize("hints", [
    {"ordering": "shuffle_once", "scheme": "serial"},
    {"ordering": "shuffle_always", "scheme": "serial"},
    {"ordering": "clustered", "scheme": "serial"},
    {"ordering": "shuffle_once", "scheme": "segmented", "num_segments": 4},
], ids=["shuffle_once", "shuffle_always", "clustered", "segmented"])
@pytest.mark.parametrize("budgets", [(2, 2, 2), (1, 3, 2)], ids=["homogeneous", "masked"])
def test_fused_lanes_match_the_reference_and_their_singleton_runs(budgets, hints):
    """Every branch of the fused builder (fused shuffles, the fixed
    stored order, the fixed shuffle_once prep of a non-serial scheme),
    with equal budgets and with masked lanes: ONE batch, each lane its
    own singleton run and the reference's fused lane."""
    tickets, ref_tickets, singles, srv = _fuse_both(_table(), hints, budgets)
    assert srv.stats["batches"] == 1 and srv.stats["fused_lanes"] == 3
    assert srv.metrics()["obs"]["serve.fused_lanes"]["value"] == 3
    assert srv.stats["masked_batches"] == (len(set(budgets)) > 1)
    assert all(t.result.batch_size == 3 for t in tickets)
    _assert_lanes(tickets, ref_tickets, singles)


@pytest.mark.parametrize("impl", ["cuda_fused", "cuda_minibatch"])
@pytest.mark.parametrize("ordering", ["clustered", "shuffle_once", "shuffle_always"])
def test_fused_kernel_lanes_match_the_reference_and_their_singleton_runs(ordering, impl):
    """Heterogeneous-epoch batches of kernel lanes (the reference vmaps
    its Pallas call; the port makes one lane launch an epoch, here its
    plain version): each lane equals its own singleton kernel run."""
    hints = {"ordering": ordering, "scheme": "serial", "implementation": impl}
    tickets, ref_tickets, singles, srv = _fuse_both(_table(), hints, (4, 2, 4))
    assert srv.stats["batches"] == 1 and srv.stats["masked_batches"] == 1
    assert all(t.result.plan.implementation == impl for t in tickets)
    _assert_lanes(tickets, ref_tickets, singles)


@pytest.mark.parametrize("impl", ["torch_fold", "cuda_fused"])
def test_distinct_tables_fuse_on_stacked_lanes(impl):
    """Same signature, different tables: the lanes read a stacked bank
    (kernel lanes: a lane stride of N rows) and still match."""
    a = _table()
    b = {"x": a["x"] * 1.25, "y": a["y"]}
    hints = {"ordering": "shuffle_once", "scheme": "serial", "implementation": impl}
    tickets, ref_tickets, singles, srv = _fuse_both(a, hints, (2, 2), tables=[a, b])
    assert srv.stats["batches"] == 1
    _assert_lanes(tickets, ref_tickets, singles)


@pytest.mark.parametrize("ordering", ["clustered", "shuffle_once", "shuffle_always"])
@pytest.mark.parametrize("impl", ["torch_fold", "cuda_fused", "cuda_minibatch"])
def test_one_fused_lane_is_its_singleton_run_bit_for_bit(impl, ordering):
    """The batching axis at B = 1 through build_program's fused path
    (the server never fuses a group of one): the singleton's floats."""
    mem = convert.table_from_numpy(_table(), "cpu")
    q = _q(mem, seed=5, epochs=3, hints={"ordering": ordering, "scheme": "serial", "implementation": impl})
    eng = _engine()
    single = eng.run(q)
    task, agg = eng._aggregate_for(q)
    compiled = program.build_program(
        task, agg, program.EpochProgram(plan=single.plan, batch=1, shared_table=True, epochs=3))
    lane_draws = [eng.draws.stream(5, 96, eng.device)]
    examples = compiled.prep_fn(mem, lane_draws) if compiled.prep_fn else mem
    states = compiled.run_fn(compiled.init_fn(lane_draws), examples, lane_draws, [3])
    assert torch.equal(states.model[0], single.model)
    assert torch.equal(compiled.loss_fn(states.model, mem)[0], torch.tensor(single.losses[-1]))


@pytest.mark.parametrize("ordering, mode", [("shuffle_once", "fixed"), ("shuffle_always", "fused")])
@pytest.mark.parametrize("impl", ["cuda_fused", "cuda_minibatch"])
def test_kernel_lanes_gather_their_permuted_copies_once_per_draw(impl, ordering, mode):
    """Kernel lanes read rows in array order, so each lane's permutation
    is gathered into a copy: under shuffle_once once, in ``prep_fn``
    (mode "fixed"), not once an epoch; under shuffle_always once an
    epoch, in the run (mode "fused")."""
    q = _q(convert.table_from_numpy(_table(), "cpu"),
           hints={"ordering": ordering, "scheme": "serial", "implementation": impl})
    task, agg = _engine()._aggregate_for(q)
    plan = planner.Plan(ordering, implementation=impl)
    compiled = program.build_program(task, agg, program.EpochProgram(plan=plan, batch=3, epochs=2))
    assert compiled.mode == mode and (compiled.prep_fn is not None) == (mode == "fixed")


def test_fused_programs_refuse_mrs_stored_tables_and_no_epoch_bound():
    task, agg = _engine()._aggregate_for(_q(convert.table_from_numpy(_table(), "cpu")))
    for plan, epochs, match in ((planner.Plan("clustered", "mrs", mrs_buffer=8), 2, "MRS"),
                                (planner.Plan("clustered", source="table"), 2, "stored table"),
                                (planner.Plan("clustered"), 0, "epochs")):
        with pytest.raises(ValueError, match=match):
            program.build_program(task, agg, program.EpochProgram(plan=plan, batch=2, epochs=epochs))


@pytest.mark.parametrize("case", ["budget", "early_stop", "target_loss", "mrs", "stored", "task_args"])
def test_queries_that_keep_their_own_control_flow_run_singleton(case):
    """Early stops need per-query stop rules, a budget bounds one query's
    footprint, MRS carries a reservoir a query, a stored table is a
    chunk stream, and other task_args are another key: none fuse, and
    each still completes."""
    arrays = _table()
    mem = convert.table_from_numpy(arrays, "cpu")
    srv = _server()
    if case == "task_args":
        qs = [_q(mem, seed=0), engine.AnalyticsQuery(task="logreg", data=mem, task_args={"dim": 4, "mu": 1e-3},
                                                     seed=1, epochs=2, tolerance=0.0)]
    else:
        kw = {"budget": {"memory_budget_bytes": 10 * 1024 * 1024}, "early_stop": {"tolerance": 1e-3},
              "target_loss": {"target_loss": 1e-9},
              "mrs": {"hints": {"scheme": "mrs"}},
              "stored": {"hints": {"source": "table", "implementation": "torch_fold"}}}[case]
        data = convert.chunked_table_from_numpy(arrays, 32, "cpu") if case == "stored" else mem
        qs = [_q(data, seed=s, **kw) for s in (0, 1)]
    tickets = [srv.submit(q) for q in qs]
    assert srv.drain() == 2
    assert srv.stats["batches"] == 0 and srv.stats["singleton_queries"] == 2
    assert all(t.error is None and t.result.batch_size == 1 for t in tickets)
    if case == "stored":
        assert all(t.result.plan.source == "table" for t in tickets)


# -- admission control --------------------------------------------------------


def test_admission_sheds_load_beyond_queue_bound():
    mem = convert.table_from_numpy(_table(64), "cpu")
    srv = _server(max_queue=2, max_per_task=8, max_batch=8)
    tickets = [srv.submit(_q(mem, seed=s)) for s in range(4)]
    assert [t.accepted for t in tickets] == [True, True, False, False]
    assert tickets[2].reject_reason == serve.REJECT_QUEUE_FULL == ref_serve.REJECT_QUEUE_FULL
    assert tickets[3].done is False and tickets[3].result is None
    assert srv.queue_depth == 2
    assert srv.drain() == 2
    assert all(t.done and t.latency_s > 0 for t in tickets[:2])
    m = srv.metrics()
    assert (m["rejected"], m["shed_queue_full"], m["shed_task_limit"], m["queue_depth"]) == (2, 2, 0, 0)
    assert srv.cache_info()["plans_computed"] == 1
    assert m["obs"]["serve.shed.queue_full"]["value"] == 2
    assert m["obs"]["serve.accepted"]["value"] == 2
    lat = m["obs"]["serve.latency_s.logreg"]  # both served queries
    assert lat["count"] == 2 and lat["p99"] >= lat["p50"] > 0


def test_serving_engine_registers_operational_gauges(tmp_path):
    """Queue depth and plan-store size are live callback gauges: they
    read the server's state at snapshot time, not a stale copy."""
    from repro_torch import obs

    mem = convert.table_from_numpy(_table(64), "cpu")
    srv = _server(cache_dir=str(tmp_path))
    srv.submit(_q(mem, seed=0))
    srv.submit(_q(mem, seed=1))
    snap = obs.metrics.snapshot("serve.")
    assert snap["serve.queue_depth"]["value"] == 2
    assert snap["serve.plan_store_entries"]["value"] == 0
    srv.drain()
    snap = obs.metrics.snapshot("serve.")
    assert snap["serve.queue_depth"]["value"] == 0
    assert snap["serve.plan_store_entries"]["value"] >= 1


def test_admission_per_task_limit():
    mem = convert.table_from_numpy(_table(64), "cpu")
    srv = _server(max_queue=8, max_per_task=1, max_batch=8)
    t1 = srv.submit(_q(mem, seed=0))
    t2 = srv.submit(_q(mem, seed=1))  # same task: over the limit
    t3 = srv.submit(engine.AnalyticsQuery(task="svm", data=mem, task_args={"dim": 4}, epochs=1, tolerance=0.0))
    assert t1.accepted and t3.accepted and not t2.accepted
    assert t2.reject_reason == serve.REJECT_TASK_LIMIT == ref_serve.REJECT_TASK_LIMIT
    assert srv.stats["shed_task_limit"] == 1 and srv.stats["shed_queue_full"] == 0
    srv.drain()
    assert t1.done and t3.done


def test_failed_query_completes_with_error_and_does_not_kill_the_queue():
    mem = convert.table_from_numpy(_table(64), "cpu")
    srv = _server()
    bad = srv.submit(_q(mem, hints={"ordering": "no_such_ordering"}))
    good = srv.submit(_q(mem, seed=1))
    srv.drain()
    assert bad.done and bad.result is None and "no_such_ordering" in bad.error
    assert good.done and good.result is not None and good.error is None
    assert srv.stats["failed_queries"] == 1


# -- the persistent plan cache -------------------------------------------------


def test_plan_store_warm_start_probes_and_plans_nothing(tmp_path):
    """A fresh engine (empty probe cache) on a populated store loads the
    report: no probe, no plan, the same choice and EXPLAIN, and the
    loaded plan runs."""
    mem = convert.table_from_numpy(_table(128), "cpu")
    q = _q(mem, hints={"ordering": "shuffle_once", "scheme": "serial"})  # a fusable plan, whatever the probes say
    first = engine.Engine(device="cpu", plan_store=serve.PlanStore(str(tmp_path)))
    rep1 = first.explain(q)
    assert first.stats["plans_computed"] == 1 and first.stats["probe_runs"] == 1
    second = engine.Engine(device="cpu", plan_store=serve.PlanStore(str(tmp_path)))
    rep2 = second.explain(q)
    assert second.stats["probe_runs"] == 0 and second.stats["plans_computed"] == 0
    assert second.stats["plan_disk_hits"] == 1
    assert rep2 == rep1 and rep2.describe() == rep1.describe() and "batch=fusable" in rep2.axes
    # a re-plan against the same table (other epochs) measures nothing
    second.explain(dataclasses.replace(q, epochs=3))
    assert second.stats["probe_runs"] == 0 and second.stats["plans_computed"] == 1
    assert np.isfinite(second.run(q).losses[-1])
    # the port keeps its own files beside, never inside, the reference's
    assert all(p.parent.name == serve.STORE_DIR for p in tmp_path.rglob("plan_*.json"))


@pytest.mark.parametrize("how", ["other_table", "version", "key", "torn"])
def test_plan_store_invalidates(tmp_path, how):
    arrays = _table(128)
    q = _q(convert.table_from_numpy(arrays, "cpu"))
    store = serve.PlanStore(str(tmp_path))
    eng = engine.Engine(device="cpu", plan_store=store)
    plan_key = eng._query_plan_key(q)
    eng.explain(q)
    (path,) = tmp_path.rglob("plan_*.json")
    if how == "other_table":  # same shape, new contents: stale statistics
        q = _q(convert.table_from_numpy({"x": arrays["x"] + 1.0, "y": arrays["y"]}, "cpu"))
    elif how in ("version", "key"):
        entry = json.loads(path.read_text())
        entry["version" if how == "version" else "key"] = "other"
        path.write_text(json.dumps(entry))
    else:
        path.write_text(path.read_text()[:100])
    assert store.load(plan_key, q) is None
    fresh = engine.Engine(device="cpu", plan_store=serve.PlanStore(str(tmp_path)))
    fresh.explain(q)
    assert fresh.stats["plan_disk_hits"] == 0 and fresh.stats["plans_computed"] == 1
    assert store.size() == 1  # the entry was rewritten in place


def test_plan_report_round_trips_through_json():
    rep = _engine().explain(_q(convert.table_from_numpy(_table(), "cpu")))
    back = planner.PlanReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert back == rep and back.describe() == rep.describe()
    inf = planner.Candidate(planner.Plan("shuffle_once"), float("inf"), 2.0, "over budget")
    assert planner.Candidate.from_dict(json.loads(json.dumps(inf.to_dict()))) == inf


def test_serving_engine_uses_the_disk_cache(tmp_path):
    mem = convert.table_from_numpy(_table(), "cpu")
    srv1 = serve.ServingEngine(serve.ServeConfig(cache_dir=str(tmp_path)), engine=_engine())
    srv1.submit(_q(mem))
    srv1.drain()
    srv2 = serve.ServingEngine(serve.ServeConfig(cache_dir=str(tmp_path)), engine=_engine())
    srv2.submit(_q(mem))
    srv2.drain()
    assert srv2.engine.stats["plan_disk_hits"] == 1 and srv2.engine.stats["plans_computed"] == 0
    assert srv2.engine.stats["probe_runs"] == 0


# -- the launch surface and the sweep loop ----------------------------------------


def test_serve_analytics_fuses_a_load_through_the_launch_surface(tmp_path):
    mem = convert.table_from_numpy(_table(), "cpu")
    qs = [_q(mem, seed=s, epochs=3, hints={"ordering": "shuffle_once", "scheme": "serial"}) for s in range(5)]
    srv = launch_serve.make_analytics_server(max_batch=8, max_queue=4, device="cpu", cache_dir=str(tmp_path))
    tickets = launch_serve.serve_analytics(qs, server=srv)
    assert [t.accepted for t in tickets] == [True] * 4 + [False]
    assert [t.result.batch_size for t in tickets[:4]] == [4] * 4
    assert srv.engine.plan_store is not None and srv.engine.plan_store.size() == 1


def test_sweep_records_every_variant_and_summarizes_each(tmp_path):
    from repro_torch.engine import sweep

    def run(arch, shape, cfg_overrides=None, tag="", scale=1):
        if tag == "bad":
            raise RuntimeError("boom")
        return {"arch": arch, "tag": tag, "status": "OK", "ms": 1.5 * scale}

    lines = []
    out = tmp_path / "log.jsonl"
    recs = sweep.sweep(run, [("a", "s", {"scale": 2}, None, "good"), ("a", "s", {}, None, "bad")], str(out),
                       summarize=lambda rec: f"ms {rec.get('ms')}", log_fn=lines.append)
    assert [r["status"] for r in recs] == ["OK", "FAIL"] and "boom" in recs[1]["error"]
    assert [json.loads(line)["tag"] for line in out.read_text().splitlines()] == ["good", "bad"]
    assert lines == ["good OK ms 3.0", "bad FAIL ms None"]


@pytest.mark.parametrize("ordering", ["clustered", "shuffle_once", "shuffle_always"])
@pytest.mark.parametrize("name", ["crf", "kalman", "lmf", "portfolio", "sparse_logreg", "sparse_svm"])
def test_fused_batch_of_the_other_techniques_matches_the_reference(name, ordering, monkeypatch):
    """A served batch of three queries of each of the six other techniques
    with masked budgets (1, 3, 2), fused in both servers under the same
    hinted plan, each lane held to the reference's lane (Kalman's planted
    system is the reference's, as in test_torch_tasks_engine)."""
    from repro import tasks as ref_tasks
    from repro_torch.tasks import kalman
    from test_torch_tasks_engine import _table

    def planted(c_seed, state_dim, obs_dim, device):
        c, a = ref_tasks.KalmanFilterTask(1, state_dim, obs_dim, c_seed=c_seed)._mats()
        return torch.tensor(np.asarray(c), device=device), torch.tensor(np.asarray(a), device=device)

    monkeypatch.setattr(kalman, "system_matrices", planted)
    arrays, args = _table(name)
    hints = {"ordering": ordering, "scheme": "serial"}
    common = [dict(task=name, task_args=args, seed=s, epochs=e, tolerance=0.0, hints=dict(hints))
              for s, e in enumerate((1, 3, 2))]
    ref_data = {k: jax.numpy.asarray(v) for k, v in arrays.items()}
    ref_srv = ref_serve.ServingEngine(ref_serve.ServeConfig(max_batch=4))
    ref_tickets = [ref_srv.submit(ref_engine.AnalyticsQuery(data=ref_data, **c)) for c in common]
    ref_srv.drain()
    data = convert.table_from_numpy(arrays, "cpu")
    srv = _server()
    tickets = [srv.submit(engine.AnalyticsQuery(data=data, **c)) for c in common]
    srv.drain()
    assert srv.stats["masked_batches"] == 1 and ref_srv.stats["masked_batches"] == 1
    for t, rt in zip(tickets, ref_tickets):
        assert t.result.batch_size == rt.result.batch_size == 3
        assert t.result.epochs == rt.result.epochs
        want = jax.tree.map(np.asarray, rt.result.model)
        got = t.result.model
        if isinstance(got, dict):
            assert sorted(got) == sorted(want)
            for k in got:
                np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL, atol=1e-6)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(t.result.losses, rt.result.losses, rtol=RTOL, atol=1e-6)
