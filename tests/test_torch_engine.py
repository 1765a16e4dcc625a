"""repro_torch.engine against repro.engine, end to end on the CPU.

The same table (made with numpy from a seed) goes through both engines.
The port's engine is given a draw source that replays the reference's
threefry streams (``_threefry_replay``), so the shuffle orderings fold the
same rows in the same order and the MRS and shared-memory schemes make
the same draws. Held pairs:

* each serial implementation to its reference counterpart: torch_fold
  <-> xla_fold, cuda_fused <-> pallas_fused, cuda_minibatch <->
  pallas_minibatch (on the CPU the cuda_* lanes run the kernels' plain
  versions; the reference runs its Pallas kernels in interpret mode);
  mirrors tests/test_implementation.py;
* each other scheme under a forced plan: segmented (k = 2, 4, 8),
  shared_memory (lock, aig, nolock) and MRS;
* the planner: every candidate priced as the reference prices it, on the
  reference's measured constants, with and without a memory budget.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from _threefry_replay import ThreefryReplay
from _torch_obs import torch_obs_isolation  # noqa: F401  (autouse: the port's obs state, reset per test)
from repro import engine as ref_engine
from repro.core import ordering as ref_ordering
from repro.engine import planner as ref_planner, probes as ref_probes
from repro_torch import convert, engine
from repro_torch.core import ordering
from repro_torch.engine import planner, probes, program

torch.set_num_threads(1)

ORDERINGS = ("clustered", "shuffle_once", "shuffle_always")
TASKS = ("logreg", "svm", "least_squares")
IMPLS = {"torch_fold": "xla_fold", "cuda_fused": "pallas_fused", "cuda_minibatch": "pallas_minibatch"}
# the reference's engine-run tolerance (tests/test_implementation.py)
RTOL, ATOL = 1e-5, 1e-6


def _table(n=96, d=4, seed=0):
    """Label-clustered dense rows made with numpy (+1 first)."""
    r = np.random.default_rng(seed)
    w = r.normal(size=d) / np.sqrt(d)
    y = np.concatenate([np.ones(n // 2), -np.ones(n - n // 2)]).astype(np.float32)
    x = r.normal(size=(n, d)) / np.sqrt(d)
    x = x + ((y - x @ w) / np.sum(w**2))[:, None] * w[None, :] + 0.5 * r.normal(size=(n, d)) / np.sqrt(d)
    return {"x": x.astype(np.float32), "y": y}


def _pair(data, task="logreg", epochs=3, hints=None, task_args_extra=None, **kw):
    kw.setdefault("tolerance", 0.0)
    args = dict(task=task, task_args={"dim": data["x"].shape[1], **(task_args_extra or {})}, epochs=epochs, **kw)
    ref_q = ref_engine.AnalyticsQuery(data={k: jax.numpy.asarray(v) for k, v in data.items()},
                                      hints=dict(hints or {}), **args)
    port_hints = dict(hints or {})
    if "implementation" in port_hints:
        port_hints["implementation"] = {v: k for k, v in IMPLS.items()}[port_hints["implementation"]]
    port_q = engine.AnalyticsQuery(data=convert.table_from_numpy(data, "cpu"), hints=port_hints, **args)
    return ref_q, port_q


@pytest.fixture(scope="module")
def ref_eng():
    return ref_engine.Engine()


@pytest.fixture(scope="module")
def eng():
    return engine.Engine(device="cpu", draws=ThreefryReplay())


def _assert_same(res, ref_res):
    assert res.epochs == ref_res.epochs
    np.testing.assert_allclose(res.model.numpy(), np.asarray(ref_res.model), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res.losses, ref_res.losses, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["torch_fold", "cuda_fused", "cuda_minibatch"])
@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("ordering_name", ORDERINGS)
def test_port_matches_reference_engine(ordering_name, task, impl, ref_eng, eng):
    """Per ordering x dense GLM x implementation, the port's run equals
    the reference's run of the counterpart implementation."""
    ref_q, q = _pair(_table(), task, hints={"ordering": ordering_name, "scheme": "serial",
                                            "implementation": IMPLS[impl]})
    ref_res = ref_eng.run(ref_q)
    res = eng.run(q)
    assert res.plan.implementation == impl and res.plan.ordering == ordering_name
    _assert_same(res, ref_res)


def test_stop_rule_run_matches_reference(ref_eng, eng):
    """A tolerance-stopped run evaluates the loss every epoch and stops
    on the same epoch as the reference."""
    ref_q, q = _pair(_table(), "logreg", epochs=30, tolerance=1e-2,
                     hints={"ordering": "shuffle_once", "scheme": "serial", "implementation": "pallas_fused"})
    ref_res, res = ref_eng.run(ref_q), eng.run(q)
    assert res.converged and ref_res.converged and len(res.losses) == res.epochs
    _assert_same(res, ref_res)


def test_cuda_minibatch_parity_on_a_larger_table(ref_eng, eng):
    """512 rows = two full tiles per epoch: the mean-gradient steps agree
    with pallas_minibatch, and they make progress from the zero model."""
    ref_q, q = _pair(_table(512), "logreg", epochs=5, hints={"implementation": "pallas_minibatch"})
    ref_res, res = ref_eng.run(ref_q), eng.run(q)
    _assert_same(res, ref_res)
    loss0 = float(engine.get("logreg").make_task(dim=4).full_loss(torch.zeros(4), q.data))
    assert res.losses[-1] < loss0


def test_warm_repeat_builds_nothing():
    eng = engine.Engine(device="cpu")
    _, q = _pair(_table(), "svm", epochs=2)
    first = eng.run(q)
    info = eng.cache_info()
    again = eng.run(q)
    after = eng.cache_info()
    assert again.trace_count == first.trace_count == 1
    assert again.loss_trace_count == first.loss_trace_count == 1
    assert after["plan_cache_hits"] == info["plan_cache_hits"] + 1
    assert after["plans_computed"] == info["plans_computed"] == 1
    assert after["probe_runs"] == info["probe_runs"] == 1
    assert torch.equal(again.model, first.model)
    # a different shape is a miss: new probes, a new plan, a new build
    _, q2 = _pair(_table(64), "svm", epochs=2)
    assert eng.run(q2).trace_count == 1
    assert eng.cache_info()["compiled_plans"] == 2


def test_label_clusteredness_equals_reference():
    for data in (_table(), ref_ordering.make_catx_dataset(40), _table(200, seed=5)):
        data = {k: np.asarray(v) for k, v in data.items()}
        want = ref_engine.label_clusteredness({k: jax.numpy.asarray(v) for k, v in data.items()})
        assert planner.label_clusteredness(convert.table_from_numpy(data, "cpu")) == want
    shuffled = _table(512)
    perm = np.random.default_rng(0).permutation(512)
    shuffled = {k: v[perm] for k, v in shuffled.items()}
    got = planner.label_clusteredness(convert.table_from_numpy(shuffled, "cpu"))
    assert got == ref_engine.label_clusteredness(shuffled) and got < 0.2


def _catx_query(data):
    return dict(task="logreg", data=data, task_args={"dim": 1}, epochs=30)


def test_catx_costs_out_the_clustered_scan():
    """The label-clustered CA-TX table, on the port's own probes: every
    clustered candidate is costed out (paper §3.2), whatever the rates."""
    rep = engine.Engine(device="cpu").explain(
        engine.AnalyticsQuery(**_catx_query(ordering.make_catx_dataset(512, device="cpu"))))
    assert rep.clusteredness > 0.9
    assert rep.chosen.ordering != "clustered"
    best = min(c.cost_seconds for c in rep.candidates)
    # MRS streams the stored order too, but its reservoir randomizes it
    clustered = [c for c in rep.candidates if c.plan.ordering == "clustered" and c.plan.scheme != "mrs"]
    assert clustered and all(c.cost_seconds > 10 * best for c in clustered)
    text = rep.describe()
    assert "plan   :" in text and "reject :" in text and "impl-probed" in text
    assert "torch_fold" in text and "cuda_fused" in text and "us/epoch" in text


@pytest.fixture(scope="module")
def catx_constants():
    """The reference's measured calibration for the CA-TX query, and both
    planners' view of it. The port's eager fold has one rate, so the
    reference is given its best unroll's rate as its only one (and no
    mesh points: the sharded axis is not in this slice)."""
    ref_rep = ref_engine.Engine().explain(
        ref_engine.AnalyticsQuery(**_catx_query(ref_ordering.make_catx_dataset(512))))
    rc = ref_rep.calibration
    fold = rc.fold_per_row[rc.best_unroll()]
    cal = probes.Calibration(
        shuffle_per_row=rc.shuffle_per_row, fold_per_row=fold,
        merge_seconds=rc.merge_seconds, probe_rows=rc.probe_rows, seg_per_row=dict(rc.seg_per_row),
        impl_per_row={"cuda_fused": rc.impl_per_row["pallas_fused"],
                      "cuda_minibatch": rc.impl_per_row["pallas_minibatch"]},
    )
    return ref_rep, dataclasses.replace(rc, fold_per_row={1: fold}, shard={}), cal


def _ref_key(p, ref_names=()):
    """A plan's axes in the reference's names (its plans already use them)."""
    impl = p.implementation if p.implementation in ref_names else IMPLS[p.implementation]
    return (p.ordering, p.scheme, p.num_segments, p.sm_scheme, p.sm_workers, p.mrs_buffer, p.mrs_ratio, impl)


def _plan_on_both(constants, monkeypatch, **kw):
    """The port's planner and the reference's (its own plan(), with its
    probe swapped for the shared constants) on the same CA-TX query."""
    _, ref_cal, cal = constants
    monkeypatch.setattr(ref_probes, "calibrate", lambda *a, **k: ref_cal)
    ref_rep = ref_planner.plan(ref_engine.AnalyticsQuery(**_catx_query(ref_ordering.make_catx_dataset(512)), **kw), None)
    rep = planner.plan(engine.AnalyticsQuery(**_catx_query(ordering.make_catx_dataset(512, device="cpu")), **kw), cal)
    want = {_ref_key(c.plan, IMPLS.values()): c.cost_seconds for c in ref_rep.candidates}
    assert len(rep.candidates) == len(ref_rep.candidates) == len(want)
    for c in rep.candidates:
        assert c.cost_seconds == pytest.approx(want[_ref_key(c.plan)], rel=1e-12)
    assert _ref_key(rep.chosen) == _ref_key(ref_rep.chosen, IMPLS.values())
    assert rep.clusteredness == ref_rep.clusteredness
    return rep, ref_rep


def test_catx_plans_shuffle_once_on_the_references_constants(catx_constants, monkeypatch):
    """Which shuffle wins depends on the measured rates: the eager fold on
    a CPU is ~500x slower than XLA's scan, which makes the per-epoch
    reshuffle cheap next to the fold. Given the constants the reference
    measured, the port's cost model must price every candidate of every
    scheme exactly as the reference does and plan shuffle_once as it
    does."""
    ref_rep = catx_constants[0]
    rep, _ = _plan_on_both(catx_constants, monkeypatch)
    assert rep.chosen.ordering == ref_rep.chosen.ordering == "shuffle_once"
    assert {c.plan.scheme for c in rep.candidates} == set(planner.SCHEMES)


def test_catx_falls_back_to_mrs_on_the_references_constants(catx_constants, monkeypatch):
    """Mirrors tests/test_engine.py::test_planner_falls_back_to_mrs_under_memory_budget:
    a table larger than the buffer budget makes every shuffled plan
    infeasible, and buffered MRS (§3.4) is chosen — by both planners."""
    rep, ref_rep = _plan_on_both(catx_constants, monkeypatch, memory_budget_bytes=1024)
    assert rep.chosen.scheme == ref_rep.chosen.scheme == "mrs"
    assert rep.chosen.mrs_buffer >= 8
    shuffled = [c for c in rep.candidates if c.plan.ordering != "clustered"]
    assert shuffled and all(math.isinf(c.cost_seconds) for c in shuffled)
    assert {c.plan.scheme for c in rep.candidates} == set(planner.SCHEMES)


def test_planner_prices_implementations_from_probes():
    rep = engine.Engine(device="cpu").explain(_pair(_table(), "svm")[1])
    rates = rep.calibration.impl_per_row
    assert rates.get("cuda_fused", 0.0) > 0.0 and rates.get("cuda_minibatch", 0.0) > 0.0
    impls = {c.plan.implementation for c in rep.candidates}
    assert impls == {"torch_fold", "cuda_fused"}  # minibatch is hint-only
    assert {c.plan.implementation for c in rep.candidates if c.plan.scheme != "serial"} == {"torch_fold"}
    # the reference's candidate set over 96 rows: 3 orderings x (serial +
    # 3 segment counts + 3 shared-memory schemes), 1 MRS, 3 cuda_fused
    assert len(rep.candidates) == 25


def test_forced_kernel_on_ineligible_task_raises():
    """logreg with mu > 0 routes through the l1 prox — the fused kernel
    has no prox hook, so the hint must be rejected, not ignored."""
    q = engine.AnalyticsQuery(task="logreg", data=convert.table_from_numpy(_table(), "cpu"),
                              task_args={"dim": 4, "mu": 0.01}, epochs=3, tolerance=0.0,
                              hints={"implementation": "cuda_fused"})
    with pytest.raises(ValueError, match="kernel-eligible"):
        engine.Engine(device="cpu").explain(q)
    # and auto-planning never offers the kernel for it
    rep = engine.Engine(device="cpu").explain(
        engine.AnalyticsQuery(task="logreg", data=q.data, task_args={"dim": 4, "mu": 0.01}, epochs=3))
    assert rep.calibration.impl_per_row == {}
    assert {c.plan.implementation for c in rep.candidates} == {"torch_fold"}


@pytest.mark.parametrize("hints,exc", [
    ({"implementation": "cuda_fused", "scheme": "mrs"}, ValueError),
    ({"implementation": "cuda"}, ValueError),
    ({"ordering": "random"}, ValueError),
    ({"scheme": "mrs", "ordering": "shuffle_once"}, ValueError),
    ({"scheme": "segmented", "implementation": "cuda_fused"}, ValueError),
    ({"scheme": "shared_memory", "implementation": "cuda_minibatch"}, ValueError),
    ({"parallelism": "sharded"}, ValueError),  # one device: no probed mesh point, no num_shards hint
    ({"source": "table"}, ValueError),  # the stored-table slice: needs a stored Table
    ({"parallelism": "sharded", "scheme": "segmented"}, ValueError),  # sharded implies serial
    ({"scheme": "segmented", "num_segments": 0}, ValueError),
])
def test_bad_or_later_hints_raise(hints, exc):
    q = engine.AnalyticsQuery(task="svm", data=convert.table_from_numpy(_table(), "cpu"),
                              task_args={"dim": 4}, hints=hints)
    with pytest.raises(exc):
        engine.Engine(device="cpu").explain(q)


@pytest.mark.parametrize("hints,scheme,n_plans", [
    ({"scheme": "segmented"}, "segmented", 9),
    ({"scheme": "segmented", "num_segments": 4, "ordering": "clustered"}, "segmented", 1),
    ({"scheme": "shared_memory"}, "shared_memory", 9),
    ({"scheme": "mrs"}, "mrs", 1),
])
def test_scheme_hints_plan_that_scheme(hints, scheme, n_plans):
    """A scheme hint plans only that scheme (the reference's enumeration:
    every segment count that divides the table and every shared-memory
    scheme under each ordering; one MRS plan, over the stored order)."""
    q = engine.AnalyticsQuery(task="svm", data=convert.table_from_numpy(_table(), "cpu"),
                              task_args={"dim": 4}, hints=hints)
    rep = engine.Engine(device="cpu").explain(q)
    assert rep.chosen.scheme == scheme and {c.plan.scheme for c in rep.candidates} == {scheme}
    assert len(rep.candidates) == len({c.plan for c in rep.candidates}) == n_plans
    if scheme == "mrs":
        assert rep.chosen.ordering == "clustered" and rep.chosen.mrs_buffer == 9  # a tenth of 96 rows
    assert f"singleton/{scheme}" in rep.describe()


def test_memory_budget_over_table_falls_back_to_mrs(ref_eng, eng):
    """On the port's own probes: a table over the budget makes every
    shuffled plan infeasible and the clustered scan costs ~50x its epochs,
    so the planner streams it through buffered MRS — whose run equals the
    reference's run of the same plan."""
    ref_q, q = _pair(_table(), "svm", epochs=4, memory_budget_bytes=64)
    rep = eng.explain(q)
    assert rep.chosen.scheme == "mrs" and rep.chosen.ordering == "clustered"
    assert rep.chosen.mrs_buffer == 8  # max(64 bytes // (2 x 20 bytes a row), 8)
    assert all(math.isinf(c.cost_seconds) for c in rep.candidates if c.plan.ordering != "clustered")
    res = eng.run(q)
    assert res.plan == rep.chosen and bool(torch.isfinite(res.model).all())
    ref_res = ref_eng.run(ref_q, plan=ref_planner.Plan("clustered", "mrs", mrs_buffer=8))
    _assert_same(res, ref_res)


def test_budget_that_no_plan_fits_is_an_error():
    """A shuffle-only hint under a budget the table exceeds: every
    candidate is infeasible, as in the reference."""
    q = engine.AnalyticsQuery(task="svm", data=convert.table_from_numpy(_table(), "cpu"), task_args={"dim": 4},
                              memory_budget_bytes=64, hints={"ordering": "shuffle_once", "scheme": "serial"})
    with pytest.raises(RuntimeError, match="no feasible plan"):
        engine.Engine(device="cpu").explain(q)
    q = dataclasses.replace(q, hints={"scheme": "segmented", "num_segments": 4}, memory_budget_bytes=None,
                            data={k: v[:7] for k, v in q.data.items()})
    assert all(c.plan.num_segments == 4 for c in engine.Engine(device="cpu").explain(q).candidates)
    q = dataclasses.replace(q, hints={"scheme": "segmented"})
    with pytest.raises(ValueError, match="admit no physical plan"):
        engine.Engine(device="cpu").explain(q)


# forced plans: (ordering, scheme, plan fields) — every scheme under one
# ordering or more, each held to the reference's run of the same plan
FORCED = [
    ("clustered", "segmented", {"num_segments": 2}),
    ("shuffle_once", "segmented", {"num_segments": 4}),
    ("shuffle_always", "segmented", {"num_segments": 8}),
    ("shuffle_always", "shared_memory", {"sm_scheme": "lock"}),
    ("shuffle_once", "shared_memory", {"sm_scheme": "aig"}),
    ("shuffle_always", "shared_memory", {"sm_scheme": "nolock"}),
    ("clustered", "shared_memory", {"sm_scheme": "nolock", "sm_workers": 3}),
    ("clustered", "mrs", {"mrs_buffer": 12}),
    ("clustered", "mrs", {"mrs_buffer": 7, "mrs_ratio": 1}),
]


@pytest.mark.parametrize("task", ["logreg", "least_squares"])
@pytest.mark.parametrize("ordering_name,scheme,fields", FORCED)
def test_forced_scheme_plan_matches_reference(ordering_name, scheme, fields, task, ref_eng, eng):
    """Model, losses and epochs of the port's run of a forced plan equal
    the reference's, the draws replayed (logreg with the L1 prox)."""
    ref_q, q = _pair(_table(), task, epochs=3, task_args_extra={"mu": 0.01} if task == "logreg" else {})
    ref_res = ref_eng.run(ref_q, plan=ref_planner.Plan(ordering_name, scheme, **fields))
    res = eng.run(q, plan=planner.Plan(ordering_name, scheme, **fields))
    assert res.plan.scheme == scheme and res.kernel_launches == 0
    _assert_same(res, ref_res)


def test_mrs_run_with_a_stop_rule_matches_reference(ref_eng, eng):
    ref_q, q = _pair(_table(), "svm", epochs=30, tolerance=1e-2)
    plan = {"ordering": "clustered", "scheme": "mrs", "mrs_buffer": 10}
    ref_res = ref_eng.run(ref_q, plan=ref_planner.Plan(**plan))
    res = eng.run(q, plan=planner.Plan(**plan))
    assert res.converged and ref_res.converged and len(res.losses) == res.epochs
    _assert_same(res, ref_res)


def test_clear_cache_forgets_compiled_plans_and_keeps_calibrations():
    eng = engine.Engine(device="cpu")
    _, q = _pair(_table(), "svm", epochs=1, hints={"scheme": "segmented", "num_segments": 2})
    eng.run(q)
    assert eng.cache_info()["compiled_plans"] == 1 and eng.stats["probe_runs"] == 1
    eng.clear_cache()
    assert eng.cache_info() == {"plan_cache_hits": 0, "plan_cache_misses": 0, "plans_computed": 0,
                                "plan_disk_hits": 0, "probe_runs": 0, "bytes_to_device": 0,
                                "compiled_plans": 0}
    res = eng.run(q)
    assert res.trace_count == res.loss_trace_count == 1
    assert eng.stats["plans_computed"] == 1 and eng.stats["probe_runs"] == 0


def test_sequential_alias_and_forced_plan():
    eng = engine.Engine(device="cpu")
    _, q = _pair(_table(), "least_squares", epochs=2, hints={"ordering": "sequential"})
    assert eng.explain(q).chosen.ordering == "clustered"
    res = eng.run(q, plan=planner.Plan("shuffle_always", implementation="cuda_fused"))
    assert res.report is None and res.plan.implementation == "cuda_fused"
    assert "implementation=cuda_fused" in res.plan.axes()
    assert "impl=cuda_fused" in res.describe()


def test_table_on_another_device_is_an_error():
    eng = engine.Engine(device="cpu")
    data = {k: v.to("meta") for k, v in convert.table_from_numpy(_table(), "cpu").items()}
    with pytest.raises(ValueError, match="lies on"):
        eng.run(engine.AnalyticsQuery(task="svm", data=data, task_args={"dim": 4}))


def test_kernel_permuted_lane_equals_lane_over_permuted_table():
    eng = engine.Engine(device="cpu")
    _, q = _pair(_table(), "logreg")
    _, agg = eng._aggregate_for(q)
    state = agg.initialize(torch.Generator())
    perm = torch.randperm(96, generator=torch.Generator().manual_seed(1))
    lane = program.kernel_lane_fold(agg, "lr")
    permuted = program.kernel_permuted_lane(agg, "lr")
    a = permuted(state, q.data, perm)
    b = lane(state, {k: v[perm] for k, v in q.data.items()})
    assert torch.equal(a.model, b.model) and int(a.step) == 96 and float(a.weight) == 96.0


def test_build_program_counts_builds_and_refuses_unknown_lowerings():
    eng = engine.Engine(device="cpu")
    _, q = _pair(_table(), "logreg")
    task, agg = eng._aggregate_for(q)
    counter = {"traces": 0}
    prog = program.build_program(task, agg, program.EpochProgram(planner.Plan("clustered")), counter=counter)
    assert prog.trace_count == 1 and counter["traces"] == 1
    assert "B=1" in prog.program.describe()
    with pytest.raises(ValueError):
        program.build_program(task, agg, program.EpochProgram(planner.Plan("clustered", implementation="xla")))


@pytest.mark.parametrize("plan,match", [
    (planner.Plan("clustered", "mrs"), "mrs_buffer > 0"),
    (planner.Plan("clustered", "segmented", num_segments=2, implementation="cuda_fused"), "no kernel form"),
    (planner.Plan("shuffle_once", "shared_memory", implementation="cuda_minibatch"), "no kernel form"),
    (planner.Plan("clustered", "mrs", mrs_buffer=4, implementation="cuda_fused"), "no kernel form"),
    (planner.Plan("clustered", "sharded"), "unknown scheme"),
])
def test_build_program_refuses_what_has_no_lowering(plan, match):
    """The reference's refusals: an MRS plan without a buffer, and a
    kernel implementation for any scheme but serial."""
    task, agg = engine.Engine(device="cpu")._aggregate_for(_pair(_table(), "svm")[1])
    with pytest.raises(ValueError, match=match):
        program.build_program(task, agg, program.EpochProgram(plan))
