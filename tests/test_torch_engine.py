"""repro_torch.engine against repro.engine, end to end on the CPU.

The same table (made with numpy from a seed) goes through both engines.
The port's engine is given a permutation source that replays the
reference's threefry stream, so the shuffle orderings fold the same rows
in the same order, and each port implementation is held to its
reference counterpart: torch_fold <-> xla_fold, cuda_fused <->
pallas_fused, cuda_minibatch <-> pallas_minibatch (on the CPU the cuda_*
lanes run the kernels' plain versions; the reference runs its Pallas
kernels in interpret mode). Mirrors tests/test_implementation.py.
"""

import jax
import numpy as np
import pytest
import torch

from repro import engine as ref_engine
from repro.core import ordering as ref_ordering
from repro.engine.program import PERM_STREAM_SALT
from repro_torch import convert, engine
from repro_torch.core import ordering
from repro_torch.engine import planner, probes, program

torch.set_num_threads(1)

ORDERINGS = ("clustered", "shuffle_once", "shuffle_always")
TASKS = ("logreg", "svm", "least_squares")
IMPLS = {"torch_fold": "xla_fold", "cuda_fused": "pallas_fused", "cuda_minibatch": "pallas_minibatch"}
# the reference's engine-run tolerance (tests/test_implementation.py)
RTOL, ATOL = 1e-5, 1e-6


class ThreefryReplay:
    """The reference executor's permutation stream: perm_rng =
    fold_in(PRNGKey(seed), 0x5EED); each shuffle splits it (rng, sub) and
    permutes with sub; the executor then splits rng once per epoch. Every
    draw of the port's orderings happens at an epoch's start, so draw k
    is the reference's k-th shuffle."""

    def stream(self, seed, n, device):
        key = [jax.random.fold_in(jax.random.PRNGKey(seed), PERM_STREAM_SALT)]

        def draw():
            rng, sub = jax.random.split(key[0])
            perm = np.asarray(jax.random.permutation(sub, n))
            key[0] = jax.random.split(rng)[0]
            return torch.tensor(perm, dtype=torch.int64, device=device)

        return draw


def _table(n=96, d=4, seed=0):
    """Label-clustered dense rows made with numpy (+1 first)."""
    r = np.random.default_rng(seed)
    w = r.normal(size=d) / np.sqrt(d)
    y = np.concatenate([np.ones(n // 2), -np.ones(n - n // 2)]).astype(np.float32)
    x = r.normal(size=(n, d)) / np.sqrt(d)
    x = x + ((y - x @ w) / np.sum(w**2))[:, None] * w[None, :] + 0.5 * r.normal(size=(n, d)) / np.sqrt(d)
    return {"x": x.astype(np.float32), "y": y}


def _pair(data, task="logreg", epochs=3, hints=None, **kw):
    kw.setdefault("tolerance", 0.0)
    args = dict(task=task, task_args={"dim": data["x"].shape[1]}, epochs=epochs, **kw)
    ref_q = ref_engine.AnalyticsQuery(data={k: jax.numpy.asarray(v) for k, v in data.items()},
                                      hints=dict(hints or {}), **args)
    port_hints = {k: v for k, v in (hints or {}).items() if k != "scheme"}
    if "implementation" in port_hints:
        port_hints["implementation"] = {v: k for k, v in IMPLS.items()}[port_hints["implementation"]]
    port_q = engine.AnalyticsQuery(data=convert.table_from_numpy(data, "cpu"), hints=port_hints, **args)
    return ref_q, port_q


@pytest.fixture(scope="module")
def ref_eng():
    return ref_engine.Engine()


@pytest.fixture(scope="module")
def eng():
    return engine.Engine(device="cpu", permutations=ThreefryReplay())


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
    clustered = [c for c in rep.candidates if c.plan.ordering == "clustered"]
    assert clustered and all(c.cost_seconds > 10 * best for c in clustered)
    text = rep.describe()
    assert "plan   :" in text and "reject :" in text and "impl-probed" in text
    assert "torch_fold" in text and "cuda_fused" in text and "us/epoch" in text


def test_catx_plans_shuffle_once_on_the_references_constants():
    """Which shuffle wins depends on the measured rates: the eager fold on
    a CPU is ~500x slower than XLA's scan, which makes the per-epoch
    reshuffle cheap next to the fold. Given the constants the reference
    measured, the port's cost model must price every serial candidate
    exactly as the reference does and plan shuffle_once as it does."""
    ref_rep = ref_engine.Engine().explain(
        ref_engine.AnalyticsQuery(**_catx_query(ref_ordering.make_catx_dataset(512))))
    rc = ref_rep.calibration
    cal = probes.Calibration(
        shuffle_per_row=rc.shuffle_per_row, fold_per_row=rc.fold_per_row[rc.best_unroll()],
        merge_seconds=rc.merge_seconds, probe_rows=rc.probe_rows,
        impl_per_row={"cuda_fused": rc.impl_per_row["pallas_fused"],
                      "cuda_minibatch": rc.impl_per_row["pallas_minibatch"]},
    )
    rep = planner.plan(engine.AnalyticsQuery(**_catx_query(ordering.make_catx_dataset(512, device="cpu"))), cal)
    assert rep.chosen.ordering == ref_rep.chosen.ordering == "shuffle_once"
    assert rep.clusteredness == ref_rep.clusteredness
    ref_serial = {(c.plan.ordering, c.plan.implementation): c.cost_seconds for c in ref_rep.candidates
                  if c.plan.scheme == "serial" and c.plan.parallelism == "singleton"}
    assert len(rep.candidates) == 6
    for c in rep.candidates:
        want = ref_serial[(c.plan.ordering, IMPLS[c.plan.implementation])]
        assert c.cost_seconds == pytest.approx(want, rel=1e-12)


def test_planner_prices_implementations_from_probes():
    rep = engine.Engine(device="cpu").explain(_pair(_table(), "svm")[1])
    rates = rep.calibration.impl_per_row
    assert rates.get("cuda_fused", 0.0) > 0.0 and rates.get("cuda_minibatch", 0.0) > 0.0
    impls = {c.plan.implementation for c in rep.candidates}
    assert impls == {"torch_fold", "cuda_fused"}  # minibatch is hint-only
    assert len(rep.candidates) == 6


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
    ({"scheme": "segmented"}, NotImplementedError),
    ({"scheme": "mrs"}, NotImplementedError),
    ({"parallelism": "sharded"}, NotImplementedError),
    ({"source": "table"}, NotImplementedError),
    ({"num_shards": 2}, NotImplementedError),
])
def test_bad_or_later_hints_raise(hints, exc):
    q = engine.AnalyticsQuery(task="svm", data=convert.table_from_numpy(_table(), "cpu"),
                              task_args={"dim": 4}, hints=hints)
    with pytest.raises(exc):
        engine.Engine(device="cpu").explain(q)


def test_memory_budget_over_table_raises_until_mrs_is_ported():
    q = engine.AnalyticsQuery(task="svm", data=convert.table_from_numpy(_table(), "cpu"),
                              task_args={"dim": 4}, memory_budget_bytes=64)
    with pytest.raises(NotImplementedError, match="mrs"):
        engine.Engine(device="cpu").explain(q)


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
