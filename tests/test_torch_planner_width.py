"""Kernel eligibility follows the fused-IGD kernels' D ranges, on the CPU.

``igd_fold`` takes 1 <= D <= 4,096 and ``igd_fold_minibatch`` 1 <= D <=
12,032 (``kernels/igd_fused/kernel.py``). The planner and probe (e) ask
``igd_fused.supports``, which builds nothing, so a wide dense GLM plans on
the CPU exactly as on the card: unhinted it plans the eager fold, and a
``cuda_*`` hint past a kernel's limit raises at plan time naming the limit
(the plain versions the CPU runs have no limit, so nothing else would
show it here). A forced plan that bypasses the planner is refused when
its program is built. The eager run of a 4,097-wide query is held to the
reference's forced ``xla_fold`` run, which pads any D, with the
reference's draws replayed (rtol 1e-5, atol 1e-6)."""

import jax
import numpy as np
import pytest
import torch

from _threefry_replay import ThreefryReplay
from repro import engine as ref_engine
from repro.engine import planner as ref_planner
from repro_torch import convert, engine
from repro_torch.engine import planner, serve
from repro_torch.kernels import igd_fused
from repro_torch.kernels.igd_fused import kernel as K

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
ROWS = 64


def _arrays(n, d, seed=0):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(x @ r.normal(size=d) + 0.1 * r.normal(size=n)).astype(np.float32)
    return {"x": x, "y": y}


def _q(d, task="logreg", hints=None, n=ROWS, **kw):
    kw.setdefault("epochs", 2)
    kw.setdefault("tolerance", 0.0)
    return engine.AnalyticsQuery(task=task, data=convert.table_from_numpy(_arrays(n, d), "cpu"),
                                 task_args={"dim": d}, hints=dict(hints or {}), **kw)


@pytest.mark.parametrize("impl,d,why", [
    ("cuda_fused", 1, None), ("cuda_fused", 4_096, None), ("cuda_fused", 4_097, "4096"),
    ("cuda_fused", 0, "4096"), ("cuda_minibatch", 4_097, None), ("cuda_minibatch", 12_032, None),
    ("cuda_minibatch", 12_033, "12032"), ("torch_fold", 100_000, None),
])
def test_supports_reads_the_kernels_limits(impl, d, why):
    got = igd_fused.supports(impl, d)
    if why is None:
        assert got is None
    else:
        assert why in got and f"D={d}" in got
    assert (K.FOLD_MAX_DIM, K.MINIBATCH_MAX_DIM) == (4_096, 12_032)
    with pytest.raises(ValueError, match="unknown implementation"):
        igd_fused.supports("pallas_fused", 54)


@pytest.mark.parametrize("d,priced", [(4_096, {"cuda_fused", "cuda_minibatch"}), (4_097, {"cuda_minibatch"}),
                                      (12_033, set())])
def test_probe_prices_only_the_kernels_that_take_the_width(d, priced):
    report = engine.Engine(device="cpu").explain(_q(d))
    assert set(report.calibration.impl_per_row) == priced


@pytest.mark.parametrize("task", ["logreg", "svm", "least_squares"])
def test_wide_query_plans_without_a_cuda_fused_candidate(task):
    report = engine.Engine(device="cpu").explain(_q(4_097, task))
    assert report.chosen.implementation == "torch_fold"
    assert {c.plan.implementation for c in report.candidates} == {"torch_fold"}


def test_cuda_fused_hint_past_its_limit_raises_naming_4096():
    with pytest.raises(ValueError, match=r"4096 \(FOLD_MAX_DIM\); this query has D=4097"):
        engine.Engine(device="cpu").explain(_q(4_097, hints={"implementation": "cuda_fused"}))
    # cuda_minibatch still takes this width
    plan = engine.Engine(device="cpu").explain(_q(4_097, hints={"implementation": "cuda_minibatch"})).chosen
    assert plan.implementation == "cuda_minibatch"


def test_cuda_minibatch_hint_past_its_limit_raises_naming_12032():
    for impl, limit in (("cuda_minibatch", "12032"), ("cuda_fused", "4096")):
        with pytest.raises(ValueError, match=f"{limit}.*D=12033"):
            engine.Engine(device="cpu").explain(_q(12_033, "least_squares", hints={"implementation": impl}))


def test_sharded_hint_past_the_limit_raises_at_plan_time():
    hints = {"parallelism": "sharded", "num_shards": 2, "implementation": "cuda_fused"}
    with pytest.raises(ValueError, match="4096"):
        engine.Engine(device="cpu").explain(_q(4_097, hints=hints))


@pytest.mark.parametrize("plan", [
    planner.Plan("clustered", "serial", implementation="cuda_fused"),
    planner.Plan("shuffle_always", "serial", implementation="cuda_fused", parallelism="sharded", num_shards=2),
], ids=["singleton", "sharded"])
def test_forced_plan_past_the_limit_is_refused_before_a_launch(plan):
    with pytest.raises(ValueError, match="4096"):
        engine.Engine(device="cpu").run(_q(4_097), plan=plan)


def test_served_wide_queries_plan_the_eager_fold_and_a_forced_kernel_fails_its_ticket():
    eng = engine.Engine(device="cpu")
    srv = serve.ServingEngine(serve.ServeConfig(max_batch=4, flight_capacity=0), engine=eng)
    data = convert.table_from_numpy(_arrays(ROWS, 4_097), "cpu")
    qs = [engine.AnalyticsQuery(task="logreg", data=data, task_args={"dim": 4_097}, epochs=1, tolerance=0.0,
                                seed=s, hints={"ordering": "shuffle_always", "scheme": "serial"})
          for s in range(3)]
    bad = engine.AnalyticsQuery(task="logreg", data=data, task_args={"dim": 4_097}, epochs=1, tolerance=0.0,
                                hints={"implementation": "cuda_fused"})
    tickets = [srv.submit(q) for q in qs + [bad]]
    srv.drain()
    assert [t.result.batch_size for t in tickets[:3]] == [3, 3, 3]
    assert tickets[0].result.plan.implementation == "torch_fold"
    assert tickets[3].result is None and "4096" in tickets[3].error


def test_wide_torch_fold_run_matches_the_reference():
    """D = 4,097: the port's forced torch_fold run equals the reference's
    forced xla_fold run (its kernels pad any D; the eager folds do not
    need to)."""
    arrays = _arrays(ROWS, 4_097)
    for ordering in ("clustered", "shuffle_always"):
        ref_res = ref_engine.Engine().run(
            ref_engine.AnalyticsQuery(task="logreg", data={k: jax.numpy.asarray(v) for k, v in arrays.items()},
                                      task_args={"dim": 4_097}, epochs=2, tolerance=0.0),
            plan=ref_planner.Plan(ordering, "serial", implementation="xla_fold"))
        res = engine.Engine(device="cpu", draws=ThreefryReplay()).run(
            engine.AnalyticsQuery(task="logreg", data=convert.table_from_numpy(arrays, "cpu"),
                                  task_args={"dim": 4_097}, epochs=2, tolerance=0.0),
            plan=planner.Plan(ordering, "serial", implementation="torch_fold"))
        assert res.epochs == ref_res.epochs == 2
        np.testing.assert_allclose(res.model.numpy(), np.asarray(ref_res.model), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res.losses, ref_res.losses, rtol=RTOL, atol=ATOL)
