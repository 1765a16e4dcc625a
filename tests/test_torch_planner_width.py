"""The fused-IGD kernels take every D >= 1, and the planner knows it, on
the CPU.

``igd_fold`` and ``igd_fold_minibatch`` have wide instances past their
narrow ones (``kernels/igd_fused/kernel.py``: the register fold ends at
D = 4,096, the minibatch's row-share cluster at 256), so
``igd_fused.supports`` answers None for any D >= 1. The planner and probe
(e) ask it, and it builds nothing, so a wide dense GLM plans on the CPU
exactly as on the card: probe (e) prices both kernels, the kernel lane is
a candidate beside the eager fold, and a ``cuda_*`` hint plans; a hint is
refused only for an aggregate the kernels cannot lower (an L1 prox) or a
D below 1. On the CPU the kernel lanes run their plain versions, and
those runs are held to the reference's engine running its Pallas kernels
(interpret mode) with its draws replayed (rtol 1e-5, atol 1e-6)."""

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


def _q(d, task="logreg", hints=None, n=ROWS, task_args=None, **kw):
    kw.setdefault("epochs", 2)
    kw.setdefault("tolerance", 0.0)
    return engine.AnalyticsQuery(task=task, data=convert.table_from_numpy(_arrays(n, d), "cpu"),
                                 task_args={"dim": d, **(task_args or {})}, hints=dict(hints or {}), **kw)


@pytest.mark.parametrize("impl,d,why", [
    ("cuda_fused", 1, None), ("cuda_fused", 4_096, None), ("cuda_fused", 4_097, None),
    ("cuda_fused", 0, "D >= 1"), ("cuda_minibatch", 4_097, None), ("cuda_minibatch", 12_032, None),
    ("cuda_minibatch", 12_033, None), ("torch_fold", 100_000, None),
])
def test_supports_reads_the_kernels_limits(impl, d, why):
    got = igd_fused.supports(impl, d)
    if why is None:
        assert got is None
    else:
        assert why in got and f"D={d}" in got
    # the narrow instances' ends are instance boundaries now, not limits
    assert (K.FOLD_REGISTER_MAX_DIM, K.MINIBATCH_CLUSTER_MAX_DIM, K.MINIBATCH_RESIDENT_MAX_DIM) == (4_096, 256, 1_424)
    assert igd_fused.supports(impl, 10 ** 6) is None
    with pytest.raises(ValueError, match="unknown implementation"):
        igd_fused.supports("pallas_fused", 54)


@pytest.mark.parametrize("d", [4_096, 4_097, 12_033])
def test_probe_prices_both_kernels_at_any_width(d):
    report = engine.Engine(device="cpu").explain(_q(d))
    assert set(report.calibration.impl_per_row) == {"cuda_fused", "cuda_minibatch"}


@pytest.mark.parametrize("task", ["logreg", "svm", "least_squares"])
def test_wide_query_enumerates_the_cuda_fused_candidate(task):
    """Unhinted, the kernel lane stands beside the eager fold and the
    probe-priced ranking picks (cuda_minibatch is never auto-chosen)."""
    report = engine.Engine(device="cpu").explain(_q(4_097, task))
    assert {c.plan.implementation for c in report.candidates} == {"torch_fold", "cuda_fused"}
    assert report.chosen.implementation in ("torch_fold", "cuda_fused")


def test_wide_hints_plan_the_kernels_on_the_cpu_as_on_the_card():
    for d in (4_097, 12_033):
        for impl in ("cuda_fused", "cuda_minibatch"):
            plan = engine.Engine(device="cpu").explain(_q(d, "least_squares", hints={"implementation": impl})).chosen
            assert plan.implementation == impl and plan.scheme == "serial"


def test_hint_is_refused_only_for_an_ineligible_aggregate():
    """At D = 12,033 a kernel hint plans; with an L1 prox (mu > 0) the
    aggregate cannot lower through the kernel, and the hint raises; D < 1
    is the kernels' only width refusal (``supports``)."""
    assert engine.Engine(device="cpu").explain(
        _q(12_033, hints={"implementation": "cuda_fused"})).chosen.implementation == "cuda_fused"
    for impl in ("cuda_fused", "cuda_minibatch"):
        with pytest.raises(ValueError, match="not kernel-eligible"):
            engine.Engine(device="cpu").explain(_q(12_033, hints={"implementation": impl},
                                                   task_args={"mu": 1e-3}))
        assert "D >= 1" in igd_fused.supports(impl, 0)


def test_sharded_hint_at_a_wide_d_plans_kernel_lanes():
    hints = {"parallelism": "sharded", "num_shards": 2, "implementation": "cuda_fused"}
    plan = engine.Engine(device="cpu").explain(_q(4_097, hints=hints)).chosen
    assert (plan.parallelism, plan.num_shards, plan.implementation) == ("sharded", 2, "cuda_fused")


@pytest.mark.parametrize("plan", [
    planner.Plan("clustered", "serial", implementation="cuda_fused"),
    planner.Plan("shuffle_always", "serial", implementation="cuda_fused", parallelism="sharded", num_shards=2),
], ids=["singleton", "sharded"])
def test_forced_kernel_plan_at_a_wide_d_runs_as_the_eager_fold(plan):
    """A forced kernel plan at D = 4,097 runs (the kernel lanes' plain
    versions here) and equals the same plan on the eager fold: both are
    the exact per-row fold."""
    eager = planner.Plan(plan.ordering, plan.scheme, implementation="torch_fold", parallelism=plan.parallelism,
                         num_shards=plan.num_shards)
    got = engine.Engine(device="cpu").run(_q(4_097), plan=plan)
    want = engine.Engine(device="cpu").run(_q(4_097), plan=eager)
    assert got.plan.implementation == "cuda_fused" and got.epochs == want.epochs == 2
    np.testing.assert_allclose(got.model.numpy(), want.model.numpy(), rtol=RTOL, atol=ATOL)


def test_served_wide_queries_fuse_into_kernel_lanes():
    """Three wide logreg queries with the cuda_fused hint fuse into one
    batch of kernel lanes (one launch an epoch on the card); a fourth,
    unhinted, is served too."""
    eng = engine.Engine(device="cpu")
    srv = serve.ServingEngine(serve.ServeConfig(max_batch=4, flight_capacity=0), engine=eng)
    data = convert.table_from_numpy(_arrays(ROWS, 4_097), "cpu")
    qs = [engine.AnalyticsQuery(task="logreg", data=data, task_args={"dim": 4_097}, epochs=1, tolerance=0.0,
                                seed=s, hints={"ordering": "shuffle_always", "implementation": "cuda_fused"})
          for s in range(3)]
    single = engine.AnalyticsQuery(task="logreg", data=data, task_args={"dim": 4_097}, epochs=1, tolerance=0.0,
                                   hints={"implementation": "cuda_minibatch"})
    tickets = [srv.submit(q) for q in qs + [single]]
    srv.drain()
    assert [t.result.batch_size for t in tickets[:3]] == [3, 3, 3]
    assert {t.result.plan.implementation for t in tickets[:3]} == {"cuda_fused"}
    assert tickets[3].error is None and tickets[3].result.plan.implementation == "cuda_minibatch"


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


@pytest.mark.parametrize("task,d,impl,ref_impl", [
    ("logreg", 4_097, "cuda_fused", "pallas_fused"),
    ("least_squares", 12_033, "cuda_minibatch", "pallas_minibatch"),
])
def test_wide_kernel_run_matches_the_references_kernel_run(task, d, impl, ref_impl):
    """The hinted query plans the kernel lane here as on the card, and its
    run (the lane's plain version on the CPU) equals the reference's
    engine running its Pallas kernel (interpret mode) with the reference's
    draws replayed."""
    arrays = _arrays(ROWS, d, seed=1)
    for ordering in ("clustered", "shuffle_always"):
        hints = {"ordering": ordering, "implementation": impl}
        q = engine.AnalyticsQuery(task=task, data=convert.table_from_numpy(arrays, "cpu"), task_args={"dim": d},
                                  epochs=2, tolerance=0.0, hints=hints)
        eng = engine.Engine(device="cpu", draws=ThreefryReplay())
        plan = eng.explain(q).chosen
        assert (plan.implementation, plan.ordering, plan.scheme) == (impl, ordering, "serial")
        res = eng.run(q, plan=plan)
        ref_res = ref_engine.Engine().run(
            ref_engine.AnalyticsQuery(task=task, data={k: jax.numpy.asarray(v) for k, v in arrays.items()},
                                      task_args={"dim": d}, epochs=2, tolerance=0.0),
            plan=ref_planner.Plan(ordering, "serial", implementation=ref_impl))
        assert res.epochs == ref_res.epochs == 2
        np.testing.assert_allclose(res.model.numpy(), np.asarray(ref_res.model), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res.losses, ref_res.losses, rtol=RTOL, atol=ATOL)
