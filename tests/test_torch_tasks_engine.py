"""The six other techniques through repro_torch.engine against
repro.engine, end to end on the CPU, with the plan forced equal.

The same numpy table goes through both engines. The port's engine is
given ``_threefry_replay.ThreefryReplay``: its runs start from the
reference's initial model (LMF's random factors, CRF's when
``init_scale > 0``) and make the reference's draws. Kalman's planted
system is the reference's too (the ``ref_kalman_system`` fixture): the
two packages draw it from different generators. Held to the reference's
engine-run tolerance, rtol=1e-5, atol=1e-6."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _threefry_replay import ThreefryReplay
from repro import engine as ref_engine, tasks as ref_tasks
from repro.engine import planner as ref_planner
from repro_torch import convert, engine
from repro_torch.engine import catalog, planner
from repro_torch.tasks import kalman

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
ORDERINGS = ("clustered", "shuffle_once", "shuffle_always")


def _table(name, seed=0):
    """(numpy table, task_args) at a few dozen rows."""
    r = np.random.default_rng(seed)
    if name in ("sparse_logreg", "sparse_svm"):
        idx = r.integers(0, 30, size=(48, 4)).astype(np.int32)
        idx[::4, -1] = -1
        y = np.concatenate([np.ones(24), -np.ones(24)]).astype(np.float32)
        val = (np.abs(r.normal(size=(48, 4))) * y[:, None]).astype(np.float32)
        return {"idx": idx, "val": val, "y": y}, {"dim": 30, "mu": 0.01}
    if name == "lmf":
        i = np.sort(r.integers(0, 10, 48)).astype(np.int32)
        data = {"i": i, "j": r.integers(0, 8, 48).astype(np.int32), "v": r.normal(size=48).astype(np.float32)}
        return data, {"n_rows": 10, "n_cols": 8, "rank": 3, "mu": 0.01}
    if name == "crf":
        y = r.integers(0, 3, size=(12, 5)).astype(np.int32)
        x = (np.eye(3, 4)[y] + 0.5 * r.normal(size=(12, 5, 4))).astype(np.float32)
        mask = np.ones((12, 5), np.float32)
        mask[2, 3:] = 0.0
        return {"x": x, "y": y, "mask": mask}, {"n_labels": 3, "feat_dim": 4}
    if name == "kalman":
        return ({"t": np.arange(32, dtype=np.int32), "y": r.normal(size=(32, 2)).astype(np.float32)},
                {"horizon": 32, "state_dim": 3, "obs_dim": 2, "c_seed": 1})
    r_ = r.normal(size=(48, 6)).astype(np.float32)
    return ({"r": r_ - r_.mean(0)},
            {"n_assets": 6, "expected_returns": tuple(float(x) for x in np.linspace(-0.1, 0.1, 6))})


def _pair(name, epochs=2, seed=0, task_args=None, **kw):
    data, args = _table(name, seed)
    args.update(task_args or {})
    kw.setdefault("tolerance", 0.0)
    common = dict(task=name, task_args=args, epochs=epochs, seed=seed, **kw)
    return (ref_engine.AnalyticsQuery(data={k: jax.numpy.asarray(v) for k, v in data.items()}, **common),
            engine.AnalyticsQuery(data=convert.table_from_numpy(data, "cpu"), **common))


@pytest.fixture(autouse=True)
def ref_kalman_system(monkeypatch):
    def planted(c_seed, state_dim, obs_dim, device):
        c, a = ref_tasks.KalmanFilterTask(1, state_dim, obs_dim, c_seed=c_seed)._mats()
        return torch.tensor(np.asarray(c), device=device), torch.tensor(np.asarray(a), device=device)

    monkeypatch.setattr(kalman, "system_matrices", planted)


@pytest.fixture(scope="module")
def ref_eng():
    return ref_engine.Engine()


@pytest.fixture(scope="module")
def eng():
    return engine.Engine(device="cpu", draws=ThreefryReplay())


def _assert_same(res, ref_res):
    assert res.epochs == ref_res.epochs
    want = jax.tree.map(np.asarray, ref_res.model)
    if isinstance(res.model, dict):
        assert sorted(res.model) == sorted(want)
        for k in res.model:
            np.testing.assert_allclose(res.model[k].numpy(), want[k], rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(res.model.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res.losses, ref_res.losses, rtol=RTOL, atol=ATOL)


NEW = ("crf", "kalman", "lmf", "portfolio", "sparse_logreg", "sparse_svm")


def test_catalog_has_the_references_techniques():
    assert catalog.names() == ref_engine.names() == sorted(NEW + ("least_squares", "logreg", "svm"))
    for name in NEW:
        spec, ref_spec = catalog.get(name), ref_engine.get(name)
        assert spec.factory.__name__ == ref_spec.factory.__name__
        assert spec.nonconvex == ref_spec.nonconvex and spec.kernel_loss is ref_spec.kernel_loss is None
        for n in (1, 48, 1000):
            assert dataclasses.astuple(spec.step_size(n)) == dataclasses.astuple(ref_spec.step_size(n))


def test_lmf_degrees_are_derived_from_the_table(ref_eng, eng):
    ref_q, q = _pair("lmf")
    _, ref_task, _ = ref_eng._aggregate_for(ref_q)
    task, agg = eng._aggregate_for(q)
    assert (task.mean_row_degree, task.mean_col_degree) == (ref_task.mean_row_degree, ref_task.mean_col_degree)
    assert (task.mean_row_degree, task.mean_col_degree) == (4.8, 6.0)  # 48 ratings over 10 rows, 8 columns
    pinned = dict(q.task_args, mean_row_degree=2.0)
    task, _ = eng._aggregate_for(engine.AnalyticsQuery(task="lmf", data=q.data, task_args=pinned))
    assert (task.mean_row_degree, task.mean_col_degree) == (2.0, 1.0)  # an explicit choice wins
    assert agg.prox is catalog.igd.identity_prox  # no L2 prox on top of the local penalty


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("name", NEW)
def test_serial_run_matches_reference(name, ordering, ref_eng, eng):
    ref_q, q = _pair(name)
    ref_res = ref_eng.run(ref_q, plan=ref_planner.Plan(ordering, "serial"))
    res = eng.run(q, plan=planner.Plan(ordering, "serial"))
    assert res.plan.scheme == "serial" and res.kernel_launches == 0
    _assert_same(res, ref_res)


@pytest.mark.parametrize("scheme,fields", [
    ("segmented", {"num_segments": 2}), ("segmented", {"num_segments": 8}),
    ("shared_memory", {"sm_scheme": "lock"}), ("shared_memory", {"sm_scheme": "aig"}),
    ("shared_memory", {"sm_scheme": "nolock"}), ("mrs", {"mrs_buffer": 6}),
])
def test_lmf_scheme_run_matches_reference(scheme, fields, ref_eng, eng):
    """A dict model through every non-serial scheme: the merged factors,
    the raveled shared-memory ring and the MRS fold."""
    ref_q, q = _pair("lmf", epochs=3, seed=4)
    ordering = "clustered" if scheme == "mrs" else "shuffle_once"
    ref_res = ref_eng.run(ref_q, plan=ref_planner.Plan(ordering, scheme, **fields))
    res = eng.run(q, plan=planner.Plan(ordering, scheme, **fields))
    assert res.plan.scheme == scheme and sorted(res.model) == ["L", "R"]
    _assert_same(res, ref_res)


@pytest.mark.parametrize("name,plan", [("crf", {"ordering": "shuffle_always", "scheme": "serial"}),
                                       ("crf", {"ordering": "shuffle_once", "scheme": "segmented",
                                                "num_segments": 4}),
                                       ("portfolio", {"ordering": "shuffle_once", "scheme": "shared_memory",
                                                      "sm_scheme": "aig"}),
                                       ("sparse_svm", {"ordering": "clustered", "scheme": "mrs", "mrs_buffer": 8})])
def test_other_plans_match_reference(name, plan, ref_eng, eng):
    """A random CRF initial model (init_scale > 0) replayed, and the
    simplex and L1 proxes under the non-serial schemes."""
    args = {"init_scale": 0.2} if name == "crf" else {}
    ref_q, q = _pair(name, epochs=2, seed=3, task_args=args)
    ref_res = ref_eng.run(ref_q, plan=ref_planner.Plan(**plan))
    res = eng.run(q, plan=planner.Plan(**plan))
    _assert_same(res, ref_res)


def test_stop_rule_run_matches_reference(ref_eng, eng):
    ref_q, q = _pair("lmf", epochs=30, tolerance=1e-2)
    ref_res = ref_eng.run(ref_q, plan=ref_planner.Plan("shuffle_always", "serial"))
    res = eng.run(q, plan=planner.Plan("shuffle_always", "serial"))
    assert res.converged and ref_res.converged and len(res.losses) == res.epochs
    _assert_same(res, ref_res)


@pytest.mark.parametrize("name", NEW)
def test_planned_run_on_the_ports_probes(name):
    """No hints: the port's planner probes the dict or sparse table and
    runs what it chose; the loss drops from the initial model. Ratings,
    CRF's and Kalman's 2-D labels have no clusteredness statistic."""
    _, q = _pair(name, epochs=3)
    eng = engine.Engine(device="cpu")
    res = eng.run(q)
    task, agg = eng._aggregate_for(q)
    loss0 = float(task.full_loss(eng.draws.stream(q.seed, q.n_examples, "cpu").initial_model(task), q.data))
    assert res.losses[-1] < loss0 and res.report.calibration.impl_per_row == {}
    if name in ("lmf", "crf", "kalman", "portfolio"):
        assert res.report.clusteredness == 0.0


@pytest.mark.parametrize("k,h", [(2, 1), (4, 2)])
@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("name", NEW)
def test_sharded_run_matches_reference(name, ordering, k, h, ref_eng, eng):
    """sharded(k, H) local SGD for the six techniques: k shared-nothing
    shards of the eager fold, merged every H epochs (3 epochs: a short
    last block at H = 2), the plans forced equal."""
    ref_q, q = _pair(name, epochs=3)
    fields = dict(parallelism="sharded", num_shards=k, merge_period=h)
    ref_res = ref_eng.run(ref_q, plan=ref_planner.Plan(ordering, "serial", **fields))
    res = eng.run(q, plan=planner.Plan(ordering, "serial", **fields))
    assert res.plan.parallelism == "sharded" and res.kernel_launches == 0
    _assert_same(res, ref_res)
