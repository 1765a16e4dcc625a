"""The port's UDA fold and aggregate against repro.core.uda, and the
CA-TX closed form as an exact check of the port's fold alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tasks as ref_tasks
from repro.core import igd as ref_igd, uda as ref_uda
from repro_torch import convert, tasks
from repro_torch.core import igd, ordering, uda

torch.set_num_threads(1)

# engine-run tolerance of the reference (tests/test_implementation.py)
RTOL, ATOL = 1e-5, 1e-6


def _table(seed=0, n=160, d=6):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(r.normal(size=n)).astype(np.float32)
    return {"x": x, "y": y}


@pytest.mark.parametrize("name,mu", [("LogisticRegression", 0.0), ("LogisticRegression", 0.01),
                                     ("SVM", 0.0), ("LeastSquares", None)])
def test_fold_matches_reference(name, mu):
    data = _table()
    kw = {"dim": 6} if mu is None else {"dim": 6, "mu": mu}
    prox_ref = ref_igd.make_l1_prox(mu) if mu else ref_igd.identity_prox
    prox = igd.make_l1_prox(mu) if mu else igd.identity_prox
    ragg = ref_uda.IGDAggregate(getattr(ref_tasks, name)(**kw), ref_igd.diminishing(0.3, decay=160), prox_ref)
    agg = uda.IGDAggregate(getattr(tasks, name)(**kw), igd.diminishing(0.3, decay=160), prox)
    w0 = np.random.default_rng(9).normal(size=6).astype(np.float32) * 0.1
    rstate = ref_uda.IGDState(jnp.asarray(w0), jnp.int32(40), jnp.float32(40.0))
    want = ref_uda.fold(ragg, rstate, {k: jnp.asarray(v) for k, v in data.items()})
    state = convert.state_from_numpy(*(np.asarray(a) for a in rstate), device="cpu")
    got = uda.fold(agg, state, convert.table_from_numpy(data, "cpu"))
    np.testing.assert_allclose(got.model.numpy(), np.asarray(want.model), rtol=RTOL, atol=ATOL)
    assert int(got.step) == int(want.step) == 200
    assert float(got.weight) == float(want.weight) == 200.0
    assert got.step.dtype == torch.int32 and got.weight.dtype == torch.float32


@pytest.mark.parametrize("wa,wb", [(3.0, 1.0), (0.0, 0.0), (0.0, 5.0)])
def test_merge_matches_reference(wa, wb):
    r = np.random.default_rng(1)
    a, b = r.normal(size=4).astype(np.float32), r.normal(size=4).astype(np.float32)
    ragg = ref_uda.IGDAggregate(ref_tasks.SVM(dim=4), ref_igd.constant(0.1))
    agg = uda.IGDAggregate(tasks.SVM(dim=4), igd.constant(0.1))
    rs = [ref_uda.IGDState(jnp.asarray(m), jnp.int32(s), jnp.float32(w))
          for m, s, w in ((a, 7, wa), (b, 9, wb))]
    want = ragg.merge(*rs)
    got = agg.merge(*(convert.state_from_numpy(*(np.asarray(v) for v in s), "cpu") for s in rs))
    np.testing.assert_allclose(got.model.numpy(), np.asarray(want.model), rtol=1e-6, atol=1e-7)
    assert int(got.step) == int(want.step) and float(got.weight) == float(want.weight)
    assert torch.equal(agg.terminate(got), got.model)


def test_initialize_is_zero_state_on_generator_device():
    agg = uda.IGDAggregate(tasks.LogisticRegression(dim=3), igd.constant(0.1))
    s = agg.initialize(torch.Generator())
    assert torch.equal(s.model, torch.zeros(3))
    assert s.step.dtype == torch.int32 and int(s.step) == 0
    assert s.weight.dtype == torch.float32 and float(s.weight) == 0.0


@pytest.mark.parametrize("n,alpha,w0", [(200, 0.05, 0.3), (50, 0.2, -1.0), (1000, 0.01, 0.0)])
def test_catx_closed_form_is_the_ports_fold(n, alpha, w0):
    """Appendix C: one clustered epoch over CA-TX lands exactly on the
    closed form — an exact check of the port's fold with no reference
    run."""
    data = ordering.make_catx_dataset(n, device="cpu")
    agg = uda.IGDAggregate(tasks.LeastSquares(dim=1), igd.constant(alpha))
    state = convert.state_from_numpy(np.array([w0]), 0, 0.0, "cpu")
    out = uda.fold(agg, state, data)
    np.testing.assert_allclose(float(out.model[0]), ordering.catx_closed_form(w0, alpha, n), rtol=1e-4, atol=1e-6)


def test_convert_keeps_dtypes_and_device():
    t = convert.table_from_numpy({"x": np.ones((3, 2), np.float32), "i": np.arange(3, dtype=np.int32)}, "cpu")
    assert t["x"].dtype == torch.float32 and t["i"].dtype == torch.int32
    s = convert.state_from_numpy(np.zeros(2), np.int32(4), np.float32(4), "cpu")
    assert s.model.dtype == torch.float32 and s.step.dtype == torch.int32 and int(s.step) == 4


def _lmf_aggs(n_rows=7, n_cols=5, rank=2):
    kw = {"n_rows": n_rows, "n_cols": n_cols, "rank": rank, "mu": 0.05, "mean_row_degree": 3.0, "mean_col_degree": 4.0}
    return (ref_uda.IGDAggregate(ref_tasks.LowRankMF(**kw), ref_igd.diminishing(0.2, decay=40)),
            uda.IGDAggregate(tasks.LowRankMF(**kw), igd.diminishing(0.2, decay=40)))


def _lmf_state(seed, step=3, weight=3.0):
    r = np.random.default_rng(seed)
    model = {"R": r.normal(size=(5, 2)).astype(np.float32), "L": r.normal(size=(7, 2)).astype(np.float32)}
    return (ref_uda.IGDState({k: jnp.asarray(v) for k, v in model.items()}, jnp.int32(step), jnp.float32(weight)),
            convert.state_from_numpy(model, step, weight, "cpu"))


def _ratings(n=40, seed=2):
    r = np.random.default_rng(seed)
    return {"i": r.integers(0, 7, n).astype(np.int32), "j": r.integers(0, 5, n).astype(np.int32),
            "v": r.normal(size=n).astype(np.float32)}


@pytest.mark.parametrize("wa,wb", [(3.0, 1.0), (0.0, 0.0)])
def test_merge_of_dict_models_matches_reference(wa, wb):
    ragg, agg = _lmf_aggs()
    (ra, a), (rb, b) = _lmf_state(1, 7, wa), _lmf_state(2, 9, wb)
    want, got = ragg.merge(ra, rb), agg.merge(a, b)
    for k in ("L", "R"):
        np.testing.assert_allclose(got.model[k].numpy(), np.asarray(want.model[k]), rtol=1e-6, atol=1e-7)
    assert int(got.step) == int(want.step) == 9 and float(got.weight) == float(want.weight)


@pytest.mark.parametrize("k", [1, 4])
def test_fold_and_segmented_fold_of_a_dict_model_match_reference(k):
    """LMF's factors through the fold and the shared-nothing lanes
    (``torch.func.vmap`` over the fold, merged leaf by leaf)."""
    ragg, agg = _lmf_aggs()
    rs, s = _lmf_state(3)
    data = _ratings()
    rdata = {c: jnp.asarray(v) for c, v in data.items()}
    tdata = convert.table_from_numpy(data, "cpu")
    want = ref_uda.fold(ragg, rs, rdata) if k == 1 else ref_uda.segmented_fold(ragg, rs, rdata, k)
    got = uda.fold(agg, s, tdata) if k == 1 else uda.segmented_fold(agg, s, tdata, k)
    for c in ("L", "R"):
        np.testing.assert_allclose(got.model[c].numpy(), np.asarray(want.model[c]), rtol=RTOL, atol=ATOL)
    assert int(got.step) == int(want.step) and float(got.weight) == float(want.weight) == 43.0
