"""The port's other techniques (sparse LR/SVM, LMF, CRF, Kalman,
portfolio) against the JAX package's on the CPU: each task's
``example_loss``, ``example_grad`` and ``full_loss`` on the same numpy
inputs made from a seed, with the models carried across by
``convert.model_from_numpy``; CRF's Viterbi decode; the sparse-update
and simplex properties the reference's own tests check; and the
synthetic generators, whose streams differ from JAX's by design and are
checked statistically."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tasks as ref_tasks
from repro_torch import convert, tasks
from repro_torch.core import igd
from repro_torch.data import synthetic
from repro_torch.tasks import kalman

torch.set_num_threads(1)

# the reference's engine-run tolerance (tests/test_implementation.py)
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = {k: np.asarray(v) for k, v in want.items()} if isinstance(want, dict) else np.asarray(want)
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=rtol, atol=atol)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def _sparse(r, n=24, dim=40, nnz=6):
    idx = r.integers(0, dim, size=(n, nnz)).astype(np.int32)
    idx[::3, -2:] = -1  # padded rows
    return {"idx": idx, "val": r.normal(size=(n, nnz)).astype(np.float32),
            "y": np.sign(r.normal(size=n)).astype(np.float32)}


def _crf(r, n=6, length=7, labels=4, feats=5):
    mask = np.ones((n, length), np.float32)
    mask[1, 5:] = 0.0  # a shorter sentence
    mask[3, 2:] = 0.0
    return {"x": r.normal(size=(n, length, feats)).astype(np.float32),
            "y": r.integers(0, labels, size=(n, length)).astype(np.int32), "mask": mask}


@pytest.fixture
def ref_kalman_system(monkeypatch):
    """Plant the reference's system (C, A) in the port's Kalman task: the
    two packages draw it from different generators."""

    def planted(c_seed, state_dim, obs_dim, device):
        c, a = ref_tasks.KalmanFilterTask(1, state_dim, obs_dim, c_seed=c_seed)._mats()
        return torch.tensor(np.asarray(c), device=device), torch.tensor(np.asarray(a), device=device)

    monkeypatch.setattr(kalman, "system_matrices", planted)


def _cases(name, r):
    """(reference task, port task, model as numpy, table as numpy)."""
    if name in ("sparse_logreg", "sparse_svm"):
        cls = "SparseLogisticRegression" if name == "sparse_logreg" else "SparseSVM"
        kw = {"dim": 40, "mu": 0.01}
        model = (r.normal(size=40) * 0.3).astype(np.float32)
        data = _sparse(r)
    elif name == "lmf":
        cls, kw = "LowRankMF", {"n_rows": 12, "n_cols": 9, "rank": 3, "mu": 0.02,
                                "mean_row_degree": 2.5, "mean_col_degree": 3.0}
        model = {"R": r.normal(size=(9, 3)).astype(np.float32), "L": r.normal(size=(12, 3)).astype(np.float32)}
        data = {"i": r.integers(0, 12, 30).astype(np.int32), "j": r.integers(0, 9, 30).astype(np.int32),
                "v": r.normal(size=30).astype(np.float32)}
    elif name == "crf":
        cls, kw = "LinearChainCRF", {"n_labels": 4, "feat_dim": 5}
        model = {"T": r.normal(size=(4, 4)).astype(np.float32), "E": r.normal(size=(4, 5)).astype(np.float32)}
        data = _crf(r)
    elif name == "kalman":
        cls, kw = "KalmanFilterTask", {"horizon": 20, "state_dim": 4, "obs_dim": 3, "c_seed": 3,
                                       "smooth_weight": 0.7}
        model = r.normal(size=(20, 4)).astype(np.float32)
        data = {"t": np.arange(20, dtype=np.int32), "y": r.normal(size=(20, 3)).astype(np.float32)}
    else:
        p = tuple(float(x) for x in np.linspace(-0.1, 0.1, 8))
        cls, kw = "PortfolioOpt", {"n_assets": 8, "expected_returns": p, "risk_weight": 1.5}
        model = np.abs(r.normal(size=8)).astype(np.float32)
        model /= model.sum()
        data = {"r": r.normal(size=(24, 8)).astype(np.float32)}
    return getattr(ref_tasks, cls)(**kw), getattr(tasks, cls)(**kw), model, data


NAMES = ("sparse_logreg", "sparse_svm", "lmf", "crf", "kalman", "portfolio")


@pytest.mark.parametrize("name", NAMES)
def test_loss_grad_and_full_loss_match_reference(name, ref_kalman_system):
    rtask, task, model, data = _cases(name, np.random.default_rng(NAMES.index(name)))
    rmodel, m = jax.tree.map(jnp.asarray, model), convert.model_from_numpy(model, "cpu")
    n = next(iter(data.values())).shape[0]
    rloss, rgrad = jax.jit(rtask.example_loss), jax.jit(rtask.example_grad)
    for i in (0, 1, 3, n - 1):
        rex = {k: jnp.asarray(v[i]) for k, v in data.items()}
        ex = convert.table_from_numpy({k: v[i] for k, v in data.items()}, "cpu")
        _close(task.example_loss(m, ex), rloss(rmodel, rex))
        _close(task.example_grad(m, ex), rgrad(rmodel, rex))
    _close(task.full_loss(m, convert.table_from_numpy(data, "cpu")),
           rtask.full_loss(rmodel, {k: jnp.asarray(v) for k, v in data.items()}))


@pytest.mark.parametrize("init_scale", [0.0, 0.5])
def test_crf_decode_matches_reference(init_scale):
    r = np.random.default_rng(11)
    rtask = ref_tasks.LinearChainCRF(n_labels=4, feat_dim=5, init_scale=init_scale)
    task = tasks.LinearChainCRF(n_labels=4, feat_dim=5, init_scale=init_scale)
    model = jax.tree.map(np.asarray, rtask.init_model(jax.random.PRNGKey(2)))
    if init_scale == 0.0:
        model = {k: r.normal(size=v.shape).astype(np.float32) for k, v in model.items()}
    data = _crf(r, n=8)
    for i in range(8):
        got = task.decode(convert.model_from_numpy(model, "cpu"),
                          convert.table_from_numpy({k: v[i] for k, v in data.items()}, "cpu"))
        want = rtask.decode(jax.tree.map(jnp.asarray, model), {k: jnp.asarray(v[i]) for k, v in data.items()})
        assert got.tolist() == np.asarray(want).tolist()


def test_lmf_and_kalman_gradients_touch_only_their_rows():
    """The transitions are sparse updates (tests/test_tasks.py
    ::test_lmf_reduces_loss_and_updates_are_sparse): row i of L and row j
    of R; rows t and t - 1 of the trajectory (t alone at t = 0)."""
    gen = torch.Generator().manual_seed(0)
    task = tasks.LowRankMF(n_rows=64, n_cols=32, rank=4, mu=1e-3)
    model = task.init_model(gen)
    data = synthetic.ratings(gen, 64, 32, 256, rank=3)
    for r in (0, 100, 255):
        g = task.example_grad(model, {k: v[r] for k, v in data.items()})
        assert torch.nonzero(g["L"].abs().sum(1)).flatten().tolist() == [int(data["i"][r])]
        assert torch.nonzero(g["R"].abs().sum(1)).flatten().tolist() == [int(data["j"][r])]
    task = tasks.KalmanFilterTask(horizon=16, state_dim=4, obs_dim=3)
    w = torch.randn((16, 4), generator=gen)
    series = synthetic.kalman_series(gen, 16, 4, 3)
    for t in (0, 1, 9, 15):
        g = task.example_grad(w, {k: v[t] for k, v in series.items()})
        assert torch.nonzero(g.abs().sum(1)).flatten().tolist() == sorted({max(t - 1, 0), t})


def test_portfolio_stays_on_the_simplex():
    gen = torch.Generator().manual_seed(1)
    p = tuple(float(x) for x in np.linspace(-0.1, 0.1, 16))
    task = tasks.PortfolioOpt(n_assets=16, expected_returns=p)
    data = synthetic.returns(gen, 512, 16)
    prox = igd.make_simplex_prox()
    w = task.init_model(gen)
    loss0 = float(task.full_loss(w, data))
    for k in range(512):
        w = igd.igd_step(w, task.example_grad(w, {"r": data["r"][k]}), 0.05 / (1 + k / 512), prox)
        assert float(w.min()) >= 0.0 and abs(float(w.sum()) - 1.0) < 1e-5
    assert float(task.full_loss(w, data)) < loss0


def test_kalman_system_is_the_ports_own_and_seeded():
    c, a = kalman.system_matrices(0, 16, 8, "cpu")
    c2, a2 = kalman.system_matrices(0, 16, 8, "cpu")
    assert torch.equal(c, c2) and torch.equal(a, a2) and c.shape == (8, 16) and a.shape == (16, 16)
    assert not torch.equal(c, kalman.system_matrices(1, 16, 8, "cpu")[0])
    ref_c, _ = ref_tasks.KalmanFilterTask(1, 16, 8, c_seed=0)._mats()
    assert not np.allclose(c.numpy(), np.asarray(ref_c))  # a stated difference (ROADMAP queue 3)
    assert abs(float(c.std()) - 16**-0.5) < 0.05
    # I + 0.05 N(0, 1), scaled to spectral radius 1 (unscaled it is ~1.15)
    radius = float(torch.linalg.eigvals(a.double()).abs().max())
    assert abs(radius - 1.0) < 1e-6 and 0.8 < float(a.diagonal().mean()) < 1.0
    _, a = kalman.system_matrices(0, 2, 1, "cpu")  # drawn with radius 0.91: kept as drawn
    assert float(torch.linalg.eigvals(a.double()).abs().max()) < 0.99


# ---------------------------------------------------------------------------
# data/synthetic.py: shapes, dtypes and statistics (the streams are torch's)
# ---------------------------------------------------------------------------


def _runs_fraction(y):
    """Label changes between neighbours over those of a random order."""
    y = y.numpy()
    changes = np.count_nonzero(y[1:] != y[:-1])
    p = np.mean(y == y[0])
    return changes / ((len(y) - 1) * 2 * p * (1 - p))


@pytest.mark.parametrize("clustered", [True, False])
def test_sparse_classification(clustered):
    d = synthetic.sparse_classification(torch.Generator().manual_seed(0), 2000, 300, 8, clustered=clustered)
    assert d["idx"].shape == d["val"].shape == (2000, 8) and d["y"].shape == (2000,)
    assert (d["idx"].dtype, d["val"].dtype, d["y"].dtype) == (torch.int32, torch.float32, torch.float32)
    assert int(d["idx"].min()) >= 0 and int(d["idx"].max()) < 300  # no padding: every slot is a feature
    assert set(d["y"].tolist()) == {1.0, -1.0} and float(d["y"].sum()) == 0.0
    assert (_runs_fraction(d["y"]) < 0.01) == clustered
    # the labels are learnable: a few sparse-LR epochs cut the loss
    task = tasks.SparseLogisticRegression(dim=300)
    w = task.init_model(torch.Generator())
    loss0 = float(task.full_loss(w, d))
    perm = torch.randperm(2000, generator=torch.Generator().manual_seed(1))
    for k in perm[:600].tolist():
        w = igd.igd_step(w, task.example_grad(w, {c: v[k] for c, v in d.items()}), 0.3)
    assert float(task.full_loss(w, d)) < 0.8 * loss0


def test_ratings():
    d = synthetic.ratings(torch.Generator().manual_seed(0), 50, 40, 5000, rank=3)
    assert d["i"].shape == d["j"].shape == d["v"].shape == (5000,)
    assert (d["i"].dtype, d["j"].dtype, d["v"].dtype) == (torch.int32, torch.int32, torch.float32)
    assert bool((d["i"][1:] >= d["i"][:-1]).all())  # stored sorted by row
    assert set(d["i"].tolist()) == set(range(50)) and set(d["j"].tolist()) == set(range(40))
    # planted rank-3 factors, each N(0, 1/3): v has variance 3 x 1/9, plus 0.05^2
    assert abs(float(d["v"].var()) - (1 / 3 + 0.0025)) < 0.03


def test_tagged_sequences():
    d = synthetic.tagged_sequences(torch.Generator().manual_seed(0), 400, 12, 5, 7)
    assert d["x"].shape == (400, 12, 7) and d["y"].shape == d["mask"].shape == (400, 12)
    assert (d["x"].dtype, d["y"].dtype, d["mask"].dtype) == (torch.float32, torch.int32, torch.float32)
    assert bool((d["mask"] == 1).all()) and int(d["y"].min()) >= 0 and int(d["y"].max()) == 4
    # a Markov chain with peaked transitions: the next label is far more
    # predictable from the current one than from the marginal
    y = d["y"].long()
    counts = torch.zeros((5, 5)).index_put_((y[:, :-1].flatten(), y[:, 1:].flatten()), torch.ones(400 * 11),
                                            accumulate=True)
    cond = counts / counts.sum(1, keepdim=True)
    assert float(cond.max(1).values.mean()) > 1.5 * float((counts.sum(0) / counts.sum()).max())
    # features sit around the planted emission of their label
    mean0 = d["x"][y == 0].mean(0)
    assert float(((d["x"][y == 0] - mean0) ** 2).mean()) < 0.8


def test_kalman_series():
    d = synthetic.kalman_series(torch.Generator().manual_seed(0), 300, 6, 4, c_seed=2)
    assert torch.equal(d["t"], torch.arange(300, dtype=torch.int32)) and d["y"].shape == (300, 4)
    assert d["y"].dtype == torch.float32 and bool(torch.isfinite(d["y"]).all())
    # paper_tasks.KALMAN's shape stays bounded (the reference's overflows)
    long = synthetic.kalman_series(torch.Generator().manual_seed(0), 2048, 16, 8)["y"]
    assert float(long.abs().max()) < 100.0
    # A ~ I: the observations drift slowly, neighbours are correlated
    y = d["y"] - d["y"].mean(0)
    corr = float((y[1:] * y[:-1]).sum() / (y * y).sum())
    assert corr > 0.5


def test_returns():
    d = synthetic.returns(torch.Generator().manual_seed(0), 3000, 16)
    r = d["r"]
    assert r.shape == (3000, 16) and r.dtype == torch.float32
    assert float(r.mean(0).abs().max()) < 1e-5  # centered
    # a 4-factor covariance: 4 eigenvalues carry nearly all the variance
    ev = torch.linalg.eigvalsh(r.T @ r / 3000).flip(0)
    assert float(ev[:4].sum() / ev.sum()) > 0.9
