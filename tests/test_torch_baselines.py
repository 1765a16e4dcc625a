"""The port's Fig. 7 baselines (tasks/baselines.py) against the JAX
package's on the CPU, from the same inputs and initial models: full-batch
gradient descent (svm, crf), IRLS for logistic regression and ALS for
LMF. The solves and segment sums run in another order on each side, so
the models are held to rtol=1e-4, with the reference's kernel atol
(2e-5) for components near zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tasks as ref_tasks
from repro.data import synthetic as ref_synthetic
from repro.tasks import baselines as ref_baselines
from repro_torch import convert, tasks
from repro_torch.tasks import baselines

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-5


def _both(data):
    data = {k: np.asarray(v) for k, v in data.items()}
    return {k: jnp.asarray(v) for k, v in data.items()}, convert.table_from_numpy(data, "cpu")


def _close(got, want):
    if isinstance(got, dict):
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_irls_matches_reference():
    rdata, data = _both(ref_synthetic.dense_classification(jax.random.PRNGKey(0), 512, 8, margin=0.5, noise=2.0))
    want = ref_baselines.irls_logistic(rdata, steps=12, ridge=1e-3)
    got = baselines.irls_logistic(data, steps=12, ridge=1e-3)
    _close(got, want)
    task = tasks.LogisticRegression(dim=8)
    # Newton's optimum is below what the zero model scores
    assert float(task.full_loss(got, data)) < float(task.full_loss(torch.zeros(8), data))


@pytest.mark.parametrize("name", ["svm", "crf"])
def test_full_batch_gd_matches_reference(name):
    key = jax.random.PRNGKey(1)
    if name == "svm":
        raw = ref_synthetic.dense_classification(key, 256, 6)
        rtask, task, lr = ref_tasks.SVM(dim=6), tasks.SVM(dim=6), 0.5 / 256
    else:
        raw = ref_synthetic.tagged_sequences(key, 24, 6, 4, 5)
        rtask = ref_tasks.LinearChainCRF(n_labels=4, feat_dim=5, init_scale=0.3)
        task, lr = tasks.LinearChainCRF(n_labels=4, feat_dim=5, init_scale=0.3), 2e-3
    rdata, data = _both(raw)
    model0 = jax.tree.map(np.asarray, rtask.init_model(key))
    rm, rl = ref_baselines.full_batch_gd(rtask, rdata, steps=8, lr=lr, model=jax.tree.map(jnp.asarray, model0))
    m, losses = baselines.full_batch_gd(task, data, steps=8, lr=lr, model=convert.model_from_numpy(model0, "cpu"))
    _close(m, rm)
    np.testing.assert_allclose(losses, rl, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]


def test_full_batch_gd_draws_its_model_from_the_generator():
    raw = ref_synthetic.tagged_sequences(jax.random.PRNGKey(2), 8, 5, 3, 4)
    _, data = _both(raw)
    task = tasks.LinearChainCRF(n_labels=3, feat_dim=4, init_scale=0.1)
    a, _ = baselines.full_batch_gd(task, data, steps=2, lr=1e-3, generator=torch.Generator().manual_seed(5))
    b, _ = baselines.full_batch_gd(task, data, steps=2, lr=1e-3, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_als_matches_reference_and_beats_the_initial_model():
    """tests/test_tasks.py::test_als_baseline_beats_random, held to the
    reference from the reference's initial factors."""
    key = jax.random.PRNGKey(0)
    rdata, data = _both(ref_synthetic.ratings(key, 64, 32, 2048, rank=3))
    want = ref_baselines.als_lmf(rdata, 64, 32, 4, sweeps=5, mu=1e-2, rng=key)
    kl, kr = jax.random.split(key)
    init = {"L": 0.1 * jax.random.normal(kl, (64, 4)), "R": 0.1 * jax.random.normal(kr, (32, 4))}
    got = baselines.als_lmf(data, 64, 32, 4, sweeps=5, mu=1e-2,
                            model=convert.model_from_numpy(jax.tree.map(np.asarray, init), "cpu"))
    _close(got, want)
    task = tasks.LowRankMF(n_rows=64, n_cols=32, rank=4, mu=1e-3)
    m0 = convert.model_from_numpy(jax.tree.map(np.asarray, init), "cpu")
    assert float(task.full_loss(got, data)) < 0.2 * float(task.full_loss(m0, data))
    # a generator's draw is the default initial model
    drawn = baselines.als_lmf(data, 64, 32, 4, sweeps=5, generator=torch.Generator().manual_seed(0))
    assert float(task.full_loss(drawn, data)) < 0.2 * float(task.full_loss(m0, data))
