"""The port's dense GLM tasks against repro.tasks: per-example loss and
gradient, and the batched full loss, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tasks as ref
from repro_torch import tasks

torch.set_num_threads(1)

TASKS = [
    ("LogisticRegression", {"dim": 7}),
    ("LogisticRegression", {"dim": 7, "mu": 0.05}),
    ("SVM", {"dim": 7}),
    ("SVM", {"dim": 7, "mu": 0.05}),
    ("LeastSquares", {"dim": 7}),
]
# tolerance of a float32 dot of length 7 summed in another order
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed=0, n=64, d=7):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(r.normal(size=n)).astype(np.float32)
    w = r.normal(size=d).astype(np.float32)
    return x, y, w


@pytest.mark.parametrize("name,kw", TASKS)
def test_example_loss_and_grad_match(name, kw):
    x, y, w = _inputs()
    rt, pt = getattr(ref, name)(**kw), getattr(tasks, name)(**kw)
    tw = torch.from_numpy(w)
    for i in range(x.shape[0]):
        jex = {"x": jnp.asarray(x[i]), "y": jnp.asarray(y[i])}
        tex = {"x": torch.from_numpy(x[i]), "y": torch.tensor(y[i])}
        np.testing.assert_allclose(float(pt.example_loss(tw, tex)),
                                   float(rt.example_loss(jnp.asarray(w), jex)), **TOL)
        np.testing.assert_allclose(pt.example_grad(tw, tex).numpy(),
                                   np.asarray(rt.example_grad(jnp.asarray(w), jex)), **TOL)


@pytest.mark.parametrize("name,kw", TASKS)
def test_full_loss_matches(name, kw):
    x, y, w = _inputs(1, n=200)
    rt, pt = getattr(ref, name)(**kw), getattr(tasks, name)(**kw)
    want = float(rt.full_loss(jnp.asarray(w), {"x": jnp.asarray(x), "y": jnp.asarray(y)}))
    got = float(pt.full_loss(torch.from_numpy(w), {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["LogisticRegression", "SVM", "LeastSquares"])
def test_init_model_is_zeros_on_generator_device(name):
    w = getattr(tasks, name)(dim=5).init_model(torch.Generator())
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    assert torch.equal(w, torch.zeros(5))


def test_least_squares_grad_is_autodiff_of_the_loss():
    """LeastSquares keeps the Task default: torch.func.grad of its loss,
    which is (w.x - y) x."""
    x, y, w = _inputs(2)
    t = tasks.LeastSquares(dim=7)
    ex = {"x": torch.from_numpy(x[0]), "y": torch.tensor(y[0])}
    tw = torch.from_numpy(w)
    want = (torch.dot(tw, ex["x"]) - ex["y"]) * ex["x"]
    np.testing.assert_allclose(t.example_grad(tw, ex).numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
