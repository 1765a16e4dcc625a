"""repro_torch.core.igd against repro.core.igd: step-size rules over a
step vector and the proximal operators, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import igd as ref
from repro_torch.core import igd

torch.set_num_threads(1)

STEPS = np.arange(0, 1_200_000, 37, dtype=np.int32)


@pytest.mark.parametrize("rule", [
    ("constant", (0.3,), {}),
    ("diminishing", (0.5,), {"decay": 581_012}),
    ("diminishing", (0.1,), {"decay": 96}),
    ("diminishing", (0.2,), {}),
])
def test_step_size_rules_bit_identical(rule):
    """The kernel lane computes step_size(step + arange(n)); the alphas
    must be the reference's to the last bit (same float32 operation
    order, true division)."""
    name, a, kw = rule
    want = np.broadcast_to(np.asarray(getattr(ref, name)(*a, **kw)(jnp.asarray(STEPS))), STEPS.shape)
    got = getattr(igd, name)(*a, **kw)(torch.from_numpy(STEPS)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("alpha0,rho,decay", [(0.5, 0.9, 512.0), (0.2, 0.95, 3.0), (0.1, 0.99, 581_012.0)])
def test_geometric_rule_within_two_ulp(alpha0, rho, decay):
    """The geometric rule's rho ** e is a float32 pow; XLA's CPU pow is
    not correctly rounded (it differs from the float64-rounded value too),
    so bit identity is not available. Over the normal range the two stay
    within 2 ulp; no catalog technique uses this rule."""
    want = np.asarray(ref.geometric(alpha0, rho, decay)(jnp.asarray(STEPS)))
    got = igd.geometric(alpha0, rho, decay)(torch.from_numpy(STEPS)).numpy()
    normal = want > np.finfo(np.float32).tiny
    ulp = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert normal.sum() >= 100
    assert ulp[normal].max() <= 2


def test_step_size_scalar_step():
    assert float(igd.diminishing(0.5, decay=10)(torch.tensor(5, dtype=torch.int32))) == float(
        ref.diminishing(0.5, decay=10)(jnp.int32(5)))
    with pytest.raises(ValueError):
        igd.StepSize("cubic", 0.1)(torch.tensor(1))


def _vec(seed, n=33):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


@pytest.mark.parametrize("t", [0.0, 0.05, 0.7])
def test_prox_l1_and_l2sq_match(t):
    v = _vec(1)
    np.testing.assert_array_equal(igd.prox_l1(torch.from_numpy(v), t).numpy(),
                                  np.asarray(ref.prox_l1(jnp.asarray(v), t)))
    np.testing.assert_allclose(igd.prox_l2sq(torch.from_numpy(v), t).numpy(),
                               np.asarray(ref.prox_l2sq(jnp.asarray(v), t)), rtol=1e-7, atol=0)


@pytest.mark.parametrize("radius", [0.1, 1.0, 100.0])
def test_project_l2_ball_matches(radius):
    v = _vec(2)
    np.testing.assert_allclose(igd.project_l2_ball(torch.from_numpy(v), radius).numpy(),
                               np.asarray(ref.project_l2_ball(jnp.asarray(v), radius)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_project_simplex_matches(seed):
    v = _vec(seed, 17) * 2.0
    got = igd.project_simplex(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.project_simplex(jnp.asarray(v))), rtol=1e-6, atol=1e-6)
    assert abs(got.sum() - 1.0) < 1e-5 and (got >= 0).all()


@pytest.mark.parametrize("factory,arg", [("make_l1_prox", 0.3), ("make_l2_prox", 0.3), ("make_simplex_prox", None)])
def test_prox_factories_and_igd_step(factory, arg):
    w, g = _vec(6, 9), _vec(7, 9)
    a = () if arg is None else (arg,)
    want = ref.igd_step(jnp.asarray(w), jnp.asarray(g), jnp.float32(0.1), getattr(ref, factory)(*a))
    got = igd.igd_step(torch.from_numpy(w), torch.from_numpy(g), torch.tensor(0.1), getattr(igd, factory)(*a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    ident = igd.igd_step(torch.from_numpy(w), torch.from_numpy(g), torch.tensor(0.1))
    np.testing.assert_array_equal(ident.numpy(), np.asarray(
        ref.igd_step(jnp.asarray(w), jnp.asarray(g), jnp.float32(0.1))))
