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


# ---------------------------------------------------------------------------
# dict models (core/tree.py): LMF's {"L", "R"}, CRF's {"E", "T"}
# ---------------------------------------------------------------------------


def _tree(seed):
    """A dict model whose insertion order is not sorted, and its leaves'
    gradient."""
    r = np.random.default_rng(seed)
    w = {"R": r.normal(size=(3, 2)).astype(np.float32), "L": r.normal(size=(4, 2)).astype(np.float32)}
    g = {k: r.normal(size=v.shape).astype(np.float32) for k, v in w.items()}
    return w, g


def test_ravel_order_is_jaxs_sorted_key_order():
    from jax.flatten_util import ravel_pytree
    from repro_torch.core import tree

    w, _ = _tree(0)
    w["E"] = {"z": np.arange(3, dtype=np.float32), "a": np.float32(7.0)[None]}  # nested, unsorted too
    flat, unravel = tree.ravel({k: torch.from_numpy(np.asarray(v)) if not isinstance(v, dict)
                                else {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in w.items()})
    want, _ = ravel_pytree(w)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = unravel(flat * 2)
    assert list(back) == ["E", "L", "R"] and list(back["E"]) == ["a", "z"]
    np.testing.assert_array_equal(back["R"].numpy(), 2 * w["R"])
    assert tree.size(back) == flat.numel() == 4 + 8 + 6
    # a lone tensor is its own leaf: raveled as it is, unraveled to its shape
    m = torch.arange(6.0).view(2, 3)
    flat, unravel = tree.ravel(m)
    assert flat.shape == (6,) and torch.equal(unravel(flat), m) and tree.leaves(m)[0] is m


@pytest.mark.parametrize("factory,arg", [("make_l1_prox", 0.3), ("make_l2_prox", 0.3), ("make_simplex_prox", None),
                                         ("identity_prox", None)])
def test_igd_step_on_a_dict_model_matches_reference(factory, arg):
    w, g = _tree(1)
    if factory == "identity_prox":
        ref_prox, prox = ref.identity_prox, igd.identity_prox
    else:
        a = () if arg is None else (arg,)
        ref_prox, prox = getattr(ref, factory)(*a), getattr(igd, factory)(*a)
    want = ref.igd_step({k: jnp.asarray(v) for k, v in w.items()}, {k: jnp.asarray(v) for k, v in g.items()},
                        jnp.float32(0.1), ref_prox)
    got = igd.igd_step({k: torch.from_numpy(v) for k, v in w.items()}, {k: torch.from_numpy(v) for k, v in g.items()},
                       torch.tensor(0.1), prox)
    assert list(got) == ["L", "R"]
    for k in w:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("factory,arg", [("make_l1_prox", 0.3), ("make_l2_prox", 0.3), ("make_simplex_prox", None)])
def test_dense_prox_and_step_are_unchanged_bit_for_bit(factory, arg):
    """On one tensor the tree-wise rules are the single-tensor formulas
    they were, bit for bit."""
    w, g, t = torch.from_numpy(_vec(8, 11)), torch.from_numpy(_vec(9, 11)), torch.tensor(0.07)
    a = () if arg is None else (arg,)
    plain = {"make_l1_prox": lambda x, s: igd.prox_l1(x, s * arg), "make_l2_prox": lambda x, s: igd.prox_l2sq(x, s * arg),
             "make_simplex_prox": lambda x, s: igd.project_simplex(x)}[factory]
    prox = getattr(igd, factory)(*a)
    assert torch.equal(prox(w, t), plain(w, t))
    assert torch.equal(igd.igd_step(w, g, t, prox), plain(w - t * g, t))
