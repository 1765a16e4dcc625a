"""``repro_torch.optim`` (IGD, AdamW, compression) against ``repro.optim``
leaf by leaf on the same numpy trees, and compression's own bounds as
``tests/test_compression.py`` states them: the int8 round trip within a
block's max / 127, error feedback conserving the signal exactly and
keeping the applied update unbiased. Tolerance rtol = 1e-6, atol = 1e-7
for the optimizers (the same float32 operations in the same order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import igd as jax_igd
from repro.optim import AdamW as JaxAdamW, IGD as JaxIGD, compression as JC
from repro_torch.core import igd
from repro_torch.core.tree import leaves, tree_map
from repro_torch.optim import AdamW, IGD, compression as C

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"a": (7, 5), "b": {"c": (300,), "d": (2, 3, 4)}}


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return (scale * r.normal(size=spec)).astype(np.float32)

    return make(SHAPES)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


OPTIMIZERS = {
    "igd": (lambda: JaxIGD(jax_igd.constant(0.05)), lambda: IGD(igd.constant(0.05))),
    "igd_momentum": (lambda: JaxIGD(jax_igd.diminishing(0.1, 3.0), momentum=0.9),
                     lambda: IGD(igd.diminishing(0.1, 3.0), momentum=0.9)),
    "igd_momentum_decay": (lambda: JaxIGD(jax_igd.geometric(0.1, 0.9, 2.0), momentum=0.5, weight_decay=0.01),
                           lambda: IGD(igd.geometric(0.1, 0.9, 2.0), momentum=0.5, weight_decay=0.01)),
    "adamw": (lambda: JaxAdamW(), lambda: AdamW()),
    "adamw_no_decay": (lambda: JaxAdamW(lr=1e-2, b2=0.999, weight_decay=0.0),
                       lambda: AdamW(lr=1e-2, b2=0.999, weight_decay=0.0)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_the_reference_leaf_by_leaf(name):
    make_jax, make_port = OPTIMIZERS[name]
    jopt, opt = make_jax(), make_port()
    jp, p = jax.tree.map(jnp.asarray, _tree(0)), _torch(_tree(0))
    js, s = jopt.init(jp), opt.init(p)
    assert len(s) == len(js)
    for step in range(5):
        grads = _tree(10 + step, scale=0.5)
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, grads), js, jnp.int32(step))
        got_p, got_s = opt.update(p, _torch(grads), s, step)
        assert got_p is p and all(a is b for a, b in zip(leaves(got_s), leaves(s)))  # in place
    for g, w in zip(leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for g, w in zip(leaves(s), jax.tree.leaves(js)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("seed,n", [(0, 10), (1, 256), (2, 257), (3, 600), (4, 1)])
def test_int8_quantization_matches_the_reference_and_its_error_bound(seed, n):
    x = (3.0 * np.random.default_rng(seed).normal(size=n)).astype(np.float32)
    q, s = C.quantize_int8(torch.from_numpy(x))
    jq, js = JC.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    out = C.dequantize_int8(q, s, (n,), torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(JC.dequantize_int8(jq, js, (n,), jnp.float32)))
    # per-block max error <= scale/2 = blockmax/254
    assert np.abs(out.numpy() - x).max() <= np.abs(x).max() / 127.0 + 1e-6


def test_bf16_roundtrip_and_tree_compression():
    x = {"w": torch.linspace(-1, 1, 100), "v": [torch.ones(3, 300)]}
    y = C.from_bf16(C.to_bf16(x), x)
    assert y["w"].dtype == torch.float32 and y["v"][0].dtype == torch.float32
    np.testing.assert_allclose(y["w"].numpy(), x["w"].numpy(), atol=1e-2)
    tree = C.compress_tree_int8(x)
    assert tree["v"][0][0].shape == (4, C.BLOCK) and tree["w"][1].shape == (1, 1)


def test_error_feedback_matches_the_reference_and_conserves_the_signal():
    g = _tree(3)
    qs, r1 = C.ef_compress(_torch(g), tree_map(torch.zeros_like, _torch(g)))
    jqs, jr1 = JC.ef_compress(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, g)))
    for got, want in zip(leaves(r1), jax.tree.leaves(jr1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # q + residual == target (the EF-SGD invariant)
    q, s = qs["b"]["c"]
    approx = C.dequantize_int8(q, s, (300,), torch.float32)
    np.testing.assert_allclose((approx + r1["b"]["c"]).numpy(), g["b"]["c"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqs["b"]["c"][0]))


def test_error_feedback_keeps_the_applied_update_unbiased():
    g = {"w": 0.01 * torch.ones(256)}
    r = tree_map(torch.zeros_like, g)
    applied = torch.zeros(256)
    for _ in range(50):
        qs, r = C.ef_compress(g, r)
        applied += C.dequantize_int8(*qs["w"], (256,), torch.float32)
    np.testing.assert_allclose(applied.numpy() / 50, 0.01 * np.ones(256), rtol=0.05)
