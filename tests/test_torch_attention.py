"""The port's causal GQA attention (``repro_torch.kernels.attention``)
against the JAX package's: its Pallas kernel in interpret mode, as the
reference's own tests run it on the CPU, and its plain version. On the
CPU the port's ``mha`` is its plain version; the CUDA kernel is held to
that plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as ref_ops
from repro_torch.kernels.attention import ops, ref as R

torch.set_num_threads(1)

# the reference's tolerances (tests/test_kernels.py)
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
# the reference's shapes (B, S, H, Kv, hd), and a ragged S
SHAPES = [(2, 256, 4, 2, 64), (1, 128, 4, 4, 128), (2, 384, 6, 2, 32), (1, 200, 4, 2, 64)]


def _inputs(b, s, h, kv, hd, seed=0):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


def _as(arrays, dtype):
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd", SHAPES)
def test_mha_matches_pallas_interpret_and_ref(b, s, h, kv, hd, dtype):
    jx, tx = _as(_inputs(b, s, h, kv, hd), dtype)
    got = ops.mha(*tx)
    assert got.shape == (b, s, h, hd) and got.dtype == tx[0].dtype
    tol = TOLS[dtype]
    want_kernel = ref_ops.mha(*jx, use_kernel=True, interpret=True)
    want_ref = ref_ops.mha(*jx, use_kernel=False)
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(want_ref), rtol=tol, atol=tol)


def test_mha_is_causal():
    """Perturbing future keys and values leaves earlier outputs unchanged."""
    b, s, h, kv, hd = 1, 256, 2, 2, 64
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, s, h, kv, hd))
    out1 = ops.mha(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, s // 2:] = 0.0
    v2[:, s // 2:] = 0.0
    out2 = ops.mha(q, k2, v2)
    torch.testing.assert_close(out1[:, : s // 2], out2[:, : s // 2], rtol=1e-5, atol=1e-6)
    assert not torch.allclose(out1[:, s // 2:], out2[:, s // 2:])


def test_gqa_head_order_is_kv_major():
    """q head h reads kv head h // (H/Kv): with one kv head's values set to
    a constant, exactly the q heads of its group output that constant."""
    b, s, h, kv, hd = 1, 16, 6, 2, 8
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, s, h, kv, hd))
    v[:, :, 1] = 3.0
    out = ops.mha(q, k, v)
    torch.testing.assert_close(out[:, :, 3:], torch.full_like(out[:, :, 3:], 3.0))
    assert not torch.allclose(out[:, :, :3], torch.full_like(out[:, :, :3], 3.0))


def test_attention_ref_takes_the_reference_layout():
    """The plain version in the reference's [BH, S, hd] layout equals the
    JAX oracle on the same arrays."""
    from repro.kernels.attention import ref as jax_ref

    r = np.random.default_rng(1)
    q = r.normal(size=(6, 40, 16)).astype(np.float32)
    k = r.normal(size=(2, 40, 16)).astype(np.float32)
    v = r.normal(size=(2, 40, 16)).astype(np.float32)
    got = R.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jax_ref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
