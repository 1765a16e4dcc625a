"""The port's flash decode (``repro_torch.kernels.decode``) against the JAX
package's: its Pallas kernel in interpret mode and its plain version,
``(out, m, l)`` included. On the CPU the port's functions are its plain
versions; the CUDA kernels are held to them on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode import ops as ref_ops
from repro.kernels.decode import ref as jax_ref
from repro_torch.kernels.decode import ops, ref as R

torch.set_num_threads(1)

# the reference's tolerances (tests/test_kernels.py)
TOLS = {"float32": 5e-5, "bfloat16": 2e-2}
# the reference's shapes (B, H, Kv, hd, S, length)
SHAPES = [(2, 4, 2, 64, 1024, 700), (1, 8, 8, 128, 512, 512), (4, 4, 1, 32, 2048, 1)]


def _inputs(b, h, kv, hd, s, seed=0):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32)
            for shape in ((b, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,hd,s,length", SHAPES)
def test_decode_attention_matches_pallas_interpret_and_ref(b, h, kv, hd, s, length, dtype):
    arrays = _inputs(b, h, kv, hd, s)
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    got = ops.decode_attention(*tx, length)
    assert got.shape == (b, h, hd) and got.dtype == tx[0].dtype
    tol = TOLS[dtype]
    want_kernel = ref_ops.decode_attention(*jx, length, use_kernel=True, interpret=True)
    want_ref = ref_ops.decode_attention(*jx, length, use_kernel=False)
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(want_ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,kv,hd,s,length", SHAPES)
def test_out_m_l_match_the_reference_oracle(b, h, kv, hd, s, length):
    """(out, m, l) in the reference's [BH, S, hd] layout, and through the
    ops' layout, against ``repro.kernels.decode.ref.decode_ref``."""
    q, kc, vc = _inputs(b, h, kv, hd, s)
    kf = kc.transpose(0, 2, 1, 3).reshape(b * kv, s, hd)
    vf = vc.transpose(0, 2, 1, 3).reshape(b * kv, s, hd)
    want = jax_ref.decode_ref(jnp.asarray(q.reshape(b * h, hd)), jnp.asarray(kf), jnp.asarray(vf), length)
    got = R.decode_ref(torch.from_numpy(q.reshape(b * h, hd)), torch.from_numpy(kf),
                       torch.from_numpy(vf), length)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5, atol=5e-5)
    out, m, l = R.decode_attention_ref(*(torch.from_numpy(a) for a in (q, kc, vc)), length)
    np.testing.assert_allclose(out.reshape(b * h, hd).numpy(), np.asarray(want[0]), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(m.reshape(-1).numpy(), np.asarray(want[1]), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(l.reshape(-1).numpy(), np.asarray(want[2]), rtol=5e-5, atol=5e-5)


def test_decode_ignores_cache_tail():
    b, h, kv, hd, s = 1, 2, 2, 64, 1024
    q, kc, vc = (torch.from_numpy(a) for a in _inputs(b, h, kv, hd, s))
    out1 = ops.decode_attention(q, kc, vc, 300)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, 300:] = 99.0
    vc2[:, 300:] = -99.0
    torch.testing.assert_close(ops.decode_attention(q, kc2, vc2, 300), out1, rtol=1e-6, atol=1e-7)


def test_length_zero_gives_the_pallas_kernels_empty_result():
    """No valid position: out 0, m -1e30, l 0, what the Pallas kernel
    returns (and what the CUDA kernel returns on the card)."""
    q, kc, vc = _inputs(1, 4, 2, 32, 512)
    want = ref_ops.K.flash_decode(jnp.asarray(q.reshape(4, 32)), jnp.asarray(kc.transpose(0, 2, 1, 3).reshape(2, 512, 32)),
                                  jnp.asarray(vc.transpose(0, 2, 1, 3).reshape(2, 512, 32)), 0,
                                  scale=1 / 32 ** 0.5, interpret=True)
    out, m, l = R.decode_attention_ref(*(torch.from_numpy(a) for a in (q, kc, vc)), 0)
    np.testing.assert_array_equal(out.reshape(4, 32).numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(m.reshape(-1).numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(l.reshape(-1).numpy(), np.asarray(want[2]))


# -- how the decode kernel cuts its work (plain Python) ------------------------

from repro_torch.kernels.decode import kernel as K  # noqa: E402

SERVING = dict(b=8, kv=8, h=24, length=2176, n_sm=132)


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 700, 2176, 10_000])
@pytest.mark.parametrize("b,kv,h", [(8, 8, 24), (1, 2, 2), (2, 2, 16), (4, 1, 4)])
def test_splits_cover_every_position_exactly_once(b, kv, h, length):
    splits = K.splits_for(b, kv, h, length, 132)
    chunk = K.split_chunk(length, splits)
    assert splits >= 1 and chunk % K.TILE == 0 and chunk >= K.TILE
    covered = np.zeros(length, dtype=int)
    for i in range(splits):
        covered[i * chunk:min((i + 1) * chunk, length)] += 1
    assert (covered == 1).all()
    assert splits <= max(1, -(-length // K.TILE))  # no split without a tile to read


def test_splits_fill_two_waves_at_the_serving_shape():
    s = SERVING
    splits = K.splits_for(s["b"], s["kv"], s["h"], s["length"], s["n_sm"])
    g = s["h"] // s["kv"]
    blocks = splits * s["b"] * s["kv"] * (g // K.head_group(g))
    assert blocks >= K.MIN_WAVES * K.BLOCKS_PER_SM * s["n_sm"] == 528
    # every split has positions to read
    assert (splits - 1) * K.split_chunk(s["length"], splits) < s["length"]


@pytest.mark.parametrize("g", range(1, 33))
def test_head_group_divides_g_with_no_dead_slot(g):
    n = K.head_group(g)
    assert 1 <= n <= K.MAX_GROUP and g % n == 0
    assert all(g % m for m in range(n + 1, K.MAX_GROUP + 1))


@pytest.mark.parametrize("softcap", [30.0, 1.0])
@pytest.mark.parametrize("b,h,kv,hd,s,length", SHAPES + [(2, 6, 2, 192, 300, 200)])
def test_soft_capped_decode_matches_the_reference_attn_core(b, h, kv, hd, s, length, softcap):
    """The capped decode (out) against the reference's _attn_core for one
    token at position length - 1; m is the capped logits' max."""
    from repro.models import layers as jax_layers

    q, kc, vc = _inputs(b, h, kv, hd, s, seed=4)
    q = 4.0 * q
    qg = jnp.asarray(q).reshape(b, 1, kv, h // kv, hd)
    want = jax_layers._attn_core(qg, jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.full((b, 1), length - 1, jnp.int32),
                                 jnp.full((b,), length, jnp.int32), softcap)
    out, m, _ = R.decode_attention_ref(*(torch.from_numpy(a) for a in (q, kc, vc)), length, softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want).reshape(b, h, hd), rtol=5e-5, atol=5e-5)
    assert bool((m.abs() <= softcap).all())  # the capped logits' max
    np.testing.assert_array_equal(ops.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)), length,
                                                       softcap).numpy(), out.numpy())
