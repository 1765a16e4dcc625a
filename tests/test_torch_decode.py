"""The port's flash decode (``repro_torch.kernels.decode``) against the JAX
package's: its Pallas kernel in interpret mode and its plain version,
``(out, m, l)`` included. On the CPU the port's functions are its plain
versions; the CUDA kernels are held to them on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import math

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


# (instance, B, Kv, H, length): llama3.2-3b's serving shape on the
# CUDA-core layout, nemotron-4's decode shape on the tensor-core instance
WAVE_SHAPES = {"cuda_core": (False, 8, 8, 24, 2176), "tensor_cores": (True, 8, 8, 96, 2080)}


@pytest.mark.parametrize("instance", sorted(WAVE_SHAPES))
def test_splits_fill_two_waves_at_the_serving_shape(instance):
    """MIN_WAVES full waves of the blocks that fit an SM (132 SMs), every
    split with positions to read, and the f32 partials (B H hd floats a
    split) within a tenth of the bf16 cache's bytes."""
    tc, b, kv, h, length = WAVE_SHAPES[instance]
    n_sm, hd, g = 132, 128, h // kv
    splits = K.splits_for(b, kv, h, length, n_sm, tc)
    blocks = splits * b * kv * K.head_blocks(g, tc)
    assert blocks >= K.MIN_WAVES * K.blocks_per_sm(g, tc) * n_sm
    chunk = K.split_chunk(length, splits, K.TC_TILE if tc else K.TILE)
    assert (splits - 1) * chunk < length
    assert splits * b * h * hd * 4 <= 0.1 * 2 * b * length * kv * hd * 2
    if tc:  # nemotron-4: one block a kv head for its 12 q heads, two an SM
        assert (K.head_blocks(g, tc), K.blocks_per_sm(g, tc), splits, chunk) == (1, 2, 9, 256)
    else:  # the plan the CUDA-core layout has always had
        assert (K.head_blocks(g, tc), K.blocks_per_sm(g, tc), splits, chunk) == (1, 2, 9, 256)


TC_GROUPS = (1, 3, 8, 12, 16, 24, 32, 48)


@pytest.mark.parametrize("tc", [False, True], ids=["cuda_core", "tensor_cores"])
@pytest.mark.parametrize("g", TC_GROUPS)
def test_every_q_head_is_one_block_row(g, tc):
    """Each (b, q head) is exactly one row of one block of the grid (B Kv,
    splits, head_blocks): the tensor-core instance's rows past g are dead,
    the CUDA-core layout's head groups have none."""
    b, kv = 3, 2
    h = g * kv
    n = K.block_heads(g, tc)
    rows = np.zeros(b * h, dtype=int)
    for bk in range(b * kv):
        bb, kvh = divmod(bk, kv)
        for z in range(K.head_blocks(g, tc)):
            for row in range(n):
                head = z * n + row
                if head < g:
                    rows[bb * h + kvh * g + head] += 1
                else:
                    assert tc, "a dead head slot in the CUDA-core layout"
    assert (rows == 1).all()
    if tc:
        assert n in (K.TC_ROWS, 2 * K.TC_ROWS) and K.head_blocks(g, tc) == -(-g // (K.TC_ROWS * K.TC_MAX_ROW_TILES))


@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 63, 64, 65, 2049, 2080, 10_000])
@pytest.mark.parametrize("g", TC_GROUPS[:-1])
def test_tensor_core_instance_reads_every_position_once(g, length):
    """Up to 32 q heads a kv head, every position below length of every kv
    head is read by exactly one block (b, kv head, split), in whole
    32-position tiles; nothing past length is read."""
    b, kv = 2, 2
    h = g * kv
    assert K.head_blocks(g, True) == 1
    splits = K.splits_for(b, kv, h, length, 132, True)
    chunk = K.split_chunk(length, splits, K.TC_TILE)
    assert chunk % K.TC_TILE == 0 and 1 <= splits <= K.MAX_SPLITS
    reads = np.zeros((b * kv, max(length, 1)), dtype=int)
    for bk in range(b * kv):
        for split in range(splits):
            reads[bk, split * chunk:min((split + 1) * chunk, length)] += 1
    assert (reads[:, :length] == 1).all()
    assert splits <= max(1, -(-length // K.TC_TILE))  # no split without a tile to read
    assert splits <= max(1, int(K.PARTIALS_SHARE * length / g))


def test_tensor_core_instance_is_bf16_past_128():
    assert K.tensor_core_instance(torch.bfloat16, 192) and K.tensor_core_instance(torch.bfloat16, 136)
    assert not K.tensor_core_instance(torch.bfloat16, 128) and not K.tensor_core_instance(torch.float32, 192)


def test_tensor_maps_stop_at_length():
    """The tensor-core instance's maps: dims (hd, Kv, length, B), the
    cache's own byte strides (a strided slice of a longer cache too), boxes
    of 64 columns by TC_TILE positions; length 0 encodes one position, which
    no block reads."""
    cache = torch.zeros((2, 700, 8, 192), dtype=torch.bfloat16)
    shard = cache[:, 350:]
    for t, length in ((cache, 2), (shard, 333), (shard, 0)):
        got = list(K._tma_layouts(t, t, length))
        per = [*(192, 8, max(length, 1), 2), 192 * 2, 8 * 192 * 2, 700 * 8 * 192 * 2, 64, 1, K.TC_TILE, 1]
        assert got == per + per


def test_decode_source_includes_the_shared_hopper_header():
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel as AK

    got = [p.resolve() for p in _build.local_sources(K.SOURCE)]
    assert got == [K.SOURCE.resolve(), (AK.SOURCE.parent / "hopper.cuh").resolve()]


def _tensor_core_decode(q, k_cache, v_cache, length, softcap=0.0, n_sm=132):
    """The tensor-core instance's arithmetic in float32: per (b, kv head,
    split), 32-position tiles, each two 16-position slices with their own
    online softmax in log2 units (P rounded to bf16 for P V, the row sum
    from the unrounded P), the slices merged, the partial's m in natural
    units; then the combine kernel's sums. Returns (out bf16, m, l)."""
    b, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    splits = K.splits_for(b, kv, h, length, n_sm, True)
    chunk = K.split_chunk(length, splits, K.TC_TILE)
    scale = 1.0 / hd ** 0.5
    log2e = 1.4426950408889634
    qf = q.float().reshape(b, kv, g, hd)
    kf = k_cache.float().transpose(1, 2)  # [B, Kv, S, hd]
    vf = v_cache.float().transpose(1, 2)
    parts = []
    for split in range(splits):
        start, end = split * chunk, min((split + 1) * chunk, length)
        sl_m, sl_l, sl_o = [], [], []
        for sl in range(K.TC_TILE // 16):
            m = torch.full((b, kv, g), -1e30)
            l = torch.zeros((b, kv, g))
            o = torch.zeros((b, kv, g, hd))
            for t0 in range(start, end, K.TC_TILE):
                pos = torch.arange(t0 + 16 * sl, t0 + 16 * sl + 16)
                idx = pos.clamp(max=k_cache.shape[1] - 1)
                s = torch.einsum("bkgd,bkpd->bkgp", qf, kf[:, :, idx])
                x = (softcap * torch.tanh(s * scale / softcap) if softcap else s * scale) * log2e
                x = torch.where(pos < end, x, float("-inf"))
                mx = torch.maximum(m, x.amax(-1))
                corr = torch.exp2(m - mx)
                p = torch.exp2(x - mx[..., None])
                l = l * corr + p.sum(-1)
                o = o * corr[..., None] + torch.einsum(
                    "bkgp,bkpd->bkgd", p.to(torch.bfloat16).float(),
                    torch.where((pos < end)[:, None], vf[:, :, idx], 0.0))
                m = mx
            sl_m.append(m), sl_l.append(l), sl_o.append(o)
        mm = torch.stack(sl_m).amax(0)
        a = [torch.exp2(mi - mm) for mi in sl_m]
        den = sum(li * ai for li, ai in zip(sl_l, a))
        out = sum(oi * ai[..., None] for oi, ai in zip(sl_o, a)) / den.clamp_min(1e-30)[..., None]
        parts.append((out, torch.where(den > 0, mm * math.log(2.0), torch.tensor(-1e30)), den))
    pm = torch.stack([p[1] for p in parts])
    ms = pm.amax(0)
    w = torch.stack([p[2] for p in parts]) * torch.exp(pm - ms)
    den = w.sum(0)
    out = (w[..., None] * torch.stack([p[0] for p in parts])).sum(0) / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, hd).to(torch.bfloat16), ms.reshape(b, h), den.reshape(b, h)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("g,hd,length", [(12, 192, 2080), (12, 192, 33), (3, 136, 65), (24, 192, 64),
                                         (16, 192, 1), (1, 136, 300)])
def test_tensor_core_arithmetic_stays_within_the_bf16_tolerance(g, hd, length, softcap):
    """The tensor-core instance's roundings and order (the card holds the
    kernel to the plain version at 2e-2, tests/test_torch_cuda.py) against
    the reference on the same bf16-valued inputs: the Pallas kernel in
    interpret mode and its plain version without a cap, the reference's
    _attn_core with one; m and l against the port's plain version (held to
    the reference above)."""
    from repro.models import layers as jax_layers

    b, kv = 2, 2
    h, s = g * kv, length + 40
    q, kc, vc = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(b, h, kv, hd, s, seed=g + hd))
    q = (3.0 * q.float()).to(torch.bfloat16)
    kc[:, length:], vc[:, length:] = float("nan"), float("inf")  # a stale tail: never read
    out, m, l = _tensor_core_decode(q, kc, vc, length, softcap)
    clean = [t.float().numpy() for t in (q, kc[:, :length], vc[:, :length])]
    if softcap:
        qg = jnp.asarray(clean[0]).reshape(b, 1, kv, g, hd)
        want = [jax_layers._attn_core(qg, jnp.asarray(clean[1]), jnp.asarray(clean[2]),
                                      jnp.full((b, 1), length - 1, jnp.int32), jnp.full((b,), length, jnp.int32),
                                      softcap).reshape(b, h, hd)]
    else:
        jx = [jnp.asarray(a) for a in clean]
        want = [ref_ops.decode_attention(*jx, length, use_kernel=True, interpret=True),
                ref_ops.decode_attention(*jx, length, use_kernel=False)]
    for w in want:
        np.testing.assert_allclose(_f32(out), np.asarray(w), rtol=2e-2, atol=2e-2)
    _, m_ref, l_ref = R.decode_attention_ref(*(torch.from_numpy(a) for a in clean), length, softcap)
    np.testing.assert_allclose(m.numpy(), m_ref.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(l.numpy(), l_ref.numpy(), rtol=2e-2, atol=2e-2)


def test_tensor_core_arithmetic_at_length_zero_is_the_empty_result():
    q, kc, vc = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 12, 1, 192, 64))
    out, m, l = _tensor_core_decode(q, kc, vc, 0)
    assert not out.float().any() and bool((m == -1e30).all()) and not l.any()


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
