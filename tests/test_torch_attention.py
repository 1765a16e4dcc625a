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


# -- the bf16 tensor-core kernel's Python side --------------------------------

from repro_torch.kernels.attention import kernel as K  # noqa: E402


def _views():
    """(name, [B, S, heads, hd] view, dims, byte strides) for the layouts
    the serving path and the card tests hand the kernel."""
    b, s, h, hd, s_max = 2, 300, 6, 72, 512
    contiguous = torch.zeros((b, s, h, hd), dtype=torch.bfloat16)
    head_major = torch.zeros((b, h, s, hd), dtype=torch.bfloat16).transpose(1, 2)
    cache = torch.zeros((b, s_max, 2, hd), dtype=torch.bfloat16)[:, :s]
    fused = torch.zeros((b, s, h + 4, hd), dtype=torch.bfloat16)[:, :, h:h + 2]
    return [
        ("contiguous", contiguous, (hd, h, s, b), (hd * 2, h * hd * 2, s * h * hd * 2)),
        ("head_major", head_major, (hd, h, s, b), (s * hd * 2, hd * 2, h * s * hd * 2)),
        ("cache_prefix", cache, (hd, 2, s, b), (hd * 2, 2 * hd * 2, s_max * 2 * hd * 2)),
        ("fused_slice", fused, (hd, 2, s, b), (hd * 2, (h + 4) * hd * 2, s * (h + 4) * hd * 2)),
    ]


@pytest.mark.parametrize("case", range(4), ids=[v[0] for v in _views()])
def test_tma_layout_reads_views_in_place(case):
    _, t, dims, strides = _views()[case]
    got_dims, got_strides, box = K.tma_layout(t)
    assert got_dims == dims and got_strides == strides
    assert box == (64, 1, K.BLOCK_Q, 1)


def test_tma_layout_packs_size_one_dims_and_refuses_misaligned_strides():
    one_head = torch.zeros((1, 40, 8, 64), dtype=torch.bfloat16)[:, :, 3:4]
    assert K.tma_layout(one_head)[1] == (128, 8 * 128, 40 * 8 * 128)
    with pytest.raises(ValueError, match="16-byte"):
        K.tma_layout(torch.zeros((1, 40, 4, 68), dtype=torch.bfloat16)[..., :64])
    with pytest.raises(ValueError, match="contiguous last dimension"):
        K.tma_layout(torch.zeros((1, 40, 64, 4), dtype=torch.bfloat16).transpose(2, 3))


@pytest.mark.parametrize("hd", range(8, 193, 8))
def test_instantiated_hd_is_the_next_of_64_and_128(hd):
    """The bf16 kernel's width: the least of 64, 128 and 192 that holds hd
    (192 for nemotron-4's heads), and its k/v tile (112 positions at 192)."""
    assert K.instantiated_hd(hd) == (64 if hd <= 64 else 128 if hd <= 128 else 192)
    assert K.block_k(K.instantiated_hd(hd)) == (112 if hd > 128 else 128)
    with pytest.raises(ValueError, match="head dim"):
        K.instantiated_hd(hd + 4)
    if hd == 192:
        with pytest.raises(ValueError, match="head dim"):
            K.instantiated_hd(hd + 8)


def test_tma_layout_takes_the_k_tiles_rows():
    t = torch.zeros((1, 100, 2, 192), dtype=torch.bfloat16)
    assert K.tma_layout(t, K.block_k(192))[2] == (64, 1, 112, 1)
    assert K.tma_layout(t)[2] == (64, 1, K.BLOCK_Q, 1)


def test_the_192_wide_plan_fits_a_blocks_shared_memory():
    """The 192-wide kernel's tiles: its k/v tile is whole k16 steps of P V
    and one wgmma N and TMA box of Q K^T (a multiple of 16, at most 256),
    and the q tile, both rings and the barriers, after the 1 KB that aligns
    the base, fit the 232,448 bytes a block may take; one more stage, or
    128-position tiles, would not."""
    bk = K.block_k(192)
    assert bk % 16 == 0 and 8 <= bk <= 256
    smem = K.wide_smem_bytes()
    q_tile, kv_tile = K.BLOCK_Q * 192 * 2, bk * 192 * 2
    assert smem == 1024 + q_tile + 2 * K.WIDE_STAGES * kv_tile + 8 * (2 + 4 * K.WIDE_STAGES)
    assert smem <= 232_448
    assert K.wide_smem_bytes(stages=K.WIDE_STAGES + 1) > 232_448
    assert K.wide_smem_bytes(bk=128) > 232_448
    # every 1,024-byte swizzle span starts on its own: the tiles are whole spans
    assert q_tile % 1024 == 0 and kv_tile % 1024 == 0


@pytest.mark.parametrize("b,h,s,blocks", [(8, 96, 2048, 132), (1, 96, 4096, 132), (2, 3, 1, 132),
                                           (1, 2, 300, 132), (3, 5, 1000, 7)])
def test_persistent_items_visit_every_q_tile_once_longest_first(b, h, s, blocks):
    """The 192-wide kernel's persistent grid: min(items, blocks) blocks
    take every (b, h, q tile) exactly once; in the items' order (block k's
    i-th item is item k + i G) the q tiles go longest first, and each
    block's own items do too."""
    per_block = K.persistent_items(b, h, s, blocks)
    n_q = -(-s // K.BLOCK_Q)
    items = b * h * n_q
    assert len(per_block) == min(items, blocks)
    taken = [item for block in per_block for item in block]
    assert sorted(taken) == sorted((bb, hh, qt) for bb in range(b) for hh in range(h) for qt in range(n_q))
    grid = len(per_block)
    in_order = [per_block[j % grid][j // grid] for j in range(items)]
    assert [qt for _, _, qt in in_order] == sorted((qt for _, _, qt in in_order), reverse=True)
    for block in per_block:
        assert [qt for _, _, qt in block] == sorted((qt for _, _, qt in block), reverse=True)
    # the blocks' shares of the work (keys their q tiles read) differ by at most the longest item's
    work = [sum(min((qt + 1) * K.BLOCK_Q, s) for _, _, qt in block) for block in per_block]
    assert max(work) - min(work) <= n_q * K.BLOCK_Q


@pytest.mark.parametrize("case", range(4), ids=[v[0] for v in _views()])
def test_tma_layout_takes_the_gradients_box_rows(case):
    """The bf16 gradient reads q, k, v and dO through 64-row boxes, the
    layouts otherwise as the forward's."""
    _, t, dims, strides = _views()[case]
    assert K.BWD_BOX_ROWS == 64
    assert K.tma_layout(t, K.BWD_BOX_ROWS) == (dims, strides, (64, 1, 64, 1))


@pytest.mark.parametrize("s", [1, 37, 63, 64, 65, 1000, 4096, 4097])
def test_bwd_rows_pads_s_to_the_box_for_the_wgmma_widths_only(s):
    """D and lse2 rows: S rounded up to 64 for the wgmma instances (every
    bf16 width: 64, 128 and 192), whose bulk copies read whole 64-row
    slices; S for float32 (width 0)."""
    padded = -(-s // 64) * 64
    assert [K.bwd_rows(s, w) for w in (0, 64, 128, 192)] == [s, padded, padded, padded]
    assert padded % K.BWD_BOX_ROWS == 0 and padded - s < K.BWD_BOX_ROWS
    assert K.BWD_WGMMA_WIDTHS == K.WIDTHS == (64, 128, 192)


def _attention_p_in_bf16(q, k, v, tile=128):
    """What the tensor-core kernel computes: f32 scores over 128-key tiles,
    an online softmax in f32, P rounded to bf16 before P V (f32 sums); l
    sums the unrounded P."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    m = torch.full((b, h, s, 1), R.NEG_INF)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, hd))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, tile):
        cols = torch.arange(k0, min(k0 + tile, s))[None, :]
        logits = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2) / hd ** 0.5
        logits = torch.where(cols <= rows, logits, R.NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("b,s,h,kv,hd", SHAPES)
def test_bf16_p_rounding_stays_within_the_reference_tolerance(b, s, h, kv, hd):
    """Rounding P to bf16 before P V, as the tensor-core kernel does, stays
    within the reference's bf16 tolerance (2e-2) of its plain version and of
    its Pallas kernel in interpret mode: the card tests hold the kernel to
    that tolerance."""
    jx, tx = _as(_inputs(b, s, h, kv, hd), "bfloat16")
    got = _f32(_attention_p_in_bf16(*tx))
    np.testing.assert_allclose(got, _f32(R.mha_ref(*tx)), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, _f32(ref_ops.mha(*jx, use_kernel=True, interpret=True)), rtol=2e-2, atol=2e-2)


# -- soft cap and a q chunk at a cache offset, against the reference's
# _attn_core (the XLA attention its models run) -------------------------------

from repro.models import layers as jax_layers  # noqa: E402


def _core(q, k, v, offset, softcap):
    """The reference's _attn_core on q [B, S, H, hd] at positions offset + i
    over k/v [B, Skv, Kv, hd] with kv_limit offset + S."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = jnp.asarray(q).reshape(b, s, kv, h // kv, hd)
    pos = jnp.broadcast_to(offset + jnp.arange(s, dtype=jnp.int32), (b, s))
    limit = jnp.broadcast_to(jnp.int32(offset + s), (b,))
    out = jax_layers._attn_core(qg, jnp.asarray(k), jnp.asarray(v), pos, limit, softcap)
    return np.asarray(out).reshape(b, s, h, hd)


@pytest.mark.parametrize("softcap", [0.0, 30.0, 1.0])
@pytest.mark.parametrize("b,s,skv,h,kv,hd", [(2, 7, 16, 4, 2, 16), (1, 64, 64, 6, 2, 32),
                                             (2, 33, 200, 4, 4, 64), (1, 1, 9, 4, 1, 8)])
def test_mha_offset_and_softcap_match_the_reference_attn_core(b, s, skv, h, kv, hd, softcap):
    """k/v longer than q put q row i at position skv - s + i (a prefill
    chunk at a cache offset); softcap caps the scaled logits before the
    mask. The cache past skv is the reference's masked tail."""
    r = np.random.default_rng(2)
    q = (3.0 * r.normal(size=(b, s, h, hd))).astype(np.float32)
    k = (3.0 * r.normal(size=(b, skv + 5, kv, hd))).astype(np.float32)
    v = r.normal(size=(b, skv + 5, kv, hd)).astype(np.float32)
    want = _core(q, k, v, skv - s, softcap)
    got = ops.mha(*(torch.from_numpy(a) for a in (q, k[:, :skv], v[:, :skv])), softcap)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_mha_refuses_kv_shorter_than_q_on_the_plain_path_too():
    q, k = torch.zeros(1, 8, 2, 8), torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="shapes"):
        ops.mha(q, k, k)
