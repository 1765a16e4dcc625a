"""The gradient of the port's attention: ``ref.mha_backward_ref`` (the plain
version of the gradient kernels, recomputing P from the forward's
log-sum-exp) against ``torch.autograd`` through ``ref.mha_ref`` and
against ``jax.vjp`` of the JAX package's attention (``attention_ref``;
with a soft cap, ``models.layers._attn_core``, which applies it), and
``ref.mha_lse_ref`` against ``jax.nn.logsumexp`` of the same logits.
GQA g in {1, 3}, hd in {16, 64, 192}, S in {1, 37, 128}, soft cap off and
30; and qwen3-moe's wide group, g 16, at hd 16 and 64. Tolerance: the
kernels' rtol=2e-4, atol=2e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ref import attention_ref
from repro.models.layers import _attn_core
from repro_torch.kernels.attention import ref as R

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
B, KV = 2, 2
CASES = [(g, hd, s, cap) for g in (1, 3) for hd in (16, 64, 192) for s in (1, 37, 128) for cap in (0.0, 30.0)]
CASES += [(16, hd, s, cap) for hd in (16, 64) for s in (1, 37, 128) for cap in (0.0, 30.0)]


def _inputs(g, hd, s, seed):
    r = np.random.default_rng(seed)
    h = g * KV
    q = (2.0 * r.normal(size=(B, s, h, hd))).astype(np.float32)  # logits past the cap
    k, v = (r.normal(size=(B, s, KV, hd)).astype(np.float32) for _ in range(2))
    do = r.normal(size=(B, s, h, hd)).astype(np.float32)
    return q, k, v, do


def _jax_attention(q, k, v, cap):
    """The reference's attention in the port's [B, S, H, hd] layout."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if cap:
        pos = jnp.broadcast_to(jnp.arange(s), (b, s))
        out = _attn_core(q.reshape(b, s, kv, h // kv, hd), k, v, pos, jnp.full((b,), s), cap)
        return out.reshape(b, s, h, hd)
    flat = lambda t: t.transpose(0, 2, 1, 3).reshape(-1, s, t.shape[-1])  # noqa: E731
    return attention_ref(flat(q), flat(k), flat(v)).reshape(b, h, s, hd).transpose(0, 2, 1, 3)


@functools.partial(jax.jit, static_argnums=4)
def _jax_vjp(q, k, v, do, cap):
    out, vjp = jax.vjp(lambda a, b_, c: _jax_attention(a, b_, c, cap), q, k, v)
    return out, vjp(do)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("g,hd,s,cap", CASES)
def test_backward_ref_matches_autograd_and_jax_vjp(g, hd, s, cap):
    q, k, v, do = _inputs(g, hd, s, seed=g * 1000 + hd + s)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = R.mha_ref(*leaves, cap)
    out.backward(torch.from_numpy(do))
    lse = R.mha_lse_ref(leaves[0].detach(), leaves[1].detach(), cap)
    got = R.mha_backward_ref(*(t.detach() for t in leaves), out.detach(), lse, torch.from_numpy(do), cap)
    want_out, want = _jax_vjp(q, k, v, do, cap)
    _close(out, want_out)
    for mine, auto, ref in zip(got, leaves, want):
        assert mine.dtype == torch.float32 and mine.shape == auto.shape
        _close(mine, auto.grad.numpy())
        _close(mine, ref)


@pytest.mark.parametrize("g,hd,s,cap", [c for c in CASES if c[1] == 64])
def test_lse_ref_matches_jax_logsumexp(g, hd, s, cap):
    q, k, _, _ = _inputs(g, hd, s, seed=7 + s)
    h = g * KV
    kr = np.repeat(k, g, axis=2)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, kr) / jnp.sqrt(jnp.float32(hd))
    if cap:
        logits = cap * jnp.tanh(logits / cap)
    logits = jnp.where(jnp.tril(jnp.ones((s, s), bool)), logits, -1e30)
    got = R.mha_lse_ref(torch.from_numpy(q), torch.from_numpy(k), cap)
    assert got.shape == (B, h, s) and got.dtype == torch.float32
    _close(got, jax.nn.logsumexp(logits, axis=-1))


def test_backward_ref_keeps_the_input_dtype():
    q, k, v, do = (torch.from_numpy(t).to(torch.bfloat16) for t in _inputs(3, 64, 37, seed=1))
    o = R.mha_ref(q, k, v)
    grads = R.mha_backward_ref(q, k, v, o, R.mha_lse_ref(q, k), do)
    assert [t.dtype for t in grads] == [torch.bfloat16] * 3
    assert [t.shape for t in grads] == [q.shape, k.shape, v.shape]


LOG2E = 1.4426950408889634


def _wgmma_backward(q, k, v, o, lse, do, cap):
    """What the bf16 tensor-core gradient kernels (flash_attention_bwd.cu,
    widths 64, 128 and 192) compute, in float32 with bf16 roundings where
    they round: lse in log2 units; P = exp2(x - lse2) with x the scaled
    logit in log2 units (capped through tanh as 1 - 2 / (e^{2y} + 1)); P and
    dS rounded to bf16 as the A operands of dV += P^T dO, dK += dS^T Q and
    dQ += dS K; dS without the scale, which is applied to dk and dq after
    the sums; with a cap, the cap's derivative 1 - t^2 from the same t. At
    192 the dk/dv kernel hands P^T (1 - t^2) from one consumer warpgroup to
    the other in float32, so dS^T takes the same single rounding to bf16."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / hd ** 0.5
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    qh, doh, oh = (t.float().transpose(1, 2) for t in (q, do, o))  # [B, H, S, hd]
    kh, vh = (t.float().transpose(1, 2).repeat_interleave(g, dim=1) for t in (k, v))
    lse2 = lse.float()[..., None] * LOG2E
    delta = (doh * oh).sum(-1, keepdim=True)
    raw = qh @ kh.transpose(-1, -2)
    t = 1.0 - 2.0 / (torch.exp2((raw * (scale / cap)).clamp(-15.0, 15.0) * 2.0 * LOG2E) + 1.0) if cap else None
    x = cap * LOG2E * t if cap else raw * (scale * LOG2E)
    mask = torch.tril(torch.ones(s, s, dtype=torch.bool))
    p = torch.where(mask, torch.exp2(x - lse2), torch.zeros(()))
    ds = p * (doh @ vh.transpose(-1, -2) - delta)
    if cap:
        ds = ds * (1.0 - t * t)
    p, ds = bf(p), bf(ds)
    dq = scale * (ds @ kh)
    dk, dv = scale * (ds.transpose(-1, -2) @ qh), p.transpose(-1, -2) @ doh

    def kv_heads(t):  # [B, H, S, hd] -> [B, S, Kv, hd], summing each group
        return t.reshape(b, kv, g, s, hd).sum(2).transpose(1, 2)

    return dq.transpose(1, 2), kv_heads(dk), kv_heads(dv)


@pytest.mark.parametrize("g,hd,s,cap", [(g, hd, s, cap) for g in (1, 3) for hd in (64, 128, 192)
                                        for s in (37, 128) for cap in (0.0, 30.0)])
def test_wgmma_gradients_arithmetic_stays_within_the_bf16_tolerance_of_jax_vjp(g, hd, s, cap):
    """The bf16 kernels' roundings (P and dS in bf16, the scale after the
    sums, the cap's tanh and derivative as they form them) held to jax.vjp
    of the reference on the same bf16-valued inputs, at the tolerance the
    card holds the kernels to (tests/test_torch_cuda.py): 2e-2, the
    absolute part scaled by the largest entry."""
    q, k, v, do = (torch.from_numpy(t).to(torch.bfloat16) for t in _inputs(g, hd, s, seed=g + hd + s))
    o = R.mha_ref(q, k, v, cap)
    lse = R.mha_lse_ref(q, k, cap)
    got = _wgmma_backward(q, k, v, o, lse, do, cap)
    _, want = _jax_vjp(*(t.float().numpy() for t in (q, k, v, do)), cap)
    for mine, ref in zip(got, want):
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(mine.numpy(), ref, rtol=2e-2, atol=2e-2 * scale)
