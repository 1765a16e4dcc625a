"""The gradient of the port's attention: ``ref.mha_backward_ref`` (the plain
version of the gradient kernels, recomputing P from the forward's
log-sum-exp) against ``torch.autograd`` through ``ref.mha_ref`` and
against ``jax.vjp`` of the JAX package's attention (``attention_ref``;
with a soft cap, ``models.layers._attn_core``, which applies it), and
``ref.mha_lse_ref`` against ``jax.nn.logsumexp`` of the same logits.
GQA g in {1, 3}, hd in {16, 64, 192}, S in {1, 37, 128}, soft cap off and
30. Tolerance: the kernels' rtol=2e-4, atol=2e-5."""

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
