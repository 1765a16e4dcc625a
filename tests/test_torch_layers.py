"""The port's layers (``repro_torch.models.layers``) against
``repro.models.layers`` on the same numpy inputs and params, in float32
(rtol = atol = 1e-5): RMSNorm, RoPE, the four MLP variants, and attention
in its three routed modes (fresh causal, prefill into the cache, one-token
decode), the updated cache included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import layers as L
from repro_torch.configs import get_arch
from repro_torch.models import layers

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S_MAX = 2, 40


def _cfgs(**kw):
    return jax_arch("llama3.2-3b").smoke().scaled(**kw), get_arch("llama3.2-3b").smoke().scaled(**kw)


def _tree(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _x(b, s, d, seed):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_rms_norm():
    x = _x(2, 5, 64, 0)
    w = np.random.default_rng(1).normal(size=64).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           L.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("start", [0, 2000])
def test_apply_rope(start):
    x = np.random.default_rng(2).normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(start + np.arange(7, dtype=np.int32), (2, 7))
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 500000.0),
           L.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp(kind):
    jcfg, tcfg = _cfgs(mlp=kind)
    params = L.init_mlp(jax.random.PRNGKey(3), jcfg)
    x = _x(2, 5, jcfg.d_model, 4)
    _close(layers.mlp(_tree(params), torch.from_numpy(x), tcfg), L.mlp(params, jnp.asarray(x), jcfg))


@pytest.fixture(scope="module")
def attn():
    """One reference run of the three modes: fresh causal attention, a
    24-token prefill into an empty cache, then one decode token."""
    jcfg, tcfg = _cfgs()
    params = L.init_attention(jax.random.PRNGKey(5), jcfg)
    d = jcfg.d_model
    xp, xd = _x(B, 24, d, 6), _x(B, 1, d, 7)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (B, 24)).copy()
    pos_d = np.full((B, 1), 24, np.int32)
    cache0 = L.init_attention_cache(jcfg, B, S_MAX, jnp.float32)
    fresh, _ = L.attention(params, jnp.asarray(xp), jcfg, jnp.asarray(pos))
    pre, cache1 = L.attention(params, jnp.asarray(xp), jcfg, jnp.asarray(pos),
                              cache=cache0, cache_index=jnp.int32(0))
    dec, cache2 = L.attention(params, jnp.asarray(xd), jcfg, jnp.asarray(pos_d),
                              cache=cache1, cache_index=jnp.int32(24))
    want = {"fresh": fresh, "prefill": pre, "cache1": jax.tree.map(np.asarray, cache1),
            "decode": dec, "cache2": jax.tree.map(np.asarray, cache2)}
    inputs = {"xp": xp, "xd": xd, "pos": pos, "pos_d": pos_d}
    return tcfg, _tree(params), inputs, want


def test_attention_fresh_causal(attn):
    tcfg, params, inp, want = attn
    out, cache = layers.attention(params, torch.from_numpy(inp["xp"]), tcfg, torch.from_numpy(inp["pos"]))
    assert cache is None
    _close(out, want["fresh"])


def test_attention_prefill_into_cache_then_decode(attn):
    tcfg, params, inp, want = attn
    cache = layers.init_attention_cache(tcfg, B, S_MAX, torch.float32, device="cpu")
    out, cache1 = layers.attention(params, torch.from_numpy(inp["xp"]), tcfg,
                                   torch.from_numpy(inp["pos"]), cache=cache, cache_index=0)
    assert cache1 is cache  # updated in place
    _close(out, want["prefill"])
    for name in ("k", "v"):
        _close(cache1[name], want["cache1"][name])
    out, cache2 = layers.attention(params, torch.from_numpy(inp["xd"]), tcfg,
                                   torch.from_numpy(inp["pos_d"]), cache=cache1, cache_index=24)
    _close(out, want["decode"])
    for name in ("k", "v"):
        _close(cache2[name], want["cache2"][name])


def test_attention_long_sequence_matches_the_chunked_reference():
    """S = 1024 takes the reference's ATTN_CHUNK scan; the port's one mha
    call computes the same function."""
    jcfg, tcfg = _cfgs()
    params = L.init_attention(jax.random.PRNGKey(8), jcfg)
    x = _x(1, 1024, jcfg.d_model, 9)
    pos = np.arange(1024, dtype=np.int32)[None]
    want, _ = L.attention(params, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got, _ = layers.attention(_tree(params), torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    _close(got, want)


@pytest.mark.parametrize("softcap", [0.0, 30.0, 2.0])
def test_chunk_at_an_offset_matches_the_reference(softcap):
    """A 7-token chunk written at cache index 9 of a cache that holds 9
    earlier positions: the chunk's output and the cache equal the
    reference's (q_pos = index + i, kv_limit = index + S), with and
    without the attention-logit soft cap."""
    jcfg, tcfg = _cfgs(logit_softcap=softcap)
    params = L.init_attention(jax.random.PRNGKey(11), jcfg)
    x0, x1 = _x(B, 9, jcfg.d_model, 12), _x(B, 7, jcfg.d_model, 13)
    pos0 = np.broadcast_to(np.arange(9, dtype=np.int32), (B, 9)).copy()
    pos1 = np.broadcast_to(9 + np.arange(7, dtype=np.int32), (B, 7)).copy()
    jcache = L.init_attention_cache(jcfg, B, S_MAX, jnp.float32)
    _, jcache = L.attention(params, jnp.asarray(x0), jcfg, jnp.asarray(pos0), cache=jcache,
                            cache_index=jnp.int32(0))
    want, jcache = L.attention(params, jnp.asarray(x1), jcfg, jnp.asarray(pos1), cache=jcache,
                               cache_index=jnp.int32(9))
    tp = _tree(params)
    cache = layers.init_attention_cache(tcfg, B, S_MAX, torch.float32, device="cpu")
    layers.attention(tp, torch.from_numpy(x0), tcfg, torch.from_numpy(pos0), cache=cache, cache_index=0)
    got, cache = layers.attention(tp, torch.from_numpy(x1), tcfg, torch.from_numpy(pos1), cache=cache,
                                  cache_index=9)
    _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], np.asarray(jcache[name]))


@pytest.mark.parametrize("mode", ["fresh", "prefill", "decode"])
def test_soft_capped_attention_matches_the_reference(mode):
    """cfg.logit_softcap (grok-1's 30, and a cap of 1 that bends every
    logit) in each routed mode: the kernels' plain versions cap the scaled
    logits before the mask, as the reference's _soft_cap does."""
    for cap in (30.0, 1.0):
        jcfg, tcfg = _cfgs(logit_softcap=cap)
        params = L.init_attention(jax.random.PRNGKey(14), jcfg)
        tp = _tree(params)
        x = _x(B, 12, jcfg.d_model, 15) * 4.0
        pos = np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12)).copy()
        if mode == "fresh":
            want, _ = L.attention(params, jnp.asarray(x), jcfg, jnp.asarray(pos))
            got, _ = layers.attention(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos))
        else:
            jcache = L.init_attention_cache(jcfg, B, S_MAX, jnp.float32)
            cache = layers.init_attention_cache(tcfg, B, S_MAX, torch.float32, device="cpu")
            want, jcache = L.attention(params, jnp.asarray(x), jcfg, jnp.asarray(pos), cache=jcache,
                                       cache_index=jnp.int32(0))
            got, cache = layers.attention(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos), cache=cache,
                                          cache_index=0)
            if mode == "decode":
                xd = _x(B, 1, jcfg.d_model, 16) * 4.0
                pd = np.full((B, 1), 12, np.int32)
                want, _ = L.attention(params, jnp.asarray(xd), jcfg, jnp.asarray(pd), cache=jcache,
                                      cache_index=jnp.int32(12))
                got, _ = layers.attention(tp, torch.from_numpy(xd), tcfg, torch.from_numpy(pd), cache=cache,
                                          cache_index=12)
        _close(got, want)


def test_dense_init_is_a_truncated_normal_scaled_by_fan_in():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, (256, 512), torch.float32, device="cpu")
    assert w.abs().max() <= 2.0 / 16 and abs(float(w.std()) * 16 - 0.88) < 0.02
    again = layers.dense_init(torch.Generator().manual_seed(0), (256, 512), torch.float32, device="cpu")
    assert torch.equal(w, again)
