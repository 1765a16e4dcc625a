"""The port's Mamba2 mixer (``repro_torch.models.mamba2``) against
``repro.models.mamba2`` on the same numpy params and inputs, float32 at
rtol = atol = 1e-4: the causal conv (with and without a carried state),
the chunked SSD (one chunk, several, a carried initial state), the
one-token recurrence, and the block in its three modes (prefill from
scratch, prefill into a cache, decode), the float32 cache included; bf16
compute at the reference's bf16 tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import mamba2 as jax_mamba
from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba2

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(family="hybrid", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_ff=0, vocab=64,
            ssm_state=8, ssm_head_dim=16, attn_every=2, dtype="float32")


def _cfgs(**kw):
    return JaxArchConfig("t", **{**BASE, **kw}), ArchConfig("t", **{**BASE, **kw})


def _np(*shapes, seed=0, scale=1.0):
    r = np.random.default_rng(seed)
    return [(scale * r.normal(size=s)).astype(np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, dtype=np.float32), **(tol or TOL))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    x, w, b, st = _np((2, 9, 12), (4, 12), (12,), (2, 3, 12), seed=1)
    want = jax_mamba._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  jnp.asarray(st) if with_state else None)
    got = mamba2._causal_conv(_t(x), _t(w), _t(b), _t(st) if with_state else None)
    for g, w_ in zip(got, want):
        _close(g, w_)


def _ssd_inputs(bs, l, h, p, n, seed):
    x, b, c, dt_raw, init = _np((bs, l, h, p), (bs, l, n), (bs, l, n), (bs, l, h), (bs, h, p, n), seed=seed)
    dt = np.log1p(np.exp(dt_raw - 2.0)).astype(np.float32)
    a = -np.linspace(1.0, 4.0, h).astype(np.float32)
    d_skip = np.linspace(0.5, 1.5, h).astype(np.float32)
    return x, dt, a, b, c, d_skip, init


@pytest.mark.parametrize("l", [16, 256, 512])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(l, with_state):
    """One chunk (16, 256 tokens) and two chunks of 256 (512 tokens)."""
    x, dt, a, b, c, d_skip, init = _ssd_inputs(2, l, 3, 8, 4, seed=2)
    want = jax_mamba.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, b, c, d_skip)),
                                 jnp.asarray(init) if with_state else None)
    got = mamba2.ssd_chunked(*(_t(v) for v in (x, dt, a, b, c, d_skip)), _t(init) if with_state else None)
    for g, w in zip(got, want):
        _close(g, w)


def test_ssd_chunked_refuses_a_ragged_sequence_as_the_reference_does():
    x, dt, a, b, c, d_skip, _ = _ssd_inputs(1, 300, 2, 4, 4, seed=3)
    with pytest.raises(AssertionError):
        jax_mamba.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, b, c, d_skip)))
    with pytest.raises(ValueError, match="chunk"):
        mamba2.ssd_chunked(*(_t(v) for v in (x, dt, a, b, c, d_skip)))


def test_ssd_step_is_the_chunked_scan_one_token_at_a_time():
    x, dt, a, b, c, d_skip, init = _ssd_inputs(2, 5, 3, 8, 4, seed=4)
    jstate, tstate = jnp.asarray(init), _t(init)
    for t in range(5):
        jy, jstate = jax_mamba.ssd_step(*(jnp.asarray(v[:, t]) if v.ndim > 1 else jnp.asarray(v)
                                          for v in (x, dt, a, b, c, d_skip)), jstate)
        ty, tstate = mamba2.ssd_step(*(_t(v[:, t]) if v.ndim > 1 else _t(v)
                                       for v in (x, dt, a, b, c, d_skip)), tstate)
        _close(ty, jy)
        _close(tstate, jstate)
    chunk = mamba2.ssd_chunked(*(_t(v) for v in (x, dt, a, b, c, d_skip)), _t(init))
    _close(chunk[1], jstate)


@pytest.fixture(scope="module")
def block():
    jcfg, tcfg = _cfgs()
    params = jax_mamba.init_mamba(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, {k: _t(v) for k, v in params.items()}


def test_mamba_block_prefill_from_scratch(block):
    jcfg, tcfg, params, tparams = block
    (x,) = _np((2, 32, jcfg.d_model), seed=5)
    want, wc = jax_mamba.mamba_block(params, jnp.asarray(x), jcfg)
    got, gc = mamba2.mamba_block(tparams, _t(x), tcfg)
    assert wc is None and gc is None
    _close(got, want)


def test_mamba_block_prefill_into_cache_then_decode(block):
    """A 16-token prefill into the cache, then 4 one-token steps: every
    output and the float32 cache after each call."""
    jcfg, tcfg, params, tparams = block
    (x,) = _np((2, 20, jcfg.d_model), seed=6)
    jcache = jax_mamba.init_mamba_cache(jcfg, 2)
    tcache = mamba2.init_mamba_cache(tcfg, 2, device="cpu")
    for lo, hi in ((0, 16), (16, 17), (17, 18), (18, 19), (19, 20)):
        want, jcache = jax_mamba.mamba_block(params, jnp.asarray(x[:, lo:hi]), jcfg, cache=jcache)
        got, tcache = mamba2.mamba_block(tparams, _t(x[:, lo:hi]), tcfg, cache=tcache)
        _close(got, want)
        for k in ("conv", "ssm"):
            assert tcache[k].dtype == torch.float32
            _close(tcache[k], jcache[k])


def test_mamba_block_in_bf16_keeps_the_references_dtype_steps():
    """bf16 compute, float32 params: dt and the decays in float32, the
    products in bf16, the cache stored in float32 (reference bf16
    tolerance, 2e-2)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    params = jax_mamba.init_mamba(jax.random.PRNGKey(1), jcfg)
    tparams = {k: _t(v) for k, v in params.items()}
    (x,) = _np((2, 16, jcfg.d_model), seed=7, scale=0.5)
    jcache, tcache = jax_mamba.init_mamba_cache(jcfg, 2), mamba2.init_mamba_cache(tcfg, 2, device="cpu")
    for lo, hi in ((0, 15), (15, 16)):
        want, jcache = jax_mamba.mamba_block(params, jnp.asarray(x[:, lo:hi]).astype(jnp.bfloat16), jcfg,
                                             cache=jcache)
        got, tcache = mamba2.mamba_block(tparams, _t(x[:, lo:hi]).bfloat16(), tcfg, cache=tcache)
        assert got.dtype == torch.bfloat16 and tcache["ssm"].dtype == torch.float32
        _close(got, want.astype(jnp.float32), rtol=2e-2, atol=2e-2)
        _close(tcache["ssm"], jcache["ssm"], rtol=2e-2, atol=2e-2)


def test_dims_and_init_shapes_match_the_reference():
    jcfg, tcfg = _cfgs()
    assert mamba2.dims(tcfg) == jax_mamba.dims(jcfg)
    ours = mamba2.init_mamba(torch.Generator().manual_seed(0), tcfg, device="cpu")
    theirs = jax_mamba.init_mamba(jax.random.PRNGKey(0), jcfg)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape
    for k in ("conv_b", "a_log", "dt_bias", "d_skip", "norm"):  # deterministic
        _close(ours[k], theirs[k], rtol=1e-6, atol=1e-6)
