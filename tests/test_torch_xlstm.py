"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against
``repro.models.xlstm`` on the same numpy params and inputs, float32 at
rtol = atol = 1e-4: the stabilised parallel mLSTM, its recurrence, the
mLSTM block (parallel and decode; a prefill into a cache raises in both),
the sLSTM cell and block (from scratch and into a cache), and the
reference's own parallel-vs-recurrent check (2e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import xlstm as jax_xlstm
from repro_torch.configs.base import ArchConfig
from repro_torch.models import xlstm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(family="ssm", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_ff=0, vocab=64,
            slstm_every=2, dtype="float32")


def _cfgs(**kw):
    return JaxArchConfig("t", **{**BASE, **kw}), ArchConfig("t", **{**BASE, **kw})


def _np(*shapes, seed=0, scale=1.0):
    r = np.random.default_rng(seed)
    return [(scale * r.normal(size=s)).astype(np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(p):
    return {k: _t(v) for k, v in p.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("s", [1, 7, 64])
def test_mlstm_parallel(s):
    q, k, v, i_pre, f_pre = _np((2, s, 3, 8), (2, s, 3, 8), (2, s, 3, 8), (2, s, 3), (2, s, 3), seed=s)
    want = jax_xlstm.mlstm_parallel(*(jnp.asarray(a) for a in (q, k, v, i_pre, f_pre)))
    _close(xlstm.mlstm_parallel(*(_t(a) for a in (q, k, v, i_pre, f_pre))), want)


def test_mlstm_step_from_the_initial_state():
    jcfg, tcfg = _cfgs()
    q, k, v, i_pre, f_pre = _np((2, 4, 16), (2, 4, 16), (2, 4, 16), (2, 4), (2, 4), seed=1)
    jstate = {kk: jnp.asarray(vv) for kk, vv in jax.tree.map(np.asarray, jax_xlstm.init_mlstm_cache(jcfg, 2)).items()}
    tstate = xlstm.init_mlstm_cache(tcfg, 2, device="cpu")
    for _ in range(3):
        jh, jstate = jax_xlstm.mlstm_step(*(jnp.asarray(a) for a in (q, k, v, i_pre, f_pre)), jstate)
        th, tstate = xlstm.mlstm_step(*(_t(a) for a in (q, k, v, i_pre, f_pre)), tstate)
        _close(th, jh)
        for name in ("c", "n", "m"):
            _close(tstate[name], jstate[name])


@pytest.fixture(scope="module")
def blocks():
    jcfg, tcfg = _cfgs()
    mp = jax_xlstm.init_mlstm(jax.random.PRNGKey(0), jcfg)
    sp = jax_xlstm.init_slstm(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, mp, _tree(mp), sp, _tree(sp)


def test_mlstm_block_parallel_and_decode(blocks):
    jcfg, tcfg, mp, tmp, _, _ = blocks
    (x,) = _np((2, 12, jcfg.d_model), seed=2)
    want, _ = jax_xlstm.mlstm_block(mp, jnp.asarray(x), jcfg)
    got, cache = xlstm.mlstm_block(tmp, _t(x), tcfg)
    assert cache is None
    _close(got, want)
    jcache = jax_xlstm.init_mlstm_cache(jcfg, 2)
    tcache = xlstm.init_mlstm_cache(tcfg, 2, device="cpu")
    for t in range(4):
        want, jcache = jax_xlstm.mlstm_block(mp, jnp.asarray(x[:, t:t + 1]), jcfg, cache=jcache)
        got, tcache = xlstm.mlstm_block(tmp, _t(x[:, t:t + 1]), tcfg, cache=tcache)
        _close(got, want)
        for name in ("c", "n", "m"):
            _close(tcache[name], jcache[name])


def test_mlstm_prefill_into_a_cache_raises_in_both(blocks):
    jcfg, tcfg, mp, tmp, _, _ = blocks
    (x,) = _np((1, 3, jcfg.d_model), seed=3)
    with pytest.raises(NotImplementedError, match="prefill-into-cache"):
        jax_xlstm.mlstm_block(mp, jnp.asarray(x), jcfg, cache=jax_xlstm.init_mlstm_cache(jcfg, 1))
    with pytest.raises(NotImplementedError, match="prefill-into-cache"):
        xlstm.mlstm_block(tmp, _t(x), tcfg, cache=xlstm.init_mlstm_cache(tcfg, 1, device="cpu"))


@pytest.mark.parametrize("with_cache", [False, True])
def test_slstm_block(blocks, with_cache):
    """A 9-token run from scratch, or into a cache followed by one step."""
    jcfg, tcfg, _, _, sp, tsp = blocks
    (x,) = _np((2, 10, jcfg.d_model), seed=4)
    jc = jax_xlstm.init_slstm_cache(jcfg, 2) if with_cache else None
    tc = xlstm.init_slstm_cache(tcfg, 2, device="cpu") if with_cache else None
    want, jc = jax_xlstm.slstm_block(sp, jnp.asarray(x[:, :9]), jcfg, cache=jc)
    got, tc = xlstm.slstm_block(tsp, _t(x[:, :9]), tcfg, cache=tc)
    _close(got, want)
    if not with_cache:
        assert tc is None
        return
    want, jc = jax_xlstm.slstm_block(sp, jnp.asarray(x[:, 9:]), jcfg, cache=jc)
    got, tc = xlstm.slstm_block(tsp, _t(x[:, 9:]), tcfg, cache=tc)
    _close(got, want)
    for name in ("c", "n", "h", "m"):
        _close(tc[name], jc[name])


def test_parallel_mlstm_block_matches_its_recurrence(blocks):
    """The reference's own check (tests/test_models.py): the parallel form
    and the token-by-token recurrence agree within 2e-3."""
    jcfg, tcfg, _, tmp, _, _ = blocks
    (x,) = _np((2, 16, jcfg.d_model), seed=5)
    par, _ = xlstm.mlstm_block(tmp, _t(x), tcfg)
    cache = xlstm.init_mlstm_cache(tcfg, 2, device="cpu")
    seq = []
    for t in range(16):
        out, cache = xlstm.mlstm_block(tmp, _t(x[:, t:t + 1]), tcfg, cache=cache)
        seq.append(out)
    assert float((par - torch.cat(seq, dim=1)).abs().max()) < 2e-3


def test_init_shapes_match_the_reference():
    jcfg, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    for ours, theirs in ((xlstm.init_mlstm(gen, tcfg, device="cpu"), jax_xlstm.init_mlstm(jax.random.PRNGKey(0), jcfg)),
                         (xlstm.init_slstm(gen, tcfg, device="cpu"), jax_xlstm.init_slstm(jax.random.PRNGKey(0), jcfg))):
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert tuple(ours[k].shape) == theirs[k].shape
    _close(xlstm.init_slstm(gen, tcfg, device="cpu")["b"], jax_xlstm.init_slstm(jax.random.PRNGKey(0), jcfg)["b"])
