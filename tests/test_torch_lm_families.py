"""The port's LM (``repro_torch.models.lm``) against ``repro.models.lm``
for every family, on the reference's smoke config of each architecture
but llama3.2-3b (tests/test_torch_lm.py holds that one) (2 layers, d 64,
4 heads, hd 16, vocab 256, float32; moe
4 experts top-2 in groups of 32 tokens; hybrid one segment of 2 Mamba2
blocks; ssm one mLSTM + one sLSTM) and on tests/test_models.py's 4-layer
hybrid and ssm configs (two segments each), with the reference's params
carried across by ``convert.lm_params_from_numpy``.

Held at rtol = atol = 1e-4 (the reference's own chunked-vs-unchunked
attention bound): ``forward`` logits and aux, ``prefill``, a prefill into
the cache (the vlm/audio prefix prepended) plus teacher-forced decode
steps, the cache after the steps, and the serving steps' greedy tokens.
The ssm family replays its prompt token by token from an empty cache,
since an mLSTM prefill into a cache raises in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.launch import serve as jax_serve
from repro.models import lm as jax_lm
from repro_torch import convert
from repro_torch.configs import all_archs, get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import serve
from repro_torch.models import lm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
B, PROMPT, STEPS, S_MAX = 2, 24, 5, 40

# tests/test_models.py's multi-segment configs
MULTI = {
    "t-hyb": dict(family="hybrid", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
                  ssm_state=16, ssm_head_dim=16, attn_every=2, dtype="float32"),
    "t-ssm": dict(family="ssm", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=128,
                  slstm_every=2, dtype="float32"),
}
CASES = sorted(set(all_archs()) - {"llama3.2-3b"}) + sorted(MULTI)


def _cfgs(case):
    if case in MULTI:
        return JaxArchConfig(case, **MULTI[case]), ArchConfig(case, **MULTI[case])
    return jax_arch(case).smoke(), get_arch(case).smoke()


_RUNS = {}


def _run(case):
    """One reference run of a case, cached for the module's tests."""
    if case in _RUNS:
        return _RUNS[case]
    jcfg, tcfg = _cfgs(case)
    params = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    r = np.random.default_rng(1)
    tokens = r.integers(0, jcfg.vocab, size=(B, PROMPT + STEPS)).astype(np.int32)
    prefix = r.normal(size=(B, jcfg.n_prefix, jcfg.d_model)).astype(np.float32) if jcfg.n_prefix else None
    jprefix = None if prefix is None else jnp.asarray(prefix)
    prompt = jnp.asarray(tokens[:, :PROMPT])
    logits, aux, _ = jax_lm.forward(params, prompt, jcfg, prefix_embeds=jprefix)
    out = {"forward": logits, "aux": aux, "prefill": jax_lm.prefill(params, prompt, jcfg, prefix_embeds=jprefix)}
    cache = jax_lm.init_cache(jcfg, B, S_MAX)
    steps = []
    if jcfg.family == "ssm":
        for t in range(PROMPT + STEPS):
            step_logits, cache = jax_lm.decode_step(params, jnp.asarray(tokens[:, t:t + 1]), cache, jcfg)
            steps.append(step_logits)
    else:
        step_logits, _, cache = jax_lm.forward(params, prompt, jcfg, prefix_embeds=jprefix, cache=cache)
        steps.append(step_logits[:, -1])
        for t in range(STEPS):
            step_logits, cache = jax_lm.decode_step(params, jnp.asarray(tokens[:, PROMPT + t:PROMPT + t + 1]),
                                                    cache, jcfg)
            steps.append(step_logits)
    out["steps"], out["cache"] = steps, jax.tree.map(np.asarray, cache)
    batch = {"tokens": prompt} if prefix is None else {"tokens": prompt, "prefix_embeds": jprefix}
    out["next_prefill"] = jax_serve.make_prefill_step(jcfg)(params, batch)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    _RUNS[case] = (tcfg, tparams, tokens, prefix, out)
    return _RUNS[case]


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) if k != "index" for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("case", CASES)
def test_forward_logits_and_aux(case):
    tcfg, params, tokens, prefix, want = _run(case)
    logits, aux, cache = lm.forward(params, _t(tokens[:, :PROMPT]), tcfg, prefix_embeds=_t(prefix))
    assert logits.shape == (B, tcfg.n_prefix + PROMPT, tcfg.vocab) and cache is None
    _close(logits, want["forward"])
    np.testing.assert_allclose(float(aux), float(want["aux"]), **TOL)
    assert (float(aux) > 0) == bool(tcfg.n_experts)


@pytest.mark.parametrize("case", CASES)
def test_prefill(case):
    tcfg, params, tokens, prefix, want = _run(case)
    _close(lm.prefill(params, _t(tokens[:, :PROMPT]), tcfg, prefix_embeds=_t(prefix)), want["prefill"])


@pytest.mark.parametrize("case", CASES)
def test_decode_replay_and_cache(case):
    """Prefill into the cache (the ssm: token by token), then teacher-forced
    steps: every step's logits and the cache after the last step."""
    tcfg, params, tokens, prefix, want = _run(case)
    cache = lm.init_cache(tcfg, B, S_MAX, device="cpu")
    got = []
    if tcfg.family == "ssm":
        for t in range(PROMPT + STEPS):
            logits, cache = lm.decode_step(params, _t(tokens[:, t:t + 1]), cache, tcfg)
            got.append(logits)
    else:
        logits, cache = lm.decode_step(params, _t(tokens[:, :PROMPT]), cache, tcfg, prefix_embeds=_t(prefix))
        got.append(logits)
        for t in range(STEPS):
            logits, cache = lm.decode_step(params, _t(tokens[:, PROMPT + t:PROMPT + t + 1]), cache, tcfg)
            got.append(logits)
    assert len(got) == len(want["steps"])
    for g, w in zip(got, want["steps"]):
        _close(g, w)
    ref_cache = convert.cache_from_numpy(want["cache"], "cpu")
    assert cache["index"] == ref_cache["index"] == tcfg.n_prefix + PROMPT + STEPS
    assert sorted(cache) == sorted(ref_cache)
    mine, theirs = _leaves(cache), _leaves(ref_cache)
    assert len(mine) == len(theirs) > 0
    for g, w in zip(mine, theirs):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w)


@pytest.mark.parametrize("case", CASES)
def test_serving_steps_pick_the_reference_tokens(case):
    tcfg, params, tokens, prefix, want = _run(case)
    batch = {"tokens": _t(tokens[:, :PROMPT])}
    if prefix is not None:
        batch["prefix_embeds"] = _t(prefix)
    logits = serve.make_prefill_step(tcfg)(params, batch)
    _close(logits, want["next_prefill"])
    if tcfg.family == "ssm":
        return  # no prefill into a cache (an mLSTM raises)
    step = serve.make_decode_step(tcfg)
    nxt, cache = step(params, {**batch, "cache": lm.init_cache(tcfg, B, S_MAX, device="cpu")})
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(want["steps"][0]).argmax(-1))
    nxt, cache = step(params, {"tokens": nxt[:, None], "cache": cache})
    assert nxt.dtype == torch.int32 and cache["index"] == tcfg.n_prefix + PROMPT + 1


def test_mlstm_prefill_into_a_cache_raises_as_the_reference_does():
    tcfg = get_arch("xlstm-350m").smoke()
    jcfg = jax_arch("xlstm-350m").smoke()
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="prefill-into-cache"):
        jax_lm.decode_step(jparams, jnp.zeros((1, 4), jnp.int32), jax_lm.init_cache(jcfg, 1, 8), jcfg)
    params = lm.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="prefill-into-cache"):
        lm.decode_step(params, torch.zeros((1, 4), dtype=torch.long), lm.init_cache(tcfg, 1, 8, device="cpu"), tcfg)


@pytest.mark.parametrize("case", ["zamba2-2.7b", "t-hyb", "grok-1-314b", "internvl2-2b"])
def test_chunked_prefill_at_an_offset_matches_the_reference(case):
    """The prompt in two chunks (the prefix and 8 tokens, then 16 at the
    cache index): the second chunk's logits and the cache equal the
    reference's same two calls. Without experts they also equal the
    one-shot prefill's (a MoE routes each call's tokens as its own groups,
    so its capacity drops depend on the chunking, in both packages)."""
    tcfg, params, tokens, prefix, want = _run(case)
    jcfg, _ = _cfgs(case)
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    jcache = jax_lm.init_cache(jcfg, B, S_MAX)
    _, _, jcache = jax_lm.forward(jparams, jnp.asarray(tokens[:, :8]), jcfg,
                                  prefix_embeds=None if prefix is None else jnp.asarray(prefix), cache=jcache)
    jlogits, _, jcache = jax_lm.forward(jparams, jnp.asarray(tokens[:, 8:PROMPT]), jcfg, cache=jcache)
    cache = lm.init_cache(tcfg, B, S_MAX, device="cpu")
    _, cache = lm.decode_step(params, _t(tokens[:, :8]), cache, tcfg, prefix_embeds=_t(prefix))
    logits, cache = lm.decode_step(params, _t(tokens[:, 8:PROMPT]), cache, tcfg)
    _close(logits, np.asarray(jlogits)[:, -1])
    if not tcfg.n_experts:
        _close(logits, want["steps"][0])
    for g, w in zip(_leaves(cache), _leaves(convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu"))):
        _close(g, w)


@pytest.mark.parametrize("case", ["qwen3-moe-235b-a22b", "zamba2-2.7b", "xlstm-350m"])
def test_params_carry_across_and_init_has_the_reference_structure(case):
    """``init_lm`` builds the tree ``convert`` makes of the reference's
    params: same keys, nesting and shapes."""
    tcfg, params, _, _, _ = _run(case)
    ours = lm.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(ours) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_cast_params_keeps_what_the_reference_reads_in_float32():
    """The compute-dtype copy casts matrices once; 1-d params and the
    sLSTM's recurrent weights (read in float32 by the reference) stay."""
    for name in ("zamba2-2.7b", "xlstm-350m", "qwen3-moe-235b-a22b"):
        cfg = get_arch(name).smoke().scaled(dtype="bfloat16")
        cast = lm.cast_params(lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg)
        if name == "zamba2-2.7b":
            mp = cast["mamba"][0][0]
            assert mp["w_in"].dtype == mp["conv_w"].dtype == torch.bfloat16
            assert all(mp[k].dtype == torch.float32 for k in ("a_log", "dt_bias", "d_skip", "conv_b", "norm"))
        elif name == "xlstm-350m":
            assert cast["slstm"][0]["r_h"].dtype == torch.float32 and cast["slstm"][0]["w_x"].dtype == torch.bfloat16
            assert cast["mlstm"][0][0]["b_i"].dtype == torch.float32
        else:
            assert cast["blocks"][0]["moe"]["w_in"].dtype == torch.bfloat16
            assert cast["blocks"][0]["moe"]["router"].dtype == torch.bfloat16
