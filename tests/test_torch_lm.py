"""The port's LM (``repro_torch.models.lm``) and its serving steps
(``repro_torch.launch.serve``) against ``repro.models.lm`` and
``repro.launch.serve`` on llama3.2-3b's smoke config (2 layers, d 64,
4/2 heads, hd 16, vocab 256, float32), with the reference's params
carried across by ``convert.lm_params_from_numpy``. Tolerance rtol = atol
= 1e-4, the reference's own chunked-vs-unchunked attention bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.launch import serve as jax_serve
from repro.models import lm as jax_lm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import lm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
B, PROMPT, STEPS, S_MAX = 2, 24, 8, 40


@pytest.fixture(scope="module")
def ref():
    """One reference run: forward, prefill, a prefill into the cache plus
    STEPS teacher-forced decode steps, and the serving steps' tokens."""
    jcfg = jax_arch("llama3.2-3b").smoke()
    params = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, size=(B, PROMPT + STEPS)).astype(np.int32)
    prompt = jnp.asarray(tokens[:, :PROMPT])
    out = {"forward": jax_lm.forward(params, prompt, jcfg)[0],
           "prefill": jax_lm.prefill(params, prompt, jcfg)}
    cache = jax_lm.init_cache(jcfg, B, S_MAX)
    logits, cache = jax_lm.decode_step(params, prompt, cache, jcfg)
    steps = [logits]
    for t in range(STEPS):
        logits, cache = jax_lm.decode_step(params, jnp.asarray(tokens[:, PROMPT + t:PROMPT + t + 1]), cache, jcfg)
        steps.append(logits)
    out["steps"] = steps
    out["cache"] = jax.tree.map(np.asarray, cache)
    out["next_prefill"] = jax_serve.make_prefill_step(jcfg)(params, {"tokens": prompt})
    out["next_decode"], _ = jax_serve.make_decode_step(jcfg)(
        params, {"tokens": prompt, "cache": jax_lm.init_cache(jcfg, B, S_MAX)})
    tcfg = get_arch("llama3.2-3b").smoke()
    return tcfg, convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu"), tokens, out


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_carry_across_one_to_one(ref):
    tcfg, params, _, _ = ref
    assert len(params["blocks"]) == tcfg.n_layers and "lm_head" not in params  # tied
    assert params["blocks"][0]["attn"]["wq"].shape == (tcfg.d_model, tcfg.n_heads * tcfg.hd)
    ours = lm.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(ours) == jax.tree.structure(params)


def test_forward_logits(ref):
    tcfg, params, tokens, want = ref
    logits, aux, cache = lm.forward(params, torch.from_numpy(tokens[:, :PROMPT]), tcfg)
    assert logits.shape == (B, PROMPT, tcfg.vocab) and logits.dtype == torch.float32
    assert cache is None and float(aux) == 0.0
    _close(logits, want["forward"])


def test_prefill(ref):
    tcfg, params, tokens, want = ref
    _close(lm.prefill(params, torch.from_numpy(tokens[:, :PROMPT]), tcfg), want["prefill"])


def test_prefill_into_cache_then_teacher_forced_decode(ref):
    tcfg, params, tokens, want = ref
    cache = lm.init_cache(tcfg, B, S_MAX, device="cpu")
    logits, cache = lm.decode_step(params, torch.from_numpy(tokens[:, :PROMPT]), cache, tcfg)
    assert cache["index"] == PROMPT
    _close(logits, want["steps"][0])
    for t in range(STEPS):
        logits, cache = lm.decode_step(params, torch.from_numpy(tokens[:, PROMPT + t:PROMPT + t + 1]),
                                       cache, tcfg)
        _close(logits, want["steps"][t + 1])
    assert cache["index"] == PROMPT + STEPS == int(want["cache"]["index"])
    ref_cache = convert.cache_from_numpy(want["cache"], "cpu")
    for got_kv, want_kv in zip(cache["kv"], ref_cache["kv"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(got_kv[name].numpy(), want_kv[name].numpy(), **TOL)


def test_serving_steps_pick_the_reference_tokens(ref):
    tcfg, params, tokens, want = ref
    prompt = torch.from_numpy(tokens[:, :PROMPT])
    logits = serve.make_prefill_step(tcfg)(params, {"tokens": prompt})
    _close(logits, want["next_prefill"])
    step = serve.make_decode_step(tcfg)
    cache = lm.init_cache(tcfg, B, S_MAX, device="cpu")
    nxt, cache = step(params, {"tokens": prompt, "cache": cache})
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(want["next_decode"]))
    np.testing.assert_array_equal(nxt.numpy(), logits.argmax(-1).numpy())
    nxt2, cache = step(params, {"tokens": nxt[:, None], "cache": cache})  # int32 ids feed back
    assert nxt2.shape == (B,) and cache["index"] == PROMPT + 1


def test_cast_params_casts_matrices_once_and_keeps_norms():
    cfg = get_arch("llama3.2-3b").smoke().scaled(dtype="bfloat16")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    cast = lm.cast_params(params, cfg)
    assert cast["embed"].dtype == torch.bfloat16 and cast["final_norm"].dtype == torch.float32
    assert torch.equal(cast["blocks"][1]["mlp"]["w_in"], params["blocks"][1]["mlp"]["w_in"].bfloat16())
    again = lm.cast_params(cast, cfg)
    assert again["embed"] is cast["embed"]  # a cast of cast params copies nothing


def test_chunked_prefill_at_an_offset_matches_the_reference(ref):
    """A prompt prefilled into the cache in two chunks (8 tokens, then 16
    at index 8): the second chunk's logits and the cache equal the
    reference's, and the one-shot prefill's last logits."""
    tcfg, params, tokens, want = ref
    jcfg = jax_arch("llama3.2-3b").smoke()
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    jcache = jax_lm.init_cache(jcfg, B, S_MAX)
    _, jcache = jax_lm.decode_step(jparams, jnp.asarray(tokens[:, :8]), jcache, jcfg)
    jlogits, jcache = jax_lm.decode_step(jparams, jnp.asarray(tokens[:, 8:PROMPT]), jcache, jcfg)
    cache = lm.init_cache(tcfg, B, S_MAX, device="cpu")
    _, cache = lm.decode_step(params, torch.from_numpy(tokens[:, :8]), cache, tcfg)
    logits, cache = lm.decode_step(params, torch.from_numpy(tokens[:, 8:PROMPT]), cache, tcfg)
    assert cache["index"] == PROMPT
    _close(logits, jlogits)
    _close(logits, want["steps"][0])
    ref_cache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    for got_kv, want_kv in zip(cache["kv"], ref_cache["kv"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(got_kv[name].numpy(), want_kv[name].numpy(), **TOL)


def test_every_reference_architecture_registers_with_its_fields():
    """The port's registry holds the reference's ten architectures, each
    with the same fields (the configs are copies)."""
    import dataclasses

    from repro.configs import all_archs as jax_all_archs
    from repro_torch.configs import all_archs

    ours, theirs = all_archs(), jax_all_archs()
    assert sorted(ours) == sorted(theirs) and len(ours) == 10
    for name in ours:
        assert dataclasses.asdict(ours[name]) == dataclasses.asdict(theirs[name]), name
    assert {c.family for c in ours.values()} == {"dense", "moe", "hybrid", "ssm", "vlm", "audio"}


def test_a_bfloat16_reference_cache_carries_its_bits():
    jcfg = jax_arch("llama3.2-3b").smoke().scaled(dtype="bfloat16")
    cache = jax_lm.init_cache(jcfg, 1, 8)
    cache = {"kv": {k: v.at[0, 0, 1].set(1.0 / 3.0) for k, v in cache["kv"].items()}, "index": jnp.int32(5)}
    got = convert.cache_from_numpy(jax.tree.map(np.asarray, cache), "cpu")
    assert got["index"] == 5 and len(got["kv"]) == jcfg.n_layers
    assert got["kv"][0]["k"].dtype == torch.bfloat16
    assert float(got["kv"][0]["k"][0, 1, 0, 0]) == float(jnp.bfloat16(1.0 / 3.0))
