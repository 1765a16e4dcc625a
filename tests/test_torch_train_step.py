"""``repro_torch.launch.train.make_train_step`` against
``repro.launch.train.make_train_step`` for 3 steps on llama3.2-3b's smoke
config, from the reference's params: IGD with momentum, AdamW,
``grad_accum=2`` (the strided microbatch split), ``igd_microsteps``,
``compress_grads`` and ``cast_bf16``. Each step's loss and gradient norm,
the final params and the optimizer state are held to the reference's.
Tolerance rtol = atol = 1e-4 (the LM parity tests' own); 2e-2, the
reference's bf16 tolerance, for ``cast_bf16`` (a bf16 forward).
``compress_grads`` rounds each gradient to bf16: a gradient that differs by
one float32 ulp from the reference's can round to the neighbouring bf16
value. Its loss, gradient norm and params are held at 1e-4; its momentum
buffer, which holds those rounded gradients, within a bf16 ulp (below)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import igd as jax_igd
from repro.launch import train as jax_train
from repro.models import lm as jax_lm
from repro.optim import AdamW as JaxAdamW, IGD as JaxIGD
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import igd
from repro_torch.core.tree import leaves
from repro_torch.launch import train
from repro_torch.optim import AdamW, IGD

torch.set_num_threads(1)

B, S, STEPS = 4, 16, 3
MODES = {
    "igd_momentum": ({}, 1e-4),
    "adamw": ({}, 1e-4),
    "grad_accum_2": ({"grad_accum": 2}, 1e-4),
    "igd_microsteps": ({"grad_accum": 2, "igd_microsteps": True}, 1e-4),
    "compress_grads": ({"compress_grads": True}, 1e-4),
    "cast_bf16": ({"cast_bf16": True}, 2e-2),
}


# compress_grads' momentum buffer. After step 0 it is the bf16-rounded
# gradient: bf16-representable, equal to the reference's but where a float32
# difference straddles a rounding boundary (85 of 90,432 entries on the
# smoke config), and there within one bf16 ulp (2^-8 to 2^-7 relative).
# After 3 steps it sums three rounded gradients taken at params that differ
# by those flips, so its absolute part is scaled by the largest entry.
BF16_ULP_RTOL, BF16_FLIP_SHARE, BUF0_ATOL, BUF_ATOL = 1e-2, 1e-2, 1e-8, 1e-3


def _check_compressed_buffer(got_state, want_state, first: bool):
    got, want = _flat(got_state), _flat(want_state)
    assert len(got) == len(want)
    if not first:
        scale = max(float(np.abs(w).max()) for w in want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=BF16_ULP_RTOL, atol=BUF_ATOL * scale)
        return
    flips = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, torch.from_numpy(g).to(torch.bfloat16).float().numpy(),
                                      err_msg="step 0's momentum is not bf16-representable")
        np.testing.assert_allclose(g, w, rtol=BF16_ULP_RTOL, atol=BUF0_ATOL)
        flips += int((g != w).sum())
    assert flips <= BF16_FLIP_SHARE * sum(w.size for w in want), f"{flips} entries differ from the reference's"


def _optimizers(mode):
    if mode == "adamw":
        return JaxAdamW(lr=1e-3), AdamW(lr=1e-3)
    return (JaxIGD(jax_igd.diminishing(0.05, 10.0), momentum=0.9),
            IGD(igd.diminishing(0.05, 10.0), momentum=0.9))


def _flat(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_step_matches_the_reference(mode):
    kw, tol = MODES[mode]
    jcfg, cfg = jax_arch("llama3.2-3b").smoke(), get_arch("llama3.2-3b").smoke()
    jopt, opt = _optimizers(mode)
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jstate, state = jopt.init(jparams), opt.init(params)
    jstep = jax.jit(jax_train.make_train_step(jcfg, jopt, **kw))
    step = train.make_train_step(cfg, opt, **kw)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(STEPS, B, S)).astype(np.int32)
    for t in range(STEPS):
        jparams, jstate, jm = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens[t])}, jnp.int32(t))
        params, state, m = step(params, state, {"tokens": torch.from_numpy(tokens[t])}, t)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=tol, atol=tol, err_msg=f"step {t} {key}")
        if mode == "compress_grads" and t == 0:
            _check_compressed_buffer([convert.lm_params_to_numpy(s) for s in state], jstate, first=True)
    got = convert.lm_params_to_numpy(params)
    for g, w in zip(_flat(got), _flat(jparams)):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    got_state = [convert.lm_params_to_numpy(s) for s in state]
    assert len(got_state) == len(jstate)
    if mode == "compress_grads":
        _check_compressed_buffer(got_state, jstate, first=False)
    else:
        for g, w in zip(_flat(got_state), _flat(jstate)):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    # the step updated the given tensors and dropped their gradients
    assert all(p.grad is None for p in leaves(params))


def test_microbatch_split_is_the_reference_strided_split():
    x = np.arange(24, dtype=np.int32).reshape(8, 3)
    want = np.asarray(jax_train._microbatch({"x": jnp.asarray(x)}, 4)["x"])
    got = train._microbatch({"x": torch.from_numpy(x)}, 4)["x"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_param_shardings_wait_for_the_sharding_slice():
    cfg = get_arch("llama3.2-3b").smoke()
    with pytest.raises(NotImplementedError, match="sharding"):
        train.make_train_step(cfg, IGD(igd.constant(0.1)), param_shardings={})


@pytest.mark.parametrize("mode", ["igd_momentum", "adamw"])
def test_params_and_optimizer_state_carry_across_mid_run(mode):
    """The reference's params and optimizer state after one step, carried
    across by ``convert`` (``lm_params_from_numpy``,
    ``opt_state_from_numpy``), take the next step as the reference does."""
    jcfg, cfg = jax_arch("llama3.2-3b").smoke(), get_arch("llama3.2-3b").smoke()
    jopt, opt = _optimizers(mode)
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    jstate = jopt.init(jparams)
    jstep = jax.jit(jax_train.make_train_step(jcfg, jopt))
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, B, S)).astype(np.int32)
    jparams, jstate, _ = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens[0])}, jnp.int32(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    state = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    assert len(state) == len(jstate)
    jparams, jstate, jm = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens[1])}, jnp.int32(1))
    params, state, m = train.make_train_step(cfg, opt)(params, state, {"tokens": torch.from_numpy(tokens[1])}, 1)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
    for g, w in zip(_flat([convert.lm_params_to_numpy(params)] + [convert.lm_params_to_numpy(t) for t in state]),
                    _flat([jparams, *jstate])):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
