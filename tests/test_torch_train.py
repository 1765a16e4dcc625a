"""``repro_torch.models.lm.train_loss`` and its gradient against
``jax.value_and_grad(repro.models.lm.train_loss)`` for all ten
architectures' ``.smoke()`` configs (the reference's own
``tests/test_arch_smoke.py::test_smoke_train_step`` set: B 2 x 32 tokens,
vlm/audio prefixes of 0.1, the MoE's aux), with the reference's params
carried across by ``convert.lm_params_from_numpy`` and the port's
gradients stacked back by ``convert.lm_params_to_numpy``; then remat on
against remat off, bit for bit on the CPU. Tolerance rtol = atol = 1e-4,
the LM parity tests' own."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jax_archs, get_arch as jax_arch
from repro.models import lm as jax_lm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core.tree import leaves, tree_map
from repro_torch.models import lm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = sorted(jax_archs())
B, S = 2, 32


def _batch(cfg, seed=1):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.n_prefix:
        batch["prefix_embeds"] = np.full((B, cfg.n_prefix, cfg.d_model), 0.1, np.float32)
    return batch


@functools.partial(jax.jit, static_argnums=2)
def _jax_loss_and_grads(params, batch, cfg):
    return jax.value_and_grad(lambda p: jax_lm.train_loss(p, batch, cfg), has_aux=True)(params)


def _port_loss_and_grads(params, batch, cfg):
    for p in leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = lm.train_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    loss.backward()
    return loss.detach(), metrics, tree_map(lambda p: p.grad, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_the_reference(arch):
    jcfg, cfg = jax_arch(arch).smoke(), get_arch(arch).smoke()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    (want_loss, want_metrics), want_grads = _jax_loss_and_grads(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                                                                jcfg)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    loss, metrics, grads = _port_loss_and_grads(params, batch, cfg)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(want_metrics[key]), **TOL)
    if cfg.n_experts:
        assert float(metrics["aux"]) > 0.0
    got = convert.lm_params_to_numpy(grads)
    got_flat, got_tree = jax.tree_util.tree_flatten_with_path(got)
    want_flat, want_tree = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want_grads))
    assert got_tree == want_tree
    for (path, g), (_, w) in zip(got_flat, want_flat):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path), **TOL)
    assert sum(float(np.abs(g).sum()) for _, g in got_flat) > 0.0


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-235b-a22b", "zamba2-2.7b", "xlstm-350m"])
def test_remat_equals_no_remat_bit_for_bit(arch, policy):
    """Checkpointing recomputes the same values on the CPU: the loss and
    every gradient equal the run that keeps every activation."""
    base = get_arch(arch).smoke()
    runs = []
    for cfg in (base.scaled(remat=False), base.scaled(remat=True, remat_policy=policy)):
        params = lm.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
        loss, _, grads = _port_loss_and_grads(params, _batch(cfg), cfg)
        runs.append((loss, leaves(grads)))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1) and all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_checkpoints_each_block_and_only_under_grad(monkeypatch):
    """With remat, each transformer block goes through torch.utils.checkpoint
    once in the forward; under no_grad (serving) and with remat off, never."""
    calls = []
    real = lm.checkpoint.checkpoint
    monkeypatch.setattr(lm.checkpoint, "checkpoint", lambda fn, *a, **kw: calls.append(kw) or real(fn, *a, **kw))
    cfg = get_arch("llama3.2-3b").smoke()
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        lm.train_loss(params, batch, cfg)
    lm.train_loss(params, batch, cfg.scaled(remat=False))
    assert calls == []
    lm.train_loss(params, batch, cfg)
    assert len(calls) == cfg.n_layers and all(kw["use_reentrant"] is False for kw in calls)
    lm.train_loss(params, batch, cfg.scaled(remat_policy="dots"))
    assert len(calls) == 2 * cfg.n_layers and "context_fn" in calls[-1]
    with pytest.raises(ValueError, match="remat_policy"):
        lm.train_loss(params, batch, cfg.scaled(remat_policy="some"))
