"""The port's MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on the same numpy params and inputs: every MLP
variant (out and the Switch aux loss at rtol = atol = 1e-4), a router with
planted ties (the reference's experts, lax.top_k's order), a capacity
overflow (the reference's dropped tokens), and bf16 compute, where the
router logits are rounded before the softmax and ties are common."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import moe as jax_moe
from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48, vocab=64,
            n_experts=8, top_k=2, moe_block=16, dtype="float32")


def _cfgs(**kw):
    return JaxArchConfig("t", **{**BASE, **kw}), ArchConfig("t", **{**BASE, **kw})


def _params(jcfg, seed=0):
    params = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return params, {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


def _run(jcfg, tcfg, params, tparams, x, dtype="float32"):
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, want_aux = jax_moe.moe_ffn(params, jx, jcfg)
    got, aux = moe.moe_ffn(tparams, tx, tcfg)
    return got, aux, want, want_aux


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "relu2", "gelu"])
@pytest.mark.parametrize("b,s", [(2, 16), (3, 7), (1, 40)])
def test_moe_ffn_matches_the_reference(mlp, b, s):
    """Groups of 16 tokens: whole, padded (21 and 40 tokens) and one group."""
    jcfg, tcfg = _cfgs(mlp=mlp)
    params, tparams = _params(jcfg)
    got, aux, want, want_aux = _run(jcfg, tcfg, params, tparams, _x(b, s, jcfg.d_model))
    assert got.shape == (b, s, jcfg.d_model) and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_top_k_takes_lax_top_ks_order_on_ties():
    """bf16-rounded logits over 128 experts, top-8: the same experts in the
    same order as jax.lax.top_k (the lower index first among equals)."""
    r = np.random.default_rng(3)
    logits = jnp.asarray(r.normal(size=(512, 128)).astype(np.float32)).astype(jnp.bfloat16).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    want_v, want_i = jax.lax.top_k(probs, 8)
    got_v, got_i = moe.top_k(torch.from_numpy(np.asarray(probs)), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert int((np.asarray(probs)[:, :, None] == np.asarray(probs)[:, None, :]).sum()) > 512 * 128  # ties planted


def test_planted_router_ties_pick_the_reference_experts():
    """Router columns duplicated in pairs (experts 2k and 2k+1 score the
    same on every token): the lower index wins, as in the reference, so
    only even experts are routed; the outputs agree."""
    jcfg, tcfg = _cfgs(n_experts=8, top_k=3)
    params, tparams = _params(jcfg, seed=4)
    router = np.array(params["router"])
    router[:, 1::2] = router[:, 0::2]
    params = {**params, "router": jnp.asarray(router)}
    tparams = {**tparams, "router": torch.from_numpy(router)}
    x = _x(2, 16, jcfg.d_model, 5)
    got, aux, want, want_aux = _run(jcfg, tcfg, params, tparams, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    probs = torch.softmax(torch.from_numpy(x.reshape(2, 16, -1)) @ tparams["router"], dim=-1)
    _, expert, _, _ = moe.route(probs, tcfg)
    assert bool((expert[..., 0] % 2 == 0).all())  # the pair's lower index first
    want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1]
    np.testing.assert_array_equal(expert.numpy(), np.asarray(want_i))


def test_capacity_overflow_drops_the_reference_tokens():
    """A router that sends almost every token to expert 0 first, with a
    capacity of 8 slots per expert in a 32-token group: tokens past the
    8th are dropped from expert 0 in token order, as the reference drops
    them (their outputs keep only their second choice)."""
    jcfg, tcfg = _cfgs(moe_block=32, capacity_factor=0.5)
    assert moe._capacity(tcfg) == jax_moe._capacity(jcfg) == 8
    params, tparams = _params(jcfg, seed=6)
    router = np.array(params["router"])
    router[:, 0] += 3.0 * np.abs(router).max()
    params = {**params, "router": jnp.asarray(router)}
    tparams = {**tparams, "router": torch.from_numpy(router)}
    x = np.abs(_x(2, 16, jcfg.d_model, 7))  # positive features: expert 0 wins every token
    got, aux, want, want_aux = _run(jcfg, tcfg, params, tparams, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    probs = torch.softmax(torch.from_numpy(x.reshape(1, 32, -1)) @ tparams["router"], dim=-1)
    _, expert, slot, kept = moe.route(probs, tcfg)
    assert bool((expert[..., 0] == 0).all())
    np.testing.assert_array_equal(slot[0, :, 0].numpy(), np.arange(32))  # token-major slots
    np.testing.assert_array_equal(kept[0, :, 0].numpy(), np.arange(32) < 8)


def test_bf16_compute_routes_as_the_reference():
    """bf16 x and params: the experts chosen equal the reference's (its
    router logits rounded to bf16, then the f32 softmax) and the outputs
    agree at the reference's bf16 tolerance."""
    jcfg, tcfg = _cfgs(n_experts=16, top_k=4, dtype="bfloat16")
    params, tparams = _params(jcfg, seed=8)
    x = _x(2, 16, jcfg.d_model, 9)
    got, aux, want, want_aux = _run(jcfg, tcfg, params, tparams, x, "bfloat16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-5)
    xb = torch.from_numpy(x).bfloat16().reshape(2, 16, -1)
    probs = torch.softmax((xb @ tparams["router"].bfloat16()).float(), dim=-1)
    jprobs = jax.nn.softmax((jnp.asarray(x).astype(jnp.bfloat16).reshape(2, 16, -1)
                             @ params["router"].astype(jnp.bfloat16)).astype(jnp.float32), axis=-1)
    np.testing.assert_array_equal(moe.route(probs, tcfg)[1].numpy(), np.asarray(jax.lax.top_k(jprobs, 4)[1]))


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The aten ops a region runs, by name."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


# ops whose output size depends on the data, or that read a value back to the host
_DATA_DEPENDENT = {"nonzero", "masked_select", "_local_scalar_dense", "item", "unique", "_unique2"}


@pytest.mark.parametrize("overflow", [False, True], ids=["kept", "dropped"])
def test_moe_forward_and_backward_have_static_shapes_and_no_host_sync(overflow):
    """The dispatch is one-hot einsums: no op of the forward or backward
    sizes its output from the routing (no ``nonzero``, no boolean-mask
    index) or reads a value back to the host, with or without dropped
    tokens; so the forward runs under FakeTensorMode, which cannot size a
    data-dependent output, and gives the shapes the config fixes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    jcfg, tcfg = _cfgs(moe_block=32, capacity_factor=0.5 if overflow else 1.25)
    _, tparams = _params(jcfg, seed=6)
    tparams = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    x = torch.from_numpy(np.abs(_x(2, 16, jcfg.d_model, 7))).requires_grad_(True)
    with _Ops() as ops:
        out, aux = moe.moe_ffn(tparams, x, tcfg)
        (out.sum() + aux).backward()
    assert ops.names and not ops.names & _DATA_DEPENDENT, ops.names & _DATA_DEPENDENT
    assert x.grad is not None and all(p.grad is not None for p in tparams.values())
    with FakeTensorMode():
        fake = {k: torch.empty(tuple(v.shape)) for k, v in tparams.items()}
        out, aux = moe.moe_ffn(fake, torch.empty(3, 40, jcfg.d_model), tcfg)
    assert tuple(out.shape) == (3, 40, jcfg.d_model) and tuple(aux.shape) == ()


def test_dispatch_tensors_are_the_references_one_hots():
    """dispatch / combine [G, Bt, E, C] equal the reference's tensors built
    its way (a [G, Bt, k, E, C] product summed over k), with drops."""
    jcfg, tcfg = _cfgs(moe_block=32, capacity_factor=0.5, top_k=3)
    _, tparams = _params(jcfg, seed=2)
    x = torch.from_numpy(_x(1, 32, jcfg.d_model, 3))
    probs = torch.softmax(x.reshape(1, 32, -1) @ tparams["router"], dim=-1)
    gate, expert, slot, kept = moe.route(probs, tcfg)
    dispatch, combine = moe.dispatch_tensors(gate, expert, slot, kept, tcfg, torch.float32)
    cap, e = moe._capacity(tcfg), tcfg.n_experts
    ohe = torch.nn.functional.one_hot(expert, e)[..., None]                                # [G, Bt, k, E, 1]
    ohc = torch.nn.functional.one_hot(torch.where(kept, slot, cap), cap + 1)[..., None, :cap]  # [G, Bt, k, 1, C]
    want = (ohe * ohc).float()
    assert bool((~kept).any()) and bool(kept.any())
    assert torch.equal(dispatch, want.sum(2))
    assert torch.equal(combine, (want * (gate * kept)[..., None, None]).sum(2))
