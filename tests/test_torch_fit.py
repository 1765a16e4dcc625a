"""``repro_torch.launch.train_loop.fit`` and local SGD against the
reference (``tests/test_fault_tolerance.py``'s ft-lm config and
``tests/test_localsgd.py``'s ls-lm config), with the reference's tokens
and its initial params carried across: the losses equal the reference's
``fit`` (1e-4, the LM parity tests' tolerance); a resume after 8 of 12
steps equals the uninterrupted run (the reference's rtol=1e-6,
atol=1e-7); the watchdog counts; local SGD merges on schedule, trains,
and its bank after 2 steps equals the reference's (1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.core import igd as jax_igd
from repro.data import synthetic as jax_synthetic
from repro.launch import train as jax_train
from repro.launch.train_loop import fit as jax_fit
from repro.models import lm as jax_lm
from repro.optim import IGD as JaxIGD
from _torch_dist import world1  # noqa: F401
from repro_torch import convert
from repro_torch.configs.base import ArchConfig
from repro_torch.core import igd
from repro_torch.core.tree import leaves, tree_map
from repro_torch.launch import train
from repro_torch.launch.train_loop import fit
from repro_torch.optim import IGD

torch.set_num_threads(1)

FT = dict(name="ft-lm", family="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
          dtype="float32", remat=False)
LS = dict(FT, name="ls-lm", n_layers=1)


@pytest.fixture(scope="module")
def ft():
    jcfg, cfg = JaxArchConfig(**FT), ArchConfig(**FT)
    tokens = np.array(jax_synthetic.token_stream(jax.random.PRNGKey(0), 64, 16, jcfg.vocab)["tokens"])
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))  # what the reference's fit draws at seed 0
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, tokens, params


def _kw():
    return dict(optimizer=IGD(igd.constant(0.05)), global_batch=8, log_every=0, seed=0, device="cpu")


def test_fit_losses_equal_the_reference(ft):
    jcfg, cfg, tokens, params = ft
    want = jax_fit(jcfg, {"tokens": jnp.asarray(tokens)}, optimizer=JaxIGD(jax_igd.constant(0.05)), steps=12,
                   global_batch=8, log_every=0, seed=0)
    got = fit(cfg, {"tokens": torch.from_numpy(tokens)}, steps=12, params=params, **_kw())
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert got.step == want.step == 12 and got.losses[-1] < got.losses[0]
    for g, w in zip(jax.tree.leaves(convert.lm_params_to_numpy(got.params)), jax.tree.leaves(want.params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)


def test_resume_matches_uninterrupted(ft, tmp_path):
    _, cfg, tokens, params = ft
    data = {"tokens": torch.from_numpy(tokens)}
    kw = dict(_kw(), ckpt_every=4, keep=5, params=params)
    full = fit(cfg, data, steps=12, ckpt_dir=str(tmp_path / "a"), **kw)
    fit(cfg, data, steps=8, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = fit(cfg, data, steps=12, ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed.resumed_from == 8 and resumed.step == 12 and len(resumed.losses) == 4
    np.testing.assert_allclose(resumed.losses, full.losses[8:], rtol=1e-6, atol=1e-7)
    for a, b in zip(leaves(full.params), leaves(resumed.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-7)
    # the caller's params were copied, not trained in place
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(ft[3])))


def test_straggler_watchdog_counts(ft):
    _, cfg, tokens, params = ft
    r = fit(cfg, {"tokens": torch.from_numpy(tokens)}, steps=3, straggler_timeout_s=0.0, params=params, **_kw())
    assert r.straggler_events == 3


def test_fit_refuses_an_object_that_is_not_a_mesh(ft):
    _, cfg, tokens, _ = ft
    with pytest.raises(TypeError, match="DeviceMesh"):
        fit(cfg, {"tokens": torch.from_numpy(tokens)}, steps=1, mesh=object(), **_kw())


def test_fit_on_a_one_rank_mesh_equals_fit_without_one(ft, tmp_path, world1):
    """``fit(mesh=...)`` on a (1, 1) mesh of one gloo rank: the same losses
    and params bit for bit, a checkpoint of logical arrays, and a resume
    through ``elastic_restore`` equal to the uninterrupted run (the
    reference's rtol=1e-6, atol=1e-7); the activation context is put back
    (8 ranks and two meshes: ``test_torch_elastic.py``)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh

    _, cfg, tokens, params = ft
    data = {"tokens": torch.from_numpy(tokens)}
    mesh = make_host_mesh(1, 1, device="cpu")
    kw = dict(_kw(), ckpt_every=3, params=params)
    plain = fit(cfg, data, steps=6, **kw)
    meshed = fit(cfg, data, steps=6, mesh=mesh, ckpt_dir=str(tmp_path / "a"), **kw)
    assert shd.activation_ctx() == (None, False)
    assert meshed.losses == plain.losses
    for a, b in zip(leaves(meshed.params), leaves(plain.params)):
        assert shd.is_dtensor(a) and torch.equal(a.full_tensor(), b)
    fit(cfg, data, steps=3, mesh=mesh, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = fit(cfg, data, steps=6, mesh=mesh, ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed.resumed_from == 3
    np.testing.assert_allclose(resumed.losses, plain.losses[3:], rtol=1e-6, atol=1e-7)
    for a, b in zip(leaves(resumed.params), leaves(plain.params)):
        np.testing.assert_allclose(a.full_tensor().detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def ls():
    jcfg, cfg = JaxArchConfig(**LS), ArchConfig(**LS)
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(7))
    return jcfg, cfg, jparams, convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _banked(k, n_pods=2):
    return np.random.default_rng(k).integers(0, LS["vocab"], size=(n_pods, 4, 16)).astype(np.int32)


def _disagreement(bank):
    return max(float((x[0] - x[1]).abs().max()) for x in leaves(bank))


def test_localsgd_merges_on_schedule_and_equals_the_reference(ls):
    jcfg, cfg, jparams, params = ls
    bank = train.replicate_for_pods(params, 2)
    jbank = jax_train.replicate_for_pods(jparams, 2)
    step_fn = train.make_localsgd_step(cfg, IGD(igd.constant(0.05)), merge_period=2)
    jstep = jax.jit(jax_train.make_localsgd_step(jcfg, JaxIGD(jax_igd.constant(0.05)), merge_period=2))
    # step 0: no merge (0 % 2 != 1) -> pods diverge (different batches)
    bank, _, _ = step_fn(bank, (), {"tokens": torch.from_numpy(_banked(0))}, 0)
    jbank, _, _ = jstep(jbank, (), {"tokens": jnp.asarray(_banked(0))}, jnp.int32(0))
    assert _disagreement(bank) > 1e-6
    # step 1: merge (1 % 2 == 1) -> pods coincide
    bank, _, m = step_fn(bank, (), {"tokens": torch.from_numpy(_banked(1))}, 1)
    jbank, _, jm = jstep(jbank, (), {"tokens": jnp.asarray(_banked(1))}, jnp.int32(1))
    assert _disagreement(bank) < 1e-6
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
    for pod in range(2):
        got = convert.lm_params_to_numpy(tree_map(lambda x: x[pod], bank))
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(lambda x: x[pod], jbank))):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)


def test_localsgd_trains(ls):
    _, cfg, _, params = ls
    bank = train.replicate_for_pods(params, 2)
    opt = IGD(igd.constant(0.05))
    opt_bank = opt.init(bank)
    step_fn = train.make_localsgd_step(cfg, opt, merge_period=4)
    losses = []
    for k in range(8):
        bank, opt_bank, metrics = step_fn(bank, opt_bank, {"tokens": torch.from_numpy(_banked(100 + k))}, k)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
