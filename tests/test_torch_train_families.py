"""``repro_torch.launch.train.make_train_step`` against
``repro.launch.train.make_train_step`` for all ten architectures'
``.smoke()`` configs (``tests/test_torch_train_step.py`` holds the step's
modes on llama3.2-3b alone): ``grad_accum=2`` (the strided microbatch
split, vlm/audio prefixes split with their tokens), IGD with momentum, two
steps from the reference's params carried across by
``convert.lm_params_from_numpy``. Each step's loss and gradient norm, the
params and the momentum buffer after the second step are held to the
reference's at rtol = atol = 1e-4, the LM parity tests' own. Beside
them: IGD's sliced update against the whole-leaf update, and each
family's step with and without remat, bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jax_archs, get_arch as jax_arch
from repro.core import igd as jax_igd
from repro.launch import train as jax_train
from repro.models import lm as jax_lm
from repro.optim import IGD as JaxIGD
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import igd
from repro_torch.core.tree import leaves
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim import IGD

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = sorted(jax_archs())
B, S, STEPS, ACCUM = 4, 16, 2, 2


def _batches(cfg):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
        if cfg.n_prefix:
            batch["prefix_embeds"] = (0.1 * rng.standard_normal((B, cfg.n_prefix, cfg.d_model))).astype(np.float32)
        out.append(batch)
    return out


def _flat(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference_for_every_architecture(arch):
    jcfg, cfg = jax_arch(arch).smoke(), get_arch(arch).smoke()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jopt = JaxIGD(jax_igd.diminishing(0.05, 10.0), momentum=0.9)
    opt = IGD(igd.diminishing(0.05, 10.0), momentum=0.9)
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jstate, state = jopt.init(jparams), opt.init(params)
    jstep = jax.jit(jax_train.make_train_step(jcfg, jopt, grad_accum=ACCUM))
    step = train.make_train_step(cfg, opt, grad_accum=ACCUM)
    for t, batch in enumerate(_batches(cfg)):
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(t))
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in batch.items()}, t)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), err_msg=f"step {t} {key}", **TOL)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0.0
    got = convert.lm_params_to_numpy(params)
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, jparams))
    for g, w in zip(_flat(got), _flat(jparams)):
        np.testing.assert_allclose(g, w, **TOL)
    got_state = [convert.lm_params_to_numpy(s) for s in state]
    assert len(got_state) == len(jstate)
    for g, w in zip(_flat(got_state), _flat(jstate)):
        np.testing.assert_allclose(g, w, **TOL)
    assert all(p.grad is None for p in leaves(params))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_igd_update_in_slices_equals_the_whole_leaf(dtype, momentum, monkeypatch):
    """IGD updates a large leaf slice by slice of its flat view
    (``optim.sgd.SLICE`` elements at a time, to bound its float32
    temporaries): the params and the momentum buffer after three steps
    equal those of the whole-leaf update, bit for bit."""
    from repro_torch.optim import sgd

    r = np.random.default_rng(3)
    params = {"w": torch.from_numpy(r.standard_normal((1000, 37)).astype(np.float32)).to(dtype),
              "b": torch.from_numpy(r.standard_normal(5).astype(np.float32)).to(dtype)}
    grads = {k: torch.from_numpy(r.standard_normal(tuple(v.shape)).astype(np.float32)).to(dtype)
             for k, v in params.items()}
    opt = IGD(igd.diminishing(0.05, 10.0), momentum=momentum)
    runs = []
    for slice_ in (sgd.SLICE, 777):  # whole, then 48 slices of 777 and a ragged last one
        monkeypatch.setattr(sgd, "SLICE", slice_)
        p = {k: v.clone() for k, v in params.items()}
        state = opt.init(p)
        for t in range(3):
            p, state = opt.update(p, grads, state, t)
        runs.append(leaves([p, state]))
    assert len(runs[0]) == len(runs[1]) == (4 if momentum else 2)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_bit_of_a_cpu_step(arch):
    """Remat (each block checkpointed, its forward run again for the
    backward) gives the CPU's step the same bits as keeping the
    activations: loss, params and momentum after two grad_accum=2 steps.
    chip_smoke.py's phase 10e holds the card's step with remat to the
    CPU's without it."""
    cfg = get_arch(arch).smoke()
    assert cfg.remat
    runs = []
    for remat in (True, False):
        params = lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        opt = IGD(igd.diminishing(0.05, 10.0), momentum=0.9)
        state, losses = opt.init(params), []
        step = train.make_train_step(cfg.scaled(remat=remat), opt, grad_accum=ACCUM)
        for t, batch in enumerate(_batches(cfg)):
            params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in batch.items()}, t)
            losses.append(float(m["loss"]))
        runs.append((losses, leaves([params, state])))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
