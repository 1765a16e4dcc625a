"""Elastic scaling in the port (``launch.elastic``, ``ckpt.restore(
shardings=...)``, ``fit(mesh=...)``), as the reference's
``tests/test_elastic.py``: train 3 steps on a (2, 4) mesh of 8 gloo ranks,
checkpoint (logical arrays, rank 0 writing), then continue 2 steps on
(2, 4), on (4, 2) after an elastic restore, and with no mesh after a
restore onto one process. Each continuation equals the run on (2, 4)
(5e-4, the reference's bound), and the restored values equal the saved
ones exactly. Then ``fit`` on (2, 4) checkpoints after 2 of 4 steps and a
fresh ``fit`` on (4, 2) resumes from it: its losses and params equal the
uninterrupted (2, 4) run's and a single-process ``fit``'s."""

import pickle

import numpy as np
import pytest

from _torch_dist import run_ranks

TOL = 5e-4

_RANKS = """
def worker(rank, world, io):
    import pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core import igd
    from repro_torch.core.tree import leaves
    from repro_torch.data import synthetic
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.elastic import elastic_restore, shardings_for
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.launch.train_loop import fit
    from repro_torch.models import lm
    from repro_torch.optim import IGD

    cfg = ArchConfig("el-lm", "dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                     dtype="float32", remat=False)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_lm(cfg, gen, "cpu")
    data = synthetic.token_stream(gen, 16, 32, cfg.vocab)
    opt = IGD(igd.constant(0.05), momentum=0.9)

    def on(mesh):
        shd.set_activation_ctx(mesh)
        pshard, _ = shardings_for(cfg, mesh, opt)
        batch = shd.distribute(data, shd.shardings(shd.batch_specs(cfg, "train", mesh, 16), mesh))
        return make_train_step(cfg, opt, grad_accum=2, param_shardings=pshard), batch, pshard

    def host(tree):
        return [x.detach().numpy().copy() for x in leaves(shd.full(tree))]

    mesh_a, mesh_b = make_host_mesh(2, 4, device="cpu"), make_host_mesh(4, 2, device="cpu")
    step_a, batch_a, pshard_a = on(mesh_a)
    p = shd.distribute({k: v for k, v in params.items()}, pshard_a)
    o = tuple(shd.distribute(t, pshard_a) for t in opt.init(params))
    for k in range(3):
        p, o, _ = step_a(p, o, batch_a, k)
    saved = shd.full({"params": p, "opt": o})
    ckpt = os.path.join(io, "ckpt")
    if rank == 0:
        CheckpointManager(ckpt, async_write=False).save(3, saved, meta={"pipeline": {"epoch": 0, "cursor": 0,
                                                                                       "seed": 0}})
    dist.barrier()
    for k in range(3, 5):
        p, o, _ = step_a(p, o, batch_a, k)
    out = {"a": host(p)}

    step_b, batch_b, pshard_b = on(mesh_b)
    pb, ob, meta = elastic_restore(ckpt, cfg, opt, mesh_b)
    assert meta["step"] == 3
    assert all(x.placements == s.placements for x, s in zip(leaves(pb), leaves(pshard_b)))
    out["restored_b"] = host({"params": pb, "opt": ob})
    for k in range(3, 5):
        pb, ob, _ = step_b(pb, ob, batch_b, k)
    out["b"] = host(pb)

    shd.set_activation_ctx(None)
    pc, oc, _ = elastic_restore(ckpt, cfg, opt, None, device="cpu")
    assert not any(shd.is_dtensor(x) for x in leaves(pc))
    out["restored_c"] = [x.numpy().copy() for x in leaves({"params": pc, "opt": oc})]
    step = make_train_step(cfg, opt, grad_accum=2)
    for k in range(3, 5):
        pc, oc, _ = step(pc, oc, data, k)
    out["c"] = [x.detach().numpy().copy() for x in leaves(pc)]
    out["saved"] = [x.detach().numpy().copy() for x in leaves(saved)]

    kw = dict(optimizer=opt, global_batch=8, grad_accum=2, log_every=0, seed=0, params=params, device="cpu",
              ckpt_every=2, log_fn=lambda msg: None)
    full = fit(cfg, data, steps=4, mesh=mesh_a, **kw)
    fit(cfg, data, steps=2, mesh=mesh_a, ckpt_dir=os.path.join(io, "fit"), **kw)
    resumed = fit(cfg, data, steps=4, mesh=mesh_b, ckpt_dir=os.path.join(io, "fit"), **kw)
    assert resumed.resumed_from == 2 and shd.activation_ctx() == (None, False)
    out.update(fit_losses=full.losses, fit_params=host(full.params), resumed_losses=resumed.losses,
               resumed_params=host(resumed.params))
    if rank == 0:
        with open(os.path.join(io, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    io = tmp_path_factory.mktemp("elastic")
    run_ranks(io, 8, _RANKS)
    with open(io / "out.pkl", "rb") as f:
        return pickle.load(f)


def _worst(a, b):
    assert len(a) == len(b)
    return max(float(np.max(np.abs(x - y))) for x, y in zip(a, b))


def test_restore_onto_another_mesh_continues_as_the_first(out):
    assert _worst(out["restored_b"], out["saved"]) == 0.0
    assert _worst(out["b"], out["a"]) < TOL


def test_restore_onto_no_mesh_continues_as_the_mesh_run(out):
    assert _worst(out["restored_c"], out["saved"]) == 0.0
    assert _worst(out["c"], out["a"]) < TOL


def test_fit_resumes_on_another_mesh(out):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core import igd
    from repro_torch.core.tree import leaves
    from repro_torch.data import synthetic
    from repro_torch.launch.train_loop import fit
    from repro_torch.models import lm
    from repro_torch.optim import IGD
    import torch

    assert len(out["resumed_losses"]) == 2
    np.testing.assert_allclose(out["resumed_losses"], out["fit_losses"][2:], rtol=0, atol=1e-4)
    assert _worst(out["resumed_params"], out["fit_params"]) < TOL
    cfg = ArchConfig("el-lm", "dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                     dtype="float32", remat=False)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_lm(cfg, gen, "cpu")
    data = synthetic.token_stream(gen, 16, 32, cfg.vocab)
    single = fit(cfg, data, optimizer=IGD(igd.constant(0.05), momentum=0.9), steps=4, global_batch=8, grad_accum=2,
                 log_every=0, seed=0, params=params, device="cpu")
    np.testing.assert_allclose(out["fit_losses"], single.losses, rtol=0, atol=1e-4)
    assert _worst(out["fit_params"], [x.detach().numpy() for x in leaves(single.params)]) < TOL
