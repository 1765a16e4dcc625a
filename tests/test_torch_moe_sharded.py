"""The MoE layer and sequence-sharded activations over DTensor, on a
(2, 2) ("data", "model") mesh of 4 gloo ranks, against the port's
single-process step on the same params and tokens.

* ``moe.moe_ffn`` on DTensor params runs on each rank's local tensors
  (``local_map``): the groups split over "data" when every shard holds
  whole groups (``moe_block`` 16), every rank routes all the tokens when
  not (``moe_block`` 48), the experts' ``d_ff`` over "model";
* ``seq_shard=True`` (``sharding.set_activation_ctx``): the residual's
  sequence split over "model", gathered before each projection
  (``sharding.gather_seq``), for a dense and an MoE config, through
  ``make_train_step`` and through ``fit``.

Each sharded step is held to the single-process step: every updated
parameter within 1e-4 of its largest element, the loss within 1e-5."""

import json

import pytest

from _torch_dist import run_ranks

STEP_TOL, LOSS_TOL = 1e-4, 1e-5

MOE = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=48,
           vocab=64, mlp="swiglu", n_experts=4, top_k=2, moe_block=16, dtype="float32", param_dtype="float32",
           remat=False)
DENSE = dict(name="d", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
             vocab=64, dtype="float32", param_dtype="float32", remat=False)
CASES = {
    "moe_groups_split": (MOE, False),
    "moe_groups_whole": (dict(MOE, moe_block=48), False),
    "moe_seq_shard": (MOE, True),
    "dense_seq_shard": (DENSE, True),
}

_BODY = """
def worker(rank, world, io):
    import json
    import torch
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core import igd
    from repro_torch.core.tree import leaves
    from repro_torch.data import synthetic
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.launch.train_loop import fit
    from repro_torch.models import lm
    from repro_torch.optim import IGD

    cases = json.load(open(os.path.join(io, "cases.json")))
    mesh = make_host_mesh(2, 2, device="cpu")
    out = {}
    for name, (cfg_kw, seq_shard) in cases.items():
        cfg = ArchConfig(**cfg_kw)
        params = lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = synthetic.token_stream(torch.Generator().manual_seed(1), 8, 16, cfg.vocab)["tokens"]
        step = lambda **kw: make_train_step(cfg, IGD(igd.constant(0.05)), grad_accum=2, **kw)
        # the step updates its params in place: the single-process run takes its own copy
        single, _, m1 = step()(lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu"), (), {"tokens": tokens}, 0)
        shd.set_activation_ctx(mesh, seq_shard=seq_shard)
        pshard = shd.shardings(shd.param_specs(params, cfg, mesh), mesh)
        bshard = shd.shardings(shd.batch_specs(cfg, "train", mesh, 8), mesh)
        ps = shd.distribute(params, pshard)
        batch = shd.distribute({"tokens": tokens}, bshard)
        p2, _, m2 = step(param_shardings=pshard)(ps, (), batch, 0)
        shd.set_activation_ctx(None)
        full = shd.full(p2)
        worst = max(float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
                    for a, b in zip(leaves(full), leaves(single)))
        out[name] = {"worst": worst, "loss": [float(m1["loss"]), float(m2["loss"])]}
        if seq_shard:
            data = synthetic.token_stream(torch.Generator().manual_seed(2), 32, 16, cfg.vocab)
            kw = dict(optimizer=IGD(igd.constant(0.05)), steps=2, global_batch=8, grad_accum=2, log_every=0,
                      device="cpu", params=params)
            one = fit(cfg, data, **kw)
            on_mesh = fit(cfg, data, mesh=mesh, seq_shard=True, **kw)
            assert shd.activation_ctx() == (None, False)
            out[name]["fit"] = [one.losses, on_mesh.losses]
    if rank == 0:
        with open(os.path.join(io, "out.json"), "w") as f:
            json.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io = tmp_path_factory.mktemp("moe_sharded")
    (io / "cases.json").write_text(json.dumps(CASES))
    run_ranks(io, 4, _BODY)
    return json.loads((io / "out.json").read_text())


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_the_single_process_step(runs, case):
    got = runs[case]
    assert got["worst"] < STEP_TOL, got
    single, sharded = got["loss"]
    assert abs(single - sharded) < LOSS_TOL, got


@pytest.mark.parametrize("case", ["dense_seq_shard", "moe_seq_shard"])
def test_fit_with_seq_shard_matches_fit_without_a_mesh(runs, case):
    one, on_mesh = runs[case]["fit"]
    assert len(one) == len(on_mesh) == 2
    for a, b in zip(one, on_mesh):
        assert abs(a - b) < LOSS_TOL, (one, on_mesh)
