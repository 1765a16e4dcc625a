"""The sharded training step of the ssm and hybrid families over DTensor:
``make_train_step(param_shardings=...)`` for xlstm-350m's and
zamba2-2.7b's ``.smoke()`` configs on a (2, 2) ("data", "model") mesh of
4 gloo ranks, two IGD-momentum steps at ``grad_accum=2``, against the
single-process step on the same params and tokens: every param and
momentum leaf within 1e-4 (absolute), the losses within 1e-4, the bounds
``tests/test_torch_distributed.py`` holds llama's sharded step to.

The xLSTM's log forget gate is ``-softplus(-x)``, JAX's
``log_sigmoid``: ``F.logsigmoid``'s backward has no DTensor sharding
rule, so its sharded step raised before. The mLSTM's parallel form,
Mamba2's chunked SSD and the sLSTM's scan run on each rank's local
tensors (``sharding.batch_head_local``): among other things, cumsum's
backward calls ``aten.flip``, which torch 2.11's DTensor has no rule for,
so the ranks drop this release's rule for it. Beside the ranks, the port's dry
run of xlstm-350m's smoke config at ``train_4k`` (the shape cut to 256 x
8 as in ``tests/test_torch_dryrun.py``, ``grad_accum=2``) on the (4, 2)
fake mesh, in a subprocess started first, must return status OK."""

import json
import os
import subprocess
import sys

import pytest

from _torch_dist import SRC, run_ranks

TOL = 1e-4
ARCHS = ("xlstm-350m", "zamba2-2.7b")
LIMIT_S = 300

_BODY = """
def worker(rank, world, io):
    import json
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import igd
    from repro_torch.core.tree import leaves
    from repro_torch.data import synthetic
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import IGD

    # torch 2.11's DTensor has no rule for aten.flip (cumsum's backward
    # calls it); the ranks drop this release's, so the step must not need it
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    for table in ("op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs"):
        getattr(prop, table, {}).pop(torch.ops.aten.flip.default, None)
    mesh = make_host_mesh(2, 2, device="cpu")
    out = {}
    for name in json.load(open(os.path.join(io, "archs.json"))):
        cfg = get_arch(name).smoke()
        tokens = synthetic.token_stream(torch.Generator().manual_seed(1), 8, 16, cfg.vocab)["tokens"]
        opt = IGD(igd.constant(0.05), momentum=0.9)
        step = lambda **kw: make_train_step(cfg, opt, grad_accum=2, **kw)
        # each run takes its own params: the step updates them in place
        one_p = lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        one_o = opt.init(one_p)
        shd.set_activation_ctx(mesh)
        params = lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        pshard = shd.shardings(shd.param_specs(params, cfg, mesh), mesh)
        ps = shd.distribute(params, pshard)
        po = tuple(shd.distribute(t, pshard) for t in opt.init(params))
        batch = shd.distribute({"tokens": tokens}, shd.shardings(shd.batch_specs(cfg, "train", mesh, 8), mesh))
        sharded, losses = step(param_shardings=pshard), []
        for t in range(2):
            ps, po, m = sharded(ps, po, batch, t)
            losses.append(float(m["loss"]))
        placed = all(a.placements == s.placements for a, s in zip(leaves(ps), leaves(pshard)))
        shd.set_activation_ctx(None)
        single = step()
        for t in range(2):
            one_p, one_o, m = single(one_p, one_o, {"tokens": tokens}, t)
            losses.append(float(m["loss"]))
        worst = max(float((a.detach() - b.detach()).abs().max()) for a, b in
                    zip(leaves(shd.full(ps)) + leaves(shd.full(po)), leaves(one_p) + leaves(one_o)))
        out[name] = {"worst": worst, "losses": losses, "placed": placed}
    if rank == 0:
        with open(os.path.join(io, "out.json"), "w") as f:
            json.dump(out, f)
"""

_DRYRUN = r"""
import dataclasses, json, warnings
warnings.simplefilter("ignore")
import torch
from torch.distributed.tensor import DTensor
prop = DTensor._op_dispatcher.sharding_propagator
for table in ("op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs"):
    getattr(prop, table, {}).pop(torch.ops.aten.flip.default, None)  # as the ranks do
import repro_torch.configs.base as base
import repro_torch.launch.dryrun as dr
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import AbstractMesh

dr.make_production_mesh = lambda *, multi_pod=False: AbstractMesh({"data": 4, "model": 2})
base.SHAPES["train_4k"] = dataclasses.replace(base.SHAPES["train_4k"], seq_len=256, global_batch=8)
base._REGISTRY["x"] = get_arch("xlstm-350m").smoke().scaled(name="x")
rec = dr.run_cell("x", "train_4k", False, grad_accum=2)
print("RESULT " + json.dumps({k: rec.get(k) for k in ("status", "error", "arch", "shape", "mesh")}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io = tmp_path_factory.mktemp("train_sharded_families")
    (io / "archs.json").write_text(json.dumps(ARCHS))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    dryrun = subprocess.Popen([sys.executable, "-c", _DRYRUN], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    try:
        run_ranks(io, 4, _BODY)
        out, err = dryrun.communicate(timeout=LIMIT_S)
    finally:
        if dryrun.poll() is None:
            dryrun.kill()
    lines = [line for line in out.splitlines() if line.startswith("RESULT ")]
    assert lines, (out[-2000:], err[-4000:])
    return json.loads((io / "out.json").read_text()), json.loads(lines[-1][len("RESULT "):])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_single_process_step(runs, arch):
    got = runs[0][arch]
    assert got["placed"], got
    assert got["worst"] < TOL, got
    sharded, single = got["losses"][:2], got["losses"][2:]
    for a, b in zip(sharded, single):
        assert abs(a - b) < TOL, got


def test_xlstm_dryrun_train_cell_on_the_4x2_mesh(runs):
    rec = runs[1]
    assert rec["status"] == "OK", rec
