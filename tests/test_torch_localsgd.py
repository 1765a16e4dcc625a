"""The sharded local-SGD step (``launch/train.py::make_localsgd_step`` with
``param_shardings``) on 8 gloo ranks, a (2, 2, 2) ("pod", "data", "model")
mesh: each rank steps its own pod's instance on its pod's ("data",
"model") submesh, and the merge averages the instances over "pod". Two
steps (the second a merge) against the same steps of the unsharded step,
which runs the pods one after another on every rank: every bank leaf
within 1e-4 of its largest element, and the metrics within 1e-5."""

import json

from _torch_dist import run_ranks

TOL = 1e-4

_BODY = r"""
import json, os
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_arch
from repro_torch.core import igd
from repro_torch.core.tree import leaves, tree_map
from repro_torch.dist import sharding as shd
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim import IGD

N_PODS, B, S, MERGE = 2, 8, 16, 2


def worker(rank, world, io):
    cfg = get_arch("llama3.2-3b").smoke().scaled(remat=False)
    gen = torch.Generator().manual_seed(0)
    bank = train.replicate_for_pods(lm.init_lm(cfg, gen, device="cpu"), N_PODS)
    # the pods start apart, so the merge has something to average
    bank = tree_map(lambda t: t + 0.01 * torch.randn(t.shape, generator=gen), bank)
    tokens = [torch.randint(0, cfg.vocab, (N_PODS, B, S), generator=gen, dtype=torch.int32) for _ in range(MERGE)]
    opt = IGD(igd.constant(0.05), momentum=0.9)

    plain = tree_map(torch.clone, bank)
    plain_state = tuple(tree_map(lambda t: t.clone(), s) for s in opt.init(plain))
    step = train.make_localsgd_step(cfg, opt, 2, MERGE)
    want = [step(plain, plain_state, {"tokens": t}, i)[2] for i, t in enumerate(tokens)]

    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    inner = mesh["data", "model"]
    shd.set_activation_ctx(inner)
    try:
        abs_params = lm.init_lm(cfg, torch.Generator(), "meta")
        inner_specs = shd.param_specs(abs_params, cfg, inner)
        bank_specs = shd.map_specs(lambda s: shd.P(*(("pod",) + tuple(s))), inner_specs)
        bank_shard = shd.shardings(bank_specs, mesh)
        dbank = shd.distribute(bank, bank_shard)
        dstate = tuple(shd.distribute(s, bank_shard) for s in opt.init(bank))
        tshard = shd.shardings({"tokens": shd.P("pod", "data", None)}, mesh)
        sstep = train.make_localsgd_step(cfg, opt, 2, MERGE, param_shardings=shd.shardings(inner_specs, inner))
        got = [sstep(dbank, dstate, shd.distribute({"tokens": t}, tshard), i)[2] for i, t in enumerate(tokens)]
        full = shd.full(dbank)
    finally:
        shd.set_activation_ctx(None)
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1.0) for a, b in zip(leaves(full), leaves(plain)))
    metric_err = max(abs(float(g[k]) - float(w[k])) for g, w in zip(got, want) for k in w)
    placements = [[type(p).__name__, getattr(p, "dim", None)] for p in leaves(dbank)[0].placements]
    if rank == 0:
        with open(os.path.join(io, "out.json"), "w") as f:
            json.dump({"rel": rel, "metric_err": metric_err, "placements": placements,
                       "merged": float((plain["embed"][0] - plain["embed"][1]).abs().max())}, f)
"""


def test_sharded_localsgd_equals_the_pods_stepped_one_after_another(tmp_path):
    run_ranks(tmp_path, 8, _BODY)
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["merged"] == 0.0  # the merge step left the pods equal
    assert out["placements"][0] == ["Shard", 0], out  # the bank stays split over "pod"
    assert out["rel"] <= TOL, out
    assert out["metric_err"] <= 1e-5, out
