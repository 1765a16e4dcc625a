"""The port's sharded train step (``make_train_step(param_shardings=...)``
over DTensor on a (4, 2) ("data", "model") mesh of 8 gloo ranks) against
the port's single-process step and the reference's sharded step
(``tests/test_distributed.py``'s d-lm config, its 8 host devices), from
the reference's initial params and tokens: params within 5e-4 and loss
within 1e-4, the reference's own bounds. The ranks also check that a
tensor dim over ("pod", "data") lies across a (2, 2, 2) mesh in the
reference's order (the first axis major)."""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_dist import SRC, run_ranks
from repro_torch import convert
from repro_torch.configs.base import ArchConfig
from repro_torch.core import igd
from repro_torch.launch import train
from repro_torch.optim import IGD

torch.set_num_threads(1)

D_LM = dict(name="d-lm", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
            dtype="float32", remat=False)
PARAM_TOL, LOSS_TOL = 5e-4, 1e-4

_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ArchConfig
from repro.core import igd
from repro.data import synthetic
from repro.dist import sharding as shd
from repro.launch.train import make_train_step
from repro.models import lm
from repro.optim import IGD

cfg = ArchConfig("d-lm", "dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                 dtype="float32", remat=False)
rng = jax.random.PRNGKey(0)
params = lm.init_lm(cfg, rng)
data = synthetic.token_stream(rng, 16, 32, cfg.vocab)
step = make_train_step(cfg, IGD(igd.constant(0.05)), grad_accum=2)
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
shd.set_activation_ctx(mesh)
pshard = shd.shardings(shd.param_specs(params, cfg, mesh), mesh)
data_s = jax.device_put(data, shd.shardings(shd.batch_specs(cfg, "train", mesh, 16), mesh))
with mesh:
    p2, _, m2 = jax.jit(step, out_shardings=(pshard, (), None))(jax.device_put(params, pshard), (), data_s,
                                                                jnp.int32(0))
shd.set_activation_ctx(None)
host = lambda t: jax.tree.map(lambda x: np.asarray(jax.device_get(x)), t)
with open(os.path.join(sys.argv[1], "reference.pkl"), "wb") as f:
    pickle.dump({"params": host(params), "tokens": host(data["tokens"]), "stepped": host(p2),
                 "loss": float(m2["loss"])}, f)
print("REFERENCE_OK")
"""

_RANKS = """
def worker(rank, world, io):
    import pickle
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor, Replicate, Shard
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import convert
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core import igd
    from repro_torch.core.tree import leaves
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import IGD

    with open(os.path.join(io, "reference.pkl"), "rb") as f:
        ref = pickle.load(f)
    cfg = ArchConfig(**ref["cfg"])
    params = convert.lm_params_from_numpy(ref["params"], cfg, "cpu")
    mesh = make_host_mesh(4, 2, device="cpu")
    shd.set_activation_ctx(mesh)
    pshard = shd.shardings(shd.param_specs(params, cfg, mesh), mesh)
    bshard = shd.shardings(shd.batch_specs(cfg, "train", mesh, 16), mesh)
    ps = shd.distribute(params, pshard)
    batch = shd.distribute({"tokens": torch.from_numpy(ref["tokens"])}, bshard)
    p2, _, m2 = make_train_step(cfg, IGD(igd.constant(0.05)), grad_accum=2, param_shardings=pshard)(ps, (), batch, 0)
    # the step keeps every leaf on its placements
    assert all(a.placements == s.placements for a, s in zip(leaves(p2), leaves(pshard)))
    full = convert.lm_params_to_numpy(shd.full(p2))
    # a dim over ("pod", "data"): rank (p, d, m) holds block p * 2 + d, as JAX lays it out
    cube = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    rows = torch.arange(16.0)[:, None].expand(16, 3).contiguous()
    local = shd.distribute({"x": rows}, shd.shardings({"x": shd.P(("pod", "data"), None)}, cube))["x"].to_local()
    p, d = cube.get_local_rank("pod"), cube.get_local_rank("data")
    assert torch.equal(local, rows[(p * 2 + d) * 4:(p * 2 + d + 1) * 4]), (rank, local[:, 0])
    shd.set_activation_ctx(None)
    if rank == 0:
        with open(os.path.join(io, "port.pkl"), "wb") as f:
            pickle.dump({"stepped": full, "loss": float(m2["loss"])}, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io = tmp_path_factory.mktemp("distributed")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(io)], env=env, capture_output=True, text=True,
                          timeout=300)
    assert "REFERENCE_OK" in proc.stdout, (proc.stdout[-2000:], proc.stderr[-3000:])
    with open(io / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    ref["cfg"] = D_LM
    with open(io / "reference.pkl", "wb") as f:
        pickle.dump(ref, f)
    run_ranks(io, 8, _RANKS)
    with open(io / "port.pkl", "rb") as f:
        port = pickle.load(f)
    cfg = ArchConfig(**D_LM)
    params = convert.lm_params_from_numpy(ref["params"], cfg, "cpu")
    single, _, m1 = train.make_train_step(cfg, IGD(igd.constant(0.05)), grad_accum=2)(
        params, (), {"tokens": torch.from_numpy(ref["tokens"])}, 0)
    return ref, port, {"stepped": convert.lm_params_to_numpy(single), "loss": float(m1["loss"])}


def _worst(a, b):
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y)))) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_sharded_step_matches_the_single_process_step(runs):
    _, port, single = runs
    assert _worst(port["stepped"], single["stepped"]) < PARAM_TOL
    assert abs(port["loss"] - single["loss"]) < LOSS_TOL


def test_sharded_step_matches_the_reference_sharded_step(runs):
    ref, port, _ = runs
    assert jax.tree.structure(port["stepped"]) == jax.tree.structure(ref["stepped"])
    assert _worst(port["stepped"], ref["stepped"]) < PARAM_TOL
    assert abs(port["loss"] - ref["loss"]) < LOSS_TOL
