"""``repro_torch.dist.collectives`` against ``repro.dist.collectives``:
the length-sharded flash decode at the reference test's shape (b 2, h 8,
kv 4, hd 64, s 1024; ``tests/test_sharded_decode.py``) and lengths (1,
300, 640, 1024), on the same float32 inputs made with numpy, held to the
reference's run on its 8 host devices ((2, 4) mesh: 4 length shards) to
5e-5, the reference's own tolerance. The port runs the 4 shards in one
process (partials stacked, combined over the leading dim) and over a
4-rank gloo group ((1, 4) mesh: each rank its slice, all-reduce combine),
with the cache as a plain tensor on every rank and as a DTensor sharded
on S. On the CPU each shard is ``decode_attention_ref``; on the card it is
one ``flash_decode`` launch (``test_torch_cuda.py``, ``chip_smoke.py``
phase 11a). Lengths are >= 1: at a total length of 0 the reference's
oracle averages v and the port returns 0 (``kernels.decode.ref``)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import SRC, run_ranks
from repro_torch.dist import collectives
from repro_torch.kernels.decode import ref as R
from repro_torch.launch.mesh import AbstractMesh

B, H, KV, HD, S = 2, 8, 4, 64, 1024
LENGTHS = (1, 300, 640, 1024)
SHARDS = 4
TOL = 5e-5

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.dist.collectives import sharded_flash_decode
io = sys.argv[1]
z = np.load(os.path.join(io, "inputs.npz"))
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for length in (1, 300, 640, 1024):
    with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
        o = sharded_flash_decode(jnp.asarray(z["q"]), jnp.asarray(z["k"]), jnp.asarray(z["v"]), jnp.int32(length), mesh)
    out[str(length)] = np.asarray(o)
np.savez(os.path.join(io, "reference.npz"), **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs and the reference's outputs at each length."""
    io = tmp_path_factory.mktemp("sharded_decode")
    rng = np.random.default_rng(0)
    arrays = {"q": rng.standard_normal((B, H, HD), dtype=np.float32),
              "k": rng.standard_normal((B, S, KV, HD), dtype=np.float32),
              "v": rng.standard_normal((B, S, KV, HD), dtype=np.float32)}
    np.savez(io / "inputs.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(io)], env=env, capture_output=True, text=True,
                          timeout=300)
    assert "REFERENCE_OK" in proc.stdout, (proc.stdout[-2000:], proc.stderr[-3000:])
    with np.load(io / "reference.npz") as z:
        want = {int(k): z[k] for k in z.files}
    return io, {k: torch.from_numpy(v) for k, v in arrays.items()}, want


@pytest.mark.parametrize("length", LENGTHS)
def test_stacked_shards_match_the_reference_run(case, length):
    _, t, want = case
    got = collectives.sharded_flash_decode(t["q"], t["k"], t["v"], length, AbstractMesh({"data": 2, "model": SHARDS}))
    assert got.shape == (B, H, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[length], rtol=0, atol=TOL)
    # and the unsharded plain version
    np.testing.assert_allclose(got.numpy(), R.decode_attention_ref(t["q"], t["k"], t["v"], length)[0].numpy(),
                               rtol=0, atol=TOL)


def test_process_group_shards_match_the_reference_run(case):
    io, _, want = case
    run_ranks(io, SHARDS, """
        def worker(rank, world, io):
            import numpy as np
            import torch
            from torch.distributed.tensor import distribute_tensor, Replicate, Shard
            from repro_torch.dist import collectives
            from repro_torch.launch.mesh import make_host_mesh

            z = np.load(os.path.join(io, "inputs.npz"))
            q, k, v = (torch.from_numpy(z[n]) for n in "qkv")
            mesh = make_host_mesh(1, world, device="cpu")
            kd, vd = (distribute_tensor(t, mesh, [Replicate(), Shard(1)]) for t in (k, v))
            assert kd.to_local().shape[1] == k.shape[1] // world
            out = {}
            for length in (1, 300, 640, 1024):
                plain = collectives.sharded_flash_decode(q, k, v, length, mesh)
                sharded = collectives.sharded_flash_decode(q, kd, vd, length, mesh)
                assert torch.equal(plain, sharded)
                out[str(length)] = plain.numpy()
            np.savez(os.path.join(io, f"rank{rank}.npz"), **out)
    """)
    for rank in range(SHARDS):
        with np.load(io / f"rank{rank}.npz") as z:
            for length in LENGTHS:
                np.testing.assert_allclose(z[str(length)], want[length], rtol=0, atol=TOL)


def test_the_combine_weighs_an_empty_shard_zero():
    """A shard past ``length`` carries (out 0, m -1e30, l 0): weight 0."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) for s in
               ((1, 2, 16), (1, 64, 1, 16), (1, 64, 1, 16)))
    parts = [R.decode_attention_ref(q, k[:, i * 16:(i + 1) * 16], v[:, i * 16:(i + 1) * 16], n)
             for i, n in enumerate((16, 4, 0, 0))]
    assert float(parts[2][1].max()) == float(np.float32(R.NEG_INF)) and float(parts[2][2].abs().max()) == 0.0
    out, m, l = (torch.stack(t) for t in zip(*parts))
    got = collectives.flash_decode_combine(out, m, l)
    np.testing.assert_allclose(got.numpy(), R.decode_attention_ref(q, k, v, 20)[0].numpy(), rtol=0, atol=1e-6)


def test_a_cache_that_does_not_divide_raises():
    q, k = torch.zeros(1, 2, 16), torch.zeros(1, 100, 1, 16)
    with pytest.raises(ValueError, match="not divisible by 8"):
        collectives.sharded_flash_decode(q, k, k, 10, AbstractMesh({"model": 8}))
