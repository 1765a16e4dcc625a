"""The port's dry run (``repro_torch.launch.dryrun``) on small fake meshes:
the counterpart of ``tests/test_distributed.py::
test_dryrun_machinery_on_small_mesh``, with its ``t`` config (llama3.2-3b
scaled to 2 layers, d 128, 8/4 heads, hd 16, d_ff 256, vocab 512) and its
cut shapes (``train_4k`` as 256 x 8, ``decode_32k`` as 512 x 8; a
prefill cell at 256 x 8 beside them), ``grad_accum=2``.

The reference's own ``repro.launch.dryrun.run_cell`` runs the same cells
on 8 forced host devices, and the port's records are held to its:
argument and output bytes, dot count, parameter counts and model FLOPs
exactly, per-device FLOPs and collective bytes in stated bands. A scaled
qwen3-moe cell (2 layers, 8 experts, top 2) runs on both meshes and is held
to the reference's the same way (bytes, params and model FLOPs exactly).

Each script runs in its own subprocess, so no fake process group (and no
forced device count) outlives its test; the scripts start together when
the first test asks for one, so the file takes about as long as its
slowest script (the (2, 2, 2) train cell: DTensor plans the
redistributions of its 3-D mesh's strided shards for most of its time)."""

import json
import os
import subprocess
import sys

import importlib.util

import pytest

from _torch_dist import SRC

LIMIT_S = 300

_PRELUDE = r"""
import dataclasses, json, sys, warnings
warnings.simplefilter("ignore")
import torch
import repro_torch.configs.base as base
import repro_torch.launch.dryrun as dr
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import AbstractMesh


def small_mesh(*, multi_pod=False):
    return AbstractMesh({"pod": 2, "data": 2, "model": 2} if multi_pod else {"data": 4, "model": 2})


dr.make_production_mesh = small_mesh
base.SHAPES["train_4k"] = dataclasses.replace(base.SHAPES["train_4k"], seq_len=256, global_batch=8)
base.SHAPES["decode_32k"] = dataclasses.replace(base.SHAPES["decode_32k"], seq_len=512, global_batch=8)
base.SHAPES["prefill_32k"] = dataclasses.replace(base.SHAPES["prefill_32k"], seq_len=256, global_batch=8)
CFG = get_arch("llama3.2-3b").scaled(name="t", n_layers=2, d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
                                     d_ff=256, vocab=512)
base._REGISTRY["t"] = CFG
MOE = get_arch("qwen3-moe-235b-a22b").scaled(name="m", n_layers=2, d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
                                              d_ff=64, vocab=512, n_experts=8, top_k=2, moe_block=128)
base._REGISTRY["m"] = MOE
ONE = {"data": 1, "model": 1}
OUT = {}
"""

_EPILOGUE = r"""
print("RESULT " + json.dumps(OUT))
"""

_SCRIPTS = {
    # the reference test's cells, and the prefill beside them
    "train_2x2x2": r"""
OUT["rec"] = dr.run_cell("t", "train_4k", True, grad_accum=2)
""",
    "cells_4x2": r"""
for shape in ("train_4k", "decode_32k", "prefill_32k"):
    OUT[shape] = dr.run_cell("t", shape, False, grad_accum=2)
OUT["train_1x1"] = dr.run_cell("t", "train_4k", False, grad_accum=2, mesh_shape=ONE)
""",
    # the MoE cell (qwen3-moe scaled: 8 experts, top 2, groups of 128
    # tokens) on both small meshes
    "moe_4x2": r"""
OUT["rec"] = dr.run_cell("m", "train_4k", False, grad_accum=2)
""",
    "moe_2x2x2": r"""
OUT["rec"] = dr.run_cell("m", "train_4k", True, grad_accum=2)
""",
    # the local-SGD cell at the reference's default (sequence-sharded
    # activations) and without
    "localsgd_seq_shard": r"""
OUT["rec"] = dr.run_localsgd_cell("t", grad_accum=2, seq_shard=True)
""",
    "localsgd": r"""
OUT["rec"] = dr.run_localsgd_cell("t", grad_accum=2, seq_shard=False)
""",
    # (1, 1): the counter against FlopCounterMode on the same step over
    # plain fake tensors with no mesh, and argument_bytes against the trees
    "one_device": r"""
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.core.tree import leaves, tree_map
from repro_torch.dist import sharding as shd
from repro_torch.launch import inputs, serve, train
from repro_torch.models import lm
from repro_torch.optim import AdamW

def plain_fakes(tree, fm):
    with fm:
        return tree_map(lambda a: torch.empty(tuple(a.shape), dtype=a.dtype) if isinstance(a, torch.Tensor) else a,
                        tree)

for shape in ("train_4k", "decode_32k", "prefill_32k"):
    rec = dr.run_cell("t", shape, False, grad_accum=2, mesh_shape=ONE)
    sh = base.SHAPES[shape]
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    params = plain_fakes(lm.init_lm(CFG, torch.Generator(), "meta"), fm)
    batch = plain_fakes(inputs.input_specs(CFG, sh), fm)
    if shape == "train_4k":
        step, args = train.make_train_step(CFG, dr._optimizer("sgd"), 2), (params, (), batch, 0)
    elif shape == "decode_32k":
        batch["cache"]["index"] = sh.seq_len - 1
        step, args = serve.make_decode_step(CFG), (params, batch)
    else:
        step, args = serve.make_prefill_step(CFG), (params, batch)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    OUT[shape] = {"rec": rec, "flop_counter": fc.get_total_flops()}

# argument_bytes at (1, 1) against the bytes of the same trees on the CPU
rec = dr.run_cell("t", "train_4k", False, grad_accum=2, optimizer="adamw", mesh_shape=ONE)
gen = torch.Generator().manual_seed(0)
params = lm.init_lm(CFG, gen, "cpu")
trees = [params, AdamW().init(params), inputs.concrete_batch(CFG, base.SHAPES["train_4k"], gen, "cpu")]
OUT["argument_bytes"] = [rec["argument_bytes"], sum(t.untyped_storage().nbytes() for t in leaves(trees))]
""",
    # one cell built and counted twice in one fake group: DTensor's caches
    # cold, then warm (a fresh builder each time: the serving builders keep
    # their compute-dtype copy of the params from call to call)
    "cold_warm": r"""
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_lib
for shape in ("train_4k", "decode_32k"):
    with mesh_lib.fake_mesh(small_mesh().shape) as mesh:
        runs = []
        for _ in range(2):
            fm = dr._fake_mode()
            fn, args = dr.build_cell(CFG, base.SHAPES[shape], mesh, fm, grad_accum=2)
            runs.append(dr.analyze_step(fn, args, fm))
        shd.set_activation_ctx(None)
    OUT[shape] = [[vars(a), b] for a, b in runs]
""",
    # main on one patched cell; a cell that fails; what importing starts
    "main": r"""
import os, subprocess
import torch.distributed as dist
out = sys.argv[1]
dr.main(["--arch", "t", "--shape", "decode_32k", "--out", out])
OUT["lines"] = open(out).read().splitlines()
try:
    dr.main(["--arch", "no-such-arch", "--shape", "train_4k"])
    OUT["fail_exit"] = None
except SystemExit as e:
    OUT["fail_exit"] = str(e.code)
code = ("import os, torch.distributed as dist; env = dict(os.environ); import repro_torch.launch.dryrun; "
        "assert not dist.is_initialized(); assert dict(os.environ) == env; print('IMPORT_OK')")
OUT["import"] = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120).stdout
""",
}


# The reference's run_cell on the same patched cells, on 8 forced host
# devices. Beside each record: the bytes of the local shards of what the
# step returns (XLA's output size also counts its output tuple's index
# table, 8 bytes an element, which the port has no counterpart of).
_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, math
import jax
import repro.configs.base as base
import repro.launch.dryrun as dr
from repro.configs import get_arch


def small_mesh(*, multi_pod=False):
    t = (jax.sharding.AxisType.Auto,)
    if multi_pod:
        return jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=t * 3)
    return jax.make_mesh((4, 2), ("data", "model"), axis_types=t * 2)


dr.make_production_mesh = small_mesh
base.SHAPES["train_4k"] = dataclasses.replace(base.SHAPES["train_4k"], seq_len=256, global_batch=8)
base.SHAPES["decode_32k"] = dataclasses.replace(base.SHAPES["decode_32k"], seq_len=512, global_batch=8)
base.SHAPES["prefill_32k"] = dataclasses.replace(base.SHAPES["prefill_32k"], seq_len=256, global_batch=8)
CFG = get_arch("llama3.2-3b").scaled(name="t", n_layers=2, d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
                                     d_ff=256, vocab=512)
base._REGISTRY["t"] = CFG
MOE = get_arch("qwen3-moe-235b-a22b").scaled(name="m", n_layers=2, d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
                                              d_ff=64, vocab=512, n_experts=8, top_k=2, moe_block=128)
base._REGISTRY["m"] = MOE
OUT = {}
for name, arch, shape, mp in [("train_4x2", "t", "train_4k", False), ("train_2x2x2", "t", "train_4k", True),
                              ("decode_4x2", "t", "decode_32k", False), ("prefill_4x2", "t", "prefill_32k", False),
                              ("moe_4x2", "m", "train_4k", False), ("moe_2x2x2", "m", "train_4k", True)]:
    rec = dr.run_cell(arch, shape, mp, grad_accum=2)
    mesh = small_mesh(multi_pod=mp)
    with mesh:
        fn, args = dr.build_cell(base._REGISTRY[arch], base.SHAPES[shape], mesh, grad_accum=2)
        compiled = fn.lower(*args).compile()
        outs = jax.tree.leaves(jax.eval_shape(fn, *args))
        rec["output_shard_bytes"] = sum(math.prod(s.shard_shape(o.shape)) * o.dtype.itemsize
                                        for o, s in zip(outs, jax.tree.leaves(compiled.output_shardings)))
    dr.shd.set_activation_ctx(None)
    OUT[name] = rec
print("RESULT " + json.dumps(OUT))
"""


class _Runs:
    """Every script started at once; ``result(name)`` waits for one."""

    def __init__(self, tmp):
        env = dict(os.environ, PYTHONPATH=str(SRC))
        env.pop("JAX_PLATFORMS", None)
        codes = {name: _PRELUDE + body + _EPILOGUE for name, body in _SCRIPTS.items()}
        envs = dict.fromkeys(codes, env)
        if importlib.util.find_spec("jax") is not None:
            codes["reference"], envs["reference"] = _REFERENCE, dict(env, JAX_PLATFORMS="cpu")
        self.procs = {
            name: subprocess.Popen([sys.executable, "-c", code, str(tmp / f"{name}.jsonl")],
                                   env=envs[name], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name, code in codes.items()
        }
        self.done = {}

    def result(self, name):
        if name not in self.done:
            proc = self.procs[name]
            try:
                out, err = proc.communicate(timeout=LIMIT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            lines = [x for x in out.splitlines() if x.startswith("RESULT ")]
            assert proc.returncode == 0 and lines, (name, out[-2000:], err[-4000:])
            self.done[name] = json.loads(lines[-1][len("RESULT "):])
        return self.done[name]

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory.mktemp("dryrun"))
    try:
        yield r
    finally:
        r.close()


def _ok(rec):
    assert rec["status"] == "OK", rec
    assert rec["hlo_flops"] > 0, rec
    assert rec["collective_traffic_bytes"] > 0, rec


@pytest.mark.parametrize("script,key", [("cells_4x2", "train_4k"), ("train_2x2x2", "rec"),
                                        ("cells_4x2", "decode_32k"), ("cells_4x2", "prefill_32k")])
def test_small_mesh_cells_are_ok(runs, script, key):
    rec = runs.result(script)[key]
    _ok(rec)
    assert rec["n_chips"] == 8
    assert rec["argument_bytes"] > 0 and rec["output_bytes"] > 0 and rec["temp_bytes"] > 0
    assert set(rec["collectives_by_kind"]) <= {"all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    assert rec["hlo_hbm_bytes_proj"] == rec["hlo_hbm_bytes"]
    assert rec["collective_traffic_bytes"] == sum(
        v["bytes"] * (2 if k == "all-reduce" else 1) for k, v in rec["collectives_by_kind"].items())
    assert rec["n_params"] == rec["n_params_active"] == 361_088


@pytest.mark.parametrize("script", ["localsgd", "localsgd_seq_shard"])
def test_localsgd_cell_on_the_multi_pod_mesh_is_ok(runs, script):
    rec = runs.result(script)["rec"]
    _ok(rec)
    assert rec["n_chips"] == 8 and rec["tag"] == "localsgd-H16"


# the port's per-device FLOPs over the reference's: the two partitioners
# split different matmuls (measured on torch 2.13: train 1.34, decode 1.42,
# prefill 1.13; on torch 2.11: train 1.04, decode 1.42, prefill 0.87)
FLOPS_BAND = (0.8, 1.5)
# collective bytes over the reference's, measured 0.49 (prefill) to 1.36
# (decode): the two partitioners choose different collectives, so only the
# order of magnitude is held
COLLECTIVE_BAND = (1 / 3, 3.0)


@pytest.mark.parametrize("script,key,ref_key", [("cells_4x2", "train_4k", "train_4x2"),
                                                ("train_2x2x2", "rec", "train_2x2x2"),
                                                ("cells_4x2", "decode_32k", "decode_4x2"),
                                                ("cells_4x2", "prefill_32k", "prefill_4x2")])
def test_small_mesh_cells_agree_with_the_references_dry_run(runs, script, key, ref_key):
    if "reference" not in runs.procs:
        pytest.skip("the reference package needs jax")
    rec, ref = runs.result(script)[key], runs.result("reference")[ref_key]
    assert ref["status"] == "OK" and ref["n_chips"] == rec["n_chips"] == 8
    # the reference's decode cache carries its int32 index as an array;
    # the port's is a host int
    index = 4 if key == "decode_32k" else 0
    assert rec["argument_bytes"] + index == ref["argument_bytes"]
    assert rec["output_bytes"] + index == ref["output_shard_bytes"]
    for k in ("dot_count", "n_params", "n_params_active", "model_flops"):
        assert rec[k] == ref[k], k
    lo, hi = FLOPS_BAND
    assert lo * ref["hlo_flops"] <= rec["hlo_flops"] <= hi * ref["hlo_flops"]
    lo, hi = COLLECTIVE_BAND
    assert lo * ref["collective_traffic_bytes"] <= rec["collective_traffic_bytes"] <= hi * ref["collective_traffic_bytes"]


# the MoE cell's FLOPs a device over the reference's: the port routes,
# dispatches and combines (the one-hot einsums over [G, Bt, E, C]) on every
# "model" rank, where GSPMD splits that work (measured on torch 2.13: 1.59
# on both meshes)
MOE_FLOPS_BAND = (0.8, 2.0)


@pytest.mark.parametrize("script,ref_key", [("moe_4x2", "moe_4x2"), ("moe_2x2x2", "moe_2x2x2")])
def test_moe_cells_agree_with_the_references_dry_run(runs, script, ref_key):
    """The MoE dispatch has static shapes, so its cell runs sharded: bytes,
    params and model FLOPs equal the reference's, FLOPs and collective
    bytes within the bands."""
    rec = runs.result(script)["rec"]
    _ok(rec)
    assert rec["n_chips"] == 8 and rec["n_params"] > rec["n_params_active"]
    if "reference" not in runs.procs:
        pytest.skip("the reference package needs jax")
    ref = runs.result("reference")[ref_key]
    assert ref["status"] == "OK" and ref["n_chips"] == 8
    assert rec["argument_bytes"] == ref["argument_bytes"]
    assert rec["output_bytes"] == ref["output_shard_bytes"]
    for k in ("n_params", "n_params_active", "model_flops"):
        assert rec[k] == ref[k], k
    lo, hi = MOE_FLOPS_BAND
    assert lo * ref["hlo_flops"] <= rec["hlo_flops"] <= hi * ref["hlo_flops"]
    lo, hi = COLLECTIVE_BAND
    assert lo * ref["collective_traffic_bytes"] <= rec["collective_traffic_bytes"] <= hi * ref["collective_traffic_bytes"]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "prefill_32k"])
def test_one_device_flops_equal_flop_counter_mode(runs, shape):
    got = runs.result("one_device")[shape]
    rec = got["rec"]
    assert rec["status"] == "OK" and rec["n_chips"] == 1
    assert rec["hlo_flops"] == got["flop_counter"] > 0
    assert rec["collective_traffic_bytes"] == 0 and rec["collectives_by_kind"] == {}


def test_eight_devices_do_at_least_the_one_device_work(runs):
    out = runs.result("cells_4x2")
    assert 8 * out["train_4k"]["hlo_flops"] >= out["train_1x1"]["hlo_flops"] > out["train_4k"]["hlo_flops"]


def test_one_device_argument_bytes_are_the_trees_bytes(runs):
    got, want = runs.result("one_device")["argument_bytes"]
    assert got == want > 0


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_cold_and_warm_dtensor_caches_count_the_same(runs, shape):
    (cold, cold_out), (warm, warm_out) = runs.result("cold_warm")[shape]
    assert cold == warm and cold_out == warm_out
    assert cold["flops"] > 0 and cold["collective_traffic_bytes"] > 0


def test_main_writes_one_line_a_cell_and_fails_on_a_failed_cell(runs):
    out = runs.result("main")
    assert len(out["lines"]) == 1
    rec = json.loads(out["lines"][0])
    assert rec["arch"] == "t" and rec["shape"] == "decode_32k" and rec["mesh"] == "4x2"
    _ok(rec)
    assert out["fail_exit"] == "1 cells failed"


def test_importing_the_dryrun_starts_no_group_and_sets_no_env(runs):
    assert "IMPORT_OK" in runs.result("main")["import"]
