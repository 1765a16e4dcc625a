"""The port stands alone: importing it loads neither JAX nor the JAX
package, no module of it names them, and its entry points run on the
card unless the caller asks for the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.engine, repro_torch.convert, "
        "repro_torch.kernels.igd_fused.ops, repro_torch.kernels.attention.ops, "
        "repro_torch.kernels.decode.ops, repro_torch.models.lm, repro_torch.launch.serve, "
        "repro_torch.tasks.baselines, repro_torch.data.synthetic, repro_torch.configs.paper_tasks, "
        "repro_torch.obs, repro_torch.launch.obs_server, repro_torch.kernels.igd_fused, "
        "repro_torch.optim, repro_torch.optim.compression, repro_torch.ckpt, repro_torch.data.pipeline, "
        "repro_torch.launch.train, repro_torch.launch.train_loop, repro_torch.dist.sharding, "
        "repro_torch.dist.collectives, repro_torch.launch.elastic, repro_torch.launch.inputs, "
        "repro_torch.launch.mesh\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_module_of_the_port_names_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    assert len(files) > 1
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_engine_without_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    from repro_torch import engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.Engine()
    monkeypatch.setattr(engine, "_DEFAULT", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.cache_info()
    assert engine.Engine(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("which", ["mha", "decode_attention"])
def test_attention_ops_refuse_a_device_that_is_neither_cpu_nor_cuda(which):
    from repro_torch.kernels.attention import ops as attention_ops
    from repro_torch.kernels.decode import ops as decode_ops

    k = torch.zeros((1, 8, 2, 16), device="meta")
    if which == "mha":
        call = lambda: attention_ops.mha(torch.zeros((1, 8, 4, 16), device="meta"), k, k)  # noqa: E731
    else:
        call = lambda: decode_ops.decode_attention(torch.zeros((1, 4, 16), device="meta"), k, k, 3)  # noqa: E731
    with pytest.raises(ValueError, match="no version for device meta"):
        call()


def test_lm_entry_points_without_cuda_raise_instead_of_running_on_cpu(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("llama3.2-3b").smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_lm(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 1, 8)


def test_fit_without_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.core import igd
    from repro_torch.launch.train_loop import fit
    from repro_torch.optim import IGD

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(get_arch("llama3.2-3b").smoke(), {"tokens": torch.zeros((8, 16), dtype=torch.int32)},
            optimizer=IGD(igd.constant(0.1)), steps=1, global_batch=8, log_every=0)
