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
        "repro_torch.kernels.igd_fused.ops\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_module_of_the_port_names_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert files
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
