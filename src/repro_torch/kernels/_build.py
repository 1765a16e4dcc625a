"""Build and load the port's hand-written CUDA kernels.

Each kernel package keeps one CUDA source under its ``csrc/`` with a plain
C interface (no PyTorch headers, so ``nvcc`` takes seconds). At first use
the source is compiled for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the repository root and loaded with ``ctypes``.
The library's name carries a hash of the source, of every local header it
includes (``#include "name"``, followed from header to header) and of the
flags, so an edited source or header is rebuilt rather than reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Optional

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_sources(source: Path) -> list:
    """``source`` and the local headers it includes (quoted ``#include``
    lines resolved beside the including file, followed recursively), each
    once, in the order first reached."""
    seen, stack = [], [Path(source)]
    while stack:
        path = stack.pop()
        if path in seen:
            continue
        seen.append(path)
        names = _LOCAL_INCLUDE.findall(path.read_text())
        stack.extend(path.parent / name for name in reversed(names) if (path.parent / name).exists())
    return seen


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


class CudaLibrary:
    """One CUDA source, its shared library, and the loaded ``ctypes`` handle.

    ``declare`` is called once with the freshly loaded library to set
    every entry's ``argtypes``/``restype`` and to check its limits."""

    def __init__(self, name: str, source: Path, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        tag = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in local_sources(self.source):
            tag.update(path.name.encode() + b"\0" + path.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{tag.hexdigest()[:12]}.so"

    def build(self, ptxas_verbose: bool = False) -> str:
        """Compile unless this source's library already exists; returns the
        compiler's output ("" when nothing was built)."""
        out = self.path()
        if out.exists() and not ptxas_verbose:
            return ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", tmp, str(self.source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source.name} ({proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return proc.stdout + proc.stderr

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
            lib = ctypes.CDLL(str(self.path()))
            self._declare(lib)
            self._lib = lib
        return self._lib
