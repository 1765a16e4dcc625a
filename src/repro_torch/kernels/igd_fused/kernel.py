"""CUDA wrappers for the fused IGD kernels (``csrc/igd_fused.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/repro_torch/`` at the repository root, at first use, and
loaded with ``ctypes`` (a plain C interface: no PyTorch headers, so the
build takes seconds). The library's name carries a hash of the source
and flags, so an edited source is rebuilt rather than reused.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on PyTorch's current stream, raises
on a non-zero CUDA status, and adds one to its entry in ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

TILE = 256  # examples per minibatch step (the reference's VMEM block)
FOLD_MAX_DIM = 4096  # one warp up to 1024, then 8 or 16 warps
MINIBATCH_MAX_DIM = 12288 - TILE  # w and the tile's scales in 48 KB

LOSS_IDS = {"lr": 0, "svm": 1, "lsq": 2}

SOURCE = Path(__file__).resolve().parent / "csrc" / "igd_fused.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Launch counts, one per wrapper: bumped where the kernel is launched and
# nowhere else, so a run can show that its path went through the kernel.
launches: Dict[str, int] = {"igd_fold": 0, "igd_fold_minibatch": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the igd_fused CUDA kernels cannot be built")


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libigd_fused-{tag.hexdigest()[:12]}.so"


def build(ptxas_verbose: bool = False) -> str:
    """Compile the kernels unless this source's library already exists;
    returns the compiler's output ("" when nothing was built)."""
    out = library_path()
    if out.exists() and not ptxas_verbose:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
           "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for name in ("igd_fold_launch", "igd_fold_minibatch_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, ptr]
            fn.restype = i32
        lib.igd_fused_error_string.argtypes = [i32]
        lib.igd_fused_error_string.restype = ctypes.c_char_p
        for name in ("igd_fused_fold_max_dim", "igd_fused_minibatch_max_dim",
                     "igd_fused_tile"):
            getattr(lib, name).restype = i32
        limits = (lib.igd_fused_fold_max_dim(), lib.igd_fused_minibatch_max_dim(),
                  lib.igd_fused_tile())
        if limits != (FOLD_MAX_DIM, MINIBATCH_MAX_DIM, TILE):
            raise RuntimeError(f"igd_fused library limits {limits} disagree with kernel.py")
        _lib = lib
    return _lib


def _check(x, y, alpha, w0, loss: str, max_dim: int) -> None:
    if loss not in LOSS_IDS:
        raise ValueError(f"unknown loss {loss!r}; valid: {sorted(LOSS_IDS)}")
    named = {"x": x, "y": y, "alpha": alpha, "w0": w0}
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got shape {tuple(x.shape)}")
    n, d = x.shape
    if tuple(y.shape) != (n,) or tuple(alpha.shape) != (n,) or tuple(w0.shape) != (d,):
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, y {tuple(y.shape)}, "
            f"alpha {tuple(alpha.shape)}, w0 {tuple(w0.shape)}"
        )
    if not 1 <= d <= max_dim:
        raise ValueError(f"D={d} outside what this kernel supports (1..{max_dim})")


def _launch(name: str, x, y, alpha, w0, loss: str):
    lib = _load()
    out = torch.empty_like(w0)
    n, d = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w0.data_ptr(),
            out.data_ptr(), n, d, LOSS_IDS[loss], stream,
        )
    if rc != 0:
        msg = lib.igd_fused_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    launches[name] += 1
    return out


def igd_fold(x, y, alpha, w0, *, loss: str = "lr"):
    """Sequential IGD over all N rows of x [N, D] (D <= 4096) with per-row
    step sizes alpha [N], from w0 [D] -> final w [D]. Float32, CUDA,
    contiguous."""
    _check(x, y, alpha, w0, loss, FOLD_MAX_DIM)
    return _launch("igd_fold", x, y, alpha, w0, loss)


def igd_fold_minibatch(x, y, alpha, w0, *, loss: str = "lr"):
    """One mean-gradient step per TILE rows; the ragged last tile's mean
    is over TILE (rows past N add zero)."""
    _check(x, y, alpha, w0, loss, MINIBATCH_MAX_DIM)
    return _launch("igd_fold_minibatch", x, y, alpha, w0, loss)
