"""CUDA wrappers for the fused IGD kernels (``csrc/igd_fused.cu``).

The source is built and loaded at first use by ``kernels._build``
(``nvcc`` for ``sm_90a`` into ``build/repro_torch/libigd_fused-<hash>.so``,
``ctypes``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on PyTorch's current stream, raises
on a non-zero CUDA status, and adds one to its entry in ``launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, CudaLibrary  # noqa: F401

TILE = 256  # examples per minibatch step (the reference's VMEM block)
FOLD_MAX_DIM = 4096  # one warp up to 1024, then 8 or 16 warps
FOLD_GRAM_MAX_DIM = 256  # igd_fold's tiled Gram instance; the per-row chain above it
MINIBATCH_MAX_DIM = 12288 - TILE  # w and the tile's scales in 48 KB

LOSS_IDS = {"lr": 0, "svm": 1, "lsq": 2}

SOURCE = Path(__file__).resolve().parent / "csrc" / "igd_fused.cu"

# Launch counts, one per wrapper: bumped where the kernel is launched and
# nowhere else, so a run can show that its path went through the kernel.
launches: Dict[str, int] = {"igd_fold": 0, "igd_fold_minibatch": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("igd_fold_launch", "igd_fold_minibatch_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, ptr]
        fn.restype = i32
    lib.igd_fused_error_string.argtypes = [i32]
    lib.igd_fused_error_string.restype = ctypes.c_char_p
    lib.igd_chain_probe_launch.argtypes = [i32, i32, ptr, ptr]
    lib.igd_chain_probe_launch.restype = i32
    for name in ("igd_fused_fold_max_dim", "igd_fused_gram_max_dim",
                 "igd_fused_minibatch_max_dim", "igd_fused_tile"):
        getattr(lib, name).restype = i32
    limits = (lib.igd_fused_fold_max_dim(), lib.igd_fused_gram_max_dim(),
              lib.igd_fused_minibatch_max_dim(), lib.igd_fused_tile())
    if limits != (FOLD_MAX_DIM, FOLD_GRAM_MAX_DIM, MINIBATCH_MAX_DIM, TILE):
        raise RuntimeError(f"igd_fused library limits {limits} disagree with kernel.py")


LIBRARY = CudaLibrary("igd_fused", SOURCE, _declare)
library_path = LIBRARY.path
build = LIBRARY.build
_load = LIBRARY.load


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
    contiguous. The library picks the instance by D: the tiled Gram
    look-ahead up to FOLD_GRAM_MAX_DIM, the per-row chain above it."""
    _check(x, y, alpha, w0, loss, FOLD_MAX_DIM)
    return _launch("igd_fold", x, y, alpha, w0, loss)


def igd_fold_minibatch(x, y, alpha, w0, *, loss: str = "lr"):
    """One mean-gradient step per TILE rows; the ragged last tile's mean
    is over TILE (rows past N add zero)."""
    _check(x, y, alpha, w0, loss, MINIBATCH_MAX_DIM)
    return _launch("igd_fold_minibatch", x, y, alpha, w0, loss)


def chain_probe(loss: str = "lr", *, steps: int = 1 << 16, device=None):
    """(SM cycles, seconds) per step of igd_fold's dependent chain (the
    tiled instance's: grad_scale_fast, the multiply by alpha, one FMA),
    timed alone in one warp: clock64 inside the kernel, CUDA events around
    it (after a warm-up launch). A measurement probe, not a kernel of the
    path: it counts no launch."""
    lib = _load()
    if loss not in LOSS_IDS:
        raise ValueError(f"unknown loss {loss!r}; valid: {sorted(LOSS_IDS)}")
    out = torch.zeros(2, dtype=torch.int64, device=device or "cuda")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for timed in (False, True):
            start.record(stream)
            rc = lib.igd_chain_probe_launch(LOSS_IDS[loss], steps, out.data_ptr(), stream.cuda_stream)
            end.record(stream)
            if rc != 0:
                raise RuntimeError(f"igd_chain_probe launch failed: CUDA error {rc} "
                                   f"({lib.igd_fused_error_string(rc).decode()})")
        end.synchronize()
    return int(out[0]) / steps, start.elapsed_time(end) * 1e-3 / steps
