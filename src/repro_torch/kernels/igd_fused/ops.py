"""Dispatch for the fused IGD kernels: the lane bodies behind the
EpochProgram's ``cuda_fused`` / ``cuda_minibatch`` implementations.

On CUDA tensors these launch the hand-written kernels (``kernel``) or
raise; nothing on the card falls back to the plain versions. On CPU
tensors they run the plain PyTorch versions (``ref``), which is how the
tests reach this path on a machine without a card. Any (N, D) the kernel
supports is taken as it is: the kernels loop over exactly N rows and mask
their last D chunk, so nothing is padded."""

from __future__ import annotations

import torch

from repro_torch.kernels.igd_fused import kernel as K
from repro_torch.kernels.igd_fused import ref as R


def _device(*tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devs))}")
    return devs.pop()


def igd_fold(x, y, alpha, w0, *, loss: str = "lr"):
    """Bismarck transition fold over (x, y) with per-step sizes alpha."""
    dev = _device(x, y, alpha, w0)
    if dev.type == "cuda":
        return K.igd_fold(x, y, alpha, w0, loss=loss)
    if dev.type == "cpu":
        return R.igd_fold_ref(x, y, alpha, w0, loss=loss)
    raise ValueError(f"igd_fold has no version for device {dev}")


def igd_fold_minibatch(x, y, alpha, w0, *, loss: str = "lr"):
    """One mean-gradient step per TILE rows. Ragged tails keep the
    reference's semantics: the last tile's mean is over the full TILE."""
    dev = _device(x, y, alpha, w0)
    if dev.type == "cuda":
        return K.igd_fold_minibatch(x, y, alpha, w0, loss=loss)
    if dev.type == "cpu":
        return R.igd_fold_minibatch_ref(x, y, alpha, w0, loss=loss, tile=K.TILE)
    raise ValueError(f"igd_fold_minibatch has no version for device {dev}")
