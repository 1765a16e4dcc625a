"""Dispatch for the fused IGD kernels: the lane bodies behind the
EpochProgram's ``cuda_fused`` / ``cuda_minibatch`` implementations.

On CUDA tensors these launch the hand-written kernels (``kernel``) or
raise; nothing on the card falls back to the plain versions. On CPU
tensors they run the plain PyTorch versions (``ref``), which is how the
tests reach this path on a machine without a card. Any (N, D) the kernel
supports is taken as it is: the kernels loop over exactly N rows and mask
their last D chunk, so nothing is padded.

Both take one fold or B lanes of folds in one launch (``w0 [B, D]``,
``alpha [B, N]``; the layout ``kernel.lane_layout`` reads): the
counterpart of ``jax.vmap`` over the reference's kernel call. On CPU
tensors the lanes run the plain fold one after the other
(``ref.lanes_ref``)."""

from __future__ import annotations

from repro_torch.kernels import device_of
from repro_torch.kernels.igd_fused import kernel as K
from repro_torch.kernels.igd_fused import ref as R


def igd_fold(x, y, alpha, w0, *, loss: str = "lr"):
    """Bismarck transition fold over (x, y) with per-step sizes alpha."""
    dev = device_of(x, y, alpha, w0)
    if dev.type == "cuda":
        return K.igd_fold(x, y, alpha, w0, loss=loss)
    if dev.type == "cpu":
        if w0.dim() == 2:
            K.lane_layout(x, y, alpha, w0)  # raises on shapes a lane launch refuses
            return R.lanes_ref(R.igd_fold_ref, x, y, alpha, w0, loss=loss)
        return R.igd_fold_ref(x, y, alpha, w0, loss=loss)
    raise ValueError(f"igd_fold has no version for device {dev}")


def igd_fold_minibatch(x, y, alpha, w0, *, loss: str = "lr"):
    """One mean-gradient step per TILE rows. Ragged tails keep the
    reference's semantics: the last tile's mean is over the full TILE."""
    dev = device_of(x, y, alpha, w0)
    if dev.type == "cuda":
        return K.igd_fold_minibatch(x, y, alpha, w0, loss=loss)
    if dev.type == "cpu":
        if w0.dim() == 2:
            K.lane_layout(x, y, alpha, w0)  # raises on shapes a lane launch refuses
            return R.lanes_ref(R.igd_fold_minibatch_ref, x, y, alpha, w0, loss=loss, tile=K.TILE)
        return R.igd_fold_minibatch_ref(x, y, alpha, w0, loss=loss, tile=K.TILE)
    raise ValueError(f"igd_fold_minibatch has no version for device {dev}")
