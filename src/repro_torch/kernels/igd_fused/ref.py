"""Plain PyTorch versions of the fused IGD kernels: the same functions,
written as the loops they are. The CPU path of ``ops`` and the oracle the
CUDA kernels are held to."""

from __future__ import annotations

import torch


def _grad_scale(loss: str, margin, y):
    """d loss / d (w.x) given margin = y * (w.x) (lr/svm) or w.x (lsq)."""
    if loss == "lr":
        return -y * torch.sigmoid(-margin)
    if loss == "svm":
        return torch.where(margin < 1.0, -y, torch.zeros_like(y))
    if loss == "lsq":
        return margin - y  # here margin = w.x
    raise ValueError(loss)


def igd_fold_ref(x, y, alpha, w0, *, loss: str = "lr"):
    """Sequential per-example IGD: one transition per row."""
    w = w0
    for i in range(x.shape[0]):
        wx = torch.dot(w, x[i])
        m = wx if loss == "lsq" else y[i] * wx
        c = _grad_scale(loss, m, y[i]) * alpha[i]
        w = w - c * x[i]
    return w


def igd_fold_minibatch_ref(x, y, alpha, w0, *, loss: str = "lr", tile: int = 256):
    """One mean-gradient step per ``tile`` rows. The last tile may be
    short; its mean is still over ``tile`` rows (the missing rows add
    zero), which is the reference's padded semantics."""
    w = w0
    for t0 in range(0, x.shape[0], tile):
        xb, yb, ab = x[t0:t0 + tile], y[t0:t0 + tile], alpha[t0:t0 + tile]
        wx = xb @ w
        m = wx if loss == "lsq" else yb * wx
        c = _grad_scale(loss, m, yb) * ab
        w = w - (c @ xb) / tile
    return w
