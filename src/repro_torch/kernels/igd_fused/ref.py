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


def igd_fold_tiled_ref(x, y, alpha, w0, *, loss: str = "lr", tile: int = 32):
    """The same sequential fold, in the algebra and order of every
    instance of the CUDA kernel igd_fold: the one-block Gram instance
    (D <= 256) and the cluster instances, middle (256 < D <= 4,096) and
    wide (D > 4,096), whose dots over D are summed by column slices, then
    across the cluster's CTAs in a fixed tree, where this takes one matmul.
    Inside a tile of T rows that
    starts from w_t, w_i = w_t - sum_{k<i} c_k x_k, so row i's w.x is
    p_i - sum_{k<i} c_k G_ki with p = X_T w_t and G = X_T X_T^T. Per tile:
    p and G first, then the scalar recurrence (c_k from r_k, then
    r_j -= c_k G_kj for j > k), then w -= X_T^T c with the sum taken
    first, row by row in order, so w is rounded once a tile. p of the
    next tile is formed before this tile's step is applied, as
    X_next w_t - (X_next X_T^T) c. Only the tests and chip_smoke.py use
    it; ``ops`` keeps ``igd_fold_ref`` for CPU tensors."""
    w, prev = w0, None
    for t0 in range(0, x.shape[0], tile):
        xt, yt, at = x[t0:t0 + tile], y[t0:t0 + tile], alpha[t0:t0 + tile]
        if prev is None:
            r = xt @ w
        else:
            xp, cp, wp = prev
            r = xt @ wp - (xt @ xp.T) @ cp
        g = xt @ xt.T
        c = torch.zeros_like(r)
        for k in range(xt.shape[0]):
            m = r[k] if loss == "lsq" else yt[k] * r[k]
            c[k] = _grad_scale(loss, m, yt[k]) * at[k]
            r[k + 1:] -= c[k] * g[k, k + 1:]
        step = torch.zeros_like(w)
        for k in range(xt.shape[0]):
            step = step + c[k] * xt[k]
        prev = (xt, c, w)
        w = w - step
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


def igd_fold_minibatch_split_ref(x, y, alpha, w0, *, loss: str = "lr", tile: int = 256,
                                 parts: int = 8):
    """``igd_fold_minibatch_ref`` in the order of the CUDA kernel's cluster
    instance (D <= 256): each tile's rows are cut into ``parts`` row
    shares of ``tile // parts`` rows (the ragged last tile's shares hold
    its real rows, then none); every row's c is taken from the tile-start
    w; each share's update u_p = c_p @ X_p is summed on its own; the
    tile's update is the sum of the u_p in share order, divided by
    ``tile``. Only the tests and chip_smoke.py use it; ``ops`` keeps
    ``igd_fold_minibatch_ref`` for CPU tensors."""
    if tile % parts:
        raise ValueError(f"{parts} parts do not cut a {tile}-row tile evenly")
    w = w0
    for t0 in range(0, x.shape[0], tile):
        xb, yb, ab = x[t0:t0 + tile], y[t0:t0 + tile], alpha[t0:t0 + tile]
        wx = xb @ w
        m = wx if loss == "lsq" else yb * wx
        c = _grad_scale(loss, m, yb) * ab
        short = tile - xb.shape[0]  # the ragged tile's missing rows add zero
        if short:
            c = torch.cat([c, c.new_zeros(short)])
            xb = torch.cat([xb, xb.new_zeros(short, xb.shape[1])])
        u = torch.bmm(c.view(parts, 1, -1), xb.view(parts, tile // parts, -1)).squeeze(1)
        total = u[0]
        for p in range(1, parts):
            total = total + u[p]
        w = w - total / tile
    return w


def lanes_ref(fold, x, y, alpha, w0, **kw):
    """B lanes of ``fold`` (any plain fold of this module), one after the
    other: the plain version of a lane launch (``kernel.lane_layout``).
    x [N, D], y [N] are shared by every lane; x [S, N, D], y [S, N] give
    lane b segment ``b // (B // S)`` (S = B: each lane its own rows);
    alpha [B, N] and w0 [B, D] always give each lane its own."""
    shared = x.dim() == 2
    per = 1 if shared else w0.shape[0] // x.shape[0]
    return torch.stack([
        fold(x if shared else x[b // per], y if shared else y[b // per], alpha[b], w0[b], **kw)
        for b in range(w0.shape[0])
    ])
