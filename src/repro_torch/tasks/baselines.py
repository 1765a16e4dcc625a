"""Baseline solvers the paper compares against (stand-ins for the native
RDBMS tools, whose algorithms MADlib documents):

* full-batch gradient descent — touches every tuple per step (the paper's
  'traditional gradient method' contrast in Example 2.1);
* IRLS (Newton) for LR — MADlib's LR solver, superlinear in the dimension;
* ALS for LMF — alternating least squares, superlinear in #examples.

These are the competitors of paper Fig. 7. Each is a handful of library
calls on whole tables (matmuls, batched solves, ``index_add_``), on the
device the table lies on; none of them is a per-row fold."""

from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map


def full_batch_gd(task, data, *, steps: int, lr: float, generator=None, model=None):
    """Plain gradient descent on the full objective, from ``model`` or
    ``task.init_model(generator)``."""
    if model is None:
        model = task.init_model(generator)
    grad = torch.func.grad(lambda m: task.full_loss(m, data))
    losses = []
    for _ in range(steps):
        model = tree_map(lambda p, g: p - lr * g, model, grad(model))
        losses.append(float(task.full_loss(model, data)))
    return model, losses


def irls_logistic(data, *, steps: int = 20, ridge: float = 1e-6):
    """Iteratively reweighted least squares for LR — Newton steps with an
    O(d^3) solve per iteration (superlinear in dimension, like MADlib)."""
    x, y01 = data["x"], (data["y"] > 0).to(torch.float32)
    d = x.shape[1]
    w = torch.zeros((d,), dtype=torch.float32, device=x.device)
    eye = torch.eye(d, dtype=torch.float32, device=x.device)
    for _ in range(steps):
        p = torch.sigmoid(x @ w)
        s = p * (1.0 - p) + 1e-6
        h = (x * s[:, None]).T @ x + ridge * eye
        g = x.T @ (p - y01)
        w = w - torch.linalg.solve(h, g)
    return w


def als_lmf(data, n_rows, n_cols, rank, *, sweeps: int = 10, mu: float = 1e-2,
            generator=None, model=None):
    """Alternating least squares on the observed triples, from ``model``
    (``{"L", "R"}``) or 0.1 N(0, 1) factors drawn from ``generator``. Each
    sweep solves a ridge system per row/col — O(#ratings * rank^2 +
    (m+n) rank^3)."""
    i, j, v = data["i"], data["j"], data["v"]
    dev = v.device
    if model is None:
        f32 = dict(dtype=torch.float32, device=dev)
        model = {"L": 0.1 * torch.randn((n_rows, rank), generator=generator, **f32),
                 "R": 0.1 * torch.randn((n_cols, rank), generator=generator, **f32)}
    left, right = model["L"], model["R"]
    eye = torch.eye(rank, dtype=torch.float32, device=dev)

    def solve_side(fixed, idx_other, idx_own, n_own):
        f = torch.index_select(fixed, 0, idx_other)  # [nnz, rank]
        # per-own-row normal equations, accumulated with index_add_
        outer = f[:, :, None] * f[:, None, :]
        ata = torch.zeros((n_own, rank, rank), dtype=f.dtype, device=dev).index_add_(0, idx_own, outer)
        atb = torch.zeros((n_own, rank), dtype=f.dtype, device=dev).index_add_(0, idx_own, f * v[:, None])
        return torch.linalg.solve(ata + mu * eye, atb[..., None])[..., 0]

    for _ in range(sweeps):
        left = solve_side(right, j, i, n_rows)
        right = solve_side(left, i, j, n_cols)
    return {"L": left, "R": right}
