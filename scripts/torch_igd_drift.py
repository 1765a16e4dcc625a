#!/usr/bin/env python3
"""How far the per-row and the tiled float32 IGD folds land from a float64 fold.

    PYTHONPATH=src python scripts/torch_igd_drift.py [--rows N] [--dim D] [--epochs E] [--loss L] [--seed S]

Runs on the CPU, with the port's plain versions: ``igd_fold_ref`` (one
rounding of w per row, the per-row kernel's order) and ``igd_fold_tiled_ref``
(the tiled CUDA instances' algebra: w rounded once per 32-row tile), both in
float32, against ``igd_fold_ref`` in float64 on the same inputs. The data
follow ``dense_classification``'s recipe in numpy, at the Forest shape
(581,012 x 54) by default or at --rows x --dim, shuffled, folded --epochs
times over (the rows repeated), with logreg's step sizes
diminishing(0.5, decay=N) and w0 = 0; the loss is --loss (lr by default).
Prints max |dw| for each float32 fold and for the two against each other,
beside max |w|, and how each float32 fold's largest gap compares with the
kernel tolerance (|dw| <= 2e-5 + 2e-4 |w|). The default size takes a few
minutes; 8,192 x 12,033 x 2 epochs takes a minute and ~2 GB.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.igd_fused import ref as R  # noqa: E402


def forest_like(n: int, d: int, seed: int):
    r = np.random.default_rng(seed)
    w_true = r.normal(size=d) / np.sqrt(d)
    y = np.concatenate([np.ones(n // 2), -np.ones(n - n // 2)])
    x = r.normal(size=(n, d)) / np.sqrt(d)
    x += ((y - x @ w_true) / np.sum(w_true**2))[:, None] * w_true[None, :]
    x += 0.5 * r.normal(size=(n, d)) / np.sqrt(d)
    perm = r.permutation(n)
    alpha = np.float32(0.5) / (np.float32(1.0) + np.arange(n, dtype=np.float32) / np.float32(n))
    return x[perm].astype(np.float32), y[perm].astype(np.float32), alpha, np.zeros(d, np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=581_012)
    ap.add_argument("--dim", type=int, default=54)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--loss", default="lr", choices=("lr", "svm", "lsq"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    x, y, alpha, w0 = forest_like(args.rows, args.dim, args.seed)
    a = [torch.from_numpy(np.tile(v, (args.epochs,) + (1,) * (v.ndim - 1))) for v in (x, y, alpha)]
    a.append(torch.from_numpy(w0))
    exact = R.igd_fold_ref(*(t.double() for t in a), loss=args.loss)
    per_row = R.igd_fold_ref(*a, loss=args.loss)
    tiled = R.igd_fold_tiled_ref(*a, loss=args.loss)

    def gap(w):
        dw = (w.double() - exact).abs()
        return float(dw.max()), float((dw / (2e-5 + 2e-4 * exact.abs())).max())

    (pr, pr_tol), (ti, ti_tol) = gap(per_row), gap(tiled)
    print(f"{args.rows} x {args.dim} rows x {args.epochs} epochs, {args.loss}, seed {args.seed}: max |dw| against "
          f"the float64 fold: per-row float32 {pr:.3g} ({pr_tol:.3g} of the kernel tolerance at its worst element), "
          f"tiled float32 {ti:.3g} ({ti_tol:.3g}); per-row against tiled {float((per_row - tiled).abs().max()):.3g}; "
          f"max |w| {float(exact.abs().max()):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
