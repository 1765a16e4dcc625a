"""Synthetic dataset generators matching the paper's workload shapes.

| paper dataset | generator             | shape                          |
|---------------|-----------------------|--------------------------------|
| Forest        | dense_classification  | dense features, binary labels  |

The data is made on ``generator.device`` from the generator's stream, so
a full-size table never passes through the host. It comes *clustered by
label* by default (positives first) — the RDBMS heap-order pathology the
paper studies; apply an ordering policy to randomize. The other
generators come with the slices that use them."""

from __future__ import annotations

import math

import torch


def dense_classification(
    generator: torch.Generator, n: int, dim: int, *, margin: float = 1.0,
    noise: float = 0.5, clustered: bool = True,
):
    """Linearly-separable-ish binary data; labels ±1. Clustered: +1 first."""
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    w_true = torch.randn((dim,), generator=generator, **f32) / math.sqrt(dim)
    half = n // 2
    y = torch.cat([torch.ones(half, **f32), -torch.ones(n - half, **f32)])
    x = torch.randn((n, dim), generator=generator, **f32) / math.sqrt(dim)
    # push each point to its label's side of the separator
    proj = x @ w_true
    x += ((margin * y - proj) / torch.sum(w_true**2))[:, None] * w_true[None, :]
    x += noise * torch.randn((n, dim), generator=generator, **f32) / math.sqrt(dim)
    if not clustered:
        perm = torch.randperm(n, generator=generator, device=dev)
        x, y = x[perm], y[perm]
    return {"x": x, "y": y}
