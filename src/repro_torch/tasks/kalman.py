"""Kalman-filter model fitting (paper Fig. 1B):

    min_{w_1..w_T}  sum_t ||C w_t - f(y_t)||^2 + ||w_t - A w_{t-1}||^2

The model is the whole state trajectory W [T, d]; one example is one time
index t with its observation y_t. The t-th term's gradient touches rows
t and t-1 only — another sparse-update task, like LMF. Rows are gathered
with one-element device indices (``index_select``), so a transition
never reads t back to the host.

The planted system (C, A) comes from :func:`system_matrices`, a function
of ``c_seed`` alone. It is drawn from a CPU ``torch.Generator``, so every
device sees the same system, but NOT the JAX package's: that one draws
from ``jax.random.PRNGKey(c_seed)``, which torch cannot reproduce, and
does not bound A's spectral radius. The same ``c_seed`` plants a
different system in the two packages."""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tasks.base import Task, constants_on, on_devices


def system_matrices(c_seed: int, state_dim: int, obs_dim: int, device):
    """``(C [obs_dim, state_dim], A [state_dim, state_dim])`` float32 on
    ``device``: C ~ N(0, 1/state_dim), A = I + 0.05 N(0, 1) scaled down
    to spectral radius 1 where it exceeds 1. Unscaled, A's radius is
    ~1.15 at state 16, and a 2,048-step series of it overflows float32
    (the JAX package's does, at paper_tasks.KALMAN's shape)."""
    gen = torch.Generator().manual_seed(c_seed)
    c = torch.randn((obs_dim, state_dim), generator=gen) / math.sqrt(state_dim)
    a = torch.eye(state_dim) + 0.05 * torch.randn((state_dim, state_dim), generator=gen)
    radius = float(torch.linalg.eigvals(a.double()).abs().max())
    return c.to(device), (a / max(radius, 1.0)).to(device)


@dataclasses.dataclass(frozen=True)
class KalmanFilterTask(Task):
    horizon: int
    state_dim: int
    obs_dim: int
    c_seed: int = 0
    smooth_weight: float = 1.0
    # (C, A) by device (base.on_devices); compare/hash see only the fields above
    _mats_on: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        self._mats_on.update(on_devices(
            lambda d: system_matrices(self.c_seed, self.state_dim, self.obs_dim, d)))

    def init_model(self, generator):
        return torch.zeros((self.horizon, self.state_dim), dtype=torch.float32, device=generator.device)

    def example_loss(self, w, ex):
        c, a = constants_on(self._mats_on, w.device)
        t = ex["t"].reshape(1)
        wt = torch.index_select(w, 0, t)[0]
        prev = torch.index_select(w, 0, torch.clamp(t - 1, min=0))[0]
        wprev = (t > 0).to(w.dtype) * prev
        obs_err = c @ wt - ex["y"]
        dyn_err = wt - a @ wprev
        return torch.sum(obs_err**2) + self.smooth_weight * torch.sum(dyn_err**2)
