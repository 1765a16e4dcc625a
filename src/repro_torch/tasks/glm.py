"""Generalized linear tasks: LR, SVM, least squares (dense and sparse).

Paper Fig. 4 — the transitions differ by a couple of lines:

    LR :  w += alpha * y * sigmoid(-y w.x) * x
    SVM:  w += alpha * y * x               if 1 - y w.x > 0

Sparse variants take (idx, val) feature pairs (padded to fixed nnz,
idx=-1 padding); ``torch.func.grad`` through the ``index_select`` gather
gives the scatter-add (``index_add``) sparse update inside the fold — the
RDBMS sparse-vector path. The gather reads its indices on the device, so
a transition never syncs with the host."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tasks.base import Task


def _zeros(dim: int, generator: torch.Generator) -> torch.Tensor:
    return torch.zeros((dim,), dtype=torch.float32, device=generator.device)


@dataclasses.dataclass(frozen=True)
class LogisticRegression(Task):
    dim: int
    mu: float = 0.0  # L1 strength; applied via prox (igd.make_l1_prox)

    def init_model(self, generator):
        return _zeros(self.dim, generator)

    def example_loss(self, w, ex):
        margin = ex["y"] * torch.dot(w, ex["x"])
        # log(1 + exp(-m)) computed stably
        return torch.logaddexp(torch.zeros_like(margin), -margin)

    def example_grad(self, w, ex):
        # hand-written transition (paper Fig. 4, LR_Transition)
        margin = ex["y"] * torch.dot(w, ex["x"])
        sig = torch.sigmoid(-margin)
        return (-ex["y"] * sig) * ex["x"]

    def regularizer(self, w):
        return self.mu * torch.sum(torch.abs(w))


@dataclasses.dataclass(frozen=True)
class SVM(Task):
    dim: int
    mu: float = 0.0

    def init_model(self, generator):
        return _zeros(self.dim, generator)

    def example_loss(self, w, ex):
        return torch.clamp(1.0 - ex["y"] * torch.dot(w, ex["x"]), min=0.0)

    def example_grad(self, w, ex):
        # paper Fig. 4, SVM_Transition
        active = 1.0 - ex["y"] * torch.dot(w, ex["x"]) > 0
        return torch.where(active, -ex["y"], torch.zeros_like(ex["y"])) * ex["x"]

    def regularizer(self, w):
        return self.mu * torch.sum(torch.abs(w))


@dataclasses.dataclass(frozen=True)
class LeastSquares(Task):
    """0.5 (w.x - y)^2 — the CA-TX example's objective (paper Ex. 2.1).
    Its gradient is ``torch.func.grad`` of the loss (the Task default)."""

    dim: int

    def init_model(self, generator):
        return _zeros(self.dim, generator)

    def example_loss(self, w, ex):
        return 0.5 * (torch.dot(w, ex["x"]) - ex["y"]) ** 2


def _sparse_dot(w, idx, val):
    safe = torch.clamp(idx, min=0)
    gathered = torch.index_select(w, 0, safe) * (idx >= 0).to(w.dtype)
    return torch.sum(gathered * val)


@dataclasses.dataclass(frozen=True)
class SparseLogisticRegression(Task):
    dim: int
    mu: float = 0.0

    def init_model(self, generator):
        return _zeros(self.dim, generator)

    def example_loss(self, w, ex):
        margin = ex["y"] * _sparse_dot(w, ex["idx"], ex["val"])
        return torch.logaddexp(torch.zeros_like(margin), -margin)

    def regularizer(self, w):
        return self.mu * torch.sum(torch.abs(w))


@dataclasses.dataclass(frozen=True)
class SparseSVM(Task):
    dim: int
    mu: float = 0.0

    def init_model(self, generator):
        return _zeros(self.dim, generator)

    def example_loss(self, w, ex):
        hinge = 1.0 - ex["y"] * _sparse_dot(w, ex["idx"], ex["val"])
        # torch.maximum splits the gradient at a tie, as jnp.maximum does
        return torch.maximum(hinge, torch.zeros_like(hinge))

    def regularizer(self, w):
        return self.mu * torch.sum(torch.abs(w))
