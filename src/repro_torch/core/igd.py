"""Incremental gradient descent primitives: step-size rules and proximal ops.

Paper, Section 2.2 (Eq. 2) and Appendices A/B:

    w_{k+1} = Pi_{alpha P} ( w_k - alpha_k * grad f_{eta(k)}(w_k) )

Step-size rules (Appendix B): constant, diminishing (divergent series) and
geometric. Proximal operators (Appendix A): L1 soft-threshold, L2
shrinkage, Euclidean projections onto the L2 ball and the simplex.

Every rule is evaluated elementwise in float32 with the reference's
operation order, so a step vector yields the same alphas bit for bit as
the sequential schedule would one step at a time. Python scalars enter
as float32 tensors of the step's shape: ``scalar / tensor`` in PyTorch
multiplies by a reciprocal, which rounds differently.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.tree import tree_map

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Step-size rules (Appendix B)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepSize:
    """A step-size schedule alpha_k as a function of the step index k.

    ``kind`` selects the rule; one callable covers all three of the
    paper's rules. ``k`` is an integer or float tensor of any shape (or a
    Python number); the result is float32 of the same shape.
    """

    kind: str  # "constant" | "diminishing" | "geometric"
    alpha0: float
    # diminishing: alpha_k = alpha0 / (1 + k / decay)   (divergent series)
    # geometric:   alpha_k = alpha0 * rho ** (k / decay) (decay = steps/epoch)
    decay: float = 1.0
    rho: float = 0.95

    def __call__(self, k) -> Tensor:
        k = torch.as_tensor(k).to(torch.float32)

        def f32(v: float) -> Tensor:
            return torch.full_like(k, v)

        if self.kind == "constant":
            return f32(self.alpha0)
        if self.kind == "diminishing":
            return torch.div(f32(self.alpha0), f32(1.0) + torch.div(k, f32(self.decay)))
        if self.kind == "geometric":
            return f32(self.alpha0) * torch.pow(f32(self.rho), torch.div(k, f32(self.decay)))
        raise ValueError(f"unknown step-size kind: {self.kind}")


def constant(alpha0: float) -> StepSize:
    return StepSize("constant", alpha0)


def diminishing(alpha0: float, decay: float = 1.0) -> StepSize:
    return StepSize("diminishing", alpha0, decay=decay)


def geometric(alpha0: float, rho: float = 0.95, decay: float = 1.0) -> StepSize:
    return StepSize("geometric", alpha0, decay=decay, rho=rho)


# ---------------------------------------------------------------------------
# Proximal operators (Appendix A)
#
#   Pi_{aP}(x) = argmin_w  0.5 ||x - w||^2 + a P(w)
# ---------------------------------------------------------------------------


def prox_l1(x: Tensor, t) -> Tensor:
    """Soft-thresholding: prox of t * ||x||_1."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def prox_l2sq(x: Tensor, t) -> Tensor:
    """Prox of t/2 * ||x||_2^2  (ridge shrinkage)."""
    return x / (1.0 + t)


def project_l2_ball(x: Tensor, radius: float = 1.0) -> Tensor:
    """Euclidean projection onto {w : ||w||_2 <= radius}."""
    nrm = torch.linalg.vector_norm(x)
    scale = torch.clamp(radius / torch.clamp(nrm, min=1e-30), max=1.0)
    return x * scale


def project_simplex(x: Tensor) -> Tensor:
    """Euclidean projection onto the probability simplex.

    Sort-based algorithm (Held/Wolfe/Crowder), O(n log n). Used by the
    portfolio-optimization task whose feasible set is the simplex.
    """
    n = x.shape[-1]
    u = torch.flip(torch.sort(x, dim=-1).values, dims=(-1,))
    css = torch.cumsum(u, dim=-1) - 1.0
    idx = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
    cond = u - css / idx > 0
    # rho = largest index where cond holds (cond is True on a prefix)
    rho = torch.sum(cond.to(torch.int64), dim=-1) - 1
    theta = torch.gather(css, -1, rho[..., None]) / (rho[..., None].to(x.dtype) + 1.0)
    return torch.clamp(x - theta, min=0.0)


# A "prox rule" maps (model, alpha_k) -> model; a model is a tensor or a
# dict of them (``core.tree``), and the rules below act leaf by leaf.
ProxFn = Callable[[Tensor, Tensor], Tensor]


def identity_prox(w, t):
    del t
    return w


def make_l1_prox(mu: float) -> Callable:
    """Tree-wise prox for P(w) = mu * ||w||_1 (LR / SVM regularizer)."""

    def prox(w, t):
        return tree_map(lambda a: prox_l1(a, t * mu), w)

    return prox


def make_l2_prox(mu: float) -> Callable:
    """Tree-wise prox for P(w) = mu/2 * ||w||_F^2 (LMF regularizer)."""

    def prox(w, t):
        return tree_map(lambda a: prox_l2sq(a, t * mu), w)

    return prox


def make_simplex_prox() -> Callable:
    """Projection prox for simplex-constrained vectors (portfolio)."""

    def prox(w, t):
        del t
        return tree_map(project_simplex, w)

    return prox


def igd_step(w, grad, alpha, prox: Callable = identity_prox):
    """One proximal IGD update (paper Eq. 3) on a model tree."""
    return prox(tree_map(lambda p, g: p - alpha * g, w, grad), alpha)
