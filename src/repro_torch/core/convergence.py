"""Convergence / stopping rules (paper §3.1 'Epochs and Convergence' and
Appendix B). Each rule is a callable ``(losses, epoch) -> bool``."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FixedEpochs:
    """Run exactly n epochs (the common heuristic in deployed systems)."""

    n: int

    def __call__(self, losses, epoch) -> bool:
        return epoch >= self.n


@dataclasses.dataclass(frozen=True)
class RelativeLossDrop:
    """Stop when the relative drop in the objective falls below ``tol``
    (the paper's 0.1%-tolerance convergence criterion)."""

    tol: float = 1e-3

    def __call__(self, losses, epoch) -> bool:
        if len(losses) < 2:
            return False
        prev, cur = losses[-2], losses[-1]
        denom = abs(prev) if prev != 0 else 1.0
        return abs(prev - cur) / denom < self.tol


@dataclasses.dataclass(frozen=True)
class ToleranceToOptimum:
    """Stop when the objective is within ``rel_tol`` of a known optimum —
    used by the benchmarks to report 'time to 0.1% tolerance'."""

    optimum: float
    rel_tol: float = 1e-3

    def __call__(self, losses, epoch) -> bool:
        if not losses:
            return False
        denom = abs(self.optimum) if self.optimum != 0 else 1.0
        return (losses[-1] - self.optimum) / denom < self.rel_tol
