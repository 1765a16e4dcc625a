"""Low-rank matrix factorization (paper Fig. 1B, Recommendation):

    min_{L,R}  sum_{(i,j) in Omega} (L_i . R_j - M_ij)^2 + mu ||L,R||_F^2

Per-rating IGD touches only row L_i and row R_j — ``torch.func.grad``
through the ``index_select`` row gathers gives the sparse scatter-add
update (the Gemulla et al. / Bismarck LMF transition). The rows are
gathered with one-element device indices, never a 0-d tensor index,
which PyTorch would read back to the host on every rating.

Regularization is localized to the touched rows, scaled down by the
rows' expected appearance counts (the standard weighted trick), so the
transition stays O(rank): summing the per-example penalty over one epoch
recovers ~``mu * ||L,R||_F^2`` exactly once, matching ``full_loss``. The
degrees therefore MUST reflect the table (``n_ratings / n_rows`` and
``n_ratings / n_cols``); the 1.0 defaults mean "each row rated once" and
over-penalize dense tables by the mean degree — pass them explicitly or
use :meth:`degrees_for` (the catalog's ``derive_args`` does)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tasks.base import Task


def _row(table, i):
    return torch.index_select(table, 0, i.reshape(1))[0]


@dataclasses.dataclass(frozen=True)
class LowRankMF(Task):
    n_rows: int
    n_cols: int
    rank: int
    mu: float = 1e-2
    init_scale: float = 0.1
    # expected #ratings per row/col, used to apportion the global
    # Frobenius penalty onto per-example terms (see module docstring)
    mean_row_degree: float = 1.0
    mean_col_degree: float = 1.0

    @staticmethod
    def degrees_for(n_rows: int, n_cols: int, n_ratings: int) -> dict:
        """Degree apportionment for a table of ``n_ratings`` triples —
        splice into ``task_args`` so the local regularizer sums to the
        global Frobenius penalty once per epoch."""
        return {
            "mean_row_degree": max(n_ratings / max(n_rows, 1), 1.0),
            "mean_col_degree": max(n_ratings / max(n_cols, 1), 1.0),
        }

    def init_model(self, generator):
        f32 = dict(dtype=torch.float32, device=generator.device)
        return {
            "L": self.init_scale * torch.randn((self.n_rows, self.rank), generator=generator, **f32),
            "R": self.init_scale * torch.randn((self.n_cols, self.rank), generator=generator, **f32),
        }

    def example_loss(self, m, ex):
        li = _row(m["L"], ex["i"])
        rj = _row(m["R"], ex["j"])
        err = torch.dot(li, rj) - ex["v"]
        reg = self.mu * (
            torch.sum(li * li) / self.mean_row_degree
            + torch.sum(rj * rj) / self.mean_col_degree
        )
        return err * err + reg

    def full_loss(self, m, data):
        li = torch.index_select(m["L"], 0, data["i"])
        rj = torch.index_select(m["R"], 0, data["j"])
        err = torch.sum(li * rj, dim=-1) - data["v"]
        frob = torch.sum(m["L"] ** 2) + torch.sum(m["R"] ** 2)
        return torch.sum(err * err) + self.mu * frob
