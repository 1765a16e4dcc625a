"""Portfolio optimization (paper Fig. 1B):

    min_w  p^T w + w^T Sigma w   s.t.  w in simplex Delta

With Sigma the sample covariance of centered return vectors r_i, the
objective is linearly separable:  f_i(w) = p.w / N_scale + (w.(r_i - rbar))^2.
The simplex constraint is enforced by the projection prox
(``igd.make_simplex_prox``) after every IGD step — Appendix A's proximal
point rule with P = indicator of Delta."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tasks.base import Task, constants_on, on_devices


@dataclasses.dataclass(frozen=True)
class PortfolioOpt(Task):
    n_assets: int
    expected_returns: tuple  # p, length n_assets (negated returns = cost)
    risk_weight: float = 1.0
    # p as a tensor by device (base.on_devices); compare/hash see only the fields above
    _p_on: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        self._p_on.update(on_devices(
            lambda d: (torch.tensor(self.expected_returns, dtype=torch.float32, device=d),)))

    def _p(self, device):
        return constants_on(self._p_on, device)[0]

    def init_model(self, generator):
        return torch.ones((self.n_assets,), dtype=torch.float32, device=generator.device) / self.n_assets

    def example_loss(self, w, ex):
        # ex["r"]: centered return vector for one period
        risk = self.risk_weight * torch.dot(w, ex["r"]) ** 2
        return torch.dot(self._p(w.device), w) + risk

    def full_loss(self, w, data):
        n = data["r"].shape[0]
        quad = self.risk_weight * torch.sum((data["r"] @ w) ** 2)
        return n * torch.dot(self._p(w.device), w) + quad
