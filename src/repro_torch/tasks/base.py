"""Task protocol: the ~10-lines-of-code contract from the paper (Fig. 4).

A task defines ``init_model`` and ``example_loss``; ``example_grad`` comes
for free from ``torch.func.grad`` (tasks may override it with a
hand-written gradient, mirroring the paper's hand-coded transitions).
``full_loss`` is the piggybacked objective evaluation used by
convergence tests: one batched evaluation over the whole table."""

from __future__ import annotations

import torch


class Task:
    def init_model(self, generator: torch.Generator) -> torch.Tensor:
        """The initial model, on ``generator.device``."""
        raise NotImplementedError

    def example_loss(self, model, example) -> torch.Tensor:
        raise NotImplementedError

    def example_grad(self, model, example):
        return torch.func.grad(self.example_loss)(model, example)

    def regularizer(self, model) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=model.device)

    def full_loss(self, model, data) -> torch.Tensor:
        per = torch.func.vmap(lambda ex: self.example_loss(model, ex))(data)
        return torch.sum(per) + self.regularizer(model)
