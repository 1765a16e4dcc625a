"""Linear-chain Conditional Random Fields (paper Fig. 1B, Labeling).

    max_w  sum_k [ sum_j w_j F_j(y_k, x_k) - log Z(x_k) ]

One example = one sentence: token features x [L, F], labels y [L], mask.
Model: emission weights E [Y, F] and transition weights T [Y, Y]. The
negative log-likelihood per sentence is computed with the forward
algorithm (a loop over the L tokens of ``logsumexp``, masked with
``where``); the IGD transition is ``torch.func.grad`` of it — the
'next-generation task' the paper adds beyond vendor tools.

The loops run over L, taken from the shapes, never over the mask's
values, and every label lookup is a ``gather`` on the device: a
transition reads nothing back to the host."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tasks.base import Task


@dataclasses.dataclass(frozen=True)
class LinearChainCRF(Task):
    n_labels: int
    feat_dim: int
    init_scale: float = 0.0

    def init_model(self, generator):
        f32 = dict(dtype=torch.float32, device=generator.device)
        shapes = {"E": (self.n_labels, self.feat_dim), "T": (self.n_labels, self.n_labels)}
        if self.init_scale == 0.0:
            return {k: torch.zeros(s, **f32) for k, s in shapes.items()}
        return {k: self.init_scale * torch.randn(s, generator=generator, **f32)
                for k, s in shapes.items()}

    def example_loss(self, m, ex):
        x, y, mask = ex["x"], ex["y"].long(), ex["mask"]  # [L,F], [L], [L]
        emit = x @ m["E"].T  # [L, Y] emission scores

        # score of the gold path
        gold_emit = torch.sum(torch.gather(emit, 1, y[:, None])[:, 0] * mask)
        trans = torch.gather(m["T"].reshape(-1), 0, y[:-1] * self.n_labels + y[1:])
        pair_mask = mask[:-1] * mask[1:]
        gold = gold_emit + torch.sum(trans * pair_mask)

        # log Z via the forward algorithm
        alpha = emit[0]
        for t in range(1, emit.shape[0]):
            nxt = torch.logsumexp(alpha[:, None] + m["T"], dim=0) + emit[t]
            alpha = torch.where(mask[t] > 0, nxt, alpha)
        log_z = torch.logsumexp(alpha, dim=0)
        return log_z - gold  # negative log-likelihood

    def decode(self, m, ex):
        """Viterbi decode (used by tests to check learning actually works)."""
        x, mask = ex["x"], ex["mask"]
        emit = x @ m["E"].T
        alpha, backs = emit[0], []
        for t in range(1, emit.shape[0]):
            scores = alpha[:, None] + m["T"]
            backs.append(torch.argmax(scores, dim=0))
            nxt = torch.max(scores, dim=0).values + emit[t]
            alpha = torch.where(mask[t] > 0, nxt, alpha)
        state = torch.argmax(alpha).reshape(1)
        path = [state]
        for back in reversed(backs):  # backtrack: the best label before each
            state = torch.gather(back, 0, state)
            path.append(state)
        return torch.cat(path[::-1])
