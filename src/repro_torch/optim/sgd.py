"""IGD (SGD), the paper's optimizer, with the Appendix-B step-size rules and
optional momentum; AdamW beside it (``repro.optim.sgd``).

The reference's functional contract: ``init(params) -> state`` and
``update(params, grads, state, step) -> (params, state)`` over the port's
trees (dicts and lists of tensors, ``core.tree``). Unlike the reference,
``update`` writes the new params and state into the given tensors under
``torch.no_grad()`` and returns them: a second copy of llama3.2-3b's
float32 params or AdamW's moments is 12.85 GB a tree. The arithmetic
keeps the reference's order of operations, in float32 for float32 params:
IGD ``p - alpha * b``; AdamW ``m / bc1``, ``v / bc2``,
``p - lr * (mh / (sqrt(vh) + eps) + wd * p)``.

IGD's arithmetic is elementwise, so a plain contiguous leaf of more than
``SLICE`` elements is updated slice by slice of its flat view (the same
bits): whole, a 4.7 G-element bf16 table would take four float32
temporaries of 18.9 GB each (nemotron-4's embedding and head)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import igd as igd_lib
from repro_torch.core.tree import tree_map

SLICE = 1 << 27  # elements an IGD update takes at once from a large leaf


def flat_slices(first, *rest):
    """Matching parts of ``first`` and ``rest``: the whole tensors once, or
    slices of their flat views of at most ``SLICE`` elements when ``first``
    is a plain tensor of more than ``SLICE`` elements and all are
    contiguous (a DTensor goes whole)."""
    ts = (first, *rest)
    n = first.numel()
    if n <= SLICE or type(first) is not torch.Tensor or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, n, SLICE):
        yield tuple(t[i:i + SLICE] for t in flat)


@dataclasses.dataclass(frozen=True)
class IGD:
    """Incremental gradient descent (paper Eq. 2) over trees of tensors."""

    step_size: igd_lib.StepSize
    momentum: float = 0.0
    weight_decay: float = 0.0

    def init(self, params):
        if self.momentum:
            return (tree_map(torch.zeros_like, params),)
        return ()

    @torch.no_grad()
    def update(self, params, grads, state, step):
        if self.weight_decay:
            grads = tree_map(lambda g, p: g + self.weight_decay * p, grads, params)
        if self.momentum:
            (buf,) = state

            def accumulate(b, g):
                for b_, g_ in flat_slices(b, g):
                    b_.copy_(self.momentum * b_ + g_)

            tree_map(accumulate, buf, grads)
            step_from = buf
        else:
            step_from = grads

        alpha = self.step_size(step)  # a float32 scalar tensor, as the reference's

        def apply(p, d):
            for p_, d_ in flat_slices(p, d):
                p_.copy_(p_.float() - alpha * d_.float())

        tree_map(apply, params, step_from)
        return params, state


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params):
        return (tree_map(torch.zeros_like, params), tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, params, grads, state, step):
        m, v = state
        t = torch.as_tensor(step).to(torch.float32) + 1.0

        def apply(p, g, mm, vv):
            mm.copy_(self.b1 * mm + (1 - self.b1) * g)
            vv.copy_(self.b2 * vv + (1 - self.b2) * g * g)
            bc1 = 1.0 - torch.pow(self.b1, t)
            bc2 = 1.0 - torch.pow(self.b2, t)
            mh = mm / bc1
            vh = vv / bc2
            p.copy_(p - self.lr * (mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * p))

        tree_map(apply, params, grads, m, v)
        return params, (m, v)
