"""The Bismarck UDA abstraction: initialize / transition / merge / terminate.

Paper, Section 3.1. A User-Defined Aggregate is the systems abstraction for
IGD: the state is the model (plus a step counter), the transition applies
one incremental gradient step per tuple, merge combines partial states from
shared-nothing workers (model averaging, Zinkevich et al.), and terminate
finalizes the model.

In PyTorch the "aggregate fold over the tuple stream" is an eager loop over
the leading axis of the example table — a non-commutative aggregation with
exactly the UDA's data-access pattern. It is the ``torch_fold`` lane body
and the oracle every other lowering is held to.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import igd as igd_lib


class IGDState(NamedTuple):
    """Aggregation context: the model plus meta data (paper §3.1)."""

    model: torch.Tensor  # float32 [dim]
    step: torch.Tensor  # int32 scalar — number of gradient steps taken
    weight: torch.Tensor  # float32 scalar — examples folded (for weighted merge)


@dataclasses.dataclass(frozen=True)
class IGDAggregate:
    """IGD expressed as a UDA (the four-function Bismarck contract of
    paper Fig. 3) for an arbitrary analytics task.

    ``task`` provides ``init_model(generator)`` and ``example_grad(model,
    ex)`` (defaulting to ``torch.func.grad`` of ``example_loss``); this
    class provides the generic four functions. Per the paper, the only
    task-specific logic lives inside the transition's gradient
    computation.
    """

    task: Any
    step_size: igd_lib.StepSize
    prox: Callable = igd_lib.identity_prox

    def initialize(self, generator: torch.Generator) -> IGDState:
        model = self.task.init_model(generator)
        dev = model.device
        return IGDState(
            model,
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.float32, device=dev),
        )

    def transition(self, state: IGDState, example) -> IGDState:
        alpha = self.step_size(state.step)
        grad = self.task.example_grad(state.model, example)
        model = igd_lib.igd_step(state.model, grad, alpha, self.prox)
        return IGDState(model, state.step + 1, state.weight + 1.0)

    def merge(self, a: IGDState, b: IGDState) -> IGDState:
        """Weighted model averaging — IGD is 'essentially algebraic' (§3.3)."""
        tot = a.weight + b.weight
        wa = torch.where(
            tot > 0, a.weight / torch.clamp(tot, min=1e-30), torch.full_like(tot, 0.5)
        )
        wb = 1.0 - wa
        model = wa * a.model + wb * b.model
        return IGDState(model, torch.maximum(a.step, b.step), tot)

    def terminate(self, state: IGDState):
        return state.model


# ---------------------------------------------------------------------------
# The fold engine
# ---------------------------------------------------------------------------


def fold(uda, state, examples):
    """Run ``transition`` over the leading axis of ``examples`` (one epoch's
    aggregate). This is the SQL-aggregate data access pattern: one
    sequential pass, state carried through."""
    n = next(iter(examples.values())).shape[0]
    for i in range(n):
        state = uda.transition(state, {k: v[i] for k, v in examples.items()})
    return state
