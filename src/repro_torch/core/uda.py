"""The Bismarck UDA abstraction: initialize / transition / merge / terminate.

Paper, Section 3.1. A User-Defined Aggregate is the systems abstraction for
IGD: the state is the model (plus a step counter), the transition applies
one incremental gradient step per tuple, merge combines partial states from
shared-nothing workers (model averaging, Zinkevich et al.), and terminate
finalizes the model.

In PyTorch the "aggregate fold over the tuple stream" is an eager loop over
the leading axis of the example table — a non-commutative aggregation with
exactly the UDA's data-access pattern. It is the ``torch_fold`` lane body
and the oracle every other lowering is held to; ``segmented_fold`` (the
shared-nothing scheme, §3.3) batches it over lanes with ``torch.func.vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import timing
from repro_torch.core import igd as igd_lib
from repro_torch.core.tree import leaves, tree_map


class IGDState(NamedTuple):
    """Aggregation context: the model plus meta data (paper §3.1)."""

    model: Any  # a float32 tensor or a dict of them (core.tree)
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
        return initial_state(self.task.init_model(generator))

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
        model = tree_map(lambda x, y: wa * x + wb * y, a.model, b.model)
        return IGDState(model, torch.maximum(a.step, b.step), tot)

    def terminate(self, state: IGDState):
        return state.model


def initial_state(model) -> IGDState:
    """The state before any step: ``model``, step 0 and weight 0 on the
    model's device."""
    dev = leaves(model)[0].device
    return IGDState(
        model,
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.float32, device=dev),
    )


class NullAggregate:
    """The paper's strawman: sees every tuple, computes nothing (Tables 2/3).

    Used to measure the engine's pure data-movement overhead. The state
    folds a checksum of each tuple (the sum of its first column in key
    order, as the reference's first pytree leaf) so every tuple is read."""

    def initialize(self, generator: torch.Generator):
        return torch.zeros((), dtype=torch.float32, device=generator.device)

    def transition(self, state, example):
        return state + torch.sum(example[min(example)]).to(torch.float32)

    def merge(self, a, b):
        return a + b

    def terminate(self, state):
        return state


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


def gather_fold(uda, state, data, perm):
    """Fold ``transition`` over ``data[perm]`` WITHOUT materializing the
    permuted copy: each step gathers its one row. Produces exactly
    ``fold(uda, state, data[perm])`` — same rows, same order, same floats.
    ``perm`` stays on its device: each row is an ``index_select`` of a
    one-element slice, so the loop never reads an index on the host."""
    for i in range(perm.shape[0]):
        p = perm[i:i + 1]
        state = uda.transition(
            state, {k: torch.index_select(v, 0, p)[0] for k, v in data.items()}
        )
    return state


def segmented_fold(uda, state, examples, num_segments: int):
    """Shared-nothing parallel aggregate (paper §3.3, 'Pure UDA Version').

    Splits the stream into ``num_segments`` contiguous partitions, folds
    each independently from the same incoming state (``torch.func.vmap``
    over the eager fold = the parallel workers, one batched step per
    ``num_segments`` rows), then ``merge``s the partial states pairwise,
    left to right in segment order.

    Each worker folds with its merge weight ZEROED: a partial state must
    carry only its own contribution, or re-segmenting an already-merged
    state (the epoch loop's steady state) compounds the incoming weight
    into every lane — weight grew x(num_segments+1) per epoch and
    overflowed float32 into NaN models after ~40 epochs. The outgoing
    weight is the incoming one plus the examples folded, same as serial.
    """
    n = next(iter(examples.values())).shape[0]
    if n % num_segments:
        raise ValueError(f"{n} examples not divisible by {num_segments} segments")
    seg = {
        k: v.reshape((num_segments, n // num_segments) + tuple(v.shape[1:]))
        for k, v in examples.items()
    }
    lane_state = state
    if isinstance(state, IGDState):
        lane_state = IGDState(state.model, state.step, torch.zeros_like(state.weight))
    states = torch.func.vmap(lambda ex: fold(uda, lane_state, ex))(seg)

    merged = tree_map(lambda x: x[0], states)
    for i in range(1, num_segments):
        merged = uda.merge(merged, tree_map(lambda x, i=i: x[i], states))
    if isinstance(state, IGDState):
        merged = IGDState(merged.model, merged.step, state.weight + n)
    return merged


# ---------------------------------------------------------------------------
# Epoch driver (Fig. 2: the loop around the aggregate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunResult:
    model: Any
    losses: list  # loss after each epoch
    epochs: int
    shuffle_seconds: float
    gradient_seconds: float
    converged: bool


def run_igd(
    uda,
    data,
    *,
    generator: torch.Generator,
    epochs: int,
    draws=None,
    ordering=None,
    loss_fn: Optional[Callable] = None,
    stop=None,
    num_segments: int = 1,
    state=None,
) -> RunResult:
    """The Bismarck outer loop: [reorder] -> aggregate -> loss -> converged?

    ``generator`` makes the initial state; ``draws`` (a
    ``repro_torch.core.draws.RunDraws``) hands the ordering its
    permutations, and defaults to a ``TorchDraws`` stream seeded with the
    generator's seed on its device. ``ordering`` is a policy from
    ``repro_torch.core.ordering`` (None = clustered, i.e. the stream's
    stored order). ``loss_fn(model, data) -> scalar`` is the piggybacked
    objective evaluation; ``stop`` a convergence rule from
    ``repro_torch.core.convergence``.
    """
    from repro_torch.core import draws as draws_lib, ordering as ordering_lib

    if ordering is None:
        ordering = ordering_lib.Clustered()
    if state is None:
        state = uda.initialize(generator)
    n = next(iter(data.values())).shape[0]
    device = generator.device
    if draws is None:
        draws = draws_lib.TorchDraws().stream(generator.initial_seed(), n, device)

    def folder(s, ex):
        if num_segments == 1:
            return fold(uda, s, ex)
        return segmented_fold(uda, s, ex, num_segments)

    losses = []
    shuffle_s = 0.0
    grad_s = 0.0
    converged = False
    epoch = 0
    for epoch in range(1, epochs + 1):
        watch = timing.Stopwatch()
        examples = ordering.order(data, n, epoch, draws.permutation)
        timing.sync(device)
        shuffle_s += watch.lap()
        state = folder(state, examples)
        timing.sync(device)
        grad_s += watch.lap()
        if loss_fn is not None:
            losses.append(float(loss_fn(uda.terminate(state), data)))
        if stop is not None and stop(losses, epoch):
            converged = True
            break

    return RunResult(
        model=uda.terminate(state),
        losses=losses,
        epochs=epoch,
        shuffle_seconds=shuffle_s,
        gradient_seconds=grad_s,
        converged=converged,
    )
