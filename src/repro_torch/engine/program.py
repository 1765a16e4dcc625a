"""repro_torch.engine.program — the EpochProgram IR and its compiler.

The IR composes a physical ``Plan``'s axes (ordering × parallelism ×
batch × source × implementation) and ``build_program`` lowers it to the
epoch callable the executor drives. This slice of the port lowers the
singleton, in-memory, batch=1 corner under every ordering and every
scheme of paper §3.3–3.4:

* ``serial`` — the serial lane body, by implementation:

  * ``torch_fold`` — the eager ``uda.fold`` loop (the counterpart of the
    reference's ``xla_fold``);
  * ``cuda_fused`` — the fused-IGD CUDA kernel's per-tuple lane
    (``repro_torch.kernels.igd_fused``: the model held on chip while rows
    stream past — the paper's Bismarck inner loop as a real kernel);
  * ``cuda_minibatch`` — one mean-gradient step per 256-row tile, a
    DIFFERENT algorithm (hint-only; never auto-chosen);

* ``segmented`` — ``uda.segmented_fold`` (shared-nothing lanes, merged);
* ``shared_memory`` — ``parallel.hogwild_fold`` (the Lock/AIG/NoLock
  simulator);
* ``mrs`` — ``mrs.mrs_epoch`` (buffered reservoir sampling), whose epoch
  carries ``(state, buf_a, buf_b, active)``.

The non-serial schemes run eagerly and have no kernel form: a ``cuda_*``
implementation with any scheme but ``serial`` is refused, as the
reference refuses ``pallas_*``. Hints for the rest of the IR (sharding,
stored tables, fused batches) are refused by the planner with
``NotImplementedError`` naming the slice that brings them.

Eligibility for the kernel lanes is a catalog property
(``TaskSpec.kernel_loss`` + identity prox — :func:`kernel_eligibility`).

Build counting
==============

PyTorch runs eagerly: there is nothing to trace. What a warm repeat query
must not redo is building its plan's epoch callable, so
``build_program`` counts each build through
``repro_torch.core.tracecount.count_build``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import mrs as mrs_lib, ordering as ordering_lib
from repro_torch.core import parallel as parallel_lib, tree, uda as uda_lib
from repro_torch.core.tracecount import count_build, fresh_counter

# "sequential" is the stored order by another name (the storage layer
# just didn't cluster it); the IR canonicalizes so downstream code has
# exactly three physical orderings.
ORDERING_ALIASES = {"sequential": "clustered"}

# The implementation axis: how a serial lane body is lowered.
IMPLEMENTATIONS = ("torch_fold", "cuda_fused", "cuda_minibatch")


def canonical_ordering(name: str) -> str:
    return ORDERING_ALIASES.get(name, name)


def kernel_eligibility(task, agg) -> Tuple[Optional[str], str]:
    """(kernel loss name, "") when the aggregate can lower through the
    fused-IGD kernel, else (None, reason). Eligibility is a catalog
    property: the task's exact class must be registered with a
    ``kernel_loss`` (lr/svm/lsq) AND the aggregate must carry the
    identity prox — the kernel's transition has no prox hook, so an L1
    prox would silently be skipped."""
    from repro_torch.core import igd as igd_lib
    from repro_torch.engine import catalog

    loss = catalog.kernel_loss_for(task)
    if loss is None:
        return None, (
            f"task {type(task).__name__} has no kernel_loss in the catalog "
            "(only dense lr/svm/lsq transitions match the kernel)"
        )
    if agg.prox is not igd_lib.identity_prox:
        return None, (
            "the fused kernel's transition has no prox hook; this "
            "aggregate carries a non-identity prox"
        )
    return loss, ""


def require_kernel_loss(task, agg, implementation: str) -> str:
    loss, why = kernel_eligibility(task, agg)
    if loss is None:
        raise ValueError(
            f"implementation={implementation!r} needs a kernel-eligible "
            f"aggregate: {why}"
        )
    return loss


# ---------------------------------------------------------------------------
# the IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpochProgram:
    """One composed execution: a physical ``Plan`` (batch=1; fused
    query batches come with the serving slice). Hashable."""

    plan: Any  # planner.Plan (duck-typed: this module never imports it)

    def describe(self) -> str:
        return self.plan.axes(batch="B=1")


@dataclasses.dataclass
class CompiledProgram:
    """``build_program``'s output: ``epoch_fn(state, examples, draws) ->
    state``, one epoch of the plan's scheme over the epoch's stream;
    ``draws`` is the epoch's ``core.draws.EpochDraws``. For MRS plans the
    state is the carry ``(state, buf_a, buf_b, active)``."""

    program: EpochProgram
    task: Any
    agg: Any
    trace_counter: Dict[str, int]
    epoch_fn: Callable

    @property
    def plan(self):
        return self.program.plan

    @property
    def trace_count(self) -> int:
        return self.trace_counter["traces"]


# ---------------------------------------------------------------------------
# singleton epoch bodies (B=1, driver-paced)
# ---------------------------------------------------------------------------


def build_epoch_fn(task, agg, plan) -> Callable:
    """The plan's epoch function ``(state_or_carry, examples, draws) ->
    state_or_carry`` — the singleton lane body of its scheme."""
    impl = plan.implementation
    if impl not in IMPLEMENTATIONS:
        raise ValueError(
            f"unknown implementation {impl!r}; valid: {IMPLEMENTATIONS}"
        )
    if impl != "torch_fold" and plan.scheme != "serial":
        raise ValueError(
            f"implementation={impl!r} lowers the serial lane body; "
            f"scheme={plan.scheme!r} has no kernel form (use "
            "scheme='serial' or implementation='torch_fold')"
        )
    if plan.scheme == "serial":
        if impl != "torch_fold":
            lane = _kernel_lane_for(task, agg, impl)
            return lambda s, ex, draws: lane(s, ex)
        return lambda s, ex, draws: uda_lib.fold(agg, s, ex)
    if plan.scheme == "segmented":
        return lambda s, ex, draws: uda_lib.segmented_fold(
            agg, s, ex, plan.num_segments
        )
    if plan.scheme == "shared_memory":
        cfg = parallel_lib.SharedMemoryConfig(
            scheme=plan.sm_scheme, workers=plan.sm_workers
        )

        def sm_epoch(state, ex, draws):
            versions, keep = parallel_lib.hogwild_draws(
                draws, cfg, tree.size(state.model)
            )
            model = parallel_lib.hogwild_fold(
                task, agg.step_size, state.model, ex, cfg, versions, keep,
                prox=agg.prox,
            )
            n = next(iter(ex.values())).shape[0]
            return uda_lib.IGDState(model, state.step + n, state.weight + n)

        return sm_epoch
    if plan.scheme == "mrs":
        if plan.mrs_buffer <= 0:
            raise ValueError(
                "an MRS plan needs mrs_buffer > 0 (the planner sizes "
                "it from the memory budget)"
            )
        cfg = mrs_lib.MRSConfig(buffer_size=plan.mrs_buffer,
                                ratio=plan.mrs_ratio)

        def mrs_epoch(carry, ex, draws):
            state, buf_a, buf_b, active = carry
            state, buf_a = mrs_lib.mrs_epoch(
                agg, state, ex, buf_a, buf_b, active, cfg, draws.reservoir()
            )
            return (state, buf_a, buf_b, active)

        return mrs_epoch
    raise ValueError(f"unknown scheme {plan.scheme!r}")


# ---------------------------------------------------------------------------
# kernel lane bodies (the implementation axis's cuda_* lowerings)
# ---------------------------------------------------------------------------


def kernel_lane_fold(agg, loss: str, *, minibatch: bool = False):
    """The serial lane body lowered through the fused-IGD kernel:
    ``(state, ex) -> state`` over a dense ``{"x": [n, d], "y": [n]}``
    epoch stream, advancing step/weight exactly like ``uda.fold`` (one
    per example). The per-example step sizes are the sequential
    schedule's exact values — transition i reads ``step_size(step0 + i)``
    and ``StepSize`` is elementwise over the step vector, so the kernel
    sees the same alphas the eager fold computes one at a time."""
    from repro_torch.kernels.igd_fused import ops as igd_ops

    op = igd_ops.igd_fold_minibatch if minibatch else igd_ops.igd_fold

    def lane(state, ex):
        x, y = ex["x"], ex["y"]
        n = x.shape[0]
        steps = state.step + torch.arange(n, dtype=torch.int32, device=x.device)
        alphas = agg.step_size(steps)
        model = op(x, y, alphas, state.model, loss=loss)
        return uda_lib.IGDState(model, state.step + n, state.weight + n)

    return lane


def kernel_permuted_lane(agg, loss: str, *, minibatch: bool = False):
    """The kernel lane behind a permutation: the kernel streams rows in
    array order, so the permutation is applied as one gather up front
    (same rows, same order, same floats as folding ``data[perm]``)."""
    lane = kernel_lane_fold(agg, loss, minibatch=minibatch)

    def permuted(state, data, perm):
        return lane(state, ordering_lib._permute(data, perm))

    return permuted


def _kernel_lane_for(task, agg, implementation: str):
    """Build the lane body for a cuda_* implementation (validated)."""
    loss = require_kernel_loss(task, agg, implementation)
    return kernel_lane_fold(
        agg, loss, minibatch=implementation == "cuda_minibatch"
    )


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------


def build_program(
    task,
    agg,
    prog: EpochProgram,
    *,
    counter: Optional[Dict[str, int]] = None,
) -> CompiledProgram:
    """Lower ``prog`` to its epoch callable (the singleton, in-memory,
    batch=1 corner of the IR — all this slice plans)."""
    counter = counter if counter is not None else fresh_counter()
    epoch_fn = build_epoch_fn(task, agg, prog.plan)
    count_build(counter)
    return CompiledProgram(
        program=prog, task=task, agg=agg, trace_counter=counter,
        epoch_fn=epoch_fn,
    )
