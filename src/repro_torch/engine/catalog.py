"""The task catalog: the engine's system-catalog table of techniques.

MADlib keeps a catalog of registered analytics routines above the
aggregate layer; this is that layer for the Bismarck engine. Registering
a technique is ONE decorated class — the task supplies its per-example
objective, the catalog supplies everything physical (step-size schedule,
prox operator, planning, execution, caching)::

    @register_task("huber", step_size=lambda n: igd.diminishing(0.1, n))
    @dataclasses.dataclass(frozen=True)
    class HuberRegression(Task):
        dim: int
        def init_model(self, generator):
            return torch.zeros(self.dim, device=generator.device)
        def example_loss(self, w, ex):
            r = torch.dot(w, ex["x"]) - ex["y"]
            return torch.where(r.abs() < 1.0, 0.5 * r * r, r.abs() - 0.5)

A technique whose model is a dict of tensors (``lmf``'s factors,
``crf``'s weights) registers the same way: the engine's core maps over
the model's leaves (``repro_torch.core.tree``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch import tasks as tasks_lib
from repro_torch.core import igd


def _no_prox(task) -> Callable:
    del task
    return igd.identity_prox


def _l1_from_mu(task) -> Callable:
    mu = getattr(task, "mu", 0.0)
    return igd.make_l1_prox(mu) if mu else igd.identity_prox


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Catalog row: how to build the task and its IGD defaults."""

    name: str
    factory: Callable[..., Any]  # task_args -> Task
    # n_examples -> step-size schedule (decay tied to epoch length)
    step_size: Callable[[int], igd.StepSize]
    # task instance -> prox rule (regularizer / feasible-set projection)
    prox: Callable[[Any], Callable] = _no_prox
    # (task_args, n_examples) -> extra args the ENGINE fills in from the
    # table it is about to run on (explicit task_args always win). Lets a
    # technique depend on table statistics the user shouldn't have to
    # remember — e.g. LMF's degree apportionment.
    derive_args: Optional[Callable[[dict, int], dict]] = None
    # Non-convex objective: model averaging across shards can cancel
    # (factor rotations) instead of combine. The planner caps such a
    # task's sharded plans at planner.NONCONVEX_SHARD_CAP shards (probe
    # (f) probes at the capped count) and prices each shard's averaging
    # loss into its convergence term; no singleton plan reads it.
    nonconvex: bool = False
    # Loss name in the fused-IGD kernel's dispatch table
    # (kernels/igd_fused: "lr" | "svm" | "lsq"), for techniques whose
    # transition is exactly margin -> scale -> axpy on a dense (x, y)
    # row. Unset means the implementation axis stays at torch_fold.
    kernel_loss: Optional[str] = None

    def make_task(self, **task_args):
        return self.factory(**task_args)


_REGISTRY: Dict[str, TaskSpec] = {}


def register_task(
    name: str,
    *,
    step_size: Optional[Callable[[int], igd.StepSize]] = None,
    prox: Callable[[Any], Callable] = _no_prox,
    derive_args: Optional[Callable[[dict, int], dict]] = None,
    nonconvex: bool = False,
    kernel_loss: Optional[str] = None,
):
    """Class decorator registering a ``Task`` under ``name``.

    ``step_size``: n_examples -> StepSize (default: diminishing 0.1/epoch).
    ``prox``: task -> prox rule (default: identity).
    ``derive_args``: (task_args, n_examples) -> args the engine derives
    from the live table when the user left them unset (default: none).
    ``nonconvex``: the objective is non-convex (default: convex).
    ``kernel_loss``: fused-IGD kernel loss name ("lr"/"svm"/"lsq") when
    the transition matches the kernel's margin/scale/axpy shape (default:
    none — implementation axis stays torch_fold)."""
    step = step_size or (lambda n: igd.diminishing(0.1, decay=max(n, 1)))

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"task {name!r} already registered")
        _REGISTRY[name] = TaskSpec(
            name, cls, step, prox, derive_args, nonconvex, kernel_loss
        )
        return cls

    return deco


def get(name: str) -> TaskSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; catalog has {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list:
    return sorted(_REGISTRY)


def unregister(name: str) -> None:
    """Drop a catalog entry (tests re-register throwaway techniques)."""
    _REGISTRY.pop(name, None)


def kernel_loss_for(task) -> Optional[str]:
    """Fused-kernel loss name for a task INSTANCE, or None.

    Looks the instance's exact class up in the registry (subclasses
    don't inherit eligibility — an override of example_grad would
    silently diverge from the kernel's hard-coded gradient)."""
    for spec in _REGISTRY.values():
        if type(task) is spec.factory:
            return spec.kernel_loss
    return None


# ---------------------------------------------------------------------------
# Built-in techniques (paper Fig. 1B): every repro_torch.tasks technique
# with the hyperparameter defaults of the reference catalog.
# ---------------------------------------------------------------------------

register_task(
    "logreg",
    step_size=lambda n: igd.diminishing(0.5, decay=max(n, 1)),
    prox=_l1_from_mu,
    kernel_loss="lr",
)(tasks_lib.LogisticRegression)

register_task(
    "svm",
    step_size=lambda n: igd.diminishing(0.2, decay=max(n, 1)),
    prox=_l1_from_mu,
    kernel_loss="svm",
)(tasks_lib.SVM)

register_task(
    "least_squares",
    step_size=lambda n: igd.diminishing(0.1, decay=max(n, 1)),
    kernel_loss="lsq",
)(tasks_lib.LeastSquares)

register_task(
    "sparse_logreg",
    step_size=lambda n: igd.diminishing(0.5, decay=max(n, 1)),
    prox=_l1_from_mu,
)(tasks_lib.SparseLogisticRegression)

register_task(
    "sparse_svm",
    step_size=lambda n: igd.diminishing(0.2, decay=max(n, 1)),
    prox=_l1_from_mu,
)(tasks_lib.SparseSVM)

# LMF localizes its Frobenius regularizer inside example_loss (the
# Gemulla/Bismarck transition touches only rows L_i and R_j, so the
# penalty rides along apportioned by degree — see tasks/lmf.py). It must
# NOT also get an L2 prox: a prox applies the full-table penalty once
# per tuple, i.e. n_ratings× too strong, which shrinks every factor by
# ~exp(-alpha*mu*n) per epoch. The degree apportionment is derived from
# the live table by the engine (the 1.0 class defaults over-penalize by
# the mean degree otherwise).


def _lmf_derive_degrees(task_args: dict, n_examples: int) -> dict:
    if "mean_row_degree" in task_args or "mean_col_degree" in task_args:
        return {}  # explicit user choice wins
    if "n_rows" not in task_args or "n_cols" not in task_args:
        return {}  # let make_task raise its own missing-arg TypeError
    return tasks_lib.LowRankMF.degrees_for(
        task_args["n_rows"], task_args["n_cols"], n_examples
    )


register_task(
    "lmf",
    step_size=lambda n: igd.diminishing(0.1, decay=max(n, 1)),
    derive_args=_lmf_derive_degrees,
    nonconvex=True,
)(tasks_lib.LowRankMF)

register_task(
    "crf",
    step_size=lambda n: igd.diminishing(0.2, decay=max(n, 1)),
)(tasks_lib.LinearChainCRF)

register_task(
    "kalman",
    step_size=lambda n: igd.diminishing(0.02, decay=max(n, 1)),
)(tasks_lib.KalmanFilterTask)

register_task(
    "portfolio",
    step_size=lambda n: igd.diminishing(0.02, decay=max(n, 1)),
    prox=lambda task: igd.make_simplex_prox(),
)(tasks_lib.PortfolioOpt)
