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

This slice of the port registers the dense GLMs; the sparse and
structured techniques come with their tasks.
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
    kernel_loss: Optional[str] = None,
):
    """Class decorator registering a ``Task`` under ``name``.

    ``step_size``: n_examples -> StepSize (default: diminishing 0.1/epoch).
    ``prox``: task -> prox rule (default: identity).
    ``kernel_loss``: fused-IGD kernel loss name ("lr"/"svm"/"lsq") when
    the transition matches the kernel's margin/scale/axpy shape (default:
    none — implementation axis stays torch_fold)."""
    step = step_size or (lambda n: igd.diminishing(0.1, decay=max(n, 1)))

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"task {name!r} already registered")
        _REGISTRY[name] = TaskSpec(name, cls, step, prox, kernel_loss)
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
# Built-in techniques (paper Fig. 1B) with the hyperparameter defaults of
# the reference catalog.
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
