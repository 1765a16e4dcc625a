"""The declarative query surface of the engine.

An ``AnalyticsQuery`` states WHAT to compute — which registered technique,
over which table, to what tolerance, under what resource budget — and
never how. Orderings, schemes and lowerings are physical-plan decisions
owned by ``repro_torch.engine.planner`` (paper §3.2–3.4: those knobs are
generic, not per-technique).

Mirrors the paper's SQL surface::

    SELECT LogisticRegression('model', 'LabeledPapers', tolerance => 1e-3)

==  ``engine.run(AnalyticsQuery(task="logreg", data=papers))``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class AnalyticsQuery:
    """What the user wants. Only ``task`` and ``data`` are required.

    ``data`` is a table: a dict of column tensors sharing a leading row
    dimension (``{"x": [n, d], "y": [n]}`` for the dense GLMs), on the
    device of the engine that runs the query. ``hints`` may pin
    individual physical choices (``ordering``, ``implementation``, ...) —
    an escape hatch for experiments; the planner fills everything left
    unset. ``memory_budget_bytes`` models the RDBMS buffer pool."""

    task: str
    data: Mapping[str, Any]
    task_args: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    epochs: int = 20  # max epochs (the paper's outer-loop bound)
    tolerance: float = 1e-3  # relative loss-drop stop (0 = run all epochs)
    target_loss: Optional[float] = None  # stop at a known objective value
    memory_budget_bytes: Optional[int] = None
    seed: int = 0
    hints: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_examples(self) -> int:
        return next(iter(self.data.values())).shape[0]

    @property
    def data_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.data.values())

    def data_signature(self) -> tuple:
        """Column names, shapes, dtypes and device of the table — part of
        the plan-cache key (a plan's calibration is shape-specific)."""
        return tuple(
            (k, tuple(v.shape), str(v.dtype), str(v.device))
            for k, v in sorted(self.data.items())
        )

    def cache_key_fields(self) -> tuple:
        return (
            self.task,
            tuple(sorted(self.task_args.items())),
            self.data_signature(),
        )
