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

from repro_torch.engine import table as table_lib


@dataclasses.dataclass(frozen=True)
class AnalyticsQuery:
    """What the user wants. Only ``task`` and ``data`` are required.

    ``data`` is a table: a dict of column tensors sharing a leading row
    dimension (``{"x": [n, d], "y": [n]}`` for the dense GLMs), on the
    device of the engine that runs the query, OR a stored table — any
    object of the duck-typed Table protocol (``repro_torch.engine.table``,
    e.g. a ``ChunkedTable`` whose chunks lie on the host): the data-source
    axis of the EpochProgram IR. ``hints`` may pin
    individual physical choices (``ordering``, ``implementation``, ...) —
    an escape hatch for experiments; the planner fills everything left
    unset. ``memory_budget_bytes`` models the RDBMS buffer pool."""

    task: str
    data: Any
    task_args: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    epochs: int = 20  # max epochs (the paper's outer-loop bound)
    tolerance: float = 1e-3  # relative loss-drop stop (0 = run all epochs)
    target_loss: Optional[float] = None  # stop at a known objective value
    memory_budget_bytes: Optional[int] = None
    seed: int = 0
    hints: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def _stored(self) -> bool:
        return table_lib.is_stored_table(self.data)

    @property
    def n_examples(self) -> int:
        if self._stored:
            return self.data.n_rows
        return next(iter(self.data.values())).shape[0]

    @property
    def data_bytes(self) -> int:
        if self._stored:
            return self.data.data_bytes()
        return sum(v.numel() * v.element_size() for v in self.data.values())

    def data_signature(self) -> tuple:
        """Column names, shapes, dtypes and device of the table — part of
        the plan-cache key (a plan's calibration is shape-specific). A
        stored table reports the signature of its materialized columns,
        so stored and in-memory runs over the same data share plan and
        calibration caches."""
        if self._stored:
            return self.data.signature()
        return table_lib.signature_of(self.data)

    def cache_key_fields(self) -> tuple:
        return (
            self.task,
            tuple(sorted(self.task_args.items())),
            self.data_signature(),
        )

    def content_fingerprint(self, sample_rows: int = 24) -> str:
        """Cheap content hash of the table: signature + boundary rows +
        evenly strided interior rows of every column. The persistent plan
        cache stores it so a *different* table with the same shape (whose
        statistics — e.g. clusteredness — may differ) invalidates the
        on-disk entry instead of silently reusing its plan. Interior
        samples matter: a reordered table (same multiset of rows, e.g.
        label-clustered vs shuffled — exactly what the planner keys on)
        must change the fingerprint, and boundary rows alone can miss
        it."""
        if self._stored:
            return self.data.content_fingerprint(sample_rows)
        return table_lib.fingerprint_arrays(
            self.data_signature(), self.data, sample_rows
        )
