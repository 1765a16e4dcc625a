"""The stored-table side of the EpochProgram data-source axis.

An RDBMS table does not arrive as one resident tensor: the storage layer
hands the executor a *chunk stream* in stored order. This module defines
the duck-typed ``Table`` protocol the engine consumes — the engine never
imports a concrete storage class; anything with these members is a
stored table:

* ``is_stored_table`` — truthy marker (``getattr(obj, "is_stored_table",
  False)`` is the one test every layer uses);
* ``n_rows`` — total row count;
* ``signature()`` — the column names, shapes, dtypes and device of the
  *materialized* table, equal to ``AnalyticsQuery.data_signature()`` of
  the same columns held in memory on the chunks' device, so stored and
  in-memory runs share one compiled-plan cache and one calibration cache;
* ``content_fingerprint(sample_rows)`` — the same sampled content hash
  the query computes for in-memory tables (persistent plan-cache keying);
* ``chunks()`` — iterator of column dicts in stored order (the
  sequential scan the executor streams);
* ``arrays()`` — the whole table materialized as one column dict (for
  plans that need random access: shuffle orderings, the non-serial
  schemes, full-table loss evaluation);
* ``probe_slab(rows)`` — the first ``rows`` rows materialized (planner
  micro-probes and statistics).

``ChunkedTable`` is the reference implementation: fixed-size row chunks
held on whatever device its input lay on, standing in for an on-disk
store. Chunks on the host reach the card one at a time as the fold takes
them (the engine counts the bytes); that transfer is the access pattern
the axis exists for — the epoch streams one chunk-sized working set at a
time instead of requiring the whole table resident (paper §3.4 motivates
MRS the same way).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch


def is_stored_table(data: Any) -> bool:
    return bool(getattr(data, "is_stored_table", False))


def resolve(data: Any):
    """The one materialization seam: a stored table becomes its column
    dict; in-memory data passes through untouched."""
    return data.arrays() if is_stored_table(data) else data


def signature_of(data: Dict[str, torch.Tensor]) -> tuple:
    """Column names, shapes, dtypes and device of an in-memory table (the
    layout both sides of the duck-typed protocol must agree on)."""
    return tuple(
        (k, tuple(v.shape), str(v.dtype), str(v.device))
        for k, v in sorted(data.items())
    )


def _sample_indices(n: int, sample_rows: int) -> np.ndarray:
    """Boundary rows + evenly strided interior rows (sorted, unique) —
    the one sampling rule every fingerprint implementation must share."""
    edge = max(sample_rows // 6, 1)
    return np.unique(np.concatenate([
        np.arange(min(edge, n)),
        np.linspace(0, n - 1, num=min(sample_rows, n)).astype(int),
        np.arange(max(n - edge, 0), n),
    ]))


def _row_bytes(col: torch.Tensor, idx: np.ndarray) -> bytes:
    rows = col[torch.as_tensor(idx, dtype=torch.long, device=col.device)]
    return rows.detach().cpu().contiguous().numpy().tobytes()


def fingerprint_arrays(signature: tuple, data: Dict[str, torch.Tensor],
                       sample_rows: int) -> str:
    """Sampled content hash: signature + boundary rows + evenly strided
    interior rows of every column, in sorted column order (shared by
    ``AnalyticsQuery`` and stored tables so both key the persistent plan
    cache identically)."""
    h = hashlib.sha256(repr(signature).encode())
    for _, col in sorted(data.items()):
        n = col.shape[0] if col.dim() else 0
        if n == 0:
            continue
        h.update(_row_bytes(col, _sample_indices(n, sample_rows)))
    return h.hexdigest()[:32]


class ChunkedTable:
    """Reference ``Table``: fixed-size row chunks in stored order.

    Built from an in-memory table via ``from_arrays`` (the simulation of
    an ingest). Chunk boundaries are invisible to the eager fold's
    results: streaming the chunks through it gives bit-identical floats
    to folding the concatenated table — the transition sequence is the
    same, only the working set differs.
    """

    is_stored_table = True

    def __init__(self, chunks: List[Dict[str, torch.Tensor]]):
        if not chunks:
            raise ValueError("a ChunkedTable needs at least one chunk")
        self._chunks = list(chunks)
        self.n_rows = sum(_rows(c) for c in self._chunks)
        self.chunk_rows = _rows(self._chunks[0])
        self._arrays = None

    @classmethod
    def from_arrays(cls, data: Dict[str, torch.Tensor], chunk_rows: int) -> "ChunkedTable":
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        n = _rows(data)
        return cls([
            {k: v[i:i + chunk_rows] for k, v in data.items()}
            for i in range(0, n, chunk_rows)
        ])

    # -- the Table protocol ----------------------------------------------

    @property
    def num_chunks(self) -> int:
        return len(self._chunks)

    def chunks(self) -> Iterator[Dict[str, torch.Tensor]]:
        return iter(self._chunks)

    def chunk_shapes(self) -> Tuple[int, ...]:
        """Distinct chunk row counts (a ragged tail is one more shape)."""
        return tuple(sorted({_rows(c) for c in self._chunks}))

    def arrays(self) -> Dict[str, torch.Tensor]:
        if self._arrays is None:
            self._arrays = {
                k: torch.cat([c[k] for c in self._chunks]) for k in self._chunks[0]
            }
        return self._arrays

    def probe_slab(self, rows: int) -> Dict[str, torch.Tensor]:
        rows = min(rows, self.n_rows)
        have, parts = 0, []
        for c in self._chunks:
            if have >= rows:
                break
            take = min(rows - have, _rows(c))
            parts.append({k: v[:take] for k, v in c.items()})
            have += take
        if len(parts) == 1:
            return parts[0]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def signature(self) -> tuple:
        return tuple(
            (k, (self.n_rows,) + tuple(v.shape[1:]), str(v.dtype), str(v.device))
            for k, v in sorted(self._chunks[0].items())
        )

    def data_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for c in self._chunks for v in c.values())

    def content_fingerprint(self, sample_rows: int = 24) -> str:
        """Equal to ``fingerprint_arrays`` over the materialized table,
        computed chunk by chunk: only the chunks holding sampled rows are
        read, and nothing is concatenated — fingerprinting (the persistent
        plan cache's key) must not materialize the table any more than
        planning does."""
        h = hashlib.sha256(repr(self.signature()).encode())
        idx = _sample_indices(self.n_rows, sample_rows)
        for name in sorted(self._chunks[0]):
            offset = 0
            for chunk in self._chunks:
                rows = _rows(chunk)
                local = idx[(idx >= offset) & (idx < offset + rows)] - offset
                if local.size:
                    h.update(_row_bytes(chunk[name], local))
                offset += rows
        return h.hexdigest()[:32]


def _rows(table: Dict[str, torch.Tensor]) -> int:
    return next(iter(table.values())).shape[0]
