"""Carry state and tables across from the JAX package as numpy arrays.

The reference's ``IGDState`` holds a model, an int32 step and a float32
weight; its tables are dicts of column arrays. Both cross over as numpy
(``np.asarray`` of a JAX array), so this module needs neither package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.uda import IGDState


def state_from_numpy(model, step, weight, device) -> IGDState:
    """An ``IGDState`` on ``device`` from the reference state's arrays:
    ``model`` float32 [dim], ``step`` int32 scalar, ``weight`` float32
    scalar."""
    return IGDState(
        torch.tensor(np.asarray(model, dtype=np.float32), device=device),
        torch.tensor(np.asarray(step, dtype=np.int32), device=device),
        torch.tensor(np.asarray(weight, dtype=np.float32), device=device),
    )


def table_from_numpy(arrays, device) -> dict:
    """A table (dict of column tensors) on ``device`` from a dict of
    numpy-convertible columns, dtypes kept."""
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in arrays.items()}
