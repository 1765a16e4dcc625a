"""Carry state, tables, LM params and caches across from the JAX package
as numpy arrays.

The reference's ``IGDState`` holds a model, an int32 step and a float32
weight; its tables are dicts of column arrays; its LM params and decode
caches are pytrees whose layers are stacked on a leading axis. All cross
over as numpy (``np.asarray`` of a JAX array), so this module needs
neither package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.core.uda import IGDState


def model_from_numpy(model, device):
    """A float32 model on ``device`` from the reference model's arrays:
    one array, or a dict of them (``jax.tree.map(np.asarray, model)``)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device), model)


def state_from_numpy(model, step, weight, device) -> IGDState:
    """An ``IGDState`` on ``device`` from the reference state's arrays:
    ``model`` as :func:`model_from_numpy` takes it, ``step`` int32
    scalar, ``weight`` float32 scalar."""
    return IGDState(
        model_from_numpy(model, device),
        torch.tensor(np.asarray(step, dtype=np.int32), device=device),
        torch.tensor(np.asarray(weight, dtype=np.float32), device=device),
    )


def table_from_numpy(arrays, device) -> dict:
    """A table (dict of column tensors) on ``device`` from a dict of
    numpy-convertible columns, dtypes kept."""
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in arrays.items()}


def chunked_table_from_numpy(arrays, chunk_rows: int, device):
    """A ``ChunkedTable`` of ``chunk_rows``-row chunks on ``device`` from a
    dict of numpy-convertible columns: the port's counterpart of the
    reference's ``ChunkedTable.from_arrays`` over the same arrays."""
    from repro_torch.engine.table import ChunkedTable

    return ChunkedTable.from_arrays(table_from_numpy(arrays, device), chunk_rows)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.tensor(a.view(np.uint16).astype(np.int16), device=device).view(torch.bfloat16)
    return torch.tensor(a, device=device)


def lm_params_from_numpy(params, cfg, device) -> dict:
    """The port's LM params (``repro_torch.models.lm``) from the reference's
    pytree as numpy arrays (``jax.tree.map(np.asarray, params)``): the
    stacked ``blocks`` become a list of ``cfg.n_layers`` per-layer dicts."""

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else _tensor(v[i], device) for k, v in tree.items()}

    out = {k: _tensor(v, device) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [layer(params["blocks"], i) for i in range(cfg.n_layers)]
    return out


def cache_from_numpy(cache, device) -> dict:
    """The port's decode cache from the reference's (dense family):
    {"kv": {"k", "v": [L, B, S, Kv, hd]}, "index": int32 scalar} ->
    {"kv": [per-layer {"k", "v"}], "index": int}."""
    kv = cache["kv"]
    return {
        "kv": [{"k": _tensor(kv["k"][i], device), "v": _tensor(kv["v"][i], device)}
               for i in range(np.asarray(kv["k"]).shape[0])],
        "index": int(np.asarray(cache["index"])),
    }
