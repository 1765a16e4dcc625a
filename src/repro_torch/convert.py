"""Carry state, tables, LM params and caches across from the JAX package
as numpy arrays.

The reference's ``IGDState`` holds a model, an int32 step and a float32
weight; its tables are dicts of column arrays; its LM params and decode
caches are pytrees whose layers are stacked on a leading axis; its
gradients and optimizer states (``IGD`` ``(buf,)``, ``AdamW`` ``(m, v)``)
have its params' shape. All cross over as numpy (``np.asarray`` of a JAX
array), so this module needs neither package; ``lm_params_to_numpy``
stacks the port's params back into the reference's shape.
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


# the reference's stacked subtrees and the leading axes each stacks on:
# blocks [L]; the hybrid's mamba [n_seg, attn_every]; the ssm's mlstm
# [n_seg, slstm_every - 1] and slstm [n_seg]; a cache's kv [L] or [n_seg]
_STACKED = {"blocks": 1, "mamba": 2, "mlstm": 2, "slstm": 1, "kv": 1}


def _unstack(tree, depth: int, device):
    """A stacked subtree (dict of arrays with ``depth`` leading layer axes)
    as nested lists of per-layer dicts of tensors."""

    def pick(t, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i] for k, v in t.items()}

    def first_leaf(t):
        return first_leaf(next(iter(t.values()))) if isinstance(t, dict) else np.asarray(t)

    if depth == 0:
        return {k: _unstack(v, 0, device) if isinstance(v, dict) else _tensor(v, device) for k, v in tree.items()}
    return [_unstack(pick(tree, i), depth - 1, device) for i in range(first_leaf(tree).shape[0])]


def _from_numpy(tree, device):
    out = {}
    for k, v in tree.items():
        if k == "index":
            out[k] = int(np.asarray(v))
        elif k in _STACKED:
            out[k] = _unstack(v, _STACKED[k], device)
        elif isinstance(v, dict):
            out[k] = _unstack(v, 0, device)
        else:
            out[k] = _tensor(v, device)
    return out


def lm_params_from_numpy(params, cfg, device) -> dict:
    """The port's LM params (``repro_torch.models.lm``) from the reference's
    pytree as numpy arrays (``jax.tree.map(np.asarray, params)``), any
    family: the stacked ``blocks`` become a list of ``cfg.n_layers``
    per-layer dicts (a MoE layer's ``moe`` sub-dict included), the
    hybrid's ``mamba`` [n_seg, attn_every, ...] and the ssm's ``mlstm``
    [n_seg, n_m, ...] nested lists, the ssm's ``slstm`` [n_seg, ...] a
    list; the shared block's params stay single."""
    out = _from_numpy(params, device)
    if "blocks" in out and len(out["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(out['blocks'])} stacked blocks for a {cfg.n_layers}-layer config")
    return out


def cache_from_numpy(cache, device) -> dict:
    """The port's decode cache from the reference's, any family: the
    stacked ``kv`` {"k", "v": [L or n_seg, B, S, Kv, hd]} becomes a list
    of per-layer {"k", "v"}, ``mamba`` {"conv", "ssm": [n_seg,
    attn_every, ...]} and ``mlstm`` {"c", "n", "m": [n_seg, n_m, ...]}
    nested lists, ``slstm`` a list, and the int32 ``index`` an int."""
    return _from_numpy(cache, device)


def opt_state_from_numpy(state, cfg, device) -> tuple:
    """An optimizer state (``IGD``'s ``()`` or ``(buf,)``, ``AdamW``'s
    ``(m, v)``) from the reference's, each tree unstacked as the params are.
    A gradient tree is one params-shaped tree: ``lm_params_from_numpy``."""
    return tuple(lm_params_from_numpy(t, cfg, device) for t in state)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy of ``t`` (bf16 as float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack_like(items):
    """Per-layer dicts of arrays -> one dict of arrays stacked on axis 0."""
    if isinstance(items[0], dict):
        return {k: _stack_like([it[k] for it in items]) for k in items[0]}
    return np.stack(items)


def _stack(tree, depth: int):
    if depth == 0:
        return {k: _stack(v, 0) if isinstance(v, dict) else _numpy(v) for k, v in tree.items()}
    return _stack_like([_stack(t, depth - 1) for t in tree])


def lm_params_to_numpy(params) -> dict:
    """The inverse of ``lm_params_from_numpy``: the port's LM params (or a
    params-shaped tree: gradients, an optimizer's moments) as the
    reference's pytree of numpy arrays, the per-layer lists stacked on
    their leading layer axes again."""
    out = {}
    for k, v in params.items():
        if k in _STACKED:
            out[k] = _stack(v, _STACKED[k])
        elif isinstance(v, dict):
            out[k] = _stack(v, 0)
        else:
            out[k] = _numpy(v)
    return out
