"""Elastic scaling (``repro.launch.elastic``): resume a training run on a
different device count or mesh than the one that wrote the checkpoint.

Checkpoints store logical (unsharded) arrays (``repro_torch.ckpt``), so
elasticity is a placement decision at restore time:

    params, opt, meta = elastic_restore(ckpt_dir, cfg, optimizer, new_mesh)

re-derives the partition specs against the new mesh and distributes each
leaf onto it as a DTensor. The data pipeline's state in the checkpoint
meta is mesh-independent (epoch, cursor, seed), so the token order is
reproduced exactly; only the per-rank batch slicing changes. Scale-up and
scale-down are symmetric. Where the reference traces ``init_lm`` with
``eval_shape``, the port builds the params on the meta device: shapes and
dtypes, no memory.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.dist import sharding as shd
from repro_torch.models import lm


def _abstract(cfg, optimizer):
    """(params, optimizer state) of ``cfg`` as meta tensors."""
    params = lm.init_lm(cfg, torch.Generator(), "meta")
    return params, optimizer.init(params)


def shardings_for(cfg, mesh, optimizer) -> Tuple[Any, Any]:
    """(param shardings, opt-state shardings) for a config on a mesh."""
    params_abs, opt_abs = _abstract(cfg, optimizer)
    pshard = shd.shardings(shd.param_specs(params_abs, cfg, mesh), mesh)
    oshard = tuple(pshard for _ in opt_abs) if opt_abs else ()
    return pshard, oshard


def elastic_restore(ckpt_dir: str, cfg, optimizer, mesh: Optional[Any], device=None):
    """Restore the latest checkpoint in ``ckpt_dir`` re-sharded onto
    ``mesh`` (a ``DeviceMesh``; ``None``: plain tensors on ``device``, the
    card unless ``"cpu"``). Returns (params, opt_state, meta) or (None,
    None, None) when no checkpoint exists. With a mesh every rank calls
    it: each leaf is read on every rank and distributed."""
    mgr = CheckpointManager(ckpt_dir)
    params_abs, opt_abs = _abstract(cfg, optimizer)
    like = {"params": params_abs, "opt": opt_abs}
    shardings = None
    if mesh is not None:
        pshard, oshard = shardings_for(cfg, mesh, optimizer)
        shardings = {"params": pshard, "opt": oshard}
    restored, meta = mgr.restore_latest(like, shardings=shardings, device=device)
    if restored is None:
        return None, None, None
    return restored["params"], restored["opt"], meta
