"""Fault-tolerant checkpointing (``repro.ckpt.checkpoint``).

The reference's layout: a checkpoint is a directory ``step_<N>/`` holding
one ``arrays.npz`` (leaves keyed by tree path, ``['params']/['blocks']/[0]/
['attn']/['wq']`` in the port's own tree shape) and ``meta.json`` (step,
the pipeline state, user extras); writes go to ``<name>.tmp`` and are
renamed into place, so a crash mid-write never corrupts the latest
checkpoint; ``CheckpointManager`` keeps the last ``keep`` and may write
on a background thread.

The port updates params in place (``optim``), where the reference's
writer thread reads immutable arrays. So ``CheckpointManager.save`` copies
every leaf to host memory before it returns, and the thread only writes
files: an update that follows a save cannot reach the checkpoint. bf16
leaves are stored as float32 (exact) and cast back on restore. Mesh
re-sharding (the reference's ``shardings``) waits for the sharding slice.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import timing


def _flatten(tree, prefix=""):
    """[(path key, leaf)] in the reference's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}/['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}/[{i}]")]
    return [(prefix[1:], tree)]


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(x) -> np.ndarray:
    """A host copy of ``x`` that nothing else holds (bf16 as float32)."""
    if isinstance(x, torch.Tensor):
        dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        return x.detach().to("cpu", dtype=dtype, copy=True).numpy()
    return np.array(x)


def save(path: str, tree: Any, *, step: int, meta: Optional[dict] = None):
    """Atomic checkpoint write of ``tree`` (a tree of tensors)."""
    _write(path, {k: _to_host(v) for k, v in _flatten(tree)}, step, meta)


def _write(path: str, arrays: dict, step: int, meta: Optional[dict]):
    """``arrays`` (path key -> host array) into ``path`` through ``path.tmp``."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "meta": meta or {}, "time": timing.wall()}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def restore(path: str, like: Any, *, shardings: Any = None):
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf on its ``like`` leaf's device in its dtype. Returns (tree,
    meta dict). Raises KeyError for a missing leaf, ValueError for a shape
    that disagrees."""
    if shardings is not None:
        raise NotImplementedError("shardings: re-sharding onto a mesh waits for the port's sharding slice")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        data = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    out = []
    for k, proto in _flatten(like):
        if k not in data:
            raise KeyError(f"checkpoint missing leaf {k!r}")
        arr = data[k]
        if tuple(arr.shape) != tuple(proto.shape):
            raise ValueError(f"leaf {k!r}: checkpoint shape {arr.shape} != expected {tuple(proto.shape)}")
        out.append(torch.from_numpy(arr).to(device=proto.device, dtype=proto.dtype))
    return _unflatten(like, iter(out)), meta


class CheckpointManager:
    """keep-k retention + optional async writes + latest-checkpoint resume."""

    def __init__(self, root: str, *, keep: int = 3, async_write: bool = True):
        self.root = root
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def steps(self):
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def wait(self):
        """Join the writer; re-raises the error a background write hit."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, *, meta: Optional[dict] = None):
        # every leaf copied to host memory before returning: training may
        # update the tensors in place as soon as this returns
        arrays = {k: _to_host(v) for k, v in _flatten(tree)}

        def work():
            _write(self._path(step), arrays, step, meta)
            self._gc()

        def background():
            try:
                work()
            except Exception as e:  # reported by wait(), which every save and fit's end call
                self._error = e

        self.wait()
        if self.async_write:
            self._thread = threading.Thread(target=background, daemon=True)
            self._thread.start()
        else:
            work()

    def restore_latest(self, like: Any, *, shardings: Any = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return restore(self._path(step), like, shardings=shardings)

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)
