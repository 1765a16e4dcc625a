"""Layouts and merges for shared-nothing data-parallel IGD (paper §3.3
at device scale).

The construction of the merge-period-H local-SGD blocks lives in
``repro_torch.engine.program`` (``build_shard_block``), the one compiler
every execution path shares; this module keeps the pieces the compiler
and its driver lay data out with:

* ``partition_rows`` — the RDBMS partition layout: ``[n, ...]`` columns
  as ``[k, n/k, ...]`` contiguous shared-nothing segments (a view, no
  copy);
* ``scatter_lanes`` / ``replicate`` — the two placements a block input
  takes over d devices (the counterparts of the reference's
  ``shard_sharding`` and ``replicated_sharding``): segments (or
  permutation slices) split into d groups of k/d lanes, each on its
  device; the table and the draws replicated, one reference per device.
  On one device both return their input as it is: nothing is copied;
* ``merge_stacked`` / ``device_merge`` — the UDA merge tree: fold
  ``agg.merge`` left to right over a device's stacked lanes, then over
  the d device partials.

Across devices this is single controller, as the reference's
``shard_map`` is: one process drives the d devices, and
``device_merge`` moves the d model-sized partials to the first device
(``Tensor.to``) and folds them there, where the reference all-gathers
them and folds the same tree on every device. ``torch.distributed`` is
not used: ``Engine.run`` has one caller, and a process group would need
every rank to run it. The reference's ``build_block_fn`` (a legacy alias
of ``program.build_shard_block``) is **not applicable**: the port has no
older callers to keep.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core.tree import leaves, tree_map


def partition_rows(tree, num_shards: int):
    """[n, ...] leaves -> [num_shards, n/num_shards, ...] (contiguous
    shared-nothing segments, the RDBMS partition layout)."""
    n = leaves(tree)[0].shape[0]
    if n % num_shards:
        raise ValueError(f"{n} rows not divisible by {num_shards} shards")
    return tree_map(
        lambda x: x.reshape((num_shards, n // num_shards) + tuple(x.shape[1:])), tree
    )


def scatter_lanes(tree, devices: Sequence[torch.device]) -> List:
    """Split the leading lane axis of every leaf into ``len(devices)``
    equal groups, group i on ``devices[i]`` (one device: the tree as it
    is)."""
    d = len(devices)
    if d == 1:
        return [tree_map(lambda x: x.to(devices[0]), tree)]
    k = leaves(tree)[0].shape[0]
    if k % d:
        raise ValueError(f"{k} shards not divisible by {d} devices")
    per = k // d
    return [tree_map(lambda x, i=i: x[i * per:(i + 1) * per].to(dev), tree)
            for i, dev in enumerate(devices)]


def replicate(tree, devices: Sequence[torch.device]) -> List:
    """``tree`` on every device of ``devices`` (a tensor already on a
    device is not copied there)."""
    return [tree_map(lambda x, dev=dev: x.to(dev), tree) for dev in devices]


def merge_stacked(agg, states, count: int, *, batched: bool = False):
    """Fold ``agg.merge`` left to right over a stacked ``[count, ...]``
    state bank. ``batched``: the states carry a query axis after the lane
    axis, and the merge is ``torch.func.vmap``-ed over it (the merge is
    elementwise, so each query's merge is its own un-batched merge bit
    for bit)."""
    merge = torch.func.vmap(agg.merge) if batched else agg.merge
    out = tree_map(lambda x: x[0], states)
    for i in range(1, count):
        out = merge(out, tree_map(lambda x, i=i: x[i], states))
    return out


def device_merge(agg, partials: Sequence, *, batched: bool = False):
    """Merge one partial state per device: move the d (model-sized)
    partials to the first device and fold ``agg.merge`` over them left to
    right, the tree the reference folds after its all_gather. Exact
    weighted model averaging; the only cross-device traffic of a
    local-SGD block."""
    out = partials[0]
    if len(partials) == 1:
        return out
    merge = torch.func.vmap(agg.merge) if batched else agg.merge
    dev = leaves(out)[0].device
    for part in partials[1:]:
        out = merge(out, tree_map(lambda x: x.to(dev), part))
    return out
