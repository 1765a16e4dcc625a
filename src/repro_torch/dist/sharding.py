"""Partition-spec derivation and activation sharding constraints
(``repro.dist.sharding``), over ``torch.distributed.tensor`` (DTensor).

The reference's one policy, line for line:

* **Parameters** — megatron-style tensor parallelism over the "model" axis
  on the last dim, FSDP over the "data" axis on the second-to-last dim.
  Leading stack dims stay replicated. A dim is sharded only when its size
  divides the axis size, so the same code serves the 512-device production
  mesh and a 2x4 host mesh.
* **Batches** — leading batch dim over every data-parallel axis present
  ("pod" then "data").
* **Decode caches** — batch dim over the data axes; the cache length dim
  is length-sharded over "model" (each shard scans its KV slice; see
  ``repro_torch.dist.collectives.flash_decode_combine``).
* **Activations** — ``constrain(x, kind)`` pins residual/logit layouts by
  redistributing a DTensor; a no-op until ``set_activation_ctx`` has
  installed a ``DeviceMesh``, and on a plain tensor.

PyTorch's counterpart of GSPMD is DTensor over a ``DeviceMesh`` with named
dims, one process a device. A spec is the port's own small type,
:class:`PartitionSpec`: a tuple with one entry a tensor dim, ``None``, an
axis name or a tuple of axis names, so it compares one for one with the
reference's ``jax.sharding.PartitionSpec``. :func:`placements` turns it
into DTensor placements (mesh dim -> ``Shard(tensor dim)`` or
``Replicate()``); a tensor dim over two mesh axes, ``("pod", "data")``,
is ``Shard`` on both mesh dims, which DTensor splits the first axis major,
as JAX does.

The policy functions read only the mesh's axis sizes, so they take a
``DeviceMesh`` (``launch.mesh.make_host_mesh``) or the abstract
production mesh (``launch.mesh.make_production_mesh``) alike.

:func:`head_local` runs an attention function on each rank's local heads
(``local_map``): the port's kernels take raw pointers, so a DTensor never
reaches them. ``param_specs`` splits q/k/v over "model" only along head
boundaries, so attention stays head-local. :func:`embed_lookup` gathers
token rows the same way, and :func:`gather_data_axes` pins a parameter's
use layout (its data-axis shards gathered, FSDP's way), so a sharded step
leaves DTensor only the "model" split to choose.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.core.tree import tree_map

# Minimum cache-length extent worth length-sharding (below this the
# per-shard combine overhead dominates the cache read).
_MIN_LENGTH_SHARD = 512


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, an axis name, or a tuple of axis
    names (that dim split over those mesh axes, the first major). A leaf of
    a spec tree, not a container."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# mesh shapes
# ---------------------------------------------------------------------------


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's axis order, for a ``DeviceMesh``
    (``mesh_dim_names``) or an abstract mesh (``shape`` a dict)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def is_dtensor(x) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a torch built without distributed
        return False
    return isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# activation context
# ---------------------------------------------------------------------------

_CTX: dict = {"mesh": None, "seq_shard": False}


def set_activation_ctx(mesh, *, seq_shard: bool = False) -> None:
    """Install (or clear, with ``mesh=None``) the mesh used by
    ``constrain``. Process-global by design: model code stays mesh-free."""
    _CTX["mesh"] = mesh
    _CTX["seq_shard"] = bool(seq_shard)


def activation_ctx() -> tuple:
    """(mesh, seq_shard) as installed now."""
    return _CTX["mesh"], _CTX["seq_shard"]


def _data_axes(shape: dict) -> tuple:
    return tuple(a for a in ("pod", "data") if a in shape)


def _axis_size(shape: dict, axes) -> int:
    if not axes:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(shape[a] for a in axes)


def _div(dim: int, shape: dict, axes) -> bool:
    size = _axis_size(shape, axes)
    return size > 1 and dim % size == 0


def activation_spec(x_shape, kind: str, mesh, seq_shard: bool = False) -> PartitionSpec:
    """The spec ``constrain`` pins a [B, S, D] (``"resid"``) or [B, S, V]
    (``"logits"``) activation of shape ``x_shape`` to."""
    shape = mesh_shape(mesh)
    data = _data_axes(shape)
    dims: list = [None] * len(x_shape)
    if data and _div(x_shape[0], shape, data):
        dims[0] = data if len(data) > 1 else data[0]
    if kind == "logits":
        if _div(x_shape[-1], shape, "model"):
            dims[-1] = "model"
    elif kind == "resid":
        if seq_shard and _div(x_shape[1], shape, "model"):
            dims[1] = "model"
    return P(*dims)


def constrain(x, kind: str):
    """Constrain an activation's layout. ``kind``:

    * ``"resid"``  — [B, S, D]: batch over data axes; S over "model" when
      the context was installed with ``seq_shard=True``;
    * ``"logits"`` — [B, S, V]: batch over data axes, vocab over "model".

    The identity with no mesh installed, on a plain tensor, or below 3 dims."""
    mesh = _CTX["mesh"]
    if mesh is None or x.dim() < 3 or not is_dtensor(x):
        return x
    spec = activation_spec(tuple(x.shape), kind, mesh, _CTX["seq_shard"])
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------


def _walk(f, tree, key="", stack=(), collapse=False):
    """``f(name, stack, leaf)`` over a param or cache tree. ``stack`` holds
    the lengths of the lists above the leaf: the port keeps layers in
    lists where the reference stacks them on leading axes, so a leaf's
    reference shape is ``stack + leaf.shape``. With ``collapse`` a list
    becomes its first element's result (the reference's stacked tree)."""
    if isinstance(tree, dict):
        return {k: _walk(f, tree[k], k, stack, collapse) for k in sorted(tree)}
    if isinstance(tree, list):
        if collapse:
            return _walk(f, tree[0], key, stack + (len(tree),), collapse)
        return [_walk(f, v, key, stack + (len(tree),), collapse) for v in tree]
    return f(key, stack, tree)


def map_specs(f, specs, *rest):
    """``f(spec, *leaves)`` over a spec tree (dicts, lists and tuples; a
    :class:`PartitionSpec` is a leaf) and trees of the same structure."""
    if isinstance(specs, dict):
        return {k: map_specs(f, specs[k], *(r[k] for r in rest)) for k in sorted(specs)}
    if isinstance(specs, (list, tuple)) and not isinstance(specs, PartitionSpec):
        return type(specs)(map_specs(f, *xs) for xs in zip(specs, *rest))
    return f(specs, *rest)


def _param_rule(cfg, mesh):
    """The reference's rule: (leaf name, shape with its stack dims) ->
    PartitionSpec of that stacked shape."""
    shape = mesh_shape(mesh)
    has_model = "model" in shape
    has_data = "data" in shape
    msize = _axis_size(shape, "model") if has_model else 1
    kv_heads = getattr(cfg, "n_kv_heads", 0) if cfg is not None else 0
    heads_splittable = msize <= 1 or not kv_heads or kv_heads % msize == 0

    def worth(dim: int, axis: str) -> bool:
        return _div(dim, shape, axis) and dim >= 2 * _axis_size(shape, axis)

    def spec(name, dims_of) -> PartitionSpec:
        if len(dims_of) < 2:
            return P()
        dims: list = [None] * len(dims_of)
        head_split = name in ("wq", "wk", "wv")
        if has_model and worth(dims_of[-1], "model") and (not head_split or heads_splittable):
            dims[-1] = "model"
        if has_data and worth(dims_of[-2], "data"):
            dims[-2] = "data"
        return P(*dims)

    return spec


def stacked_param_specs(params, cfg, mesh):
    """The reference's ``param_specs`` on the reference's tree: each list
    of layers collapsed to one stacked leaf (shape ``stack + leaf.shape``),
    so the result equals the reference's spec for spec. The dry run reads
    per-device bytes from it."""
    rule = _param_rule(cfg, mesh)
    return _walk(lambda name, stack, leaf: rule(name, stack + tuple(leaf.shape)), params, collapse=True)


def param_specs(params, cfg, mesh):
    """PartitionSpec tree for an ``lm.init_lm`` param tree (or any param
    tree of the same conventions: trailing two dims are (in, out)); the
    leaves may be meta tensors.

    Two guards on the generic trailing-dims rule:

    * a dim is sharded only when it is at least twice the axis size —
      tiny dims gain nothing, and this keeps the leading layer-stack dim
      of stacked-vector leaves off the mesh where the stack is short;
    * q/k/v projections are tensor-parallel only along HEAD boundaries:
      the "model" axis must divide ``n_kv_heads`` (GQA: then also
      ``n_heads``), else a shard would own a fraction of a head.

    Each leaf's spec is the reference's spec of its stacked shape
    (:func:`stacked_param_specs`) without the stack dims. Where the
    reference shards a stack dim (its guard lets a [28, d] norm stack onto
    a 4-wide "data" axis), the port's per-layer tensors have no such dim:
    that split is dropped and each layer's tensor keeps the rest of the
    spec."""
    rule = _param_rule(cfg, mesh)
    return _walk(lambda name, stack, leaf: P(*rule(name, stack + tuple(leaf.shape))[len(stack):]), params)


def _batch_axes(shape: dict, global_batch: int) -> Any:
    data = _data_axes(shape)
    if data and global_batch % _axis_size(shape, data) == 0:
        return data if len(data) > 1 else data[0]
    return None


def batch_specs(cfg, kind: str, mesh, global_batch: int) -> dict:
    """PartitionSpec dict for a (train|prefill|decode) input batch."""
    batch_axes = _batch_axes(mesh_shape(mesh), global_batch)
    specs = {"tokens": P(batch_axes, None)}
    if kind in ("train", "prefill") and getattr(cfg, "n_prefix", 0):
        specs["prefix_embeds"] = P(batch_axes, None, None)
    return specs


def _cache_rule(mesh, global_batch: int):
    shape = mesh_shape(mesh)
    batch_axes = _batch_axes(shape, global_batch)
    has_model = "model" in shape

    def spec(dims_of) -> PartitionSpec:
        dims: list = [None] * len(dims_of)
        for i, d in enumerate(dims_of):
            if d == global_batch:
                dims[i] = batch_axes
                j = i + 1
                if (has_model and j < len(dims_of) and dims_of[j] >= _MIN_LENGTH_SHARD
                        and _div(dims_of[j], shape, "model")):
                    dims[j] = "model"
                break
        return P(*dims)

    return spec


def _cache_leaf(rule, stack, leaf, keep_stack):
    if not isinstance(leaf, torch.Tensor):  # the host-side index
        return P()
    spec = rule(stack + tuple(leaf.shape))
    return spec if keep_stack else P(*spec[len(stack):])


def stacked_cache_specs(cfg, mesh, global_batch: int, cache_abs) -> dict:
    """The reference's ``cache_specs`` on the reference's stacked cache
    tree (see :func:`stacked_param_specs`)."""
    del cfg
    rule = _cache_rule(mesh, global_batch)
    return _walk(lambda _, stack, leaf: _cache_leaf(rule, stack, leaf, True), cache_abs, collapse=True)


def cache_specs(cfg, mesh, global_batch: int, cache_abs) -> dict:
    """PartitionSpec tree for a decode cache (``lm.init_cache`` layout;
    meta tensors do).

    The batch dim is recognized by size (in the leaf's stacked shape, as
    the reference's is); the following dim is length-sharded over "model"
    when long enough and divisible. The host-side ``index`` (an int) gets
    ``P()``, as the reference's scalar does."""
    del cfg
    rule = _cache_rule(mesh, global_batch)
    return _walk(lambda _, stack, leaf: _cache_leaf(rule, stack, leaf, False), cache_abs)


# ---------------------------------------------------------------------------
# spec -> placements / abstract-value helpers
# ---------------------------------------------------------------------------


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements for ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` where tensor dim i names that axis, else ``Replicate()``.
    A dim over several axes must name them in the mesh's order (the first
    major, as JAX splits them)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: dim {i} names {axes} out of the mesh's axis order {names}")
        for j in where:
            out[j] = Shard(i)
    return tuple(out)


class Sharding:
    """Where one leaf goes: a ``DeviceMesh``, the DTensor placements on it,
    and the spec they came from (the reference's ``NamedSharding``). Not
    a container, so tree walkers take it as a leaf."""

    __slots__ = ("mesh", "placements", "spec")

    def __init__(self, mesh, placements_, spec):
        self.mesh, self.placements, self.spec = mesh, tuple(placements_), spec

    def __repr__(self) -> str:
        return f"Sharding({self.spec}, {self.placements})"


def shardings(specs, mesh):
    """Map a PartitionSpec tree to :class:`Sharding`s on ``mesh``."""
    return map_specs(lambda s: Sharding(mesh, placements(s, mesh), s), specs)


def distribute(tree, shards):
    """Each leaf of ``tree`` (a plain tensor holding the logical value on
    every rank) as a DTensor placed by its :class:`Sharding`; the
    reference's ``jax.device_put(tree, shardings)``. Every rank calls it.
    A local shard never shares memory with ``x`` (a replicated placement
    would keep ``x`` itself), so an in-place update of the DTensor leaves
    the caller's tensor as it was, as the reference's copy does."""
    from torch.distributed.tensor import distribute_tensor

    def one(s, x):
        x = x.detach()
        d = distribute_tensor(x, s.mesh, s.placements)
        if d.to_local().untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
            d = distribute_tensor(x.clone(), s.mesh, s.placements)
        return d

    return tree_map(one, shards, tree)


def full(tree):
    """Each DTensor leaf of ``tree`` gathered to its logical value (a
    collective: every rank calls it); plain leaves as they are. The
    reference's ``jax.device_get``: the value never shares memory with the
    DTensor, which the in-place optimizer goes on updating."""
    def get(x):
        if not is_dtensor(x):
            return x
        value = x.full_tensor()
        if value.untyped_storage().data_ptr() == x.to_local().untyped_storage().data_ptr():
            value = value.clone()
        return value

    return tree_map(get, tree)


def abstract_with_sharding(abs_tree, specs, mesh):
    """Meta tensors carrying their spec and placements (``.spec``,
    ``.placements``): the dry run's inputs, with no device allocation."""
    def one(s, a):
        t = torch.empty(tuple(a.shape), dtype=a.dtype, device="meta")
        t.spec, t.placements = s, placements(s, mesh)
        return t

    return map_specs(one, specs, abs_tree)


def gather_data_axes(x):
    """A DTensor parameter with its shards over the data axes ("pod",
    "data") all-gathered for use, its "model" split kept: FSDP's gather
    before a layer runs, which the reference's compiled step does too. Its
    backward reduce-scatters the gradient onto the parameter's own
    placements. Pinning the use layout keeps every matmul's data-axis
    operand the batch, whatever DTensor's cost model would pick; a plain
    tensor passes as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if name in ("pod", "data") else p
                 for name, p in zip(mesh_shape(x.device_mesh), x.placements))
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# the embedding lookup
# ---------------------------------------------------------------------------


def embed_lookup(table, tokens):
    """``table[tokens]``. On a DTensor table each rank gathers its own
    token rows from the whole table (``local_map``): the table is
    all-gathered (the reference's gather reads a replicated table too), and
    its gradient comes back a partial sum over the ranks whose token rows
    differ, reduced onto the table's own placements. DTensor's own
    strategy for the gather's backward (``index_put``) is not taken: some
    torch releases refuse it for a batch-sharded index."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tok = tokens.placements if is_dtensor(tokens) else [Replicate()] * mesh.ndim
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in tok]
    grads = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    mapped = local_map(lambda t, i: t[i], out_placements=rows, in_placements=([Replicate()] * mesh.ndim, rows),
                       in_grad_placements=(grads, rows), device_mesh=mesh, redistribute_inputs=True)
    return mapped(table, tokens)


# ---------------------------------------------------------------------------
# attention on local heads
# ---------------------------------------------------------------------------


def head_local(fn, q, kvs, *args, q_head_dim: int, kv_head_dim: int):
    """``fn(q, *kvs, *args)`` on each rank's local tensors, for q a DTensor
    (the k/v tensors ``kvs`` DTensors on its mesh). Per mesh dim: the batch
    (dim 0) stays sharded where q's is; the heads stay sharded where q's
    and every k/v's are and both head counts divide the axis; anything
    else is replicated first. q heads are kv-major (head h reads kv head
    h // g), so a shard's q heads read its own kv heads. Returns ``fn``'s
    output (shaped like q) as a DTensor placed like q's input to ``fn``;
    differentiable, so ``fn``'s backward runs per rank too."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    pq, pkv = [], []
    for j, size in enumerate(mesh.shape):
        a = q.placements[j]
        if isinstance(a, Shard) and a.dim == 0:
            pq.append(Shard(0))
            pkv.append(Shard(0))
        elif (isinstance(a, Shard) and a.dim == q_head_dim
              and all(isinstance(t.placements[j], Shard) and t.placements[j].dim == kv_head_dim for t in kvs)
              and q.shape[q_head_dim] % size == 0 and kvs[0].shape[kv_head_dim] % size == 0):
            pq.append(Shard(q_head_dim))
            pkv.append(Shard(kv_head_dim))
        else:
            pq.append(Replicate())
            pkv.append(Replicate())
    # a list is one output's placements (a tuple would be one per output)
    in_placements = (pq,) + tuple(pkv for _ in kvs) + tuple(None for _ in args)
    mapped = local_map(fn, out_placements=pq, in_placements=in_placements, device_mesh=mesh,
                       redistribute_inputs=True)
    return mapped(q, *kvs, *args)
