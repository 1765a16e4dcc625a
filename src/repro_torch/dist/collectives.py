"""Cross-shard collectives for the length-sharded decode path
(``repro.dist.collectives``).

Decode attention over a KV cache sharded on the *length* dim: each
"model" shard runs flash decode over its local cache slice, producing
partial (out, m, l) online-softmax stats, and the partials combine exactly
with a logsumexp-weighted reduction. The only cross-shard traffic is
O(B * H * hd), independent of the cache length.

On the card each shard is one launch of the port's ``flash_decode``
kernel, which returns the partials and reads the cache by strides, so a
slice along S needs no copy; on the CPU it is ``decode_attention_ref``.
The combine is plain PyTorch, as the reference's is (it lies outside any
Pallas kernel there). Two ways to hold the shards:

* over a process group (a ``DeviceMesh``): each rank holds its slice, and
  the reference's ``pmax`` / ``psum`` are ``all_reduce`` (MAX, then SUM)
  on the axis's group;
* in one process (an abstract mesh, ``launch.mesh.AbstractMesh``): the n
  slices of one cache run one after another and the partials, stacked on
  a leading shard dim, are reduced over it with the same arithmetic.

A shard whose slice holds no valid position gets out = 0, m = -1e30,
l = 0 from the kernel, which is the weight-0 partial the combine wants.
At a total ``length`` of 0 the combine returns 0 where the reference's
oracle averages v (``kernels.decode.ref``), so lengths are held >= 1.
"""

from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd
from repro_torch.kernels.decode import kernel as decode_kernel
from repro_torch.kernels.decode import ref as decode_ref


def flash_decode_combine(out, m, l, group=None):
    """Combine flash-decode partials. out: [..., hd] (locally
    softmax-normalized), m / l: [...] (local max / normalizer). With a
    process ``group`` the partials are this rank's and the reduction runs
    across the group; with ``group=None`` they carry a leading shard dim
    and are reduced over it. Exact: equals softmax over the concatenated
    cache. Returns the combined output in out's dtype."""
    import torch.distributed as dist

    out32 = out.to(torch.float32)
    if group is None:
        m_star = m.max(dim=0).values
        w = l * torch.exp(m - m_star)
        denom = w.sum(dim=0)
        num = (w[..., None] * out32).sum(dim=0)
    else:
        m_star = m.clone()
        dist.all_reduce(m_star, dist.ReduceOp.MAX, group=group)
        w = l * torch.exp(m - m_star)
        denom = w.clone()
        dist.all_reduce(denom, dist.ReduceOp.SUM, group=group)
        num = w[..., None] * out32
        dist.all_reduce(num, dist.ReduceOp.SUM, group=group)
    return (num / torch.clamp_min(denom, 1e-30)[..., None]).to(out.dtype)


def _partial(q, k, v, length: int):
    """(out [B, H, hd], m [B, H], l [B, H]) over one slice: the kernel on
    the card, the plain version on the CPU."""
    if q.device.type == "cuda":
        return decode_kernel.flash_decode(q, k, v, length)
    if q.device.type == "cpu":
        return decode_ref.decode_attention_ref(q, k, v, length)
    raise ValueError(f"sharded_flash_decode has no version for device {q.device}")


def _length_local(t, axis_name: str):
    """A DTensor cache as the reference's shard_map takes it (S over
    ``axis_name``, the rest replicated), this rank's slice; a plain tensor
    as it is."""
    if not shd.is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    want = [Shard(1) if a == axis_name else Replicate() for a in shd.mesh_shape(t.device_mesh)]
    return t.redistribute(t.device_mesh, want).to_local()


def sharded_flash_decode(q, k_cache, v_cache, length: int, mesh, *, axis_name: str = "model"):
    """Length-sharded flash decode: q [B, H, hd], caches [B, S, Kv, hd]
    split into ``mesh``'s ``axis_name`` size of shards along S; ``length``
    the shared valid prefix (a Python int, so each shard's local length,
    clip(length - shard * s_loc, 0, s_loc), is reckoned on the host).
    Returns [B, H, hd], the same on every rank.

    ``mesh`` a ``DeviceMesh`` (every rank calls this): each rank takes its
    slice (a DTensor cache's local shard, or its slice of a plain cache
    that every rank holds) and the partials are combined across the
    axis's process group. ``mesh`` an abstract mesh: one process runs
    every shard of a plain cache and combines them stacked. Raises when S
    does not divide by the shards."""
    n = shd.mesh_shape(mesh)[axis_name]
    s = k_cache.shape[1]
    if s % n:
        raise ValueError(f"cache length {s} not divisible by {n}")
    s_loc = s // n
    length = int(length)
    q = q.full_tensor() if shd.is_dtensor(q) else q

    def local_len(shard: int) -> int:
        return min(max(length - shard * s_loc, 0), s_loc)

    if hasattr(mesh, "get_group"):
        shard = mesh.get_local_rank(axis_name)
        k, v = _length_local(k_cache, axis_name), _length_local(v_cache, axis_name)
        if k.shape[1] == s:  # every rank holds the whole cache: take this rank's slice
            k, v = k[:, shard * s_loc:(shard + 1) * s_loc], v[:, shard * s_loc:(shard + 1) * s_loc]
        elif k.shape[1] != s_loc:
            raise ValueError(f"a rank's cache holds {k.shape[1]} positions, neither {s} nor the shard's {s_loc}")
        out, m, l = _partial(q, k, v, local_len(shard))
        return flash_decode_combine(out, m, l, mesh.get_group(axis_name))
    parts = [_partial(q, k_cache[:, i * s_loc:(i + 1) * s_loc], v_cache[:, i * s_loc:(i + 1) * s_loc], local_len(i))
             for i in range(n)]
    out, m, l = (torch.stack(t) for t in zip(*parts))
    return flash_decode_combine(out, m, l)
