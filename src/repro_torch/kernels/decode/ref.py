"""Plain PyTorch version of flash decode (``repro.kernels.decode.ref``).

It computes in float32, like the kernels, and returns the softmax stats
``(m, l)`` beside the output. The CPU path and the card's parity checks
use it. ``softcap`` caps the scaled logits before the mask, as the
reference's ``layers._soft_cap`` does in its decode attention."""

from __future__ import annotations

import torch

from repro_torch.kernels.attention.ref import soft_cap

NEG_INF = -1e30


def decode_ref(q, k, v, length: int, *, scale=None, softcap: float = 0.0):
    """q: [BH, hd]; k/v: [BKV, S, hd]; positions >= ``length`` masked.
    Returns (out [BH, hd] in q's dtype, m [BH] f32, l [BH] f32).

    For ``length >= 1`` this is ``repro.kernels.decode.ref.decode_ref``
    value for value (a masked position's weight is exp(-1e30 - m) = 0
    either way). At ``length == 0`` it gives what the Pallas kernel gives,
    out = 0, m = -1e30, l = 0, where the JAX oracle would average v."""
    bh, hd = q.shape
    s = k.shape[1]
    groups = bh // k.shape[0]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    k = k.repeat_interleave(groups, dim=0).float()
    v = v.repeat_interleave(groups, dim=0).float()
    logits = soft_cap(torch.einsum("hd,hkd->hk", q.float(), k) * scale, softcap)
    pos = torch.arange(s, device=q.device)
    logits = torch.where(pos[None, :] < length, logits, NEG_INF)
    m = logits.max(dim=-1).values
    p = torch.where(pos[None, :] < length, torch.exp(logits - m[:, None]), 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("hk,hkd->hd", p, v) / l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype), m, l


def decode_attention_ref(q, k_cache, v_cache, length: int, softcap: float = 0.0):
    """The ops' layout: q [B, H, hd], caches [B, S, Kv, hd] ->
    (out [B, H, hd], m [B, H], l [B, H]). The scale is 1/sqrt(hd)."""
    b, h, hd = q.shape
    _, s, kv, _ = k_cache.shape
    kf = k_cache.transpose(1, 2).reshape(b * kv, s, hd)
    vf = v_cache.transpose(1, 2).reshape(b * kv, s, hd)
    of, m, l = decode_ref(q.reshape(b * h, hd), kf, vf, length, scale=1.0 / (hd ** 0.5), softcap=softcap)
    return of.reshape(b, h, hd), m.reshape(b, h), l.reshape(b, h)
