"""Plain PyTorch version of causal GQA attention (``repro.kernels.attention.ref``).

It computes in float32, like the kernels, and casts the output to q's
dtype. The CPU path and the card's parity checks use it. Beyond the JAX
oracle it takes what the port's kernels take: k/v longer than q (q row i
at position Skv - S + i, a prefill chunk at a cache offset) and a soft cap
on the scaled logits, as ``repro.models.layers._attn_core`` applies them."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def soft_cap(logits, cap: float):
    """cap * tanh(logits / cap) for cap > 0, else the logits (the
    reference's ``layers._soft_cap``)."""
    return cap * torch.tanh(logits / cap) if cap and cap > 0 else logits


def attention_ref(q, k, v, *, scale=None, softcap: float = 0.0):
    """q: [BH, S, hd]; k/v: [BKV, Skv, hd] with Skv >= S; BH = groups * BKV
    with q head h reading kv head h // groups. Causal, q row i at position
    Skv - S + i. Returns [BH, S, hd] in q's dtype."""
    bh, s, hd = q.shape
    skv = k.shape[1]
    groups = bh // k.shape[0]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    k = k.repeat_interleave(groups, dim=0).float()
    v = v.repeat_interleave(groups, dim=0).float()
    logits = soft_cap(torch.einsum("hqd,hkd->hqk", q.float(), k) * scale, softcap)
    mask = torch.ones((s, skv), dtype=torch.bool, device=q.device).tril(skv - s)
    logits = torch.where(mask[None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v).to(q.dtype)


def mha_ref(q, k, v, softcap: float = 0.0):
    """The ops' layout: q [B, S, H, hd], k/v [B, Skv, Kv, hd] -> [B, S, H, hd].
    Batch is laid outermost, so q head b*H + h reads kv head b*Kv + h // g."""
    b, s, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    if skv < s:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)} (k and v [B, Skv >= S, Kv, hd])")
    qf = q.transpose(1, 2).reshape(b * h, s, hd)
    kf = k.transpose(1, 2).reshape(b * kv, skv, hd)
    vf = v.transpose(1, 2).reshape(b * kv, skv, hd)
    of = attention_ref(qf, kf, vf, scale=1.0 / (hd ** 0.5), softcap=softcap)
    return of.reshape(b, h, s, hd).transpose(1, 2)
