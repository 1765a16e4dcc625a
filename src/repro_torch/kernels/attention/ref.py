"""Plain PyTorch version of causal GQA attention (``repro.kernels.attention.ref``).

It computes in float32, like the kernels, and casts the output to q's
dtype. The CPU path and the card's parity checks use it."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, scale=None):
    """q: [BH, S, hd]; k/v: [BKV, S, hd]; BH = groups * BKV with q head h
    reading kv head h // groups. Causal. Returns [BH, S, hd] in q's dtype."""
    bh, s, hd = q.shape
    groups = bh // k.shape[0]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    k = k.repeat_interleave(groups, dim=0).float()
    v = v.repeat_interleave(groups, dim=0).float()
    logits = torch.einsum("hqd,hkd->hqk", q.float(), k) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask[None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v).to(q.dtype)


def mha_ref(q, k, v):
    """The ops' layout: q [B, S, H, hd], k/v [B, S, Kv, hd] -> [B, S, H, hd].
    Batch is laid outermost, so q head b*H + h reads kv head b*Kv + h // g."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, s, hd)
    kf = k.transpose(1, 2).reshape(b * kv, s, hd)
    vf = v.transpose(1, 2).reshape(b * kv, s, hd)
    of = attention_ref(qf, kf, vf, scale=1.0 / (hd ** 0.5))
    return of.reshape(b, h, s, hd).transpose(1, 2)
