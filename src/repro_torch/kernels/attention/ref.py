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


def _heads(t, groups: int = 1):
    """[B, S, heads, hd] -> float32 [B, heads * groups, S, hd], each head
    repeated ``groups`` times (kv head j serves q heads j*g .. j*g + g - 1)."""
    return t.float().transpose(1, 2).repeat_interleave(groups, dim=1)


def _logits(q, k, softcap: float):
    """(scaled and capped causal logits [B, H, S, Skv] float32 with masked
    entries at NEG_INF, the cap's derivative (1 without a cap), the mask)."""
    b, s, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    x = torch.einsum("bhqd,bhkd->bhqk", _heads(q), _heads(k, h // kv)) * (1.0 / hd ** 0.5)
    dcap = torch.ones((), device=q.device)
    if softcap and softcap > 0:
        t = torch.tanh(x / softcap)
        x, dcap = softcap * t, 1.0 - t * t
    mask = torch.ones((s, skv), dtype=torch.bool, device=q.device).tril(skv - s)
    return torch.where(mask, x, NEG_INF), dcap, mask


def mha_lse_ref(q, k, softcap: float = 0.0):
    """Each q row's log-sum-exp of its scaled (and capped) causal logits in
    natural units, float32 [B, H, S]: what the forward kernel writes as
    ``lse``. q [B, S, H, hd], k [B, Skv, Kv, hd]."""
    return torch.logsumexp(_logits(q, k, softcap)[0], dim=-1)


def mha_backward_ref(q, k, v, o, lse, do, softcap: float = 0.0):
    """The gradient kernels' plain version: (dq, dk, dv) in the inputs'
    dtype, recomputed from ``lse`` as the kernels do, over float32.
    P = exp(cap(s) - lse), D = rowsum(do * o), dS = P (dP - D) times the
    cap's derivative, dq = scale dS k, dk = scale dS^T q and dv = P^T do
    summed over each kv head's q heads. q, o, do [B, S, H, hd]; k, v
    [B, S, Kv, hd]; lse float32 [B, H, S]."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    x, dcap, mask = _logits(q, k, softcap)
    p = torch.where(mask, torch.exp(x - lse.float()[..., None]), 0.0)
    dof = _heads(do)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, _heads(v, g))
    delta = (dof * _heads(o)).sum(-1)
    ds = p * (dp - delta[..., None]) * dcap * (1.0 / hd ** 0.5)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _heads(k, g))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _heads(q))

    def kv_heads(t):  # [B, H, S, hd] -> [B, S, Kv, hd], summing each group
        return t.reshape(b, kv, g, s, hd).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), kv_heads(dk).to(k.dtype), kv_heads(dv).to(v.dtype))
