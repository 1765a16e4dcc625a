"""Mamba2 (SSD) mixer (``repro.models.mamba2``): the chunked state-space
duality algorithm for prefill, the O(1) recurrence for decode.

One B/C group shared across heads, a scalar A per head, a depthwise
causal conv over (x, B, C), sized by ``cfg.ssm_*``. The dtype steps are
the reference's: dt through softplus in float32, the decays in float32,
the chunk products in the compute dtype, the cache stored in float32 and
cast to the compute dtype for a step. The scan across chunks is a Python
loop (the reference's ``lax.scan``); no kernel form (the reference has
none either: it computes the SSD in XLA).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding
from repro_torch.models import layers

CHUNK = 256


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg, *, device) -> dict:
    d = cfg.d_model
    d_inner, h, n = dims(cfg)
    conv_dim = d_inner + 2 * n
    pd = layers.dtype_of(cfg.param_dtype)
    return {
        # projects to [z (gate), x, B, C, dt]
        "w_in": layers.dense_init(gen, (d, 2 * d_inner + 2 * n + h), pd, device=device),
        "conv_w": layers.dense_init(gen, (cfg.ssm_conv, conv_dim), pd, scale=0.5, device=device),
        "conv_b": torch.zeros((conv_dim,), dtype=pd, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=device)).to(pd),
        "dt_bias": torch.log(torch.expm1(torch.full((h,), 0.01, device=device))).to(pd),
        "d_skip": torch.ones((h,), dtype=pd, device=device),
        "norm": torch.ones((d_inner,), dtype=pd, device=device),
        "w_out": layers.dense_init(gen, (d_inner, d), pd, device=device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv, kernel K, then SiLU. x: [B, S, C]; w: [K, C];
    state: [B, K-1, C] (the inputs before x). Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, C]
    s = x.shape[1]
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    y = F.silu(y + b.to(x.dtype))
    return y, xp[:, -(k - 1):]


def ssd_chunked(x, dt, a, b, c, d_skip, init_state=None):
    """Chunk-parallel SSD. x: [B, L, H, P]; dt: [B, L, H] (post-softplus,
    float32); a: [H] (negative, float32); b, c: [B, L, N]; init_state:
    [B, H, P, N] or None. Returns (y [B, L, H, P], final_state [B, H, P, N]).
    On DTensors, per rank over its batch rows and heads
    (``sharding.batch_head_local``; b and c, shared by the heads, whole)."""
    if sharding.is_dtensor(x):
        return sharding.batch_head_local(ssd_chunked, (x, dt, a, b, c, d_skip, init_state),
                                         ((0, 2), (0, 2), (None, 0), (0, None), (0, None), (None, 0), (0, 1)),
                                         ((0, 2), (0, 1)))
    bs, l, h, p = x.shape
    n = b.shape[-1]
    q = min(CHUNK, l)
    if l % q:
        raise ValueError(f"seq {l} not divisible by chunk {q}")
    nc = l // q
    xdt = x.dtype

    xb = x.reshape(bs, nc, q, h, p)
    dtb = dt.reshape(bs, nc, q, h)
    bb = b.reshape(bs, nc, q, n)
    cb = c.reshape(bs, nc, q, n)

    log_a = dtb * a.to(dtb.dtype)  # [B,NC,Q,H], negative
    la = torch.cumsum(log_a, dim=2)  # within-chunk cumulative

    # intra-chunk: M[t,s] = exp(la_t - la_s) * (c_t . b_s) * dt_s,  s <= t
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]  # [B,NC,Q(t),Q(s),H]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(tri[None, None, :, :, None], seg, float("-inf"))
    cbs = torch.einsum("bctn,bcsn->bcts", cb, bb)  # [B,NC,Q,Q]
    m = torch.exp(seg) * cbs[..., None] * dtb[:, :, None, :, :]  # [B,NC,t,s,H]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", m.to(xdt), xb)

    # chunk summaries: S_c = sum_s exp(la_end - la_s) dt_s x_s b_s^T
    decay_to_end = torch.exp(la[:, :, -1:, :] - la)  # [B,NC,Q,H]
    wgt = (decay_to_end * dtb).to(xdt)
    s_chunk = torch.einsum("bcsh,bcshp,bcsn->bchpn", wgt, xb, bb)

    # inter-chunk scan: S_c = exp(sum log_a_c) S_{c-1} + S_chunk_c
    chunk_decay = torch.exp(torch.sum(log_a, dim=2))  # [B,NC,H]
    state = init_state if init_state is not None else x.new_zeros((bs, h, p, n))
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = chunk_decay[:, ci, :, None, None].to(state.dtype) * state + s_chunk[:, ci]
    prev_states = torch.stack(prev, dim=1)  # [B,NC,H,P,N]

    # inter-chunk contribution: y_t += exp(la_t) * (c_t . S_prev)
    decay_in = torch.exp(la)  # [B,NC,Q,H]
    y_inter = torch.einsum("bctn,bchpn,bcth->bcthp", cb, prev_states, decay_in.to(xdt))

    y = (y_intra + y_inter).reshape(bs, l, h, p)
    y = y + x * d_skip.to(xdt)[None, None, :, None]
    return y, state


def ssd_step(x, dt, a, b, c, d_skip, state):
    """One-token recurrence. x: [B,H,P]; dt: [B,H]; b, c: [B,N];
    state: [B,H,P,N]. Returns (y [B,H,P], new_state)."""
    decay = torch.exp(dt * a.to(dt.dtype))  # [B,H]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt.to(x.dtype), x, b)
    new_state = decay[:, :, None, None].to(x.dtype) * state + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, c)
    return y + x * d_skip.to(x.dtype)[None, :, None], new_state


def mamba_block(params: dict, x, cfg, *, cache: Optional[dict] = None):
    """The Mamba2 mixer. x: [B, S, D]; cache {"conv": [B, K-1, C], "ssm":
    [B, H, P, N]} (float32) for decode or a prefill into the cache, None
    for a prefill from scratch. Returns (out, the new cache or None)."""
    bs, s, _ = x.shape
    d_inner, h, n = dims(cfg)
    dt_ = x.dtype

    proj = x @ params["w_in"].to(dt_)
    z, xbc, dt_raw = proj[..., :d_inner], proj[..., d_inner:2 * d_inner + 2 * n], proj[..., 2 * d_inner + 2 * n:]
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    xs, b, c = xbc[..., :d_inner], xbc[..., d_inner:d_inner + n], xbc[..., d_inner + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    xh = xs.reshape(bs, s, h, cfg.ssm_head_dim)

    if cache is not None and s == 1:
        y, new_ssm = ssd_step(xh[:, 0], dt[:, 0], a, b[:, 0], c[:, 0], params["d_skip"],
                              cache["ssm"].to(dt_))
        y = y[:, None]  # [B,1,H,P]
    else:
        init_state = cache["ssm"].to(dt_) if cache is not None else None
        y, new_ssm = ssd_chunked(xh, dt, a, b, c, params["d_skip"], init_state)

    y = y.reshape(bs, s, d_inner)
    y = layers.rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["w_out"].to(dt_)
    new_cache = ({"conv": new_conv.float(), "ssm": new_ssm.float()} if cache is not None else None)
    return out, new_cache


def init_mamba_cache(cfg, batch: int, *, device) -> dict:
    d_inner, h, n = dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n), dtype=torch.float32, device=device),
    }
