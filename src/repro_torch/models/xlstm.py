"""xLSTM blocks (``repro.models.xlstm``): mLSTM (matrix memory, the
stabilised quadratic parallel form for prefill, the O(1) recurrence for
decode) and sLSTM (scalar memory with recurrent mixing, sequential over
time), per Beck et al. 2024. ``d_ff == 0``: the blocks carry their own
up/down projections.

As in the reference, an mLSTM prefill into a cache raises: the parallel
form does not produce the recurrent state, and the reference computes
none. The sLSTM's scan over time is a Python loop (the reference's
``lax.scan``); no kernel form (the reference has none either).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding
from repro_torch.models import layers


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg):
    d_inner = 2 * cfg.d_model  # up-projection factor 2
    hd = d_inner // cfg.n_heads
    return d_inner, cfg.n_heads, hd


def init_mlstm(gen: torch.Generator, cfg, *, device) -> dict:
    d = cfg.d_model
    d_inner, h, _ = _mlstm_dims(cfg)
    pd = layers.dtype_of(cfg.param_dtype)
    return {
        "w_up": layers.dense_init(gen, (d, 2 * d_inner), pd, device=device),  # x path + gate
        "wq": layers.dense_init(gen, (d_inner, d_inner), pd, device=device),
        "wk": layers.dense_init(gen, (d_inner, d_inner), pd, device=device),
        "wv": layers.dense_init(gen, (d_inner, d_inner), pd, device=device),
        "w_if": layers.dense_init(gen, (d_inner, 2 * h), pd, scale=0.01, device=device),
        "b_i": torch.full((h,), -3.0, dtype=pd, device=device),  # input gate starts mostly closed
        "b_f": torch.full((h,), 3.0, dtype=pd, device=device),  # forget gate starts mostly open
        "norm": torch.ones((d_inner,), dtype=pd, device=device),
        "w_down": layers.dense_init(gen, (d_inner, d), pd, device=device),
    }


def _log_sigmoid(x):
    """log(sigmoid(x)) in float32 as ``-softplus(-x)``, which is how JAX
    defines ``jax.nn.log_sigmoid``. ``F.logsigmoid``'s backward has no
    DTensor sharding rule; softplus's has."""
    return -F.softplus(-x.float())


def mlstm_parallel(q, k, v, i_pre, f_pre):
    """Stabilised quadratic mLSTM. q, k, v: [B,S,H,hd]; i_pre, f_pre:
    [B,S,H] pre-activations. D[t,s] = sum_{u=s+1..t} logsig(f_u) + i_s for
    s <= t; h_t = (S v)_t / max(|sum_s S_ts|, exp(-m_t)), S = (q k^T /
    sqrt(hd)) exp(D - m). On DTensors, per rank over its batch rows and
    heads (``sharding.batch_head_local``)."""
    if sharding.is_dtensor(q):
        return sharding.batch_head_local(mlstm_parallel, (q, k, v, i_pre, f_pre), ((0, 2),) * 5, ((0, 2),))
    _, s, _, hd = q.shape
    logf = _log_sigmoid(f_pre)  # [B,S,H]
    cf = torch.cumsum(logf, dim=1)
    dmat = cf[:, :, None, :] - cf[:, None, :, :]  # [B,t,s,H]
    dmat = dmat + i_pre.float()[:, None, :, :]
    tri = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(tri[None, :, :, None], dmat, float("-inf"))
    m = torch.clamp(dmat.amax(dim=2, keepdim=True), min=-1e30)  # [B,t,1,H]; guards all -inf rows
    dexp = torch.exp(dmat - m)  # [B,t,s,H]

    logits = torch.einsum("bthd,bshd->btsh", q, k) / torch.tensor(hd ** 0.5, dtype=q.dtype)
    smat = logits.float() * dexp
    norm = torch.maximum(torch.abs(smat.sum(dim=2)), torch.exp(-m[:, :, 0, :]))  # [B,t,H]
    weights = (smat / torch.clamp(norm[:, :, None, :], min=1e-30)).to(q.dtype)
    return torch.einsum("btsh,bshd->bthd", weights, v)


def mlstm_step(q, k, v, i_pre, f_pre, state):
    """Recurrent mLSTM update. q, k, v: [B,H,hd]; i_pre, f_pre: [B,H];
    state {"c": [B,H,hd,hd], "n": [B,H,hd], "m": [B,H]} in float32."""
    logf = _log_sigmoid(f_pre)
    i32 = i_pre.float()
    m_new = torch.maximum(logf + state["m"], i32)
    fdec = torch.exp(logf + state["m"] - m_new)
    iamp = torch.exp(i32 - m_new)
    k32, v32, q32 = k.float(), v.float(), q.float()
    c_new = fdec[..., None, None] * state["c"] + iamp[..., None, None] * (v32[..., :, None] * k32[..., None, :])
    n_new = fdec[..., None] * state["n"] + iamp[..., None] * k32
    q32 = q32 / torch.sqrt(torch.tensor(float(q.shape[-1])))
    num = torch.einsum("bhvk,bhk->bhv", c_new, q32)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q32)), torch.exp(-m_new))
    h = (num / den[..., None]).to(q.dtype)
    return h, {"c": c_new, "n": n_new, "m": m_new}


def mlstm_block(params: dict, x, cfg, *, cache: Optional[dict] = None):
    """x: [B,S,D] -> (out, new_cache). Decode when cache is given and S == 1."""
    bs, s, _ = x.shape
    d_inner, h, hd = _mlstm_dims(cfg)
    dt = x.dtype

    up = x @ params["w_up"].to(dt)
    xin, gate = up[..., :d_inner], up[..., d_inner:]
    q = (xin @ params["wq"].to(dt)).reshape(bs, s, h, hd)
    k = (xin @ params["wk"].to(dt)).reshape(bs, s, h, hd)
    v = (xin @ params["wv"].to(dt)).reshape(bs, s, h, hd)
    gif = xin @ params["w_if"].to(dt)  # [B,S,2H]
    i_pre = gif[..., :h] + params["b_i"].to(dt)
    f_pre = gif[..., h:] + params["b_f"].to(dt)

    if cache is not None and s == 1:
        hsq, new_cache = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0], cache)
        hs = hsq[:, None]
    else:
        if cache is not None:
            raise NotImplementedError("mLSTM prefill-into-cache uses scan path")
        hs = mlstm_parallel(q, k, v, i_pre, f_pre)
        new_cache = None
    hs = hs.reshape(bs, s, d_inner)
    hs = layers.rms_norm(hs, params["norm"], cfg.norm_eps) * F.silu(gate)
    return hs @ params["w_down"].to(dt), new_cache


def init_mlstm_cache(cfg, batch: int, *, device) -> dict:
    _, h, hd = _mlstm_dims(cfg)
    return {
        "c": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg, *, device) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    pd = layers.dtype_of(cfg.param_dtype)
    return {
        # input weights for (i, f, z, o)
        "w_x": layers.dense_init(gen, (d, 4 * d), pd, device=device),
        # block-diagonal recurrent weights per head, (gate, H, hd, hd); read in float32
        "r_h": layers.dense_init(gen, (4, h, hd, hd), pd, scale=1.0 / hd ** 0.5, device=device),
        "b": torch.cat([torch.full((d,), -2.0), torch.full((d,), 2.0), torch.zeros((2 * d,))]).to(
            device=device, dtype=pd),
        "norm": torch.ones((d,), dtype=pd, device=device),
        "w_out": layers.dense_init(gen, (d, d), pd, device=device),
    }


def _slstm_cell(params, x_t, state, cfg):
    """One sLSTM step. x_t: [B, 4D] (the input projection); state {"c",
    "n", "h", "m": [B, D]} in float32."""
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    bsz = x_t.shape[0]
    hprev = state["h"].reshape(bsz, h, hd)
    rec = torch.einsum("bhk,ghvk->bghv", hprev, params["r_h"].float()).reshape(bsz, 4 * d)
    pre = x_t.float() + rec + params["b"].float()
    ip, fp, zp, op = pre.chunk(4, dim=-1)
    m_new = torch.maximum(fp + state["m"], ip)  # exponential-gate stabiliser
    i = torch.exp(ip - m_new)
    f = torch.exp(fp + state["m"] - m_new)
    z = torch.tanh(zp)
    o = torch.sigmoid(op)
    c_new = f * state["c"] + i * z
    n_new = f * state["n"] + i
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_scan(xproj, r_h, b, c, n, h, m, cfg):
    """The sLSTM over time. xproj: [B,S,4D] (the input projection); the
    state c, n, h, m: [B,D] float32. Returns (hs [B,S,D], c, n, h, m). On
    DTensors, per rank over its batch rows, every head on each rank
    (``sharding.batch_head_local``): the loop's ops then dispatch as plain
    tensors, and some torch releases' DTensor refuses the cell's reshapes
    of a head-split state (2.11)."""
    if sharding.is_dtensor(xproj):
        return sharding.batch_head_local(lambda *a: _slstm_scan(*a, cfg), (xproj, r_h, b, c, n, h, m),
                                         ((0, None), (None, None), (None, None)) + ((0, None),) * 4,
                                         ((0, None),) * 5)
    params, state = {"r_h": r_h, "b": b}, {"c": c, "n": n, "h": h, "m": m}
    hs = []
    for t in range(xproj.shape[1]):
        state = _slstm_cell(params, xproj[:, t], state, cfg)
        hs.append(state["h"])
    return (torch.stack(hs, dim=1), *(state[k] for k in ("c", "n", "h", "m")))


def slstm_block(params: dict, x, cfg, *, cache: Optional[dict] = None):
    """x: [B,S,D]; sequential over S (one step for decode)."""
    bs, s, d = x.shape
    dt = x.dtype
    xproj = x @ params["w_x"].to(dt)  # [B,S,4D]
    state = cache if cache is not None else init_slstm_cache_dims(bs, d, device=x.device)
    hs, *final = _slstm_scan(xproj, params["r_h"], params["b"], *(state[k] for k in ("c", "n", "h", "m")), cfg)
    hs = hs.to(dt)
    new_cache = dict(zip(("c", "n", "h", "m"), final)) if cache is not None else None
    hs = layers.rms_norm(hs, params["norm"], cfg.norm_eps)
    return hs @ params["w_out"].to(dt), new_cache


def init_slstm_cache_dims(batch: int, d: int, *, device) -> dict:
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": z, "n": z, "h": z, "m": torch.full((batch, d), -30.0, dtype=torch.float32, device=device)}


def init_slstm_cache(cfg, batch: int, *, device) -> dict:
    return init_slstm_cache_dims(batch, cfg.d_model, device=device)
