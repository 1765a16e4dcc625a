"""Shared neural layers (``repro.models.layers``): RMSNorm, RoPE, GQA
attention (train/prefill/decode with a KV cache) and the MLP variants.

Functional style, as in the reference: params are plain dicts of tensors
with the reference's key names, so a JAX pytree carries across one to one
(``repro_torch.convert``). Differences in form, not in numbers:

* attention runs through the port's kernels (``kernels.attention.ops.mha``
  and ``kernels.decode.ops.decode_attention``) in place of the reference's
  XLA einsums and its ``ATTN_CHUNK`` scan: the kernel never materialises
  the logits, so nothing needs chunking;
* the KV cache is updated in place: the reference returns a new cache
  (``dynamic_update_slice``), which on the card would copy the whole cache
  every step (a DTensor cache split along its length is written shard by
  shard, ``dist.sharding.write_positions``). ``cache_index`` is a Python
  int, so routing and the kernels' ``length`` need no device sync. The kernels read only the cache's first
  ``cache_index + S`` positions, which is the reference's ``kv_limit``
  mask over the whole cache;
* the attention-logit soft cap (``cfg.logit_softcap``, grok-1) is applied
  inside the kernels, to the scaled float32 logits before the mask, as the
  reference's ``_soft_cap`` is;
* the ``.to(dt)`` casts of the weights are the reference's ``astype(dt)``
  and cost nothing on weights already in the compute dtype
  (``models.lm.cast_params``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import gather_seq, seq_gathered_grad, write_positions
from repro_torch.kernels.attention import ops as attention_ops
from repro_torch.kernels.decode import ops as decode_ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None, *, device):
    """``scale`` (default 1/sqrt(fan_in)) times a standard normal truncated
    to [-2, 2], drawn from ``gen`` (which lies on ``device``) in float32."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / fan_in ** 0.5
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * s).to(dtype)


# ---------------------------------------------------------------------------
# norms / rotary
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] (broadcast over heads).
    Split-half rotation, as the reference's."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [hd/2]
    angles = positions[..., :, None, None].float() * freqs  # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg, *, device) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pd = dtype_of(cfg.param_dtype)
    return {
        "wq": dense_init(gen, (d, h * hd), pd, device=device),
        "wk": dense_init(gen, (d, k * hd), pd, device=device),
        "wv": dense_init(gen, (d, k * hd), pd, device=device),
        "wo": dense_init(gen, (h * hd, d), pd, device=device),
    }


def attention(params: dict, x, cfg, positions, *, cache: Optional[dict] = None,
              cache_index: Optional[int] = None):
    """GQA attention. x: [B, S, D]; positions: [B, S]. Modes:

    * ``cache`` None: causal self-attention over the fresh q/k/v (``mha``);
    * ``cache`` given ({"k", "v": [B, S_max, Kv, hd]}), S == 1: k/v are
      written at ``cache_index`` and the token attends to the cache's
      first ``cache_index + 1`` positions (``decode_attention``);
    * ``cache`` given, S > 1 (a prefill, or a chunk of one at an offset):
      k/v are written at [cache_index, cache_index + S) and ``mha`` runs
      the S queries at positions cache_index + i over the cache's first
      ``cache_index + S`` positions (k/v longer than q).

    Returns (out [B, S, D], the cache or None); the returned cache is the
    given one, updated in place.

    q heads are laid kv-major as in the reference (head h = kv * g + j), so
    head h reads kv head h // g, which is the kernels' mapping."""
    x = gather_seq(x)
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    cap = cfg.logit_softcap

    q = (x @ params["wq"].to(dt)).reshape(b, s, h, hd)
    k = (x @ params["wk"].to(dt)).reshape(b, s, kv, hd)
    v = (x @ params["wv"].to(dt)).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = attention_ops.mha(q, k, v, cap)
    else:
        ck, cv = cache["k"], cache["v"]
        end = cache_index + s
        if end > ck.shape[1]:
            raise ValueError(f"{s} tokens at index {cache_index} overflow the cache's {ck.shape[1]} positions")
        write_positions(ck, cache_index, k.to(ck.dtype))
        write_positions(cv, cache_index, v.to(cv.dtype))
        if s == 1:
            out = decode_ops.decode_attention(q[:, 0], ck.to(dt), cv.to(dt), end, cap)
        else:
            out = attention_ops.mha(q, ck[:, :end].to(dt), cv[:, :end].to(dt), cap)

    out = out.reshape(b, s, h * hd) @ params["wo"].to(dt)
    return seq_gathered_grad(out), cache


def init_attention_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *, device) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg, *, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    pd = dtype_of(cfg.param_dtype)
    p = {
        "w_in": dense_init(gen, (d, f), pd, device=device),
        "w_out": dense_init(gen, (f, d), pd, device=device),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (d, f), pd, device=device)
    return p


def mlp(params: dict, x, cfg):
    """The reference's variants; its ``jax.nn.gelu`` is the tanh form."""
    x = gather_seq(x)
    dt = x.dtype
    hidden = x @ params["w_in"].to(dt)
    if cfg.mlp == "swiglu":
        hidden = F.silu(x @ params["w_gate"].to(dt)) * hidden
    elif cfg.mlp == "geglu":
        hidden = F.gelu(x @ params["w_gate"].to(dt), approximate="tanh") * hidden
    elif cfg.mlp == "relu2":  # nemotron's squared ReLU
        hidden = torch.square(F.relu(hidden))
    elif cfg.mlp == "gelu":
        hidden = F.gelu(hidden, approximate="tanh")
    else:
        raise ValueError(cfg.mlp)
    return seq_gathered_grad(hidden @ params["w_out"].to(dt))
