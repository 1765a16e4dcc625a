"""Unified LM (``repro.models.lm``), dense family: init / forward /
prefill / decode.

Layer params are a list of per-layer dicts (the reference stacks them on
a leading axis for ``lax.scan``); the stack is a Python loop. The
reference's ``constrain`` (``dist/sharding.py``) is the identity on one
card and is left out. Other families (moe, hybrid, ssm, vlm, audio) raise
``NotImplementedError`` naming their slice; ``train_loss`` waits for the
training slice.

Differences in form, not in numbers:

* ``prefill`` and ``decode_step`` apply the final norm and the head to the
  last position only, since both are per position and only
  ``logits[:, -1]`` is returned; the full [B, S, vocab] float32 logits of
  a 2,048-token prefill at B=8 would be 8.4 GB. ``forward`` keeps all
  positions.
* The decode cache is {"kv": [per-layer {"k", "v"}], "index": int}; its
  tensors are updated in place and ``index`` lives on the host.
* ``cast_params`` makes the compute-dtype copy of the matmul weights once;
  the layers' ``.to(dt)`` are then no-ops, where the reference casts
  float32 params at every use.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers

_FAMILY_SLICES = {
    "moe": "the MoE slice (models/moe.py)",
    "hybrid": "the hybrid slice (models/mamba2.py)",
    "ssm": "the xLSTM slice (models/xlstm.py)",
    "vlm": "the vlm/audio prefix-embedding slice",
    "audio": "the vlm/audio prefix-embedding slice",
}


def _check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes with "
            f"{_FAMILY_SLICES.get(cfg.family, 'a later slice')}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_tf_layer(gen, cfg, device) -> dict:
    pd = layers.dtype_of(cfg.param_dtype)
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=pd, device=device),
        "attn": layers.init_attention(gen, cfg, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=pd, device=device),
        "mlp": layers.init_mlp(gen, cfg, device=device),
    }


def init_lm(cfg, gen: torch.Generator, device=None) -> dict:
    """Random params from ``gen`` (a generator on ``device``; ``None`` is
    the CUDA card). The reference's threefry draws cannot be reproduced:
    tests carry the reference's params across with
    ``convert.lm_params_from_numpy``."""
    _check_family(cfg)
    device = resolve_device(device)
    pd = layers.dtype_of(cfg.param_dtype)
    params = {
        "embed": layers.dense_init(gen, (cfg.vocab, cfg.d_model), pd, scale=0.02, device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=pd, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, (cfg.d_model, cfg.vocab), pd, device=device)
    params["blocks"] = [_init_tf_layer(gen, cfg, device) for _ in range(cfg.n_layers)]
    return params


def cast_params(params: dict, cfg) -> dict:
    """A copy of ``params`` whose matrices are in the compute dtype
    (``cfg.dtype``): the values the reference's per-use ``astype(dt)``
    gives, bit for bit. Norm weights (1-d) stay as they are, since
    ``rms_norm`` reads them in float32."""
    dt = layers.dtype_of(cfg.dtype)

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree.to(dt) if tree.dim() >= 2 else tree

    return cast(params)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Decode cache: per layer {"k", "v": [batch, max_len, Kv, hd]} in the
    compute dtype, and the host-side ``index`` 0."""
    _check_family(cfg)
    device = resolve_device(device)
    kv_dt = layers.dtype_of(cfg.dtype)
    return {
        "kv": [layers.init_attention_cache(cfg, batch, max_len, kv_dt, device=device)
               for _ in range(cfg.n_layers)],
        "index": 0,
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _tf_block_apply(block, x, cfg, positions, kv=None, index=None):
    a, new_kv = layers.attention(block["attn"], layers.rms_norm(x, block["ln1"], cfg.norm_eps),
                                 cfg, positions, cache=kv, cache_index=index)
    x = x + a
    h = layers.rms_norm(x, block["ln2"], cfg.norm_eps)
    return x + layers.mlp(block["mlp"], h, cfg), new_kv


def _transformer_stack(params, x, cfg, positions, cache):
    index = cache["index"] if cache is not None else None
    new_kv = []
    for i, block in enumerate(params["blocks"]):
        x, kv = _tf_block_apply(block, x, cfg, positions,
                                cache["kv"][i] if cache is not None else None, index)
        new_kv.append(kv)
    new_cache = None if cache is None else {"kv": new_kv, "index": index + x.shape[1]}
    return x, new_cache


def _hidden(params, tokens, cfg, cache, prefix_embeds):
    _check_family(cfg)
    if prefix_embeds is not None:
        raise NotImplementedError(f"prefix embeddings come with {_FAMILY_SLICES['vlm']}")
    dt = layers.dtype_of(cfg.dtype)
    x = params["embed"].to(dt)[tokens]
    b, s, _ = x.shape
    start = cache["index"] if cache is not None else 0
    positions = (start + torch.arange(s, dtype=torch.int32, device=x.device))[None, :].expand(b, s)
    return _transformer_stack(params, x, cfg, positions, cache)


def _head(params, x, cfg):
    dt = layers.dtype_of(cfg.dtype)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"]).to(dt)
    logits = (x @ head).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def forward(params, tokens, cfg, *, prefix_embeds=None, cache: Optional[dict] = None):
    """tokens: [B, S] -> (logits [B, S, vocab] float32, aux, new_cache).
    aux is the MoE load-balancing loss, 0 for the dense family."""
    x, new_cache = _hidden(params, tokens, cfg, cache, prefix_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg), aux, new_cache


def prefill(params, tokens, cfg, prefix_embeds=None):
    """Serving prefill: last-position logits [B, vocab]."""
    x, _ = _hidden(params, tokens, cfg, None, prefix_embeds)
    return _head(params, x[:, -1:], cfg)[:, -1]


def decode_step(params, tokens, cache: dict, cfg):
    """One decode step: tokens [B, S] + cache -> (logits [B, vocab], cache).
    With S > 1 at cache index 0 it prefills into the cache."""
    x, new_cache = _hidden(params, tokens, cfg, cache, None)
    return _head(params, x[:, -1:], cfg)[:, -1], new_cache
