"""Unified LM (``repro.models.lm``): init / forward / train-loss / prefill /
decode for every family of the reference.

Families:
  dense|moe|vlm|audio -> transformer blocks (``"moe"`` in place of
                         ``"mlp"`` when ``cfg.n_experts``)
  hybrid (zamba2)     -> Mamba2 segments + ONE weight-shared transformer
                         block (attention, and its MLP when ``d_ff``)
                         applied after every ``attn_every`` SSM blocks
  ssm (xlstm)         -> segments of (slstm_every - 1) mLSTM blocks + 1 sLSTM

VLM/audio frontends are stubs, as in the reference: ``prefix_embeds``
(precomputed patch/frame embeddings) are cast to the compute dtype and
prepended to the token embeddings; positions start at the cache index.

``cfg.remat`` (with no cache, under grad) wraps each block of the three
stacks (a transformer block; a hybrid or ssm segment, as the reference's
scan bodies) in ``torch.utils.checkpoint`` (non-reentrant): the block's
activations are recomputed in the backward instead of kept, as
``jax.checkpoint`` does. ``remat_policy="dots"`` keeps the outputs of
``aten.mm`` and ``aten.bmm`` (the matmuls) through a selective-checkpoint
policy, the reference's ``dots_with_no_batch_dims_saveable``.

Layer params are lists (the reference stacks them on leading axes for
``lax.scan``): ``blocks`` a list of per-layer dicts; the hybrid's
``mamba`` a list of ``n_seg`` lists of ``attn_every`` dicts; the ssm's
``mlstm`` a list of ``n_seg`` lists of ``slstm_every - 1`` dicts and its
``slstm`` a list of ``n_seg`` dicts. The stacks are Python loops. The
reference's three ``constrain`` calls (``dist/sharding.py``: the block's
residual output, the embedded input, the logits) stand at the same
places; they redistribute DTensor activations under an installed mesh and
are the identity otherwise.

Differences in form, not in numbers:

* ``prefill`` and ``decode_step`` apply the final norm and the head to the
  last position only, since both are per position and only
  ``logits[:, -1]`` is returned; the full [B, S, vocab] float32 logits of
  a 2,048-token prefill at B=8 would be 8.4 GB. ``forward`` keeps all
  positions.
* The decode cache's tensors live in lists like the params; its KV
  tensors are updated in place, its recurrent states replaced, and
  ``index`` lives on the host.
* ``decode_step`` takes ``prefix_embeds`` too (the reference's does not):
  a vlm/audio prompt is prefilled into the cache with its prefix, which is
  the reference's ``forward(..., prefix_embeds=, cache=)``.
* ``cast_params`` makes the compute-dtype copy of the matmul weights once;
  the layers' ``.to(dt)`` are then no-ops, where the reference casts
  float32 params at every use.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint as checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import constrain, embed_lookup
from repro_torch.models import layers, mamba2, moe, xlstm

TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "audio")
# params read in float32 at use (sLSTM's recurrent weights): cast_params
# leaves them as they are
_F32_AT_USE = frozenset({"r_h"})


def _segments(cfg):
    """(n_seg, blocks a segment) of the hybrid and ssm stacks."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every, cfg.attn_every
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_tf_layer(gen, cfg, device) -> dict:
    pd = layers.dtype_of(cfg.param_dtype)
    p = {
        "ln1": torch.ones((cfg.d_model,), dtype=pd, device=device),
        "attn": layers.init_attention(gen, cfg, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=pd, device=device),
    }
    if cfg.n_experts:
        p["moe"] = moe.init_moe(gen, cfg, device=device)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg, device=device)
    return p


def init_lm(cfg, gen: torch.Generator, device=None) -> dict:
    """Random params from ``gen`` (a generator on ``device``; ``None`` is
    the CUDA card). The reference's threefry draws cannot be reproduced:
    tests carry the reference's params across with
    ``convert.lm_params_from_numpy``."""
    device = resolve_device(device)
    pd = layers.dtype_of(cfg.param_dtype)
    params = {
        "embed": layers.dense_init(gen, (cfg.vocab, cfg.d_model), pd, scale=0.02, device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=pd, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, (cfg.d_model, cfg.vocab), pd, device=device)
    if cfg.family in TRANSFORMER_FAMILIES:
        params["blocks"] = [_init_tf_layer(gen, cfg, device) for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_seg, per = _segments(cfg)
        params["mamba"] = [[mamba2.init_mamba(gen, cfg, device=device) for _ in range(per)]
                           for _ in range(n_seg)]
        params["shared_ln"] = torch.ones((cfg.d_model,), dtype=pd, device=device)
        params["shared_attn"] = layers.init_attention(gen, cfg, device=device)
        if cfg.d_ff:  # zamba2's shared block is a full transformer block (attention + MLP)
            params["shared_ln2"] = torch.ones((cfg.d_model,), dtype=pd, device=device)
            params["shared_mlp"] = layers.init_mlp(gen, cfg, device=device)
    elif cfg.family == "ssm":
        n_seg, per = _segments(cfg)
        params["mlstm"] = [[xlstm.init_mlstm(gen, cfg, device=device) for _ in range(per)]
                           for _ in range(n_seg)]
        params["slstm"] = [xlstm.init_slstm(gen, cfg, device=device) for _ in range(n_seg)]
    else:
        raise ValueError(cfg.family)
    return params


def cast_params(params: dict, cfg) -> dict:
    """A copy of ``params`` whose matrices are in the compute dtype
    (``cfg.dtype``): the values the reference's per-use ``astype(dt)``
    gives, bit for bit. 1-d params (norms, biases, the SSM's a_log,
    dt_bias, d_skip, conv_b) stay as they are, and so do the sLSTM's
    recurrent weights (``r_h``): the layers cast each at use where the
    reference does (``rms_norm`` and the sLSTM cell read theirs in
    float32)."""
    dt = layers.dtype_of(cfg.dtype)

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, key) for v in tree]
        return tree.to(dt) if tree.dim() >= 2 and key not in _F32_AT_USE else tree

    return cast(params)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Decode cache for any family: KV tensors [batch, max_len, Kv, hd] in
    the compute dtype, recurrent states in float32, the host-side
    ``index`` 0. transformer: {"kv": [per layer {"k", "v"}]}; hybrid:
    {"mamba": [[{"conv", "ssm"}]], "kv": [one per shared-block
    application]}; ssm: {"mlstm": [[{"c", "n", "m"}]], "slstm": [{"c",
    "n", "h", "m"}]}."""
    device = resolve_device(device)
    kv_dt = layers.dtype_of(cfg.dtype)

    def kv():
        return layers.init_attention_cache(cfg, batch, max_len, kv_dt, device=device)

    if cfg.family in TRANSFORMER_FAMILIES:
        return {"kv": [kv() for _ in range(cfg.n_layers)], "index": 0}
    n_seg, per = _segments(cfg)
    if cfg.family == "hybrid":
        return {
            "mamba": [[mamba2.init_mamba_cache(cfg, batch, device=device) for _ in range(per)]
                      for _ in range(n_seg)],
            "kv": [kv() for _ in range(n_seg)],
            "index": 0,
        }
    if cfg.family == "ssm":
        return {
            "mlstm": [[xlstm.init_mlstm_cache(cfg, batch, device=device) for _ in range(per)]
                      for _ in range(n_seg)],
            "slstm": [xlstm.init_slstm_cache(cfg, batch, device=device) for _ in range(n_seg)],
            "index": 0,
        }
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _tf_block_apply(block, x, cfg, positions, kv=None, index=None):
    a, new_kv = layers.attention(block["attn"], layers.rms_norm(x, block["ln1"], cfg.norm_eps),
                                 cfg, positions, cache=kv, cache_index=index)
    x = x + a
    h = layers.rms_norm(x, block["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        out, aux = moe.moe_ffn(block["moe"], h, cfg)
    else:
        out, aux = layers.mlp(block["mlp"], h, cfg), None
    return constrain(x + out, "resid"), new_kv, aux


def _dots_policy():
    """Selective-checkpoint contexts that keep matmul outputs (``aten.mm``,
    ``aten.bmm``) and recompute the rest."""
    try:
        from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts
    except ImportError as e:  # older torch: no selective checkpointing
        raise RuntimeError(f"remat_policy='dots' needs torch.utils.checkpoint.create_selective_checkpoint_contexts, "
                           f"which torch {torch.__version__} lacks") from e
    saved = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _remat(fn, cfg, cache):
    """``fn`` checkpointed for training when ``cfg.remat`` is set, there is
    no cache and grad mode is on (the reference's ``cfg.remat and cache is
    None``); ``fn`` itself otherwise."""
    if not (cfg.remat and cache is None and torch.is_grad_enabled()):
        return fn
    if cfg.remat_policy == "full":
        return lambda *args: checkpoint.checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat_policy == "dots":
        _dots_policy()  # raises here, not inside the backward, when torch lacks it
        return lambda *args: checkpoint.checkpoint(fn, *args, use_reentrant=False, context_fn=_dots_policy)
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} (full | dots)")


def _transformer_stack(params, x, cfg, positions, cache):
    index = cache["index"] if cache is not None else None
    new_kv, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    body = _remat(lambda block, h, kv: _tf_block_apply(block, h, cfg, positions, kv, index), cfg, cache)
    for i, block in enumerate(params["blocks"]):
        x, kv, a = body(block, x, cache["kv"][i] if cache is not None else None)
        new_kv.append(kv)
        if a is not None:
            aux = aux + a
    new_cache = None if cache is None else {"kv": new_kv, "index": index + x.shape[1]}
    return x, aux, new_cache


def _hybrid_stack(params, x, cfg, positions, cache):
    index = cache["index"] if cache is not None else None

    def seg_body(mp_seg, h, mc_seg, kv):
        new_seg = []
        for j, mp in enumerate(mp_seg):
            out, mc = mamba2.mamba_block(mp, h, cfg, cache=mc_seg[j] if mc_seg is not None else None)
            h = h + out
            new_seg.append(mc)
        a, kv = layers.attention(params["shared_attn"], layers.rms_norm(h, params["shared_ln"], cfg.norm_eps),
                                 cfg, positions, cache=kv, cache_index=index)
        h = h + a
        if cfg.d_ff:
            h = h + layers.mlp(params["shared_mlp"], layers.rms_norm(h, params["shared_ln2"], cfg.norm_eps), cfg)
        return h, new_seg, kv

    seg_body = _remat(seg_body, cfg, cache)
    new_mamba, new_kv = [], []
    for seg, mp_seg in enumerate(params["mamba"]):
        x, new_seg, kv = seg_body(mp_seg, x, cache["mamba"][seg] if cache is not None else None,
                                  cache["kv"][seg] if cache is not None else None)
        new_mamba.append(new_seg)
        new_kv.append(kv)
    new_cache = None if cache is None else {"mamba": new_mamba, "kv": new_kv, "index": index + x.shape[1]}
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new_cache


def _xlstm_stack(params, x, cfg, positions, cache):
    del positions  # recurrent families are position-free

    def seg_body(mp_seg, sp, h, mc_seg, sc):
        new_seg = []
        for j, mp in enumerate(mp_seg):
            out, mc = xlstm.mlstm_block(mp, h, cfg, cache=mc_seg[j] if mc_seg is not None else None)
            h = h + out
            new_seg.append(mc)
        out, sc = xlstm.slstm_block(sp, h, cfg, cache=sc)
        return h + out, new_seg, sc

    seg_body = _remat(seg_body, cfg, cache)
    new_m, new_s = [], []
    for seg, (mp_seg, sp) in enumerate(zip(params["mlstm"], params["slstm"])):
        x, new_seg, sc = seg_body(mp_seg, sp, x, cache["mlstm"][seg] if cache is not None else None,
                                  cache["slstm"][seg] if cache is not None else None)
        new_m.append(new_seg)
        new_s.append(sc)
    new_cache = None
    if cache is not None:
        new_cache = {"mlstm": new_m, "slstm": new_s, "index": cache["index"] + x.shape[1]}
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new_cache


_STACKS = {"dense": _transformer_stack, "moe": _transformer_stack, "vlm": _transformer_stack,
           "audio": _transformer_stack, "hybrid": _hybrid_stack, "ssm": _xlstm_stack}


def _hidden(params, tokens, cfg, cache, prefix_embeds):
    """The blocks' output before the final norm: (x [B, P + S, D], aux,
    new cache or None)."""
    dt = layers.dtype_of(cfg.dtype)
    # cast the table before the gather, as the reference does
    x = embed_lookup(params["embed"].to(dt), tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dt), x], dim=1)
    x = constrain(x, "resid")
    b, s, _ = x.shape
    start = cache["index"] if cache is not None else 0
    positions = (start + torch.arange(s, dtype=torch.int32, device=x.device))[None, :].expand(b, s)
    return _STACKS[cfg.family](params, x, cfg, positions, cache)


def _head(params, x, cfg):
    dt = layers.dtype_of(cfg.dtype)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"]).to(dt)
    logits = (x @ head).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return constrain(logits, "logits")


def hidden_states(params, tokens, cfg, *, prefix_embeds=None, cache: Optional[dict] = None):
    """(the blocks' output [B, P + S, D] before the final norm, new cache
    or None): what ``forward`` feeds its head."""
    x, _, new_cache = _hidden(params, tokens, cfg, cache, prefix_embeds)
    return x, new_cache


def forward(params, tokens, cfg, *, prefix_embeds=None, cache: Optional[dict] = None):
    """tokens: [B, S_tok] -> (logits [B, P + S_tok, vocab] float32, aux,
    new_cache). aux is the MoE load-balancing loss summed over layers, 0
    for the other families. With ``prefix_embeds`` [B, P, D] (vlm/audio)
    the prefix is prepended."""
    x, aux, new_cache = _hidden(params, tokens, cfg, cache, prefix_embeds)
    return _head(params, x, cfg), aux, new_cache


def train_loss(params, batch: dict, cfg, aux_weight: float = 0.01):
    """Next-token cross-entropy over the token region (prefix positions are
    context only) plus ``aux_weight`` times the MoE's aux loss. batch:
    {"tokens": [B, S_tok]} (+ optional "prefix_embeds" [B, P, D]).
    Returns (loss, {"ce", "aux"}), float32 scalars."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    logits, aux, _ = forward(params, tokens, cfg, prefix_embeds=prefix)
    p = 0 if prefix is None else prefix.shape[1]
    # predict tokens[t + 1] from position p + t
    pred = logits[:, p:p + tokens.shape[1] - 1]
    tgt = tokens[:, 1:].long()
    logz = torch.logsumexp(pred, dim=-1)
    # the trailing dim is dropped after the subtraction: on vocab-sharded
    # DTensor logits the gather is a masked partial sum, which must be
    # reduced at the gather's own shape (the same values either way)
    gold = torch.gather(pred, -1, tgt[..., None])
    ce = (logz[..., None] - gold)[..., 0].mean()
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def prefill(params, tokens, cfg, prefix_embeds=None):
    """Serving prefill: last-position logits [B, vocab]."""
    x, _, _ = _hidden(params, tokens, cfg, None, prefix_embeds)
    return _head(params, x[:, -1:], cfg)[:, -1]


def decode_step(params, tokens, cache: dict, cfg, prefix_embeds=None):
    """One decode step: tokens [B, S] + cache -> (logits [B, vocab], cache).
    With S > 1 it prefills the chunk into the cache at its index (an
    mLSTM raises, as the reference's does), with ``prefix_embeds``
    prepended when given."""
    x, _, new_cache = _hidden(params, tokens, cfg, cache, prefix_embeds)
    return _head(params, x[:, -1:], cfg)[:, -1], new_cache
