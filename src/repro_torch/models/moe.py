"""Mixture-of-Experts FFN with capacity-based token dispatch
(``repro.models.moe``).

Tokens are routed in groups of ``cfg.moe_block``: the router's top-k
experts per token, each expert taking at most ``_capacity(cfg)`` tokens of
a group, in the reference's order (token-major, then choice), the rest
dropped. Switch Transformer's aux load-balance loss, E * sum_e f_e * p_e.

Differences in form, not in numbers:

* the reference dispatches and combines with one-hot einsums over a
  [G, Bt, E, C] tensor; the port writes each kept (token, choice) into
  its expert's capacity slot and gathers it back (``index_put`` and a
  gather), which moves the same values without the one-hot tensors (at
  qwen3-moe's 128 experts the reference's [G, Bt, k, E, C] capacity
  one-hot alone would be 2.7 GB at B = 8 x 2,048 tokens);
* the experts' products are one batched matmul over E ([E, G*C, D] @
  [E, D, F]), the combine one over the k choices ([G*Bt, 1, k] @
  [G*Bt, k, D]), both in the compute dtype as the reference's einsums;
* top-k is ``torch.sort(stable=True)``: ``jax.lax.top_k`` puts the lower
  index first among equal probabilities, ``torch.topk`` does not, and the
  reference rounds the router logits to the compute dtype, so in bf16
  ties are common. The order fixes the capacity positions and the top-1
  one-hot of the aux loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def init_moe(gen: torch.Generator, cfg, *, device) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    pd = layers.dtype_of(cfg.param_dtype)
    p = {
        "router": layers.dense_init(gen, (d, e), pd, device=device),
        "w_in": layers.dense_init(gen, (e, d, f), pd, device=device),
        "w_out": layers.dense_init(gen, (e, f, d), pd, device=device),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = layers.dense_init(gen, (e, d, f), pd, device=device)
    return p


def _capacity(cfg) -> int:
    cap = int(cfg.moe_block * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, (cap + 7) // 8 * 8)


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, largest
    first and the lower index first among equals: ``jax.lax.top_k``'s
    order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs, cfg):
    """The routing of one forward: probs [G, Bt, E] float32 ->
    (gate [G, Bt, k] normalised, expert [G, Bt, k], slot [G, Bt, k],
    kept [G, Bt, k] bool). ``slot`` is the (token, choice)'s position in
    its expert's capacity buffer, counted token-major then by choice over
    the group, as the reference's cumsum counts it; ``kept`` is
    slot < capacity."""
    g, bt, e = probs.shape
    k = cfg.top_k
    gate, expert = top_k(probs, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(expert, e).reshape(g, bt * k, e)  # [G, Bt*k, E], token-major
    slot_all = torch.cumsum(onehot, dim=1) * onehot - 1  # -1 where unrouted
    slot = slot_all.gather(-1, expert.reshape(g, bt * k, 1)).reshape(g, bt, k)
    return gate, expert, slot, slot < _capacity(cfg)


def _expert_ffn(params, xe, cfg):
    """xe [E, N, D] -> [E, N, D]: each expert's FFN over its rows."""
    dt = xe.dtype
    hidden = torch.bmm(xe, params["w_in"].to(dt))
    if cfg.mlp == "swiglu":
        hidden = F.silu(torch.bmm(xe, params["w_gate"].to(dt))) * hidden
    elif cfg.mlp == "geglu":
        hidden = F.gelu(torch.bmm(xe, params["w_gate"].to(dt)), approximate="tanh") * hidden
    elif cfg.mlp == "relu2":
        hidden = torch.square(F.relu(hidden))
    else:
        hidden = F.gelu(hidden, approximate="tanh")
    return torch.bmm(hidden, params["w_out"].to(dt))


def moe_ffn(params: dict, x, cfg):
    """x: [B, S, D] -> (out [B, S, D], aux loss float32 scalar)."""
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    bt = min(cfg.moe_block, b * s)
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    pad = (-n) % bt
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros((pad, d))], dim=0)
    g = (n + pad) // bt
    xg = tokens.reshape(g, bt, d)

    logits = (xg @ params["router"].to(dt)).float()  # [G, Bt, E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert, slot, kept = route(probs, cfg)

    # aux load-balance loss (Switch): fraction routed (top-1) vs mean router prob
    f_e = F.one_hot(expert[..., 0], e).float().mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    aux = e * torch.sum(f_e * p_e)

    # dispatch: each kept (token, choice) into its expert's capacity slot
    cap = _capacity(cfg)
    gi = torch.arange(g, device=x.device)[:, None, None].expand(g, bt, k)
    ti = torch.arange(bt, device=x.device)[None, :, None].expand(g, bt, k)
    gk, ek, sk, tk = gi[kept], expert[kept], slot[kept], ti[kept]
    xe = xg.new_zeros((e, g, cap, d))
    xe[ek, gk, sk] = xg[gk, tk]
    ye = _expert_ffn(params, xe.reshape(e, g * cap, d), cfg).reshape(e, g, cap, d)

    # combine: the gate-weighted sum of a token's kept choices (a dropped
    # choice reads slot 0 with weight 0)
    weight = (gate * kept).to(dt)  # [G, Bt, k]
    picked = ye[expert, gi, torch.where(kept, slot, 0)]  # [G, Bt, k, D]
    out = torch.bmm(weight.reshape(g * bt, 1, k), picked.reshape(g * bt, k, d))
    return out.reshape(-1, d)[:n].reshape(b, s, d), aux
