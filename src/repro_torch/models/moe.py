"""Mixture-of-Experts FFN with capacity-based token dispatch
(``repro.models.moe``).

Tokens are routed in groups of ``cfg.moe_block``: the router's top-k
experts per token, each expert taking at most ``_capacity(cfg)`` tokens of
a group, in the reference's order (token-major, then choice), the rest
dropped. Switch Transformer's aux load-balance loss, E * sum_e f_e * p_e.

Dispatch and combine are the reference's: one-hot [G, Bt, E, C] tensors
and einsums, so every shape is fixed by the config and the input's shape,
never by the routing. No op sizes its output from the data (no boolean
mask, no ``nonzero``), so the forward needs no device-to-host sync, a
fake tensor can size it, and DTensor shards it as it does any einsum (the
groups over the data axes, the experts' ``d_ff`` over "model").

Differences in form, not in numbers:

* the two one-hot tensors are built as an einsum over the k choices of
  the expert one-hot [G, Bt, k, E] and the capacity-slot one-hot
  [G, Bt, k, C], where the reference sums a [G, Bt, k, E, C] product over
  k (at qwen3-moe's 128 experts that product alone would be 2.7 GB at
  B = 8 x 2,048 tokens); each (expert, slot) pair has at most one choice,
  so the sums are exact;
* top-k is ``torch.sort(stable=True)``: ``jax.lax.top_k`` puts the lower
  index first among equal probabilities, ``torch.topk`` does not, and the
  reference rounds the router logits to the compute dtype, so in bf16
  ties are common. The order fixes the capacity positions and the top-1
  one-hot of the aux loss.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import is_dtensor, mesh_shape, seq_gathered_grad
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


def _one_hot(index, n: int):
    """``index[..., None] == arange(n)``: a comparison, where ``F.one_hot``
    checks its indices' range on the host."""
    return index[..., None] == torch.arange(n, device=index.device)


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
    onehot = _one_hot(expert, e).to(torch.int32).reshape(g, bt * k, e)  # token-major
    slot = (torch.cumsum(onehot, dim=1) * onehot).sum(-1).reshape(g, bt, k) - 1
    return gate, expert, slot, slot < _capacity(cfg)


def dispatch_tensors(gate, expert, slot, kept, cfg, dtype):
    """(dispatch, combine) [G, Bt, E, C] in ``dtype``, the reference's:
    dispatch 1 where a kept choice of token t sends it to slot c of
    expert e, combine that choice's gate there."""
    slots = _one_hot(torch.where(kept, slot, -1), _capacity(cfg))  # [G, Bt, k, C]
    experts = _one_hot(expert, cfg.n_experts).to(dtype)            # [G, Bt, k, E]
    dispatch = torch.einsum("gtke,gtkc->gtec", experts, slots.to(dtype))
    combine = torch.einsum("gtke,gtkc->gtec", experts, (slots * (gate * kept)[..., None]).to(dtype))
    return dispatch, combine


def _expert_ffn(w_in, w_gate, w_out, xe, cfg):
    """xe [G, E, C, D] -> [G, E, C, D]: each expert's FFN over its slots."""
    dt = xe.dtype
    hidden = torch.einsum("gecd,edf->gecf", xe, w_in.to(dt))
    if cfg.mlp in ("swiglu", "geglu"):
        gatev = torch.einsum("gecd,edf->gecf", xe, w_gate.to(dt))
        act = F.silu(gatev) if cfg.mlp == "swiglu" else F.gelu(gatev, approximate="tanh")
        hidden = act * hidden
    elif cfg.mlp == "relu2":
        hidden = torch.square(F.relu(hidden))
    else:
        hidden = F.gelu(hidden, approximate="tanh")
    return torch.einsum("gecf,efd->gecd", hidden, w_out.to(dt))


def moe_ffn(params: dict, x, cfg):
    """x: [B, S, D] -> (out [B, S, D], aux loss float32 scalar). On DTensor
    params the layer runs on each rank's local tensors (:func:`_sharded`)."""
    bt = min(cfg.moe_block, x.shape[0] * x.shape[1])
    if is_dtensor(params["router"]):
        out, f_e, p_e = _sharded(params, x, cfg, bt)
    else:
        out, f_e, p_e = _moe(params["router"], params["w_in"], params.get("w_gate"), params["w_out"], x, cfg, bt)
    # aux load-balance loss (Switch): fraction routed (top-1) vs mean router prob
    return out, cfg.n_experts * torch.sum(f_e * p_e)


def _sharded(params, x, cfg, bt):
    """The layer over DTensors: each rank runs :func:`_moe` on its own
    tensors (``local_map``), as GSPMD partitions the reference's einsums.
    The groups follow the batch's split over the data axes when every
    shard holds whole groups of ``bt`` tokens (else every rank routes all
    the tokens, and the routing stays the reference's); the experts'
    ``d_ff`` splits over "model" when it divides (each rank's output is
    then a partial sum), the routing is repeated on every "model" rank.
    A sequence split is gathered first. f_e and p_e are means over the
    groups: each rank returns its share, divided by the number of ranks
    that sum it, so their partial sums are the means and their gradients
    reach the router once."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = params["router"].device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    b, s, _ = x.shape
    batch = [j for j, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == 0]
    n_batch = math.prod(mesh.shape[j] for j in batch)
    if b % n_batch or (b // n_batch) * s % bt:
        batch, n_batch = [], 1
    names = list(mesh_shape(mesh))
    model = names.index("model") if "model" in names else None
    m = mesh.shape[model] if model is not None else 1
    if m == 1 or cfg.d_ff % m:
        model, m = None, 1
    gated = "w_gate" in params

    def per_dim(on_batch, on_model, otherwise=Replicate()):
        return [on_batch if j in batch else on_model if j == model else otherwise for j in range(mesh.ndim)]

    x_in = per_dim(Shard(0), Replicate())
    w_in = per_dim(Replicate(), Shard(2))
    w_out = per_dim(Replicate(), Shard(1))
    mean = per_dim(Partial(), Partial())

    def local(router, w_in_, w_gate, w_out_, x_):
        out, f_e, p_e = _moe(router, w_in_, w_gate, w_out_, x_, cfg, bt)
        share = n_batch * m
        return out, f_e / share, p_e / share

    in_placements = (per_dim(Replicate(), Replicate()), w_in, w_in if gated else None, w_out, x_in)
    in_grad = (per_dim(Partial(), Partial()), per_dim(Partial(), Shard(2)),
               per_dim(Partial(), Shard(2)) if gated else None, per_dim(Partial(), Shard(1)),
               per_dim(Shard(0), Partial()))
    mapped = local_map(local, out_placements=(per_dim(Shard(0), Partial()), mean, mean),
                       in_placements=in_placements, in_grad_placements=in_grad, device_mesh=mesh,
                       redistribute_inputs=True)
    out, f_e, p_e = mapped(params["router"], params["w_in"], params.get("w_gate"), params["w_out"], x)
    return seq_gathered_grad(out), f_e, p_e


def _moe(router, w_in, w_gate, w_out, x, cfg, bt):
    """The layer on plain tensors, over groups of ``bt`` tokens: (out
    [B, S, D], f_e [E] the top-1 fraction routed, p_e [E] the mean router
    probability)."""
    dt = x.dtype
    b, s, d = x.shape
    e = cfg.n_experts
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    pad = (-n) % bt
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros((pad, d))], dim=0)
    g = (n + pad) // bt
    xg = tokens.reshape(g, bt, d)

    logits = (xg @ router.to(dt)).float()  # [G, Bt, E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert, slot, kept = route(probs, cfg)
    f_e = _one_hot(expert[..., 0], e).float().mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))

    dispatch, combine = dispatch_tensors(gate, expert, slot, kept, cfg, dt)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xg)  # [G, E, C, D]
    ye = _expert_ffn(w_in, w_gate, w_out, xe, cfg)
    out = torch.einsum("gtec,gecd->gtd", combine, ye)  # [G, Bt, D]
    return out.reshape(-1, d)[:n].reshape(b, s, d), f_e, p_e
