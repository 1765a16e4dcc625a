"""Stand-ins for every model input (``repro.launch.inputs``): meta tensors
of the reference's shapes and dtypes, no allocation (the dry run's
inputs)."""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm


def input_specs(cfg, shape) -> dict:
    """Abstract batch for an (arch, shape) cell, as meta tensors.

    train/prefill: {"tokens": [B, S_tok] int32} (+ "prefix_embeds" [B,
    n_prefix, d_model] bf16 for vlm/audio, with S_tok + n_prefix ==
    seq_len). decode: {"tokens": [B, 1] int32, "cache": the family's cache
    at seq_len (``lm.init_cache`` on the meta device; its ``index`` is the
    host-side int 0)}."""
    b = shape.global_batch
    if shape.kind in ("train", "prefill"):
        s_tok = shape.seq_len - (cfg.n_prefix or 0)
        specs = {"tokens": torch.empty((b, s_tok), dtype=torch.int32, device="meta")}
        if cfg.n_prefix:
            specs["prefix_embeds"] = torch.empty((b, cfg.n_prefix, cfg.d_model), dtype=torch.bfloat16,
                                                 device="meta")
        return specs
    if shape.kind == "decode":
        return {"tokens": torch.empty((b, 1), dtype=torch.int32, device="meta"),
                "cache": lm.init_cache(cfg, b, shape.seq_len, device="meta")}
    raise ValueError(shape.kind)


def concrete_batch(cfg, shape, gen: torch.Generator, device=None) -> dict:
    """Small-config concrete batch (smoke tests, examples) on ``device``
    (the card unless ``"cpu"``; ``gen`` lies there): integer tensors drawn
    uniformly from [0, vocab), floating ones zero, the cache a fresh
    ``lm.init_cache`` (index 0, where the reference's tree map draws its
    scalar index like a token)."""
    device = resolve_device(device)
    specs = input_specs(cfg, shape)

    def mk(s):
        if s.dtype.is_floating_point:
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        return torch.randint(0, cfg.vocab, tuple(s.shape), generator=gen, dtype=s.dtype, device=device)

    out = {k: mk(v) for k, v in specs.items() if k != "cache"}
    if "cache" in specs:
        out["cache"] = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device=device)
    return out
