"""Dispatch for flash decode (``repro.kernels.decode.ops.decode_attention``).

On CUDA tensors ``decode_attention`` launches the hand-written kernels
(``kernel``) or raises; nothing on the card falls back to the plain
version. On CPU tensors it runs the plain PyTorch version (``ref``). The
cache is read in place (no transposed or padded copy), and the scale
comes from hd as the JAX wrapper's does."""

from __future__ import annotations

from repro_torch.kernels import device_of
from repro_torch.kernels.decode import kernel as K
from repro_torch.kernels.decode import ref as R


def decode_attention(q, k_cache, v_cache, length: int, softcap: float = 0.0):
    """q: [B, H, hd] (one token per sequence); caches: [B, S, Kv, hd];
    ``length``: the shared valid prefix, a Python int; ``softcap`` caps the
    scaled logits (0: off). Returns [B, H, hd]."""
    dev = device_of(q, k_cache, v_cache)
    if dev.type == "cuda":
        return K.flash_decode(q, k_cache, v_cache, length, softcap)[0]
    if dev.type == "cpu":
        return R.decode_attention_ref(q, k_cache, v_cache, length, softcap)[0]
    raise ValueError(f"decode_attention has no version for device {dev}")
