"""Dispatch for causal GQA attention (``repro.kernels.attention.ops.mha``).

On CUDA tensors ``mha`` goes through ``kernel.FlashAttention``: the
hand-written forward kernel, and the hand-written gradient kernels when an
input needs a gradient; it launches them or raises, and nothing on the
card falls back to the plain version. On CPU tensors it runs the plain
PyTorch version (``ref``), through which autograd differentiates; that is
how the tests reach this path on a machine without a card. Unlike the JAX
wrapper it neither transposes nor pads: the kernel reads [B, S, H, hd]
in place and masks its own ragged S."""

from __future__ import annotations

import torch

from repro_torch.kernels import device_of
from repro_torch.kernels.attention import kernel as K
from repro_torch.kernels.attention import ref as R


def mha(q, k, v, softcap: float = 0.0):
    """q: [B, S, H, hd]; k/v: [B, Skv, Kv, hd] with Skv >= S (q row i at
    position Skv - S + i); causal GQA attention with scale 1/sqrt(hd),
    the scaled logits capped at ``softcap`` (0: off). Returns [B, S, H, hd]
    in q's dtype."""
    dev = device_of(q, k, v)
    if dev.type == "cuda":
        grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
        return K.FlashAttention.apply(q, k, v, softcap, grad)
    if dev.type == "cpu":
        return R.mha_ref(q, k, v, softcap)
    raise ValueError(f"mha has no version for device {dev}")
