"""Gradient compression (``repro.optim.compression``): bf16 casts (2x) and
per-block int8 quantization with per-block scales and error feedback (4x)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.tree import tree_map

BLOCK = 256


def to_bf16(tree):
    return tree_map(lambda x: x.to(torch.bfloat16), tree)


def from_bf16(tree, like):
    return tree_map(lambda x, lk: x.to(lk.dtype), tree, like)


def quantize_int8(x: torch.Tensor):
    """Per-block symmetric int8 quantization of ``x`` flattened and
    zero-padded to a multiple of BLOCK. Returns (q int8 [n_blocks, BLOCK],
    scales float32 [n_blocks, 1]); round half to even, as ``jnp.round``."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK).to(torch.float32)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def dequantize_int8(q, scale, shape, dtype):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def compress_tree_int8(tree):
    return tree_map(quantize_int8, tree)


def ef_compress(grads, residual):
    """Error-feedback int8 compression: returns (q_tree, new_residual), the
    q_tree's leaves (q, scale). Decompress and add the residual on receipt."""
    target = tree_map(lambda g, r: g + r, grads, residual)
    qs = tree_map(quantize_int8, target)
    new_res = tree_map(lambda t, qsc: t - dequantize_int8(qsc[0], qsc[1], t.shape, t.dtype), target, qs)
    return qs, new_res
