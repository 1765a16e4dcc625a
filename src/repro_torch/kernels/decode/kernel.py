"""CUDA wrapper for the flash-decode kernels (``csrc/flash_decode.cu``),
built and loaded at first use by ``kernels._build``
(``build/repro_torch/libflash_decode-<hash>.so``).

The wrapper checks device, dtype, shape, strides and head width, allocates
the outputs and the partials' scratch with ``torch.empty``, launches on
PyTorch's current stream (the partial kernel, then the combine), raises
on a non-zero CUDA status, and adds one to ``launches``. Heads up to 128
wide run the 128-wide instance (the serving path's), up to 192 the
192-wide one; ``softcap`` caps the scaled logits. The caches are
read in place by strides, so the model's [B, S_max, Kv, hd] cache needs
no transposed copy. How the work is cut (``head_group``, ``splits_for``,
``split_chunk``) is plain Python, pinned by the CPU tests.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.attention.kernel import DTYPE_IDS, check_head_dim, check_rows

MAX_HD = 192
TILE = 64  # cache positions per shared-memory stage; a split is whole tiles
MAX_GROUP = 8  # q heads one block serves
MAX_SPLITS = 1024  # the combine's weights fit in its shared memory
BLOCKS_PER_SM = 2  # the bf16 partial kernel's residency (shared memory)
MIN_WAVES = 2  # full waves of partial blocks wanted on the card

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"

# bumped where the kernel is launched and nowhere else
launches: Dict[str, int] = {"flash_decode": 0}


def reset_launches() -> None:
    launches["flash_decode"] = 0


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.flash_decode_launch.argtypes = (
        [ptr] * 9 + [i32] * 10 + [ctypes.c_float] * 2 + [i64] * 6 + [ptr]
    )
    lib.flash_decode_launch.restype = i32
    lib.flash_decode_error_string.argtypes = [i32]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    lib.flash_decode_max_hd.restype = i32
    lib.flash_decode_tile.restype = i32
    lib.flash_decode_max_group.restype = i32
    lib.flash_decode_max_splits.restype = i32
    limits = (lib.flash_decode_max_hd(), lib.flash_decode_tile(), lib.flash_decode_max_group(),
              lib.flash_decode_max_splits())
    if limits != (MAX_HD, TILE, MAX_GROUP, MAX_SPLITS):
        raise RuntimeError(f"flash_decode library limits {limits} disagree with kernel.py")


LIBRARY = CudaLibrary("flash_decode", SOURCE, _declare)


def head_group(g: int) -> int:
    """q heads per block for g q heads per kv head: the largest divisor of
    g up to MAX_GROUP, so that every block's head slots are all live."""
    return max(n for n in range(1, min(g, MAX_GROUP) + 1) if g % n == 0)


def splits_for(b: int, kv: int, h: int, length: int, n_sm: int) -> int:
    """Length splits per (b, kv head, head group): the fewest that give
    MIN_WAVES full waves of BLOCKS_PER_SM blocks on every SM (more splits
    only add blocks' start-up and partials), but no more splits than the
    length has tiles, nor than MAX_SPLITS."""
    g = h // kv
    groups = b * kv * (g // head_group(g))
    want = math.ceil(MIN_WAVES * BLOCKS_PER_SM * n_sm / groups)
    return max(1, min(want, math.ceil(length / TILE), MAX_SPLITS))


def split_chunk(length: int, splits: int) -> int:
    """Positions per split, whole tiles: split i covers
    [i * chunk, min((i + 1) * chunk, length)); the last splits may be empty."""
    return max(1, math.ceil(math.ceil(length / splits) / TILE)) * TILE


def flash_decode(q, k_cache, v_cache, length: int, softcap: float = 0.0):
    """One query token per sequence against a KV cache, on the card.
    q: [B, H, hd] contiguous; caches: [B, S, Kv, hd]; positions >= length
    are masked (0 <= length <= S). float32 or bfloat16, all one dtype.
    Returns (out [B, H, hd] in q's dtype, m [B, H] f32, l [B, H] f32), the
    softmax stats of the Pallas kernel; the scale is 1/sqrt(hd), and
    ``softcap`` > 0 caps the scaled logits (m and l are the capped ones').
    Raises on an input that requires grad: the kernel has no backward."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device {q.device}, got {t.device}")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad, but flash_decode has no backward (it serves, it does not train)")
        if t.dtype not in DTYPE_IDS or t.dtype != q.dtype:
            raise TypeError(f"{name} must be float32 or bfloat16 like q, got {t.dtype} (q {q.dtype})")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be [B, H, hd] and the caches [B, S, Kv, hd], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, h, hd = q.shape
    _, s, kv, _ = k_cache.shape
    if (tuple(k_cache.shape) != (b, s, kv, hd) or tuple(v_cache.shape) != tuple(k_cache.shape)
            or kv < 1 or h % kv):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    check_head_dim(hd)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        check_rows(name, t)
    length = int(length)
    if not 0 <= length <= s:
        raise ValueError(f"length {length} outside the cache's 0..{s}")
    softcap = float(softcap)
    if not softcap >= 0.0:
        raise ValueError(f"softcap must be >= 0 (0 is off), got {softcap}")
    lib = LIBRARY.load()
    dev = q.device
    splits = splits_for(b, kv, h, length, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty_like(q)
    m = torch.empty((b, h), dtype=torch.float32, device=dev)
    l = torch.empty((b, h), dtype=torch.float32, device=dev)
    part_o = torch.empty((b * h, splits, hd), dtype=torch.float32, device=dev)
    part_m = torch.empty((b * h, splits), dtype=torch.float32, device=dev)
    part_l = torch.empty((b * h, splits), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_decode_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), m.data_ptr(),
            l.data_ptr(), part_o.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            DTYPE_IDS[q.dtype], b, s, h, kv, hd, length, splits, split_chunk(length, splits),
            head_group(h // kv), 1.0 / hd ** 0.5, softcap,
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {rc} "
                           f"({lib.flash_decode_error_string(rc).decode()})")
    launches["flash_decode"] += 1
    return out, m, l
