"""CUDA wrapper for the flash-decode kernels (``csrc/flash_decode.cu``),
built and loaded at first use by ``kernels._build``
(``build/repro_torch/libflash_decode-<hash>.so``).

The wrapper checks device, dtype, shape, strides and head width, allocates
the outputs and the partials' scratch with ``torch.empty``, launches on
PyTorch's current stream (the partial kernel, then the combine), raises
on a non-zero CUDA status, and adds one to ``launches``. bfloat16 heads
wider than 128 run the tensor-core instance (one block a kv head for all
its q heads, TMA through tensor maps whose position extent is
``length``, ``mma.sync``); every other case the CUDA-core layout, 128
wide up to hd 128 and 192 wide above. ``softcap`` caps the scaled logits.
The caches are read in place by strides, so the model's [B, S_max, Kv, hd]
cache needs no transposed copy. How the work is cut
(``tensor_core_instance``, ``block_heads``, ``head_blocks``,
``blocks_per_sm``, ``splits_for``, ``split_chunk``) is plain Python,
pinned by the CPU tests.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.attention.kernel import DTYPE_IDS, check_head_dim, check_rows, tma_layout

MAX_HD = 192
TILE = 64  # the CUDA-core layout's cache positions a shared-memory stage
MAX_GROUP = 8  # q heads one block of the CUDA-core layout serves
MAX_SPLITS = 1024  # the combine's weights fit in its shared memory
CUDA_CORE_BLOCKS_PER_SM = 2  # the CUDA-core layout's planned residency (bf16 at hd <= 128: shared memory)
TC_TILE = 32  # the tensor-core instance's positions a stage: its tensor maps' box rows
TC_ROWS = 16  # q heads a row tile of the tensor-core instance (the mma's 16 rows)
TC_MAX_ROW_TILES = 2  # row tiles one block takes: up to 32 q heads a kv head read the cache once
TC_BLOCKS_PER_SM = {1: 2, 2: 1}  # the tensor-core instance's residency by row tiles (the library checks it)
MIN_WAVES = 2  # full waves of partial blocks wanted on the card
PARTIALS_SHARE = 0.1  # the tensor-core instance's f32 partials: at most this share of the cache's bytes

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"

# bumped where the kernel is launched and nowhere else
launches: Dict[str, int] = {"flash_decode": 0}


def reset_launches() -> None:
    launches["flash_decode"] = 0


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.flash_decode_launch.argtypes = (
        [ptr] * 9 + [i32] * 10 + [ctypes.c_float] * 2 + [i64] * 6 + [ptr, ptr]
    )
    lib.flash_decode_launch.restype = i32
    lib.flash_decode_error_string.argtypes = [i32]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    for name in ("max_hd", "tile", "max_group", "max_splits", "tc_tile", "tc_rows", "tc_max_row_tiles"):
        getattr(lib, f"flash_decode_{name}").restype = i32
    lib.flash_decode_tc_blocks_per_sm.argtypes = [i32]
    lib.flash_decode_tc_blocks_per_sm.restype = i32
    limits = (lib.flash_decode_max_hd(), lib.flash_decode_tile(), lib.flash_decode_max_group(),
              lib.flash_decode_max_splits(), lib.flash_decode_tc_tile(), lib.flash_decode_tc_rows(),
              lib.flash_decode_tc_max_row_tiles())
    if limits != (MAX_HD, TILE, MAX_GROUP, MAX_SPLITS, TC_TILE, TC_ROWS, TC_MAX_ROW_TILES):
        raise RuntimeError(f"flash_decode library limits {limits} disagree with kernel.py")
    # the residency splits_for plans with is what the card gives the compiled kernels
    fit = {rt: lib.flash_decode_tc_blocks_per_sm(rt * TC_ROWS) for rt in TC_BLOCKS_PER_SM}
    if fit != TC_BLOCKS_PER_SM:
        raise RuntimeError(f"flash_decode's tensor-core blocks an SM {fit} disagree with kernel.py's "
                           f"{TC_BLOCKS_PER_SM}")


LIBRARY = CudaLibrary("flash_decode", SOURCE, _declare)


def tensor_core_instance(dtype: torch.dtype, hd: int) -> bool:
    """bfloat16 heads wider than 128 run the tensor-core instance; every
    other case the CUDA-core layout."""
    return dtype == torch.bfloat16 and hd > 128


def head_group(g: int) -> int:
    """q heads per block of the CUDA-core layout for g q heads per kv head:
    the largest divisor of g up to MAX_GROUP, so that every block's head
    slots are all live."""
    return max(n for n in range(1, min(g, MAX_GROUP) + 1) if g % n == 0)


def row_tiles(g: int) -> int:
    """16-row tiles one block of the tensor-core instance takes for g q
    heads per kv head (rows past g are zero)."""
    return min(math.ceil(g / TC_ROWS), TC_MAX_ROW_TILES)


def block_heads(g: int, tensor_cores: bool = False) -> int:
    """q heads one block serves: the tensor-core instance's row tiles, or
    the CUDA-core layout's head group."""
    return TC_ROWS * row_tiles(g) if tensor_cores else head_group(g)


def head_blocks(g: int, tensor_cores: bool = False) -> int:
    """Blocks across one kv head's g q heads, each of which reads the kv
    head's positions: 1 for the tensor-core instance up to g = 32."""
    return math.ceil(g / block_heads(g, tensor_cores))


def blocks_per_sm(g: int, tensor_cores: bool = False) -> int:
    """The partial kernel's blocks an SM (what splits_for plans waves of)."""
    return TC_BLOCKS_PER_SM[row_tiles(g)] if tensor_cores else CUDA_CORE_BLOCKS_PER_SM


def splits_for(b: int, kv: int, h: int, length: int, n_sm: int, tensor_cores: bool = False) -> int:
    """Length splits per (b, kv head, head block): the fewest that give
    MIN_WAVES full waves of the instance's blocks on every SM (more splits
    only add blocks' start-up and partials), but no more splits than the
    length has tiles, nor than MAX_SPLITS. The tensor-core instance also
    keeps its f32 partials (B H hd floats a split) within PARTIALS_SHARE of
    the bf16 cache's bytes (2 B length Kv hd values); the CUDA-core layout
    plans as it always has, so its results are unchanged."""
    g = h // kv
    tile = TC_TILE if tensor_cores else TILE
    want = math.ceil(MIN_WAVES * blocks_per_sm(g, tensor_cores) * n_sm / (b * kv * head_blocks(g, tensor_cores)))
    most = min(math.ceil(length / tile), MAX_SPLITS)
    if tensor_cores:
        most = min(most, math.floor(PARTIALS_SHARE * length / g))
    return max(1, min(want, most))


def split_chunk(length: int, splits: int, tile: int = TILE) -> int:
    """Positions per split, whole tiles of ``tile`` positions: split i
    covers [i * chunk, min((i + 1) * chunk, length)); the last splits may be
    empty."""
    return max(1, math.ceil(math.ceil(length / splits) / tile)) * tile


def _tma_layouts(k_cache, v_cache, length: int):
    """k's and v's tensor-map layouts for the tensor-core instance: the
    position extent is ``length`` (at least 1), so the map zero-fills every
    row past it."""
    flat = []
    for t in (k_cache, v_cache):
        dims, strides, box = tma_layout(t[:, :max(length, 1)], TC_TILE)
        flat += [*dims, *strides, *box]
    return (ctypes.c_longlong * len(flat))(*flat)


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
    tc = tensor_core_instance(q.dtype, hd)
    splits = splits_for(b, kv, h, length, torch.cuda.get_device_properties(dev).multi_processor_count, tc)
    chunk = split_chunk(length, splits, TC_TILE if tc else TILE)
    tma = _tma_layouts(k_cache, v_cache, length) if tc else None
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
            DTYPE_IDS[q.dtype], b, s, h, kv, hd, length, splits, chunk, block_heads(h // kv, tc),
            1.0 / hd ** 0.5, softcap,
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2), tma, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {rc} "
                           f"({lib.flash_decode_error_string(rc).decode()})")
    launches["flash_decode"] += 1
    return out, m, l
