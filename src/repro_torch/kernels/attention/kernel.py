"""CUDA wrappers for the causal GQA flash-attention kernels
(``csrc/flash_attention.cu``) and their gradient
(``csrc/flash_attention_bwd.cu``), each built and loaded at first use by
``kernels._build`` (``build/repro_torch/lib<name>-<hash>.so``).

The dtype picks the kernel: bfloat16 runs the tensor-core kernel (wgmma,
TMA) at the width ``instantiated_hd`` picks (64, 128 or 192), float32 the
CUDA-core kernel that the reference's f32 tolerance needs. k and v may be
longer than q (a prefill chunk at a KV-cache offset), and ``softcap``
caps the scaled logits (grok-1's attention soft cap); both kernels take
both. The wrapper checks device, dtype, shape, strides and head width,
computes the bf16 kernel's tensor-map layouts (``tma_layout``) and width
(``instantiated_hd``), allocates the output with ``torch.empty``, launches
on PyTorch's current stream, raises on a non-zero CUDA status, and adds
one to ``launches``. q, k and v are read in place by strides: any layout
whose last dimension is contiguous and whose other strides keep every row
on a 16-byte boundary. With ``with_lse`` the forward also writes each q
row's log-sum-exp (float32 [B, H, S]), which the backward reads.

``FlashAttention`` is the autograd Function around both: its forward
launches the forward kernel (with ``lse`` only when an input needs a
gradient) and its backward the three gradient kernels
(``flash_attention_backward``: D = rowsum(dO o O), then dk/dv, then dq;
``launches["flash_attention_bwd"]`` counts each). In bfloat16, at each of
the widths 64, 128 and 192, the gradient kernels run on wgmma fed by TMA
(tensor maps from ``tma_layout`` with ``BWD_BOX_ROWS`` rows, D and lse
padded to ``bwd_rows``). At widths 64 and 128 the dk/dv launch splits
each key block's q-head group over a cluster of ``dkdv_splits`` CTAs where
the plain grid would leave the card unbalanced (``dkdv_launches_by_splits``
counts its launches by that cluster size). Nothing on the card falls back
to the plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels._build import CudaLibrary

MAX_HD = 192
BLOCK_Q = 128  # the bf16 kernel's q tile; it is also the q tensor map's box rows
BOX_COLS = 64  # 128 bytes of bf16: the 128-byte swizzle's span
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
BWD_LAUNCHES = 3  # kernels a backward call launches: D, dk/dv, dq
BWD_BOX_ROWS = 64  # the bf16 gradient's tensor-map box rows: every q, k, v and dO tile
BWD_WGMMA_WIDTHS = (64, 128, 192)  # the bf16 gradient's wgmma instances: every bf16 width
BWD_KEY_BLOCK = 128  # keys of a dk/dv block at widths 64 and 128
DKDV_SPLIT_WIDTHS = (64, 128)  # the instances whose dk/dv launch takes a cluster split
DKDV_MAX_SPLITS = 8  # CTAs of a dk/dv cluster at most: the portable cluster size
DKDV_BALANCE = 1.1  # the longest CTA's steps against the balanced share that dkdv_splits accepts

# bumped where the kernels are launched and nowhere else
launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
# the gradient's dk/dv launches by the CTAs of their cluster (1: no split)
dkdv_launches_by_splits: Dict[int, int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    dkdv_launches_by_splits.clear()


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ptr] * 4 + [i32] * 7 + [ctypes.c_float] * 2 + [i64] * 9 + [i32, ptr, ptr, ptr]
    )
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_max_hd.restype = i32
    lib.flash_attention_block_q.restype = i32
    lib.flash_attention_block_k.argtypes = [i32]
    lib.flash_attention_block_k.restype = i32
    lib.flash_attention_smem_bytes.argtypes = [i32]
    lib.flash_attention_smem_bytes.restype = i32
    limits = (lib.flash_attention_max_hd(), lib.flash_attention_block_q(),
              *(lib.flash_attention_block_k(w) for w in WIDTHS), lib.flash_attention_smem_bytes(MAX_HD))
    if limits != (MAX_HD, BLOCK_Q, *(block_k(w) for w in WIDTHS), wide_smem_bytes()):
        raise RuntimeError(f"flash_attention library limits {limits} disagree with kernel.py")


LIBRARY = CudaLibrary("flash_attention", SOURCE, _declare)


def _declare_bwd(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_launch.argtypes = [ptr] * 11 + [i32] * 7 + [f32] * 2 + [i32, i32, ptr, ptr]
    lib.flash_attention_bwd_launch.restype = i32
    lib.flash_attention_bwd_error_string.argtypes = [i32]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    lib.flash_attention_bwd_max_hd.restype = i32
    lib.flash_attention_bwd_box_rows.restype = i32
    lib.flash_attention_bwd_max_splits.restype = i32
    limits = (lib.flash_attention_bwd_max_hd(), lib.flash_attention_bwd_box_rows(),
              lib.flash_attention_bwd_max_splits())
    if limits != (MAX_HD, BWD_BOX_ROWS, DKDV_MAX_SPLITS):
        raise RuntimeError(f"flash_attention_bwd library limits {limits} disagree with kernel.py")


BWD_LIBRARY = CudaLibrary("flash_attention_bwd", BWD_SOURCE, _declare_bwd)


def check_head_dim(hd: int) -> None:
    if not (8 <= hd <= MAX_HD and hd % 8 == 0):
        raise ValueError(f"head dim {hd} is not taken by the kernel (a multiple of 8, 8..{MAX_HD})")


def check_rows(name: str, t: torch.Tensor) -> None:
    """t's last dimension is contiguous and every row it indexes starts on
    a 16-byte boundary (what the kernels' vector loads need)."""
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dimension, got strides {t.stride()}")
    if t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:-1]):
        raise ValueError(f"{name} strides {t.stride()} do not keep its rows on 16-byte boundaries")


WIDTHS = (64, 128, 192)  # the bf16 kernel's compiled head widths
WIDE_BLOCK_K = 112  # k/v positions a tile of the 192-wide kernel
WIDE_STAGES = 2  # its k and v rings


def instantiated_hd(hd: int) -> int:
    """The bf16 kernel's compiled width for head dim ``hd``: the least of
    64, 128 and 192 that holds it. The tensor maps zero-fill the columns
    past hd."""
    check_head_dim(hd)
    return next(w for w in WIDTHS if hd <= w)


def block_k(hd_inst: int) -> int:
    """k/v positions a tile of the bf16 kernel at width ``hd_inst``: 128,
    or ``WIDE_BLOCK_K`` at 192 (two 192-wide stages of 128 would not fit a
    block's shared memory). It is also the k/v tensor maps' box rows."""
    return WIDE_BLOCK_K if hd_inst > 128 else 128


def wide_smem_bytes(bk: Optional[int] = None, stages: Optional[int] = None) -> int:
    """Dynamic shared memory of the 192-wide kernel (``wide::kSmem``): 1 KB
    to round the base up to the swizzle's 1,024-byte alignment, the 128-row
    q tile, ``stages`` k and v tiles of ``bk`` rows (by default
    ``WIDE_STAGES`` and ``WIDE_BLOCK_K``), and the barriers (q full, q
    empty; k full, v full, k empty, v empty a stage), 8 bytes each."""
    bk, stages = bk or WIDE_BLOCK_K, stages or WIDE_STAGES
    row = MAX_HD * 2
    return 1024 + BLOCK_Q * row + 2 * stages * bk * row + 8 * (2 + 4 * stages)


def persistent_items(b: int, h: int, s: int, blocks: int):
    """The 192-wide kernel's work, as its grid of ``min(items, blocks)``
    blocks (one an SM) takes it: for each block, the (b, h, q tile) triples
    it runs in order. Item j is q tile ``n_q - 1 - j // (b*h)`` of head
    ``j % (b*h)`` (as (b, h)), so items go longest first; block k takes
    items k, k + G, k + 2G, ... (``wide::item_at``)."""
    n_q = -(-s // BLOCK_Q)
    items = b * h * n_q
    grid = min(items, blocks)
    order = [((j % (b * h)) // h, (j % (b * h)) % h, n_q - 1 - j // (b * h)) for j in range(items)]
    return [order[k::grid] for k in range(grid)]


def bwd_rows(s: int, hd_inst: int) -> int:
    """Rows of each (b, h) in the gradient's D and lse scratch: S rounded
    up to ``BWD_BOX_ROWS`` for the wgmma instances (bf16, ``hd_inst`` 64,
    128 or 192, whose bulk copies read 64-row slices whole), S for float32
    (``hd_inst`` 0)."""
    if hd_inst not in BWD_WGMMA_WIDTHS:
        return s
    return -(-s // BWD_BOX_ROWS) * BWD_BOX_ROWS


def dkdv_steps(s: int) -> list:
    """Steps of a dk/dv block at widths 64 and 128 for one q head, by key
    block: 64-row q tiles from its diagonal on (key block y starts at q
    tile 2y)."""
    n_q = -(-s // BWD_BOX_ROWS)
    return [n_q - 2 * y for y in range(-(-s // BWD_KEY_BLOCK))]


def dkdv_splits(b: int, s: int, kv: int, g: int, sms: int) -> int:
    """CTAs of a dk/dv cluster (c) at B ``b``, S ``s``, ``kv`` kv heads of
    ``g`` q heads each, on a card of ``sms`` SMs: the smallest divisor c
    of g, at most ``DKDV_MAX_SPLITS``, whose longest CTA (g/c heads of the
    first key block's steps) is within ``DKDV_BALANCE`` of the balanced
    share (all steps over the SMs); 1 wherever the one-block grid is
    balanced already. If no divisor meets it (few blocks, short S), the
    largest one; 1 at S 0 (nothing is launched)."""
    steps = dkdv_steps(s)
    if not steps:
        return 1
    share = b * kv * g * sum(steps) / sms
    divisors = [c for c in range(1, min(g, DKDV_MAX_SPLITS) + 1) if g % c == 0]
    return next((c for c in divisors if g // c * steps[0] <= DKDV_BALANCE * share), divisors[-1])


def tma_layout(t: torch.Tensor, rows: int = BLOCK_Q):
    """The 4-D tensor map the bf16 kernel reads ``t`` [B, S, heads, hd]
    through: dims (hd, heads, S, B), innermost first; the byte strides of
    dims 1..3; the box (64 columns, 1 head, ``rows`` positions, 1 batch).
    A dimension of size 1 is never stepped along, so its stride is set to
    the packed one (the map wants every stride a multiple of 16). Raises on
    a layout the map cannot describe."""
    b, s, heads, hd = t.shape
    size = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"tensor map needs a contiguous last dimension, got strides {t.stride()}")
    dims = (hd, heads, s, b)
    strides, packed = [], hd * size
    for extent, stride in ((heads, t.stride(2)), (s, t.stride(1)), (b, t.stride(0))):
        nbytes = packed if extent == 1 else stride * size
        if nbytes % 16 or nbytes <= 0:
            raise ValueError(f"strides {t.stride()} do not keep rows on 16-byte boundaries")
        strides.append(nbytes)
        packed = nbytes * extent
    return dims, tuple(strides), (BOX_COLS, 1, rows, 1)


def _tma_args(*tensors_rows):
    flat = []
    for t, rows in tensors_rows:
        dims, strides, box = tma_layout(t, rows)
        flat += [*dims, *strides, *box]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check_operands(named) -> None:
    q = named[0][1]
    for name, t in named:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device {q.device}, got {t.device}")
        if t.dtype not in DTYPE_IDS or t.dtype != q.dtype:
            raise TypeError(f"{name} must be float32 or bfloat16 like q, got {t.dtype} (q {q.dtype})")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d [B, S, heads, hd], got {tuple(t.shape)}")


def flash_attention(q, k, v, softcap: float = 0.0, *, with_lse: bool = False):
    """Causal GQA attention on the card. q: [B, S, H, hd]; k/v:
    [B, Skv, Kv, hd] with Skv >= S (H a multiple of Kv; q head h reads kv
    head h // (H/Kv)); q row i sits at position Skv - S + i and sees keys
    up to it. float32 or bfloat16, all one dtype. Returns [B, S, H, hd] in
    q's dtype; the scale is 1/sqrt(hd); ``softcap`` > 0 caps the scaled
    logits as softcap * tanh(x / softcap) before the mask. With
    ``with_lse`` returns (out, lse): lse float32 [B, H, S], each row's
    log-sum-exp of its scaled (and capped) logits in natural units."""
    _check_operands((("q", q), ("k", k), ("v", v)))
    b, s, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (b, skv, kv, hd) or tuple(v.shape) != tuple(k.shape) or kv < 1 or h % kv
            or skv < s):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "(k and v [B, Skv >= S, Kv, hd])")
    softcap = float(softcap)
    if not softcap >= 0.0:
        raise ValueError(f"softcap must be >= 0 (0 is off), got {softcap}")
    check_head_dim(hd)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_rows(name, t)
    bf16 = q.dtype == torch.bfloat16
    hd_inst = instantiated_hd(hd) if bf16 else 0
    tma = _tma_args((q, BLOCK_Q), (k, block_k(hd_inst)), (v, block_k(hd_inst))) if bf16 else None
    lib = LIBRARY.load()
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPE_IDS[q.dtype],
            b, s, skv, h, kv, hd, 1.0 / hd ** 0.5, softcap,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), hd_inst, tma,
            lse.data_ptr() if with_lse else None, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc} "
                           f"({lib.flash_attention_error_string(rc).decode()})")
    launches["flash_attention"] += 1
    return (out, lse) if with_lse else out


def flash_attention_backward(q, k, v, o, lse, do, softcap: float = 0.0):
    """The gradient of ``flash_attention`` on the card: (dq, dk, dv) in the
    inputs' dtype from q, o, do [B, S, H, hd], k, v [B, S, Kv, hd] (k/v as
    long as q: an offset prefill is never trained) and the forward's
    ``lse`` [B, H, S] float32. Three launches: D = rowsum(do * o), then
    dk and dv (one block a key block, summing the group's q heads; in
    bfloat16 at widths 64 and 128, a cluster of ``dkdv_splits`` CTAs a key
    block, for the shape and the card's SM count, sharing the group), then
    dq; no atomics, so the result is the same bits on every run. Operands
    are made contiguous (a no-op for the forward's own tensors); bfloat16
    reads q, k, v and do through tensor maps."""
    named = (("q", q), ("k", k), ("v", v), ("o", o), ("do", do))
    _check_operands(named)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if (tuple(k.shape) != (b, s, kv, hd) or tuple(v.shape) != tuple(k.shape) or tuple(o.shape) != tuple(q.shape)
            or tuple(do.shape) != tuple(q.shape) or kv < 1 or h % kv):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"o {tuple(o.shape)}, do {tuple(do.shape)} (the backward takes k and v as long as q)")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s) or lse.device != q.device:
        raise ValueError(f"lse must be float32 [B, H, S] = {(b, h, s)} on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    softcap = float(softcap)
    if not softcap >= 0.0:
        raise ValueError(f"softcap must be >= 0 (0 is off), got {softcap}")
    check_head_dim(hd)
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    for name, t in zip(("q", "k", "v", "o", "do"), (q, k, v, o, do)):
        check_rows(name, t)
    hd_inst = instantiated_hd(hd) if q.dtype == torch.bfloat16 else 0
    wgmma = hd_inst in BWD_WGMMA_WIDTHS
    splits = 1
    if hd_inst in DKDV_SPLIT_WIDTHS:
        splits = dkdv_splits(b, s, kv, h // kv, torch.cuda.get_device_properties(q.device).multi_processor_count)
    s_pad = bwd_rows(s, hd_inst)
    tma = _tma_args(*((t, BWD_BOX_ROWS) for t in (q, k, v, do))) if wgmma else None
    lib = BWD_LIBRARY.load()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # D, and for the wgmma instances lse in log2 units: [B, H, s_pad] each
    scratch = torch.empty((2 if wgmma else 1, b, h, s_pad), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            scratch[0].data_ptr(), scratch[1].data_ptr() if wgmma else None, dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), DTYPE_IDS[q.dtype], b, s, s_pad, h, kv, hd, 1.0 / hd ** 0.5, softcap, hd_inst, splits, tma,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {rc} "
                           f"({lib.flash_attention_bwd_error_string(rc).decode()})")
    launches["flash_attention_bwd"] += BWD_LAUNCHES
    dkdv_launches_by_splits[splits] = dkdv_launches_by_splits.get(splits, 0) + 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: ``apply(q, k, v, softcap,
    grad)``. With ``grad`` (grad mode on and an input that requires it;
    ``ops.mha`` works it out, since a Function's forward runs with grad
    mode off) the forward writes ``lse`` and saves (q, k, v, out, lse);
    without, it launches the forward as ``flash_attention`` does and saves
    nothing, which is the serving path. Under grad, k/v must be as long as
    q."""

    @staticmethod
    def forward(ctx, q, k, v, softcap: float = 0.0, grad: bool = False):
        if not grad:
            return flash_attention(q, k, v, softcap)
        if k.shape[1] != q.shape[1]:
            raise ValueError(f"the gradient takes k/v as long as q (no offset): q {tuple(q.shape)}, "
                             f"k {tuple(k.shape)}")
        out, lse = flash_attention(q, k, v, softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.softcap = softcap
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do, ctx.softcap)
        return dq, dk, dv, None, None
