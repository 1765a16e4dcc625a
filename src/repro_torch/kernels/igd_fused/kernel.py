"""CUDA wrappers for the fused IGD kernels (``csrc/igd_fused.cu``).

The source is built and loaded at first use by ``kernels._build``
(``nvcc`` for ``sm_90a`` into ``build/repro_torch/libigd_fused-<hash>.so``,
``ctypes``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on PyTorch's current stream, raises
on a non-zero CUDA status, and adds one to its entry in ``launches``.

Both wrappers take one fold (``x [N, D]``, ``y [N]``, ``alpha [N]``,
``w0 [D]`` -> ``w [D]``) or B lanes of folds in one launch, the
counterpart of ``jax.vmap`` over the reference's Pallas call:
``alpha [B, N]`` and ``w0 [B, D]`` -> ``w [B, D]``, over one shared table
(``x [N, D]``, ``y [N]``: every lane reads the same rows) or a stacked one
(``x [S, N, D]``, ``y [S, N]`` with S dividing B: lane b reads segment
``b // (B // S)``; S = B gives each lane its own rows, S < B lets B / S
consecutive lanes share a segment, as the B queries of a fused sharded
batch share the k segments of one partitioned table). A lane launch is one
launch however many lanes it carries; each lane's w equals its one-lane
launch's bit for bit.

Both kernels take every D >= 1; the library picks an instance by D
(the constants below are the boundaries, checked against the library's
own when it loads). ``igd_fold``: the tiled Gram look-ahead in one block
a lane up to 256, and past it the same look-ahead over a cluster a lane,
each CTA a column slice of w, after a pre-pass over the whole card that
forms every 32-row sub-tile's Gram blocks into scratch the wrapper
allocates (``torch.empty``, one pre-pass a table segment). Up to 4,096
(the middle instance) the cluster has 4 to 16 CTAs, the fewest whose
slices are at most FOLD_MIDDLE_MAX_SLICE columns (:func:`fold_middle_ctas`:
D alone sets it), each sub-tile's slice stays resident in shared memory
from its q to its update, and the pre-pass takes 64 floats of scratch a
row; past it (the wide instance) 16 CTAs stream each sub-tile in twice,
w's slices in shared memory up to D 196,608 and in global memory above,
and the pre-pass takes 320 floats a row. A cluster instance is two
launches of the library in one wrapper call (the pre-pass, the cluster
kernel; the wide one three, with the sum of the pre-pass's parts), and
``launches`` counts the call once. ``igd_fold_minibatch``: a cluster of 8
CTAs splitting each tile's rows up to 256, and past it the column-slice
cluster, 16 CTAs a lane splitting w's columns (a tile's slice resident in
shared memory from the margins to the update up to D 1,424; past it the
margins' rows streamed in by bulk copies and the update's read again
from L2; each CTA's slice of w in shared memory up to D 196,608, in
global memory above). ``middle_launches`` counts igd_fold's middle
instance (256 < D <= 4,096), ``wide_launches`` the instances past it and
past the minibatch's D 256, each a share of ``launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, CudaLibrary  # noqa: F401

TILE = 256  # examples per minibatch step (the reference's VMEM block)
# Both kernels take every D >= 1; these are the library's instance
# boundaries, which pick the instance a launch runs (see the source's head).
FOLD_GRAM_MAX_DIM = 256  # igd_fold's one-block Gram instance; its middle instance above it
FOLD_REGISTER_MAX_DIM = 4096  # igd_fold's middle instance (resident sub-tiles); the wide instance above it
FOLD_MIDDLE_MAX_SLICE = 128  # columns a CTA of the middle instance owns at most, but at 16 CTAs (fold_middle_ctas)
FOLD_CLUSTER = 16  # CTAs a lane of igd_fold's wide instance, and the most of its middle one
FOLD_CLUSTER_SMEM_MAX_DIM = FOLD_CLUSTER * 12288  # its w slices in shared memory; in global memory above
MINIBATCH_CLUSTER = 8  # CTAs a lane of igd_fold_minibatch's row-share cluster
MINIBATCH_CLUSTER_MAX_DIM = 256  # the row-share cluster instance; the column-slice cluster above it
MINIBATCH_SLICE_CLUSTER = 16  # CTAs a lane of the column-slice cluster
MINIBATCH_RESIDENT_MAX_DIM = 1424  # its tile's slice resident from the margins to the update; streamed twice above
MINIBATCH_SLICE_SMEM_MAX_DIM = MINIBATCH_SLICE_CLUSTER * 12288  # its w slices in shared memory; in global memory above
MAX_LANES = 65535  # lanes a launch (the cluster instances' gridDim.y)

LOSS_IDS = {"lr": 0, "svm": 1, "lsq": 2}

SOURCE = Path(__file__).resolve().parent / "csrc" / "igd_fused.cu"

# Launch counts, one per wrapper: bumped where the kernel is launched and
# nowhere else, so a run can show that its path went through the kernel.
launches: Dict[str, int] = {"igd_fold": 0, "igd_fold_minibatch": 0}
# The middle and the wide instances' shares of those launches, bumped
# at the same place: igd_fold's middle instance (FOLD_GRAM_MAX_DIM < D <=
# FOLD_REGISTER_MAX_DIM; igd_fold_minibatch has no middle instance) and D
# past _WIDE_ABOVE.
middle_launches: Dict[str, int] = {"igd_fold": 0, "igd_fold_minibatch": 0}
wide_launches: Dict[str, int] = {"igd_fold": 0, "igd_fold_minibatch": 0}
_WIDE_ABOVE = {"igd_fold": FOLD_REGISTER_MAX_DIM, "igd_fold_minibatch": MINIBATCH_CLUSTER_MAX_DIM}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
        middle_launches[k] = 0
        wide_launches[k] = 0


def _declare(lib: ctypes.CDLL, cluster: int = MINIBATCH_CLUSTER) -> None:
    """Set every entry's types and check the library's limits against this
    module's (``cluster``: the minibatch cluster size the source was built
    with, which a variant of the source may change)."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # x, y, alpha, w0, wout, n, d, loss, lanes, x/y lane rows, alpha lane stride, stream
    one = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i64, i64, ptr]
    # the same with lanes a x/y segment after the x/y lane rows
    segments = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i64, i32, i64, ptr]
    # igd_fold's entries take the wide instance's scratch before the stream
    for name, types in (("igd_fold_launch", one[:-1] + [ptr, ptr]), ("igd_fold_minibatch_launch", one),
                        ("igd_fold_segments_launch", segments[:-1] + [ptr, ptr]),
                        ("igd_fold_minibatch_segments_launch", segments)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = i32
    lib.igd_fused_fold_scratch_floats.argtypes = [i64, i32, i32, i64, i32]
    lib.igd_fused_fold_scratch_floats.restype = i64
    lib.igd_fused_fold_design.argtypes = [i32, ptr]
    lib.igd_fused_fold_design.restype = i32
    lib.igd_fused_fold_clusters_fit.argtypes = [i32]
    lib.igd_fused_fold_clusters_fit.restype = i32
    lib.igd_fused_fold_middle_design.argtypes = [i32, ptr]
    lib.igd_fused_fold_middle_design.restype = i32
    lib.igd_fused_fold_middle_clusters_fit.argtypes = [i32]
    lib.igd_fused_fold_middle_clusters_fit.restype = i32
    lib.igd_fused_error_string.argtypes = [i32]
    lib.igd_fused_error_string.restype = ctypes.c_char_p
    lib.igd_chain_probe_launch.argtypes = [i32, i32, ptr, ptr]
    lib.igd_chain_probe_launch.restype = i32
    lib.igd_minibatch_step_probe_launch.argtypes = [i32, i32, i32, ptr, ptr]
    lib.igd_minibatch_step_probe_launch.restype = i32
    lib.igd_minibatch_wide_step_probe_launch.argtypes = [i32, i32, ptr, ptr]
    lib.igd_minibatch_wide_step_probe_launch.restype = i32
    lib.igd_fused_minibatch_smem_bytes.argtypes = [i32]
    lib.igd_fused_minibatch_smem_bytes.restype = i64
    lib.igd_fused_minibatch_slice_design.argtypes = [i32, ptr]
    lib.igd_fused_minibatch_slice_design.restype = i32
    lib.igd_fused_minibatch_clusters_fit.argtypes = [i32]
    lib.igd_fused_minibatch_clusters_fit.restype = i32
    names = ("igd_fused_gram_max_dim", "igd_fused_fold_register_max_dim", "igd_fused_fold_cluster_smem_max_dim",
             "igd_fused_minibatch_resident_max_dim", "igd_fused_minibatch_slice_smem_max_dim", "igd_fused_tile",
             "igd_fused_minibatch_cluster", "igd_fused_minibatch_cluster_max_dim", "igd_fused_minibatch_slice_cluster",
             "igd_fused_max_lanes", "igd_fused_fold_middle_max_slice")
    for name in names:
        getattr(lib, name).restype = i32
    design = (ctypes.c_longlong * 4)()
    limits = tuple(getattr(lib, name)() for name in names) + (
        lib.igd_fused_fold_design(FOLD_REGISTER_MAX_DIM + 1, design), design[0])
    if limits != (FOLD_GRAM_MAX_DIM, FOLD_REGISTER_MAX_DIM, FOLD_CLUSTER_SMEM_MAX_DIM, MINIBATCH_RESIDENT_MAX_DIM,
                  MINIBATCH_SLICE_SMEM_MAX_DIM, TILE, cluster, MINIBATCH_CLUSTER_MAX_DIM, MINIBATCH_SLICE_CLUSTER,
                  MAX_LANES, FOLD_MIDDLE_MAX_SLICE, 0, FOLD_CLUSTER):
        raise RuntimeError(f"igd_fused library limits {limits} disagree with kernel.py")
    middle = {d: _fold_middle_design(lib, d) for d in fold_middle_widths()}
    if any(got[0] != fold_middle_ctas(d) for d, got in middle.items()):
        raise RuntimeError(f"igd_fold's middle instance picks other cluster sizes than kernel.py: "
                           f"{ {d: got[0] for d, got in middle.items()} }")
    # the non-portable 16-CTA clusters (up to 227 KB a CTA) must fit the card:
    # the wide fold's and the minibatch's column-slice instance, at each tier
    for what, fit_of, design_of, widths in (
            ("igd_fold's middle instance", lib.igd_fused_fold_middle_clusters_fit, _fold_middle_design,
             fold_middle_widths()),
            ("igd_fold's wide instance", lib.igd_fused_fold_clusters_fit, _fold_design,
             (FOLD_REGISTER_MAX_DIM + 1, FOLD_CLUSTER_SMEM_MAX_DIM + 1)),
            ("igd_fold_minibatch's column-slice instance", lib.igd_fused_minibatch_clusters_fit, _slice_design,
             (MINIBATCH_CLUSTER_MAX_DIM + 1, MINIBATCH_RESIDENT_MAX_DIM + 1, MINIBATCH_SLICE_SMEM_MAX_DIM + 1))):
        for d in widths:
            fit = fit_of(d)
            if fit < 1:
                design = design_of(lib, d)
                raise RuntimeError(f"{what} at D={d} (a cluster of {design[0]} CTAs, {design[-1]} bytes of "
                                   f"shared memory a CTA) does not fit this card: cudaOccupancyMaxActiveClusters "
                                   f"gives {fit}")


LIBRARY = CudaLibrary("igd_fused", SOURCE, _declare)
library_path = LIBRARY.path
build = LIBRARY.build
_load = LIBRARY.load


# The implementation axis's kernels.
_IMPLEMENTATION_KERNELS = {"cuda_fused": "igd_fold", "cuda_minibatch": "igd_fold_minibatch"}


def supports(implementation: str, d: int) -> Optional[str]:
    """Why the kernel behind ``implementation`` cannot take D features,
    or None when it can: every kernel takes any D >= 1 (``torch_fold``
    any D). Plain Python: the planner and the probes call it on any
    device, so a query plans on the CPU as it will on the card."""
    if implementation == "torch_fold":
        return None
    if implementation not in _IMPLEMENTATION_KERNELS:
        raise ValueError(f"unknown implementation {implementation!r}")
    if d >= 1:
        return None
    return f"{implementation}'s kernel {_IMPLEMENTATION_KERNELS[implementation]} takes D >= 1; this query has D={d}"


def lane_layout(x, y, alpha, w0):
    """(lanes, xy_lane_rows, alpha_lane_stride) of a call, or ValueError
    when the shapes fit neither one fold nor a lane launch: one fold is
    x [N, D], y [N], alpha [N], w0 [D]; B lanes are alpha [B, N] and
    w0 [B, D] over x [N, D], y [N] (shared: xy_lane_rows 0) or x [S, N, D],
    y [S, N] with S dividing B (stacked: xy_lane_rows N; see
    :func:`lanes_per_xy`)."""
    shapes = (f"x {tuple(x.shape)}, y {tuple(y.shape)}, "
              f"alpha {tuple(alpha.shape)}, w0 {tuple(w0.shape)}")
    if x.dim() not in (2, 3) or w0.dim() not in (1, 2):
        raise ValueError(f"shapes fit neither one fold nor a lane launch: {shapes}")
    n, d = x.shape[-2:]
    if w0.dim() == 1:
        if x.dim() != 2 or tuple(y.shape) != (n,) or tuple(alpha.shape) != (n,) or tuple(w0.shape) != (d,):
            raise ValueError(f"shapes disagree: {shapes}")
        return 1, 0, 0
    b = w0.shape[0]
    shared = x.dim() == 2
    want_y = (n,) if shared else (x.shape[0], n)
    if (b < 1 or tuple(w0.shape) != (b, d) or tuple(alpha.shape) != (b, n) or tuple(y.shape) != want_y
            or (not shared and (x.shape[0] < 1 or b % x.shape[0]))):
        raise ValueError(f"lane shapes disagree: {shapes}")
    return b, 0 if shared else n, n


def lanes_per_xy(x, w0) -> int:
    """Consecutive lanes that read one x/y segment: B / S for a stacked
    x [S, N, D] under w0 [B, D], else 1."""
    return w0.shape[0] // x.shape[0] if x.dim() == 3 and w0.dim() == 2 else 1


def _check(x, y, alpha, w0, loss: str):
    if loss not in LOSS_IDS:
        raise ValueError(f"unknown loss {loss!r}; valid: {sorted(LOSS_IDS)}")
    named = {"x": x, "y": y, "alpha": alpha, "w0": w0}
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device {x.device}, got {t.device}")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad, but the IGD kernels have no backward")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    layout = lane_layout(x, y, alpha, w0)
    d = x.shape[-1]
    if d < 1:
        raise ValueError(f"D={d}: the kernels take D >= 1")
    if layout[0] > MAX_LANES:
        raise ValueError(f"{layout[0]} lanes, more than a launch takes ({MAX_LANES})")
    return layout


def _launch(name: str, x, y, alpha, w0, loss: str, layout):
    lib = _load()
    out = torch.empty_like(w0)
    n, d = x.shape[-2:]
    lanes, xy_lane_rows, alpha_lane_stride = layout
    per_xy = lanes_per_xy(x, w0)
    extra = ()
    if name == "igd_fold":  # the wide instance's pre-pass scratch
        floats = lib.igd_fused_fold_scratch_floats(n, d, lanes, xy_lane_rows, per_xy)
        scratch = torch.empty(floats, dtype=torch.float32, device=x.device) if floats else None
        extra = (scratch.data_ptr() if floats else None,)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"{name}_segments_launch")(
            x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w0.data_ptr(),
            out.data_ptr(), n, d, LOSS_IDS[loss], lanes, xy_lane_rows,
            per_xy, alpha_lane_stride, *extra, stream,
        )
    if rc != 0:
        msg = lib.igd_fused_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    launches[name] += 1
    if d > _WIDE_ABOVE[name]:
        wide_launches[name] += 1
    elif name == "igd_fold" and d > FOLD_GRAM_MAX_DIM:
        middle_launches[name] += 1
    return out


def igd_fold(x, y, alpha, w0, *, loss: str = "lr"):
    """Sequential IGD over all N rows of x [N, D] (any D >= 1) with
    per-row step sizes alpha [N], from w0 [D] -> final w [D]; or B such
    folds in one launch (see the module's note). Float32, CUDA,
    contiguous. The library picks the instance by D: a block a lane for
    the tiled Gram look-ahead up to FOLD_GRAM_MAX_DIM; above it the Gram
    pre-pass, then the look-ahead on a cluster a lane: fold_middle_ctas(D)
    CTAs with every sub-tile's slice resident up to FOLD_REGISTER_MAX_DIM
    (:func:`fold_middle_design`), FOLD_CLUSTER CTAs past it (w's slices in
    shared memory up to FOLD_CLUSTER_SMEM_MAX_DIM, in global memory past
    it; :func:`fold_design`), one count in ``launches``.
    ref.igd_fold_tiled_ref is every instance's order."""
    layout = _check(x, y, alpha, w0, loss)
    return _launch("igd_fold", x, y, alpha, w0, loss, layout)


def igd_fold_minibatch(x, y, alpha, w0, *, loss: str = "lr"):
    """One mean-gradient step per TILE rows; the ragged last tile's mean
    is over TILE (rows past N add zero); or B such folds in one launch.
    Any D >= 1. The library picks the instance by D: a cluster of
    MINIBATCH_CLUSTER CTAs a lane, each a row share of a tile, up to
    MINIBATCH_CLUSTER_MAX_DIM (ref.igd_fold_minibatch_split_ref is its
    order of sums), and above it the column-slice cluster of
    MINIBATCH_SLICE_CLUSTER CTAs a lane, each a column slice of w (in
    shared memory up to MINIBATCH_SLICE_SMEM_MAX_DIM, in global memory
    past it): a tile's slice resident in shared memory from the margins to
    the update up to MINIBATCH_RESIDENT_MAX_DIM; past it the margins' rows
    streamed in by bulk copies and the update's read again from L2 (see
    :func:`minibatch_slice_design`)."""
    layout = _check(x, y, alpha, w0, loss)
    return _launch("igd_fold_minibatch", x, y, alpha, w0, loss, layout)


def minibatch_design(d: int):
    """(CTAs a cluster, dynamic shared memory bytes a CTA) of
    igd_fold_minibatch's instance at D: the row-share cluster's up to
    MINIBATCH_CLUSTER_MAX_DIM, the column-slice cluster's above."""
    lib = _load()
    cluster = lib.igd_fused_minibatch_cluster() if d <= MINIBATCH_CLUSTER_MAX_DIM else MINIBATCH_SLICE_CLUSTER
    return cluster, lib.igd_fused_minibatch_smem_bytes(d)


def _slice_design(lib: ctypes.CDLL, d: int):
    out = (ctypes.c_longlong * 5)()
    if lib.igd_fused_minibatch_slice_design(d, out) != 0:
        raise ValueError(f"D={d}: igd_fold_minibatch's column-slice instance takes D > {MINIBATCH_CLUSTER_MAX_DIM}")
    return tuple(out)


def minibatch_slice_design(d: int):
    """(CTAs a lane, panel columns, rows a panel, ring slots, shared memory
    bytes a CTA) of igd_fold_minibatch's column-slice instance at D >
    MINIBATCH_CLUSTER_MAX_DIM, from the library: each CTA's slice streams
    through a ring of panels; 256 rows a panel where the tile's slice
    stays resident (D <= MINIBATCH_RESIDENT_MAX_DIM)."""
    return _slice_design(_load(), d)


def _probe(launch, args, steps: int, device, what: str):
    """(SM cycles, seconds) a step of a probe kernel: clock64 inside, CUDA
    events around one launch after a warm-up launch."""
    lib = _load()
    out = torch.zeros(2, dtype=torch.int64, device=device or "cuda")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(2):
            start.record(stream)
            rc = getattr(lib, launch)(*args, steps, out.data_ptr(), stream.cuda_stream)
            end.record(stream)
            if rc != 0:
                raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                                   f"({lib.igd_fused_error_string(rc).decode()})")
        end.synchronize()
    return int(out[0]) / steps, start.elapsed_time(end) * 1e-3 / steps


def minibatch_step_probe(loss: str = "lsq", d: int = 54, *, steps: int = 1 << 14, device=None):
    """(SM cycles, seconds) per tile of igd_fold_minibatch's cluster
    instance with the tile already resident in shared memory: the margins,
    the block barrier, the partial sums, the exchange of partials and the
    w update, with no copies (clock64 in rank 0 around the tile loop, CUDA
    events around the launch). N_tiles times it is the kernel's tile-chain
    floor. A measurement probe, not a kernel of the path: it counts no
    launch."""
    if loss not in LOSS_IDS:
        raise ValueError(f"unknown loss {loss!r}; valid: {sorted(LOSS_IDS)}")
    if not 1 <= d <= MINIBATCH_CLUSTER_MAX_DIM:
        raise ValueError(f"D={d} outside the cluster instance (1..{MINIBATCH_CLUSTER_MAX_DIM})")
    return _probe("igd_minibatch_step_probe_launch", (LOSS_IDS[loss], d), steps, device,
                  "igd_minibatch_step_probe")


def minibatch_wide_step_probe(loss: str = "lsq", *, steps: int = 1 << 12, device=None):
    """(SM cycles, seconds) per tile of igd_fold_minibatch's column-slice
    instance's exchange alone: a consumer barrier, the push of the 256
    partial margins to every CTA (st.async), the wait on the CTA's own
    mbarrier, the 16-way sums in rank order and grad_scale of the tile's
    rows, a consumer barrier; no row traffic. N_tiles times it is the
    instance's exchange floor. A measurement probe, not a kernel of the
    path: it counts no launch."""
    if loss not in LOSS_IDS:
        raise ValueError(f"unknown loss {loss!r}; valid: {sorted(LOSS_IDS)}")
    return _probe("igd_minibatch_wide_step_probe_launch", (LOSS_IDS[loss],), steps, device,
                  "igd_minibatch_wide_step_probe")


def _fold_design(lib: ctypes.CDLL, d: int):
    out = (ctypes.c_longlong * 4)()
    if lib.igd_fused_fold_design(d, out) != 0:
        raise ValueError(f"D={d}: igd_fold's wide instance takes D > {FOLD_REGISTER_MAX_DIM}")
    return tuple(out)


def fold_design(d: int):
    """(CTAs a lane, panel columns, ring slots, shared memory bytes a CTA)
    of igd_fold's wide instance at D > FOLD_REGISTER_MAX_DIM, from the
    library: each CTA's slice streams through a ring of 32-row panels."""
    return _fold_design(_load(), d)


def fold_middle_ctas(d: int) -> int:
    """CTAs a lane of igd_fold's middle instance at FOLD_GRAM_MAX_DIM < D
    <= FOLD_REGISTER_MAX_DIM: the fewest of 1, 2, 4, 8, 16 whose column
    slices (ceil(D / CTAs)) are at most FOLD_MIDDLE_MAX_SLICE, or 16. D
    alone sets it, so a lane's w is its one-lane launch's bit for bit.
    Plain Python, the library's choice (checked when it loads)."""
    if not FOLD_GRAM_MAX_DIM < d <= FOLD_REGISTER_MAX_DIM:
        raise ValueError(f"D={d}: igd_fold's middle instance takes {FOLD_GRAM_MAX_DIM} < D <= "
                         f"{FOLD_REGISTER_MAX_DIM}")
    ctas = 1
    while ctas < FOLD_CLUSTER and -(-d // ctas) > FOLD_MIDDLE_MAX_SLICE:
        ctas *= 2
    return ctas


def fold_middle_widths():
    """The middle instance's first D and the last D of each cluster size it
    takes (the widest slice, so the most shared memory, of each)."""
    last = {}
    for d in range(FOLD_GRAM_MAX_DIM + 1, FOLD_REGISTER_MAX_DIM + 1):
        last[fold_middle_ctas(d)] = d
    return (FOLD_GRAM_MAX_DIM + 1,) + tuple(last.values())


def _fold_middle_design(lib: ctypes.CDLL, d: int):
    out = (ctypes.c_longlong * 4)()
    if lib.igd_fused_fold_middle_design(d, out) != 0:
        raise ValueError(f"D={d}: igd_fold's middle instance takes {FOLD_GRAM_MAX_DIM} < D <= "
                         f"{FOLD_REGISTER_MAX_DIM}")
    return tuple(out)


def fold_middle_design(d: int):
    """(CTAs a lane, columns a CTA, resident sub-tiles, shared memory bytes
    a CTA) of igd_fold's middle instance at FOLD_GRAM_MAX_DIM < D <=
    FOLD_REGISTER_MAX_DIM, from the library: each CTA keeps its slice of
    every sub-tile in one of the resident slots from its q to its update."""
    return _fold_middle_design(_load(), d)


def chain_probe(loss: str = "lr", *, steps: int = 1 << 16, device=None):
    """(SM cycles, seconds) per step of igd_fold's dependent chain (the
    tiled instances' at every D: grad_scale_fast, the multiply by alpha, one FMA),
    timed alone in one warp: clock64 inside the kernel, CUDA events around
    it (after a warm-up launch). A measurement probe, not a kernel of the
    path: it counts no launch."""
    if loss not in LOSS_IDS:
        raise ValueError(f"unknown loss {loss!r}; valid: {sorted(LOSS_IDS)}")
    return _probe("igd_chain_probe_launch", (LOSS_IDS[loss],), steps, device, "igd_chain_probe")
