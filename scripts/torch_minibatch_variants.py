#!/usr/bin/env python3
"""Time variants of the port's igd_fold_minibatch kernel beside the committed one, on one CUDA card.

    python3 scripts/torch_minibatch_variants.py [--only NAME ...] [--slice]

Run from the repository root on a machine with a Hopper card. Each variant
is the committed CUDA source (src/repro_torch/kernels/igd_fused/csrc/
igd_fused.cu) with a few textual changes, built into the git-ignored
build/variants/ and launched through its own library:

- cluster_k<k>: the cluster instance with k CTAs a cluster (the committed
  source's kMbCluster replaced), each a 256/k-row share of every tile;
- copy_only_k<k>: the same ring of bulk copies with no arithmetic and no
  exchange of partials (a block barrier a tile stays, so no thread falls
  a ring behind): the copy path's ceiling at k SMs (timing only, wrong w);
- exchange_only: the committed cluster with its copies, its block barrier
  and its exchange of (zero) partials a tile, but no arithmetic;
- no_exchange: the committed cluster without the exchange (each CTA
  applies whatever its receive buffer holds; timing only, wrong w);
- copy_only_x_only: copy_only_k8 without the y and alpha copies (timing
  only): what the two small copies a tile cost;
- partial4: each column's partial in four interleaved accumulators
  (rows r mod 4, then (a0 + a1) + (a2 + a3)) instead of one row-order chain.
- --against PATH: another igd_fused.cu (say, a parent commit's), built and
  timed in the same turns (held to the plain fold only).

With --slice the variants are the column-slice cluster's (D > 256, 16
CTAs a lane), timed at SLICE_SHAPES (8,192 x 12,033: panels streamed
twice; 65,536 x 1,000: a tile's slice resident), lsq, in turns committed,
variant, committed, beside the byte bound and each variant's GB/s of the
table; the variants that compute w are held to ref.igd_fold_minibatch_ref
first:

- slice_clocks: clock64 in rank 0 at the tile's phase boundaries (the
  wait for the tile's copies, pass 1, the exchange, pass 2), cycles a
  tile (timing only);
- slice_copy_only: the copies alone (a streamed tile's margins panels
  through the producer's ring of bulk copies, a resident tile by the
  consumers' cp.async) with no arithmetic and no exchange (the consumer
  barriers stay): the copy path's ceiling at 16 SMs (timing only, wrong
  w);
- slice_exchange_only: the copies and the exchange of partials, no
  arithmetic (timing only);
- slice_no_exchange: the copies and both passes, no exchange (each CTA
  takes whatever its receive buffer holds; timing only);
- slice_panel512: panels of at most 512 columns (two column chunks a
  slice at D 12,033, so twice the bulk copies) in place of 1,024.

Times are device ms per launch (CUDA events around single launches, three
a turn) of one igd_fold_minibatch epoch over the Forest-shaped table that
chip_smoke.py uses (581,012 x 54 f32, lsq, logreg's step sizes), taken in
turns in the same run: committed, variant, committed; beside each, the
table's bytes over that time. Every variant that computes w is first held
to ref.igd_fold_minibatch_ref and to ref.igd_fold_minibatch_split_ref
(parts = its k) over the full epoch (rtol=2e-4, atol=2e-5, the three
losses), and its tile step is timed with the tile resident
(kernel.minibatch_step_probe). The card's name and power limit are
printed first.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import engine  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels._build import CudaLibrary  # noqa: E402
from repro_torch.kernels.igd_fused import kernel as K, ref as R  # noqa: E402

N, D = 581_012, 54
TOL = dict(rtol=2e-4, atol=2e-5)
LOSSES = ("lr", "svm", "lsq")

CLUSTER = f"constexpr int kMbCluster = {K.MINIBATCH_CLUSTER};"
MARGINS = "    tile_margins<LOSS, VPL>(xs, ys, as, w, cs, rows, d, warp, lane);"
PARTIAL = "    const float u = tile_partial(xs, cs, rows, d, tid);"
SEND = "    send_partial(u, recv, recv_bar, half, rank, d, tid);"
WAIT = "    mbar_wait(recv_bar + half, static_cast<uint32_t>((t >> 1) & 1));"
UPDATE = "    tile_update<VPL>(recv + half * kMbCluster * kMbMaxDim, w, d, lane);"
REARM = "    if (tid == 0 && t + 2 < n_tiles) mbar_expect_tx(recv_bar + half, partial_bytes);"


def off(line: str):
    return (line, "    if (t < 0) " + line.strip())


NO_ARITHMETIC = [off(MARGINS), (PARTIAL, "    const float u = 0.0f;"), off(UPDATE)]
NO_EXCHANGE = [off(SEND), off(WAIT), off(REARM)]
PARTIAL_LOOP = """#pragma unroll 8
    for (int r = 0; r < rows; ++r) u = fmaf(cs[r], xs[r * d + tid], u);"""
# each column's partial in four interleaved accumulators (rows r mod 4)
PARTIAL4 = [(PARTIAL_LOOP, """float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int r = 0;
#pragma unroll 2
    for (; r + 4 <= rows; r += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = fmaf(cs[r + i], xs[(r + i) * d + tid], a[i]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (r + i < rows) a[i] = fmaf(cs[r + i], xs[(r + i) * d + tid], a[i]);
    }
    u = (a[0] + a[1]) + (a[2] + a[3]);""")]
# x alone by bulk copy (y and alpha left unread: timing only)
X_ONLY = [("  mbar_expect_tx(bar, xbytes + 2 * vbytes);", "  mbar_expect_tx(bar, xbytes);"),
          ("  bulk_copy(xs + kMbRows * d, y + row0, vbytes, bar);\n", ""),
          ("  bulk_copy(xs + kMbRows * d + kMbRows, alpha + row0, vbytes, bar);\n", "")]


def with_cluster(k: int):
    return [] if k == K.MINIBATCH_CLUSTER else [(CLUSTER, f"constexpr int kMbCluster = {k};")]


KS = (1, 2, 4, 8, 16)
# name -> (k, edits, computes w)
VARIANTS = {f"copy_only_k{k}": (k, with_cluster(k) + NO_ARITHMETIC + NO_EXCHANGE, False) for k in (1, 8, 16)}
VARIANTS["copy_only_x_only"] = (K.MINIBATCH_CLUSTER, NO_ARITHMETIC + NO_EXCHANGE + X_ONLY, False)
VARIANTS["exchange_only"] = (K.MINIBATCH_CLUSTER, NO_ARITHMETIC, False)
VARIANTS["no_exchange"] = (K.MINIBATCH_CLUSTER, NO_EXCHANGE, False)
VARIANTS["partial4"] = (K.MINIBATCH_CLUSTER, PARTIAL4, True)
VARIANTS.update({f"cluster_k{k}": (k, with_cluster(k), True) for k in KS if k != K.MINIBATCH_CLUSTER})


# the column-slice cluster's variants (--slice): name -> (edits, computes w)
SLICE_SHAPES = ((8_192, 12_033), (65_536, 1_000))
S_MARGINS = [f"            slice_margins<{k}>(xs, w + ch * panel, margins + p * prows, rp, len, ldp, e0, dm, ch > 0, "
             "cw, lane);" for k in (4, 2, 1)]
S_PUSH = "      push_margins(margins, recv, recv_bar, half, rank, ct);"
S_TAKE = """      take_margins<LOSS>(recv, recv_bar, cs, half, static_cast<uint32_t>((t >> 1) & 1), rows, yv, av, ct,
                         t + 2 < n_tiles);"""
S_UPDATE = "            slice_update<false>(kept, nullptr, cs, r0, r1, ldp, e0, dm, d, j, false, u0, u1);"
S_UPDATE_L2 = "            slice_update<true>(nullptr, x + row0 * d + j0 + ch * panel, cs, r0, r1, ldp, e0, dm, d, j,"


def s_off(line: str):
    indent = line[:len(line) - len(line.lstrip())]
    return (line, indent + "if (t < 0) " + line.strip())


S_NO_ARITHMETIC = [s_off(m) for m in S_MARGINS] + [s_off(S_UPDATE), s_off(S_UPDATE_L2)]
S_NO_EXCHANGE = [s_off(S_PUSH), s_off(S_TAKE)]
# clock64 in rank 0's consumer thread 0 at the tile's phase boundaries, summed over the tiles and left in
# w[0..3] (timing only): the wait for the tile's copies, pass 1, the exchange, pass 2
S_CLOCKS = [
    ("    if (resident) fetch_tile(0);\n",
     "    if (resident) fetch_tile(0);\n    long long clk[4] = {0, 0, 0, 0}, clk_t = clock64();\n"),
    ("        consumers_sync();\n      }\n      // pass 1:",
     "        consumers_sync();\n      }\n      clk[0] += clock64() - clk_t; clk_t = clock64();\n      // pass 1:"),
    ("      consumers_sync();  // margins complete\n",
     "      consumers_sync();  // margins complete\n      clk[1] += clock64() - clk_t; clk_t = clock64();\n"),
    ("      consumers_sync();  // c complete\n",
     "      consumers_sync();  // c complete\n      clk[2] += clock64() - clk_t; clk_t = clock64();\n"),
    ("      consumers_sync();  // w complete for the next tile's margins\n",
     "      consumers_sync();  // w complete for the next tile's margins\n      clk[3] += clock64() - clk_t; "
     "clk_t = clock64();\n"),
    ("""        for (int j = ct; j < len; j += kMsConsumers) wout[j0 + ch * panel + j] = w[ch * panel + j];
      }
    }
""", """        for (int j = ct; j < len; j += kMsConsumers) wout[j0 + ch * panel + j] = w[ch * panel + j];
      }
    }
    consumers_sync();
    if (rank == 0 && ct == 0) {
      for (int k = 0; k < 4; ++k) wout[k] = static_cast<float>(clk[k]);
    }
"""),
]
SLICE_VARIANTS = {
    "slice_clocks": (S_CLOCKS, False),
    "slice_copy_only": (S_NO_ARITHMETIC + S_NO_EXCHANGE, False),
    "slice_exchange_only": (S_NO_ARITHMETIC, False),
    "slice_no_exchange": (S_NO_EXCHANGE, False),
    "slice_panel512": ([("constexpr int kMsMaxPanel = 2 * kMsConsumers;", "constexpr int kMsMaxPanel = kMsConsumers;")],
                       True),
}


def variant(name: str, k: int, edits) -> CudaLibrary:
    text = K.SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: the source no longer contains {old!r}")
        text = text.replace(old, new)
    path = ROOT / "build" / "variants" / f"mb_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return CudaLibrary(f"mb_{name}", path, functools.partial(K._declare, cluster=k))


def declare_entry(lib) -> None:
    """Types of igd_fold_minibatch_launch alone, for a source of another
    commit, which need not have this one's other entries (it must take
    the lane arguments: lanes, x/y lane rows, alpha lane stride)."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.igd_fold_minibatch_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i64, i64, ptr]
    lib.igd_fold_minibatch_launch.restype = i32
    lib.igd_fused_error_string.argtypes = [i32]
    lib.igd_fused_error_string.restype = ctypes.c_char_p


def minibatch(lib: CudaLibrary, x, y, alpha, w0, loss: str):
    out = torch.empty_like(w0)
    rc = lib.load().igd_fold_minibatch_launch(x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w0.data_ptr(),
                                              out.data_ptr(), x.shape[0], x.shape[1], K.LOSS_IDS[loss],
                                              1, 0, 0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{lib.name}: CUDA error {rc} ({lib.load().igd_fused_error_string(rc).decode()})")
    return out


def launch_ms(fn, calls: int = 3) -> list:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def step_cycles(lib: CudaLibrary, loss: str = "lsq") -> tuple:
    """(cycles, seconds) a tile of the variant's step with the tile resident."""
    saved, K._load = K._load, lib.load
    try:
        return K.minibatch_step_probe(loss, D)
    finally:
        K._load = saved


def slice_main(only) -> int:
    """The column-slice cluster's variants at SLICE_SHAPES (see --slice)."""
    chosen = {name: v for name, v in SLICE_VARIANTS.items() if not only or name in only}
    libs = {"committed": (K.LIBRARY, True)}
    libs.update({name: (variant(name, K.MINIBATCH_CLUSTER, edits), computes)
                 for name, (edits, computes) in chosen.items()})
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda v: v[0].build(), libs.values()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, d in SLICE_SHAPES:
        x = torch.randn((n, d), generator=gen, device="cuda") / d ** 0.5
        y = torch.sign(torch.randn((n,), generator=gen, device="cuda"))
        alpha = engine.get("least_squares").step_size(n)(torch.arange(n, dtype=torch.int32, device="cuda"))
        w0 = torch.zeros(d, device="cuda")
        nbytes = n * (d + 2) * 4
        want = R.igd_fold_minibatch_ref(x, y, alpha, w0, loss="lsq")
        for name, (lib, computes) in libs.items():
            if computes:
                torch.testing.assert_close(minibatch(lib, x, y, alpha, w0, "lsq"), want, **TOL,
                                           msg=lambda m, name=name: f"{name} {n}x{d}: {m}")
        committed = lambda: minibatch(libs["committed"][0], x, y, alpha, w0, "lsq")  # noqa: E731
        own = launch_ms(committed)
        mean = sum(own) / len(own)
        print(f"column-slice committed at {n}x{d} lsq: {mean:.4f} ms/launch ({', '.join(f'{t:.4f}' for t in own)}), "
              f"{nbytes / mean / 1e6:.1f} GB/s of the table; byte bound {nbytes / 3.35e9:.4f} ms; design "
              f"{K.minibatch_slice_design(d)}", flush=True)
        for name, (lib, computes) in libs.items():
            if name == "committed":
                continue
            run = lambda lib=lib: minibatch(lib, x, y, alpha, w0, "lsq")  # noqa: E731
            if name == "slice_clocks":
                tiles = -(-n // K.TILE)
                cycles = [float(v) / tiles for v in run()[:4].cpu()]
                print(f"column-slice clocks at {n}x{d} (rank 0, cycles a tile): copies' wait {cycles[0]:.0f}, "
                      f"pass 1 {cycles[1]:.0f}, exchange {cycles[2]:.0f}, pass 2 {cycles[3]:.0f}", flush=True)
                continue
            first, own, second = launch_ms(committed), launch_ms(run), launch_ms(committed)
            mean = sum(own) / len(own)
            print(f"column-slice {name} at {n}x{d} lsq: {mean:.4f} ms/launch ({', '.join(f'{t:.4f}' for t in own)}), "
                  f"{nbytes / mean / 1e6:.1f} GB/s of the table{'' if computes else ' (timing only)'}; committed in "
                  f"turns {', '.join(f'{t:.4f}' for t in first + second)}", flush=True)
        del x, y, alpha
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", help="variants to run (default: all)")
    ap.add_argument("--against", type=Path, help="another igd_fused.cu to time in the same turns")
    ap.add_argument("--slice", action="store_true", help="the column-slice cluster's variants (D > 256)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_minibatch_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, f"| torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.slice:
        return slice_main(args.only)
    chosen = {name: v for name, v in VARIANTS.items() if not args.only or name in args.only}
    libs = {"committed": (K.MINIBATCH_CLUSTER, K.LIBRARY, True)}
    libs.update({name: (k, variant(name, k, edits), computes) for name, (k, edits, computes) in chosen.items()})
    if args.against:
        libs["against"] = (None, CudaLibrary("mb_against", args.against.resolve(), declare_entry), True)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda v: v[1].build(), libs.values()))

    gen = torch.Generator(device="cuda").manual_seed(0)
    table = synthetic.dense_classification(gen, N, D)
    x, y = table["x"], table["y"]
    alpha = engine.get("logreg").step_size(N)(torch.arange(N, dtype=torch.int32, device="cuda"))
    w0 = torch.zeros(D, device="cuda")
    nbytes = N * (D + 2) * 4
    n_tiles = -(-N // K.TILE)
    want = {loss: R.igd_fold_minibatch_ref(x, y, alpha, w0, loss=loss) for loss in LOSSES}
    for name, (k, lib, computes) in libs.items():
        if not computes:
            cycles, seconds = step_cycles(lib)
            print(f"{name} (k={k}, timing only): tile step resident {cycles:.0f} cycles, {seconds * 1e6:.3f} us",
                  flush=True)
            continue
        errs = []
        for loss in LOSSES:
            got = minibatch(lib, x, y, alpha, w0, loss)
            plains = [want[loss]]
            if k is not None:
                plains.append(R.igd_fold_minibatch_split_ref(x, y, alpha, w0, loss=loss, parts=k))
            errs.append(max(float((got - plain).abs().max()) for plain in plains))
            for plain in plains:
                torch.testing.assert_close(got, plain, **TOL, msg=lambda m: f"{name} {loss}: {m}")
        if k is None:
            print(f"{name} ({args.against}): vs the plain fold over {N}x{D} (lr, svm, lsq) max |err| "
                  f"{', '.join(f'{e:.3g}' for e in errs)}", flush=True)
            continue
        cycles, seconds = step_cycles(lib)
        print(f"{name} (k={k}): vs the plain and split folds over {N}x{D} (lr, svm, lsq) max |err| "
              f"{', '.join(f'{e:.3g}' for e in errs)}; tile step resident {cycles:.0f} cycles, "
              f"{seconds * 1e6:.3f} us -> floor {n_tiles * seconds * 1e3:.3f} ms for {n_tiles} tiles", flush=True)

    committed = lambda: minibatch(libs["committed"][1], x, y, alpha, w0, "lsq")  # noqa: E731
    own = launch_ms(committed)
    print(f"igd_fold_minibatch committed (k={K.MINIBATCH_CLUSTER}): {sum(own) / len(own):.4f} ms/launch at "
          f"{N}x{D} lsq ({', '.join(f'{t:.4f}' for t in own)})", flush=True)
    for name, (k, lib, _) in libs.items():
        if name == "committed":
            continue
        run = lambda lib=lib: minibatch(lib, x, y, alpha, w0, "lsq")  # noqa: E731
        first, own, second = launch_ms(committed), launch_ms(run), launch_ms(committed)
        mean = sum(own) / len(own)
        print(f"igd_fold_minibatch {name} (k={k}): {mean:.4f} ms/launch at {N}x{D} lsq "
              f"({', '.join(f'{t:.4f}' for t in own)}), {nbytes / mean / 1e6:.1f} GB/s of the table; committed "
              f"in turns {', '.join(f'{t:.4f}' for t in first + second)}", flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
