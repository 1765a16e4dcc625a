#!/usr/bin/env python3
"""Time variants of the port's igd_fold kernel beside the committed one, on one CUDA card.

    python3 scripts/torch_igd_variants.py [--wide | --middle] [VARIANT ...]

Run from the repository root on a machine with a Hopper card. Each variant
is the committed CUDA source (src/repro_torch/kernels/igd_fused/csrc/
igd_fused.cu) with a few textual changes, built into the git-ignored
build/variants/ (all sources at once, one nvcc each) and launched through
its own library. VARIANT names the variants to time (default: all of the
mode's).

Without --wide, the tiled Gram instance (D <= 256). Times are device ms
per launch (CUDA events around single launches, three a turn) of one
igd_fold epoch over the Forest-shaped table that chip_smoke.py uses
(581,012 x 54 f32, lr, logreg's step sizes), taken in turns in the same
run: committed, each variant, committed. Every variant is first held to
the per-row plain fold on a 16,384-row prefix (rtol=2e-4, atol=2e-5, the
three losses), and the committed kernel and each variant of the lr scale
also to a float64 fold on a 65,536-row prefix; two variants are for
timing only and give wrong results (no products, no shuffle). Each
variant's chain is timed alone too (its grad_scale + FMA floor, cycles a
step in one warp), and the committed kernel is also timed for svm and
lsq.

With --wide, the wide instance (D > 4,096). Times are device ms a call
(CUDA events around 3 calls a turn) of one igd_fold epoch over WIDE_ROWS
rows at D 4,097 (lr) and 12,033 (lsq), the wide tables chip_smoke.py runs,
taken in turns: committed, then each variant, the whole round twice.
Variants that keep the arithmetic are first held to the tiled plain fold
(rtol=2e-4, atol=2e-5); the timing-only ones leave a part of the work out
and give wrong results. Each line gives a variant's turns and its ratio to
the committed kernel's mean in the same rounds; `clocks` prints the
cluster kernel's cycles a step in rank 0.

With --middle, the middle instance (256 < D <= 4,096) in the same way, at
MIDDLE_SHAPES: chip_smoke.py's 65,536 x 1,000 and 16,384 x 4,096, and
16,384 rows at D 300, 600, 2,000 and 3,000, where other slice caps pick
other cluster sizes. `ring16` is the wide instance moved down to D 257 as it
is (16 CTAs, panels streamed twice through a ring of bulk copies, the
pre-pass in four parts): the baseline the middle design is held to.

The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import ctypes
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
PREFIX, F64_PREFIX = 16_384, 65_536
TOL = dict(rtol=2e-4, atol=2e-5)
LR_SCALE = "  if (LOSS == kLossLr) return -y * (1.0f / (1.0f + expf(m)));  // -y*sigmoid(-m)"

TIMING_ONLY = ("products_idle", "no_shuffle", "no_chain_loads", "bare_chain", "no_chain", "no_q", "no_w_update",
               "loads_only")
CHAIN = "        chain<LOSS>(r, gram"
NO_CHAIN = "        if (s < -1) chain<LOSS>(r, gram"
Q = "      if (vw == 0 && t < n_sub) prod["
NO_Q = "      if (vw == 0 && t < n_sub && s < -1) prod["
W_UPDATE = "      if (s > 0) {  // w_s = w_{s-1} - X_{s-1}^T c_{s-1}"
NO_W_UPDATE = "      if (s > 0 && s < -1) {  // w_s = w_{s-1} - X_{s-1}^T c_{s-1}"
CHAIN_LOADS = "    const float gn = next[lane], sn = next[k + 2], yn = ys[k + 1], an = as[k + 1];"
NO_CHAIN_LOADS = "    const float gn = gk, sn = sk, yn = yk, an = ak;"
PRODUCTS = "      if (t < n_sub) {  // G_t"
NO_PRODUCTS = "      if (t < n_sub && s < -1) {  // G_t"
IEEE_MATH = ("ieee_math", "expf_frcp_rn", "fast_expf_frcp_rn")  # held to a float64 fold too
CHAIN_STEP = "    const float c = grad_scale_fast<LOSS>(rk, yk) * ak;"
PROBE_STEP = "    const float c = grad_scale_fast<LOSS>(r, yv) * av;"
LR_FAST = "  if (LOSS == kLossLr) return -y * __fdividef(1.0f, 1.0f + __expf(y * wx));"
# (old, new) edits of csrc/igd_fused.cu
VARIANTS = {
    # the chain's lr scale in IEEE expf and division (grad_scale), probe included
    "ieee_math": [(CHAIN_STEP, CHAIN_STEP.replace("grad_scale_fast", "grad_scale")),
                  (PROBE_STEP, PROBE_STEP.replace("grad_scale_fast", "grad_scale"))],
    # IEEE expf with __frcp_rn (round to nearest, as 1.0f / x is)
    "expf_frcp_rn": [(LR_FAST, "  if (LOSS == kLossLr) return -y * __frcp_rn(1.0f + expf(y * wx));")],
    # __expf with __frcp_rn
    "fast_expf_frcp_rn": [(LR_FAST, "  if (LOSS == kLossLr) return -y * __frcp_rn(1.0f + __expf(y * wx));")],
    # the broadcast of r_k on the chain: one shuffle before every grad_scale
    "shuffle_on_chain": [(CHAIN_STEP, "    rk = __shfl_sync(kFull, r, k);\n" + CHAIN_STEP)],
    # the products' column loop not unrolled
    "product_unroll_1": [("#pragma unroll 2  // one step's loads beside the other's FMAs\n",
                          "#pragma unroll 1\n")],
    # the chain's loop unrolled by 1 and by 4 instead of 8
    "unroll_1": [("#pragma unroll 8\n  for (int k = 0; k < m; ++k) {", "#pragma unroll 1\n  for (int k = 0; k < m; ++k) {")],
    "unroll_4": [("#pragma unroll 8\n  for (int k = 0; k < m; ++k) {", "#pragma unroll 4\n  for (int k = 0; k < m; ++k) {")],
    # timing only (wrong results): no G, C or q is formed, so warp 0 runs
    # its chain beside warps that only load and update w
    "products_idle": [(PRODUCTS, NO_PRODUCTS), (Q, NO_Q)],
    # timing only (wrong results): each of the step's jobs left out in turn,
    # and all of them (the stage loads, the barriers and the loop remain)
    "no_chain": [(CHAIN, NO_CHAIN)],
    "no_q": [(Q, NO_Q)],
    "no_w_update": [(W_UPDATE, NO_W_UPDATE)],
    "loads_only": [(CHAIN, NO_CHAIN), (Q, NO_Q), (W_UPDATE, NO_W_UPDATE), (PRODUCTS, NO_PRODUCTS)],
    # timing only (wrong results): no shuffle of r in the chain
    "no_shuffle": [("    ahead = __shfl_sync(kFull, r, k + 2);", "    ahead = r;")],
    # timing only (wrong results): the chain loads no operands (it reuses the first ones)
    "no_chain_loads": [(CHAIN_LOADS, NO_CHAIN_LOADS)],
    # timing only (wrong results): the chain alone in the kernel, with no
    # loads or shuffle in it and no products beside it
    "bare_chain": [(CHAIN_LOADS, NO_CHAIN_LOADS), ("    ahead = __shfl_sync(kFull, r, k + 2);", "    ahead = r;"),
                   (PRODUCTS, NO_PRODUCTS)],
}

WIDE_ROWS = 8_192
WIDE_SHAPES = ((4_097, "lr"), (12_033, "lsq"))

PREPASS = "  if (n > 0) {  // pass 1: every segment's G and C, over the whole card"
WIDE_CHAIN = "        chain<LOSS>(r, gram + (s & 1) * kSub * kSub, ysb"
PASSES = "          panel_pass(wc, us, qs, ou,"
PREFETCH = "      if (!RESIDENT) prefetch_sub(t + kFcPrefetchAhead);"
RING = "constexpr int kFcRingMin = 3, kFcRingMax = 8;"
SPLIT = "constexpr int kPpSplit = 4;"
# clock64 in rank 0 of the cluster kernel, cycles a step: warp 0's chain,
# its C c and wait for q, its p, its barrier wait; the first consumer warp's panels,
# its q reduction and send, its barrier wait, and its work before the panels
# (G, C, y and alpha's copies issued, the L2 prefetch). Written over the
# output's first eight floats (timing only).
CLOCKS = [
    ("    float r = 0.0f;  // lane j holds row j's p of the coming sub-tile\n"
     "    for (int s = -1; s < n_sub; ++s) {\n      const int t = s + 1;\n",
     "    float r = 0.0f;  // lane j holds row j's p of the coming sub-tile\n"
     "    long long kc = 0, kq = 0, kp = 0, kb = 0;\n"
     "    for (int s = -1; s < n_sub; ++s) {\n      const int t = s + 1;\n      const long long c0 = clock64();\n"),
    ("        __syncwarp();  // every lane's c_s is in shared memory\n      }\n",
     "        __syncwarp();  // every lane's c_s is in shared memory\n      }\n"
     "      const long long c1 = clock64();\n      long long c2 = c1;\n"),
    ("        mbar_wait(recv_bar + (t & 1), static_cast<uint32_t>((t >> 1) & 1));\n        const float* qb",
     "        mbar_wait(recv_bar + (t & 1), static_cast<uint32_t>((t >> 1) & 1));\n        c2 = clock64();\n"
     "        const float* qb"),
    ("        r = part_q[0] - cc;\n      }\n      asm volatile(\"bar.sync 2, %0;\\n\" ::\"n\"(kFcStepThreads) : \"memory\");\n    }\n",
     "        r = part_q[0] - cc;\n      }\n      const long long c3 = clock64();\n"
     "      asm volatile(\"bar.sync 2, %0;\\n\" ::\"n\"(kFcStepThreads) : \"memory\");\n"
     "      const long long c4 = clock64();\n      kc += c1 - c0; kq += c2 - c1; kp += c3 - c2; kb += c4 - c3;\n    }\n"
     "    if (lane == 0) { fc_dbg[0] = kc; fc_dbg[1] = kq; fc_dbg[2] = kp; fc_dbg[3] = kb; }\n"),
    ("      panels(s, acc);\n",
     "      const long long d0 = clock64();\n      panels(s, acc);\n      const long long d1 = clock64();\n"),
    ("      cp_async_wait_all();\n      asm volatile(\"bar.sync 2, %0;\\n\" ::\"n\"(kFcStepThreads) : \"memory\");"
     "  // c_s, G_t, C_t+1 visible\n    }\n",
     "      const long long d2 = clock64();\n      cp_async_wait_all();\n"
     "      asm volatile(\"bar.sync 2, %0;\\n\" ::\"n\"(kFcStepThreads) : \"memory\");\n"
     "      const long long d3 = clock64();\n      kpan += d1 - d0; kred += d2 - d1; kbar += d3 - d2; kpre += d0 - ds;\n"
     "    }\n    if (ct == 0) { fc_dbg[4] = kpan; fc_dbg[5] = kred; fc_dbg[6] = kbar; fc_dbg[7] = kpre; }\n"),
    ("    for (int s = -1; s < n_sub; ++s) {\n      const int t = s + 1;\n      if (t + 1 < n_sub) {",
     "    long long kpan = 0, kred = 0, kbar = 0, kpre = 0;\n"
     "    for (int s = -1; s < n_sub; ++s) {\n      const int t = s + 1;\n      const long long ds = clock64();\n"
     "      if (t + 1 < n_sub) {"),
    ("  cluster.sync();  // no CTA leaves while its partials may still be in flight\n}",
     "  cluster.sync();  // no CTA leaves while its partials may still be in flight\n"
     "  if (rank == 0 && tid == 0) {\n    for (int i = 0; i < 8; ++i) wout[i] = static_cast<float>(fc_dbg[i]) / (n_sub + 1);\n  }\n}"),
    ("  extern __shared__ __align__(16) unsigned char fc_smem[];\n  const int n_sub",
     "  extern __shared__ __align__(16) unsigned char fc_smem[];\n  __shared__ long long fc_dbg[8];\n  const int n_sub"),
]
WIDE_TIMING_ONLY = ("no_prepass", "no_chain", "no_pass", "no_copies", "clocks")
WIDE_VARIANTS = {
    # timing only: the cluster kernel without the pre-pass (G and C unset)
    "no_prepass": [(PREPASS, PREPASS.replace("n > 0", "n < 0"))],
    # timing only: every chain left out (the panels, the exchange and the pre-pass alone)
    "no_chain": [(WIDE_CHAIN, "        if (s < -1) chain<LOSS>(r, gram + (s & 1) * kSub * kSub, ysb")],
    # timing only: the consumers' arithmetic on the panels left out (the panels still stream through)
    "no_pass": [(PASSES, "          if (jb < 0) panel_pass(wc, us, qs, ou,")],
    # timing only: no bulk copies (the panels arrive empty at once; the rest runs as it does)
    "no_copies": [("  const uint32_t total = __reduce_add_sync(kFull, bytes);",
                   "  const uint32_t total = 0 * __reduce_add_sync(kFull, bytes);"),
                  ("  if (bytes) bulk_copy(", "  if (bytes && lane < 0) bulk_copy(")],
    "no_prefetch": [(PREFETCH, "")],
    "clocks": CLOCKS,
    "ring_max4": [(RING, "constexpr int kFcRingMin = 3, kFcRingMax = 4;")],
    "prepass_split1": [(SPLIT, "constexpr int kPpSplit = 1;")],
    "prepass_split2": [(SPLIT, "constexpr int kPpSplit = 2;")],
    "prepass_split5": [(SPLIT, "constexpr int kPpSplit = 5;")],
    "prepass_split8": [(SPLIT, "constexpr int kPpSplit = 8;")],
}

MIDDLE_ROWS = 16_384
# (N, D, loss): chip_smoke.py's MIDDLE_SHAPES, then D where another slice cap picks another cluster size
MIDDLE_SHAPES = ((65_536, 1_000, "lr"), (16_384, 4_096, "lr"), (MIDDLE_ROWS, 300, "lr"), (MIDDLE_ROWS, 600, "lr"),
                 (MIDDLE_ROWS, 2_000, "lr"), (MIDDLE_ROWS, 3_000, "lr"))
MIDDLE_CTAS = ("  int ctas = 1;\n  while (ctas < kFcCluster && (d + ctas - 1) / ctas > kFmMaxSlice) ctas *= 2;\n"
               "  return ctas;")
MAX_SLICE = "constexpr int kFmMaxSlice = 128;"
SLOTS = "constexpr int kFmSlots = 5;"
MIDDLE_TIMING_ONLY = ("no_prepass", "no_chain", "no_pass", "no_copies", "clocks")
MIDDLE_VARIANTS = {
    # the baseline: the wide instance as it is (16 CTAs, the ring, the pre-pass in four parts) from D 257
    "ring16": [("int prepass_split(int d) { return d > kFoldMaxDim ?",
                "int prepass_split(int d) { return d > kGramMaxDim ?"),
               ("  if (d > kFoldMaxDim) {\n    const FoldPanels pn = fold_panels(",
                "  if (d > kGramMaxDim) {\n    const FoldPanels pn = fold_panels(")],
    # the alternative: the look-ahead in one CTA a lane (G and C from the pre-pass, as the one-block Gram
    # instance's design carried past D 256), the rows streamed twice through a ring of panels
    "one_cta_ring": [("  const FoldPanels pn = middle_panels(d);\n  switch (pn.ctas) {",
                      "  if (d > 0) {\n    const FoldPanels pn = fold_panels(d, 1);\n"
                      "    REPRO_FOLD_CLUSTER(1, true, false);\n  }\n  const FoldPanels pn = middle_panels(d);\n"
                      "  switch (pn.ctas) {")],
    # the resident design on 16 CTAs at every D
    "ctas16": [(MIDDLE_CTAS, "  return 16;")],
    # other caps on a CTA's columns (so other cluster sizes)
    "max_slice_64": [(MAX_SLICE, "constexpr int kFmMaxSlice = 64;")],
    "max_slice_192": [(MAX_SLICE, "constexpr int kFmMaxSlice = 192;")],
    "max_slice_256": [(MAX_SLICE, "constexpr int kFmMaxSlice = 256;")],
    "max_slice_384": [(MAX_SLICE, "constexpr int kFmMaxSlice = 384;")],
    # four resident slots (each sub-tile copied one step ahead of its q, not two)
    "slots4": [(SLOTS, "constexpr int kFmSlots = 4;")],
    # the wide instance's L2 prefetch of the sub-tile two steps ahead, on in the middle instance too
    "l2_prefetch": [(PREFETCH, "      prefetch_sub(t + kFcPrefetchAhead);"),
                    ("    for (int v = 0; !RESIDENT && v < kFcPrefetchAhead; ++v) prefetch_sub(v);",
                     "    for (int v = 0; v < kFcPrefetchAhead; ++v) prefetch_sub(v);")],
    "no_prepass": WIDE_VARIANTS["no_prepass"],
    "no_chain": WIDE_VARIANTS["no_chain"],
    "no_pass": WIDE_VARIANTS["no_pass"],
    # timing only: no copies of the rows (the slots hold whatever they held)
    "no_copies": WIDE_VARIANTS["no_copies"],
    "clocks": CLOCKS,
}


def variant(name: str, edits, declare=K._declare) -> CudaLibrary:
    text = K.SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: the source no longer contains {old!r}")
        text = text.replace(old, new, 1)  # the first: the Gram instance precedes the wide one
    path = ROOT / "build" / "variants" / f"igd_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return CudaLibrary(f"igd_{name}", path, declare)


def declare_fold(lib) -> None:
    """Types of the entries a cluster-fold round calls (a variant may pick
    cluster sizes that kernel.py's own check of the library refuses)."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.igd_fold_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i64, i64, ptr, ptr]
    lib.igd_fold_launch.restype = i32
    lib.igd_fused_fold_scratch_floats.argtypes = [i64, i32, i32, i64, i32]
    lib.igd_fused_fold_scratch_floats.restype = i64
    lib.igd_fused_error_string.argtypes = [i32]
    lib.igd_fused_error_string.restype = ctypes.c_char_p


def fold(lib: CudaLibrary, x, y, alpha, w0, loss: str):
    handle = lib.load()
    out = torch.empty_like(w0)
    floats = handle.igd_fused_fold_scratch_floats(x.shape[0], x.shape[1], 1, 0, 1)  # none at D <= 4,096
    scratch = torch.empty(floats, device=x.device) if floats else None
    rc = handle.igd_fold_launch(x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w0.data_ptr(), out.data_ptr(),
                                x.shape[0], x.shape[1], K.LOSS_IDS[loss], 1, 0, 0,
                                scratch.data_ptr() if floats else None, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{lib.name}: CUDA error {rc} ({handle.igd_fused_error_string(rc).decode()})")
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


def chain_cycles(lib: CudaLibrary, loss: str = "lr", steps: int = 1 << 16) -> float:
    """Cycles a step of the variant's chain alone, as K.chain_probe times it."""
    saved, K._load = K._load, lib.load
    try:
        return K.chain_probe(loss, steps=steps)[0]
    finally:
        K._load = saved


def turn_ms(fn, calls: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--wide", action="store_true", help="the wide instance's variants (D 4,097 and 12,033)")
    mode.add_argument("--middle", action="store_true", help="the middle instance's variants (256 < D <= 4,096)")
    ap.add_argument("variants", nargs="*", help="variants to time (default: all of the mode's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_igd_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, f"| torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    clock_hz = float(smi.split(",")[2].split()[0]) * 1e6
    variants = WIDE_VARIANTS if args.wide else MIDDLE_VARIANTS if args.middle else VARIANTS
    unknown = sorted(set(args.variants) - set(variants))
    if unknown:
        ap.error(f"unknown variants {unknown}; valid: {sorted(variants)}")
    prefix = "wide_" if args.wide else "middle_" if args.middle else ""
    declare = declare_fold if args.wide or args.middle else K._declare
    libs = {"committed": K.LIBRARY}
    libs.update({name: variant(prefix + name, variants[name], declare) for name in args.variants or variants})
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.wide:
        wide_rounds(libs, tuple((WIDE_ROWS, d, loss) for d, loss in WIDE_SHAPES), WIDE_TIMING_ONLY)
    elif args.middle:
        wide_rounds(libs, MIDDLE_SHAPES, MIDDLE_TIMING_ONLY)
    else:
        gram_rounds(libs, clock_hz)
    print(smi)
    return 0


def gram_rounds(libs: dict, clock_hz: float) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = synthetic.dense_classification(gen, N, D)
    x, y = table["x"], table["y"]
    alpha = engine.get("logreg").step_size(N)(torch.arange(N, dtype=torch.int32, device="cuda"))
    w0 = torch.zeros(D, device="cuda")
    prefix = [t[:PREFIX] for t in (x, y, alpha)] + [w0]
    prefix_cpu = [t.cpu() for t in prefix]
    want = {loss: R.igd_fold_ref(*prefix_cpu, loss=loss) for loss in ("lr", "svm", "lsq")}
    long = [t[:F64_PREFIX] for t in (x, y, alpha)] + [w0]
    exact = {loss: R.igd_fold_ref(*(t.cpu().double() for t in long), loss=loss) for loss in ("lr", "svm", "lsq")}
    for name, lib in libs.items():
        if name in TIMING_ONLY:
            continue
        errs = []
        for loss, w in want.items():
            got = fold(lib, *prefix, loss).cpu()
            errs.append(float((got - w).abs().max()))
            torch.testing.assert_close(got, w, **TOL, msg=lambda m: f"{name} {loss}: {m}")
        note = ""
        if name == "committed" or name in IEEE_MATH:
            f64 = []
            for loss, w in exact.items():
                got = fold(lib, *long, loss).cpu().double()
                f64.append(float((got - w).abs().max()))
                torch.testing.assert_close(got, w, **TOL, msg=lambda m: f"{name} {loss} vs float64: {m}")
            note = f"; vs a float64 fold on {F64_PREFIX} rows (lr, svm, lsq) {', '.join(f'{e:.3g}' for e in f64)}"
        print(f"{name}: vs the per-row fold on {PREFIX} rows (lr, svm, lsq) max |err| "
              f"{', '.join(f'{e:.3g}' for e in errs)}{note}; chain alone {chain_cycles(lib):.1f} cycles/step (lr)",
              flush=True)

    for loss in ("svm", "lsq"):
        own = launch_ms(lambda: fold(libs["committed"], x, y, alpha, w0, loss))
        mean = sum(own) / len(own)
        print(f"igd_fold committed, {loss}: {mean:.3f} ms/launch ({', '.join(f'{t:.3f}' for t in own)}), "
              f"{mean * 1e-3 * clock_hz / N:.1f} cycles/row; chain alone "
              f"{chain_cycles(libs['committed'], loss):.1f} cycles/step", flush=True)
    committed = lambda: fold(libs["committed"], x, y, alpha, w0, "lr")  # noqa: E731
    for name, lib in libs.items():
        if name == "committed":
            continue
        run = lambda lib=lib: fold(lib, x, y, alpha, w0, "lr")  # noqa: E731
        first, own, second = launch_ms(committed), launch_ms(run), launch_ms(committed)
        mean = sum(own) / len(own)
        print(f"igd_fold {name}: {mean:.3f} ms/launch at {N}x{D} lr ({', '.join(f'{t:.3f}' for t in own)}), "
              f"{mean * 1e-3 * clock_hz / N:.1f} cycles/row; committed in turns "
              f"{', '.join(f'{t:.3f}' for t in first + second)}", flush=True)


def wide_rounds(libs: dict, shapes, timing_only) -> None:
    """The cluster folds' rounds at (N, D, loss) in ``shapes``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, d, loss in shapes:
        x = torch.randn((n, d), generator=gen, device="cuda") / d ** 0.5
        y = torch.sign(torch.randn((n,), generator=gen, device="cuda"))
        alpha = engine.get("logreg").step_size(n)(torch.arange(n, dtype=torch.int32, device="cuda"))
        w0 = torch.zeros(d, device="cuda")
        want = R.igd_fold_tiled_ref(x, y, alpha, w0, loss=loss)
        for name, lib in libs.items():
            if name not in timing_only:
                torch.testing.assert_close(fold(lib, x, y, alpha, w0, loss), want, **TOL)
        turns = {name: [] for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                turns[name].append(turn_ms(lambda lib=lib: fold(lib, x, y, alpha, w0, loss)))
        base = sum(turns["committed"]) / 2
        for name, times in turns.items():
            mean = sum(times) / len(times)
            print(f"{n}x{d} {loss} {name}: {', '.join(f'{t:.4f}' for t in times)} ms; {mean / base:.3f}x "
                  f"the committed kernel ({base:.4f} ms){' [timing only]' if name in timing_only else ''}",
                  flush=True)
        if "clocks" in libs:
            got = fold(libs["clocks"], x, y, alpha, w0, loss)[:8].tolist()
            print(f"{n}x{d} {loss} clocks a step in rank 0 (cycles): warp 0 chain {got[0]:.0f}, C c and the "
                  f"wait for q {got[1]:.0f}, p {got[2]:.0f}, barrier {got[3]:.0f}; first consumer warp before the "
                  f"panels {got[7]:.0f}, panels {got[4]:.0f}, q reduce and send {got[5]:.0f}, barrier {got[6]:.0f}",
                  flush=True)
        if "no_prepass" in turns:
            rest = sum(turns["no_prepass"]) / 2
            print(f"{n}x{d} {loss}: the pre-pass takes about {base - rest:.4f} ms of {base:.4f} "
                  f"(committed less no_prepass)", flush=True)
        del x, y, alpha


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
