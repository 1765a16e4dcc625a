#!/usr/bin/env python3
"""Time variants of the port's igd_fold kernel beside the committed one, on one CUDA card.

    python3 scripts/torch_igd_variants.py

Run from the repository root on a machine with a Hopper card. Each variant
is the committed CUDA source (src/repro_torch/kernels/igd_fused/csrc/
igd_fused.cu) with a few textual changes, built into the git-ignored
build/variants/ and launched through its own library. Times are device ms
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
lsq. The card's name and power limit are printed first.
"""

from __future__ import annotations

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
    # the per-row chain of the D > 256 instance (one warp, w in registers, a shuffle butterfly per row) at D <= 256
    "per_row_chain": [
        ("  if (d <= kGramMaxDim) {\n    return launch_gram", "  if (d < 1) {\n    return launch_gram"),
        ("    vpl = d <= kWarp * 16 ? 16 : 32;", "    vpl = 1;\n    while (vpl * kWarp < d) vpl *= 2;"),
        ("  REPRO_FOLD_CASE(16, 1)\n",
         "  REPRO_FOLD_CASE(1, 1)\n  REPRO_FOLD_CASE(2, 1)\n  REPRO_FOLD_CASE(4, 1)\n"
         "  REPRO_FOLD_CASE(8, 1)\n  REPRO_FOLD_CASE(16, 1)\n"),
    ],
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


def variant(name: str, edits) -> CudaLibrary:
    text = K.SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: the source no longer contains {old!r}")
        text = text.replace(old, new)
    path = ROOT / "build" / "variants" / f"igd_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return CudaLibrary(f"igd_{name}", path, K._declare)


def fold(lib: CudaLibrary, x, y, alpha, w0, loss: str):
    out = torch.empty_like(w0)
    rc = lib.load().igd_fold_launch(x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w0.data_ptr(),
                                    out.data_ptr(), x.shape[0], x.shape[1], K.LOSS_IDS[loss], 1, 0, 0,
                                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{lib.name}: CUDA error {rc}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_igd_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, f"| torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    clock_hz = float(smi.split(",")[2].split()[0]) * 1e6
    libs = {"committed": K.LIBRARY}
    libs.update({name: variant(name, edits) for name, edits in VARIANTS.items()})
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))

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
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
