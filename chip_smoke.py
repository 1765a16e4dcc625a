#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card (Hopper:
the kernels build for sm_90a). Phases, each printed as it ends:

1. build the fused-IGD CUDA kernels from src/repro_torch/kernels/igd_fused/csrc;
2. hold each kernel against its plain PyTorch version on the card, for the
   three losses (rtol=2e-4, atol=2e-5, the reference's kernel tolerance;
   TF32 off for matmuls and cuDNN);
3. run the engine end to end on a Forest-shaped table (581,012 x 54 f32,
   UCI Covertype's shape, label-clustered, generated on the card from
   --seed): logreg with no hints (the probe-priced plan must choose
   cuda_fused), a warm repeat that must build nothing, svm under
   shuffle_always + cuda_fused and least_squares under clustered +
   cuda_minibatch by hint; then a small-input agreement check against the
   eager fold on the CPU;
4. time each kernel at the main path's shape with CUDA events, beside its
   plain version and its bound.

The second-to-last lines are one JSON object of per-kernel results and the
card's name and power limit; the last line is the run's verdict. Any
failure exits non-zero before those lines are printed; without a card the
script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

FOREST_ROWS, FOREST_DIM = 581_012, 54  # UCI Covertype (paper Table 1)
FOLD_PREFIX = 16_384  # rows the per-row plain fold is held to on the card
# N not a multiple of 256, D not of 128; one warp, then 8 and 16 warps
RAGGED = ((3_001, 77), (777, 1_500), (257, 4_096))
KERNEL_RTOL, KERNEL_ATOL = 2e-4, 2e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
LOSSES = ("lr", "svm", "lsq")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def inputs(gen, n, d, device):
    x = torch.randn((n, d), generator=gen, device=device) / d**0.5
    y = torch.sign(torch.randn((n,), generator=gen, device=device))
    alpha = 0.1 / (1.0 + torch.arange(n, device=device, dtype=torch.float32) / n)
    w0 = 0.01 * torch.randn((d,), generator=gen, device=device)
    return x, y, alpha, w0


def max_err(got, want, what: str) -> float:
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise AssertionError(f"{what}: kernel disagrees with its plain version (max |err| {err:.3g})")
    return err


def event_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch import engine, timing
    from repro_torch.data import synthetic
    from repro_torch.engine import catalog
    from repro_torch.kernels.igd_fused import kernel as K, ref as R

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi("name,power.limit")
    log("setup", f"{torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda} | TF32 off (matmul, cuDNN)")

    # -- 1. build --------------------------------------------------------
    watch = timing.Stopwatch()
    ptxas = K.build(ptxas_verbose=True)
    regs = [int(line.split("Used ")[1].split()[0]) for line in ptxas.splitlines() if "Used " in line]
    spills = [line for line in ptxas.splitlines() if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line]
    if spills:
        raise AssertionError(f"register spills in the kernels: {spills}")
    K._load()
    log("build", f"igd_fused.cu -> {K.library_path().name} in {watch.lap():.2f} s "
        f"({len(regs)} kernels, max {max(regs)} registers/thread, no spills)")

    # -- 2. kernels against their plain versions ---------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    table = synthetic.dense_classification(gen, FOREST_ROWS, FOREST_DIM)
    x, y = table["x"], table["y"]
    alpha = engine.get("logreg").step_size(FOREST_ROWS)(
        torch.arange(FOREST_ROWS, dtype=torch.int32, device=dev))
    w0 = torch.zeros(FOREST_DIM, device=dev)
    errs = {"igd_fold": 0.0, "igd_fold_minibatch": 0.0}
    xp, yp, ap = x[:FOLD_PREFIX], y[:FOLD_PREFIX], alpha[:FOLD_PREFIX]
    ragged = [inputs(gen, n, d, dev) for n, d in RAGGED]
    for loss in LOSSES:
        cases = {
            "igd_fold": [((xp, yp, ap, w0), f"{FOLD_PREFIX}x{FOREST_DIM}")],
            "igd_fold_minibatch": [((x, y, alpha, w0), f"{FOREST_ROWS}x{FOREST_DIM}")],
        }
        for args_, (n, d) in zip(ragged, RAGGED):
            for name in cases:
                cases[name].append((args_, f"{n}x{d}"))
        for name, plain in (("igd_fold", R.igd_fold_ref), ("igd_fold_minibatch", R.igd_fold_minibatch_ref)):
            for args_, shape in cases[name]:
                errs[name] = max(errs[name], max_err(
                    getattr(K, name)(*args_, loss=loss), plain(*args_, loss=loss), f"{name} {loss} {shape}"))
    shapes = ", ".join(f"{n}x{d}" for n, d in RAGGED)
    log("parity", f"igd_fold max |err| {errs['igd_fold']:.3g} ({FOLD_PREFIX}x{FOREST_DIM} prefix, {shapes}), "
        f"igd_fold_minibatch max |err| {errs['igd_fold_minibatch']:.3g} ({FOREST_ROWS}x{FOREST_DIM}, {shapes}); "
        f"lr, svm, lsq within rtol={KERNEL_RTOL}, atol={KERNEL_ATOL}")

    # -- 3. the main path, end to end --------------------------------------
    eng = engine.Engine()
    task_args = {"dim": FOREST_DIM}
    K.reset_launches()
    q = engine.AnalyticsQuery(task="logreg", data=table, task_args=task_args,
                              epochs=10, tolerance=0.0, seed=args.seed)
    rep = eng.explain(q)
    print(rep.describe(), flush=True)
    if rep.chosen.implementation != "cuda_fused":
        raise AssertionError(f"probe-priced plan chose {rep.chosen.implementation}, not cuda_fused")
    res = eng.run(q)
    logreg = catalog.get("logreg").make_task(**task_args)
    loss0 = float(logreg.full_loss(w0, table))
    if not bool(torch.isfinite(res.model).all()) or res.model.shape != (FOREST_DIM,):
        raise AssertionError("logreg model is not a finite [54] vector")
    if not res.losses[-1] < loss0:
        raise AssertionError(f"logreg loss {res.losses[-1]} did not drop below {loss0}")
    if res.kernel_launches < res.epochs:
        raise AssertionError(f"only {res.kernel_launches} igd_fold launches in {res.epochs} epochs")
    log("e2e", f"logreg {res.plan.ordering}/{res.plan.implementation}: {res.epochs} epochs, "
        f"loss {loss0:.6g} -> {res.losses[-1]:.6g}, {res.kernel_launches} kernel launches, "
        f"grad {res.gradient_seconds:.3f} s, shuffle {res.shuffle_seconds:.3f} s")
    before = eng.cache_info()
    warm = eng.run(q)
    after = eng.cache_info()
    if (warm.trace_count != res.trace_count or after["plans_computed"] != before["plans_computed"]
            or after["plan_cache_hits"] != before["plan_cache_hits"] + 1
            or after["probe_runs"] != before["probe_runs"]):
        raise AssertionError(f"warm repeat built something: {before} -> {after}")
    log("e2e", f"warm repeat: builds {warm.trace_count} (unchanged), cache {after}")
    for task, hints in (("svm", {"ordering": "shuffle_always", "implementation": "cuda_fused"}),
                        ("least_squares", {"ordering": "clustered", "implementation": "cuda_minibatch"})):
        qh = engine.AnalyticsQuery(task=task, data=table, task_args=task_args, epochs=3,
                                   tolerance=0.0, seed=args.seed, hints=hints)
        rh = eng.run(qh)
        l0 = float(catalog.get(task).make_task(**task_args).full_loss(w0, table))
        if rh.plan.implementation != hints["implementation"] or not bool(torch.isfinite(rh.model).all()):
            raise AssertionError(f"{task}: plan {rh.plan} or model not finite")
        if not rh.losses[-1] < l0 or rh.kernel_launches < rh.epochs:
            raise AssertionError(f"{task}: loss {l0} -> {rh.losses[-1]}, {rh.kernel_launches} launches")
        log("e2e", f"{task} {rh.plan.ordering}/{rh.plan.implementation}: {rh.epochs} epochs, "
            f"loss {l0:.6g} -> {rh.losses[-1]:.6g}, {rh.kernel_launches} kernel launches")
    launches = dict(K.launches)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    log("e2e", f"main-path launches {launches}")

    # small input: the card's kernel lanes against the CPU's eager fold,
    # on the same rows and the same permutations
    class SamePermutations:
        def stream(self, seed, n, device):
            g = torch.Generator().manual_seed(seed)
            return lambda: torch.randperm(n, generator=g).to(device)

    small = {k: v[:4096].contiguous() for k, v in table.items()}
    cpu_eng = engine.Engine(device="cpu", permutations=SamePermutations())
    gpu_eng = engine.Engine(permutations=SamePermutations())
    for task in ("logreg", "least_squares"):
        hint = {"ordering": "shuffle_always"}
        qg = engine.AnalyticsQuery(task=task, data=small, task_args=task_args, epochs=2,
                                   tolerance=0.0, hints=dict(hint, implementation="cuda_fused"))
        qc = engine.AnalyticsQuery(task=task, data={k: v.cpu() for k, v in small.items()},
                                   task_args=task_args, epochs=2, tolerance=0.0,
                                   hints=dict(hint, implementation="torch_fold"))
        got, want = gpu_eng.run(qg).model.cpu(), cpu_eng.run(qc).model
        # 8,192 serial steps summed in another order on each side: the
        # kernel tolerance, not the engine's
        if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
            raise AssertionError(f"{task}: card's cuda_fused run disagrees with the CPU's torch_fold")
        log("reference", f"{task} 4096x54 shuffle_always: cuda_fused on the card vs torch_fold "
            f"on the CPU, max |err| {float((got - want).abs().max()):.3g}")

    # -- 4. timings at the main path's shape -------------------------------
    n, d = FOREST_ROWS, FOREST_DIM
    io_bytes = n * (d + 2) * 4 + 2 * d * 4
    ms = {
        "igd_fold": event_ms(lambda: K.igd_fold(x, y, alpha, w0, loss="lr"), 5),
        "igd_fold_minibatch": event_ms(lambda: K.igd_fold_minibatch(x, y, alpha, w0, loss="lsq"), 10),
    }
    plain_ms = {
        "igd_fold": timing.seconds(lambda: R.igd_fold_ref(xp, yp, ap, w0, loss="lr"), dev) * 1e3,
        "igd_fold_minibatch": timing.seconds(
            lambda: R.igd_fold_minibatch_ref(x, y, alpha, w0, loss="lsq"), dev) * 1e3,
    }
    flops = {"igd_fold": n * (4 * d + 8), "igd_fold_minibatch": n * (4 * d + 8) + 2 * d * (n // K.TILE + 1)}
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    kernels = []
    for name, replaces, plain_rows in (
        ("igd_fold", "src/repro/kernels/igd_fused/kernel.py:74", FOLD_PREFIX),
        ("igd_fold_minibatch", "src/repro/kernels/igd_fused/kernel.py:119", n),
    ):
        bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops[name] / FP32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/igd_fused/csrc/igd_fused.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "rows": n, "plain_rows": plain_rows,
        })
        log("timing", f"{name}: {ms[name]:.4f} ms/launch, {ms[name] * 1e3 / n:.5f} us/row at {n}x{d}; "
            f"plain {plain_ms[name]:.2f} ms on {plain_rows} rows ({plain_ms[name] * 1e3 / plain_rows:.3f} us/row); "
            f"bound {max(bytes_ms, ops_ms):.4f} ms (bytes {io_bytes} at 3.35 TB/s: {bytes_ms:.4f} ms; "
            f"fp32 ops at 67 TFLOP/s: {ops_ms:.4f} ms)")
    # the chain: per row, ceil(D/32) dependent FMAs, 5 shuffle+add steps and
    # the axpy FMA at >= 4 cycles each (the loss scale's ops left out)
    vpl = 1
    while 32 * vpl < d:
        vpl *= 2
    chain_ms = n * (vpl + 2 * 5 + 1) * 4 / (clock_mhz * 1e6) * 1e3
    log("timing", f"igd_fold serial chain: {ms['igd_fold'] * 1e-3 * clock_mhz * 1e6 / n:.0f} SM cycles/row "
        f"measured at the {clock_mhz:.0f} MHz max SM clock; chain floor (model, {vpl + 11} dependent "
        f"ops x 4 cycles) {chain_ms:.3f} ms vs the bytes' {io_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    log("timing", "library_ms: none — no single PyTorch call computes a serial IGD fold or the "
        "tile-serial minibatch fold")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
