#!/usr/bin/env python3
"""Time the fused-IGD kernels' instances against another commit's source, in turns, on one CUDA card.

    python3 scripts/torch_igd_instance_times.py --against PATH/TO/igd_fused.cu

Run from the repository root on a machine with a Hopper card. Builds the
committed src/repro_torch/kernels/igd_fused/csrc/igd_fused.cu and the
source at PATH (say, a parent commit's, from ``git show
<commit>:src/repro_torch/kernels/igd_fused/csrc/igd_fused.cu``) into the
git-ignored build/, then for each instance (igd_fold's tiled Gram
instance, its per-row chain with w in registers at one warp and at 16
warps, its wide instance at D 4,097 and 12,033; igd_fold_minibatch's
row-share cluster, and its column-slice cluster at 65,536 x 1,000 (a
tile's slice resident), 8,192 x 12,032 and 8,192 x 12,033 (streamed
twice)) at a shape it runs, times one launch (CUDA events, the mean of 3
launches a turn) in turns: against, committed, committed, against. Where
both sources run the same instance code their results must agree bit for
bit, and the committed one is held to the plain version; the newest
design, igd_fold_minibatch past D 256 (REDESIGNED), may differ from the
other source's, so there both are held to the plain version. The wide
igd_fold rows also print the byte bound and the chain floor (N x
kernel.chain_probe's step), the column-slice rows the byte bound and the
exchange floor (the tiles x kernel.minibatch_wide_step_probe's step). The card's name and power
limit are printed first; each line gives both sources' turns and the
committed / against ratio of their means. Takes about 2 minutes of
command time.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import engine  # noqa: E402
from repro_torch.kernels._build import CudaLibrary  # noqa: E402
from repro_torch.kernels.igd_fused import kernel as K, ref as R  # noqa: E402

# (kernel, loss, N, D, instance)
CASES = (
    ("igd_fold", "lr", 581_012, 54, "tiled Gram, D <= 256"),
    ("igd_fold", "lr", 65_536, 1_000, "per-row chain, one warp"),
    ("igd_fold", "lr", 16_384, 4_096, "per-row chain, 16 warps"),
    ("igd_fold", "lr", 8_192, 4_097, "wide"),
    ("igd_fold", "lsq", 8_192, 12_033, "wide"),
    ("igd_fold_minibatch", "lsq", 581_012, 54, "row-share cluster, D <= 256"),
    ("igd_fold_minibatch", "lsq", 65_536, 1_000, "column-slice cluster, resident"),
    ("igd_fold_minibatch", "lsq", 8_192, 12_032, "column-slice cluster"),
    ("igd_fold_minibatch", "lsq", 8_192, 12_033, "column-slice cluster, odd D"),
)
# the instances whose design this source changed: (kernel, D) -> True
REDESIGNED = {"igd_fold_minibatch": lambda d: d > K.MINIBATCH_CLUSTER_MAX_DIM}
TOL = dict(rtol=2e-4, atol=2e-5)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def declare_entries(lib) -> None:
    """Types of the two one-fold entries, which both sources have (igd_fold's
    with the wide instance's scratch where the source has one)."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    one = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i64, i64, ptr]
    scratch = hasattr(lib, "igd_fused_fold_scratch_floats")
    lib.igd_fold_launch.argtypes = one[:-1] + [ptr, ptr] if scratch else one
    lib.igd_fold_minibatch_launch.argtypes = one
    for fn in (lib.igd_fold_launch, lib.igd_fold_minibatch_launch):
        fn.restype = i32
    if scratch:
        lib.igd_fused_fold_scratch_floats.argtypes = [i64, i32, i32, i64, i32]
        lib.igd_fused_fold_scratch_floats.restype = i64
    lib.igd_fused_error_string.argtypes = [i32]
    lib.igd_fused_error_string.restype = ctypes.c_char_p


def launch(lib: CudaLibrary, name: str, x, y, alpha, w0, loss: str):
    out = torch.empty_like(w0)
    handle = lib.load()
    extra = ()
    if name == "igd_fold" and hasattr(handle, "igd_fused_fold_scratch_floats"):
        floats = handle.igd_fused_fold_scratch_floats(x.shape[0], x.shape[1], 1, 0, 1)
        scratch = torch.empty(floats, device=x.device) if floats else None
        extra = (scratch.data_ptr() if floats else None,)
    rc = getattr(handle, f"{name}_launch")(x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w0.data_ptr(),
                                           out.data_ptr(), x.shape[0], x.shape[1], K.LOSS_IDS[loss], 1, 0, 0,
                                           *extra, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{lib.name} {name}: CUDA error {rc} ({lib.load().igd_fused_error_string(rc).decode()})")
    return out


def turn_ms(fn, calls: int = 3) -> float:
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
    return sum(times) / len(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, required=True, help="another igd_fused.cu to time in the same turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_igd_instance_times: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, f"| torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    committed = CudaLibrary("igd_committed", K.SOURCE, declare_entries)
    against = CudaLibrary("igd_against", args.against.resolve(), declare_entries)
    committed.build()
    against.build()
    floor_cycles, floor_s = {}, {}
    for loss in ("lr", "lsq"):
        floor_cycles[loss], floor_s[loss] = K.chain_probe(loss)
    step_cycles, step_s = K.minibatch_wide_step_probe("lsq")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ratios = []
    for name, loss, n, d, instance in CASES:
        x = torch.randn((n, d), generator=gen, device="cuda") / d ** 0.5
        y = torch.sign(torch.randn((n,), generator=gen, device="cuda"))
        alpha = engine.get("logreg").step_size(n)(torch.arange(n, dtype=torch.int32, device="cuda"))
        w0 = torch.zeros(d, device="cuda")
        got = launch(committed, name, x, y, alpha, w0, loss)
        other = launch(against, name, x, y, alpha, w0, loss)
        redesigned = REDESIGNED.get(name, lambda _: False)(d)
        if redesigned:  # another design in each source: both held to the plain version
            for which, w in (("committed", got), ("against", other)):
                torch.testing.assert_close(w, R.igd_fold_minibatch_ref(x, y, alpha, w0, loss=loss), **TOL,
                                           msg=lambda m, which=which: f"{which} {n}x{d}: {m}")
        else:
            if not torch.equal(got, other):
                raise AssertionError(f"{name} {n}x{d}: the two sources disagree")
            rows = min(n, 16_384) if name == "igd_fold" else n  # the per-row plain fold is host-bound
            if rows == n:
                torch.testing.assert_close(got, getattr(R, f"{name}_ref")(x, y, alpha, w0, loss=loss), **TOL)
            else:
                torch.testing.assert_close(launch(committed, name, x[:rows], y[:rows], alpha[:rows], w0, loss),
                                           R.igd_fold_ref(x[:rows], y[:rows], alpha[:rows], w0, loss=loss), **TOL)
        turns = {"against": [], "committed": []}
        for which in ("against", "committed", "committed", "against"):
            lib = committed if which == "committed" else against
            turns[which].append(turn_ms(lambda lib=lib: launch(lib, name, x, y, alpha, w0, loss)))
        mean = {k: sum(v) / len(v) for k, v in turns.items()}
        ratios.append(mean["committed"] / mean["against"])
        bound_ms = (n * (d + 2) + 2 * d) * 4 / HBM_BYTES_PER_S * 1e3
        note = "the same w bit for bit"
        if redesigned:
            tiles = -(-n // K.TILE)
            note = (f"both within rtol={TOL['rtol']}, atol={TOL['atol']} of the plain version, "
                    f"{'the same' if torch.equal(got, other) else 'not the same'} w bit for bit; "
                    f"against / committed {1 / ratios[-1]:.2f}x; byte bound {bound_ms:.4f} ms "
                    f"({bound_ms / mean['committed']:.4f} of it); exchange floor {tiles * step_s * 1e3:.4f} ms "
                    f"({tiles} tiles x {step_cycles:.0f} cycles, kernel.minibatch_wide_step_probe), "
                    f"{tiles * step_s * 1e3 / mean['committed']:.3f} of it; design {K.minibatch_slice_design(d)}")
        elif name == "igd_fold" and d > K.FOLD_REGISTER_MAX_DIM:
            floor_ms = n * floor_s[loss] * 1e3
            note += (f"; byte bound {bound_ms:.4f} ms ({bound_ms / mean['committed']:.4f} of it); chain floor "
                     f"{floor_ms:.4f} ms ({n} x {floor_cycles[loss]:.1f} cycles, kernel.chain_probe), "
                     f"{floor_ms / mean['committed']:.3f} of it")
        print(f"{name} {instance} ({loss}, {n}x{d}): committed {', '.join(f'{t:.4f}' for t in turns['committed'])} "
              f"ms, against {', '.join(f'{t:.4f}' for t in turns['against'])} ms; committed / against "
              f"{ratios[-1]:.4f}; {note}", flush=True)
        del x, y, alpha
    print(f"committed / against over the {len(CASES)} instances: {min(ratios):.4f} to {max(ratios):.4f}; {smi}")
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
