#!/usr/bin/env python3
"""Time the fused-IGD kernels' instances against another commit's source, in turns, on one CUDA card.

    python3 scripts/torch_igd_instance_times.py --against PATH/TO/igd_fused.cu

Run from the repository root on a machine with a Hopper card. Builds the
committed src/repro_torch/kernels/igd_fused/csrc/igd_fused.cu and the
source at PATH (say, a parent commit's, from ``git show
<commit>:src/repro_torch/kernels/igd_fused/csrc/igd_fused.cu``) into the
git-ignored build/, then for each instance (igd_fold's tiled Gram
instance, its middle instance at 65,536 x 1,000 and 16,384 x 4,096 and
as lane launches of B = 1, 8, 32 and 128 over a shared 8,192 x 1,000 table,
its wide instance at D 4,097 and 12,033; igd_fold_minibatch's row-share
cluster, and its column-slice cluster at 65,536 x 1,000 (a tile's slice
resident), 8,192 x 12,032 and 8,192 x 12,033 (streamed twice)) at a
shape it runs, times one launch (CUDA events, the mean of 3 launches a
turn) in turns: against, committed, committed, against. Where both
sources run the same instance code their results must agree bit for
bit, and the committed one is held to the plain version; the newest
designs (REDESIGNED: igd_fold's middle instance, igd_fold_minibatch past
D 256) may differ from the other source's, so there both are held to
the plain version (igd_fold: the per-row fold on a 16,384-row prefix,
and the committed one also to the tiled fold on all rows; every lane of
a lane launch equal to its one-lane launch bit for bit). The igd_fold
middle and wide rows also print the byte bound and the chain floor (N x
kernel.chain_probe's step), the column-slice rows the byte bound and the
exchange floor (the tiles x kernel.minibatch_wide_step_probe's step).
The card's name and power limit are printed first; each line gives both
sources' turns and the committed / against ratio of their means. Takes
about 3 minutes of command time.
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
from repro_torch.kernels._build import CudaLibrary  # noqa: E402
from repro_torch.kernels.igd_fused import kernel as K, ref as R  # noqa: E402

# (kernel, loss, N, D, lanes, instance)
CASES = (
    ("igd_fold", "lr", 581_012, 54, 1, "tiled Gram, D <= 256"),
    ("igd_fold", "lr", 65_536, 1_000, 1, "middle"),
    ("igd_fold", "lr", 16_384, 4_096, 1, "middle"),
    ("igd_fold", "lr", 8_192, 1_000, 1, "middle, lanes"),
    ("igd_fold", "lr", 8_192, 1_000, 8, "middle, lanes"),
    ("igd_fold", "lr", 8_192, 1_000, 32, "middle, lanes"),
    ("igd_fold", "lr", 8_192, 1_000, 128, "middle, lanes"),  # a wave of the parent's one-block lanes
    ("igd_fold", "lr", 8_192, 4_097, 1, "wide"),
    ("igd_fold", "lsq", 8_192, 12_033, 1, "wide"),
    ("igd_fold_minibatch", "lsq", 581_012, 54, 1, "row-share cluster, D <= 256"),
    ("igd_fold_minibatch", "lsq", 65_536, 1_000, 1, "column-slice cluster, resident"),
    ("igd_fold_minibatch", "lsq", 8_192, 12_032, 1, "column-slice cluster"),
    ("igd_fold_minibatch", "lsq", 8_192, 12_033, 1, "column-slice cluster, odd D"),
)
# the instances whose design this source changed: (kernel, D) -> True
REDESIGNED = {"igd_fold": lambda d: K.FOLD_GRAM_MAX_DIM < d <= K.FOLD_REGISTER_MAX_DIM,
              "igd_fold_minibatch": lambda d: d > K.MINIBATCH_CLUSTER_MAX_DIM}
FOLD_PREFIX = 16_384  # rows the per-row plain fold is held to (it is host-bound, and drifts past it)
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
    """One launch of B = alpha.shape[0] lanes over the shared table x, or
    of one fold when alpha is [N]."""
    out = torch.empty_like(w0)
    handle = lib.load()
    lanes = 1 if alpha.dim() == 1 else alpha.shape[0]
    extra = ()
    if name == "igd_fold" and hasattr(handle, "igd_fused_fold_scratch_floats"):
        floats = handle.igd_fused_fold_scratch_floats(x.shape[0], x.shape[1], lanes, 0, 1)
        scratch = torch.empty(floats, device=x.device) if floats else None
        extra = (scratch.data_ptr() if floats else None,)
    rc = getattr(handle, f"{name}_launch")(x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w0.data_ptr(),
                                           out.data_ptr(), x.shape[0], x.shape[1], K.LOSS_IDS[loss], lanes, 0,
                                           0 if lanes == 1 else x.shape[0], *extra,
                                           torch.cuda.current_stream().cuda_stream)
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
    with ThreadPoolExecutor(3) as pool:  # one nvcc each, at once (K.LIBRARY serves the probes)
        list(pool.map(lambda lib: lib.build(), (committed, against, K.LIBRARY)))
    floor_cycles, floor_s = {}, {}
    for loss in ("lr", "lsq"):
        floor_cycles[loss], floor_s[loss] = K.chain_probe(loss)
    step_cycles, step_s = K.minibatch_wide_step_probe("lsq")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ratios = []
    for name, loss, n, d, lanes, instance in CASES:
        x = torch.randn((n, d), generator=gen, device="cuda") / d ** 0.5
        y = torch.sign(torch.randn((n,), generator=gen, device="cuda"))
        alpha = engine.get("logreg").step_size(n)(torch.arange(n, dtype=torch.int32, device="cuda"))
        w0 = torch.zeros(d, device="cuda")
        one = (alpha, w0)  # the one-lane launch's
        if lanes > 1:  # B lanes of the same fold over the shared table: each the one-lane launch's bits
            alpha, w0 = alpha.expand(lanes, n).contiguous(), w0.expand(lanes, d).contiguous()
        got = launch(committed, name, x, y, alpha, w0, loss)
        other = launch(against, name, x, y, alpha, w0, loss)
        redesigned = REDESIGNED.get(name, lambda _: False)(d)
        if lanes > 1:
            for which, lib, w in (("committed", committed, got), ("against", against, other)):
                single = launch(lib, name, x, y, *one, loss)
                if not all(torch.equal(w[b], single) for b in range(lanes)):
                    raise AssertionError(f"{which} {name} {n}x{d}: a lane of B={lanes} differs from its one-lane "
                                         f"launch")
        elif redesigned and name == "igd_fold":  # another design in each source: both held to the plain folds
            rows = min(n, FOLD_PREFIX)
            want = R.igd_fold_ref(x[:rows], y[:rows], alpha[:rows], w0, loss=loss)
            for which, lib in (("committed", committed), ("against", against)):
                torch.testing.assert_close(launch(lib, name, x[:rows], y[:rows], alpha[:rows], w0, loss), want,
                                           **TOL, msg=lambda m, which=which: f"{which} {rows}x{d}: {m}")
            torch.testing.assert_close(got, R.igd_fold_tiled_ref(x, y, alpha, w0, loss=loss), **TOL)
        elif redesigned:  # another design in each source: both held to the plain version
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
        bound_ms = (n * (d + 1) + lanes * (n + 2 * d)) * 4 / HBM_BYTES_PER_S * 1e3  # the table once, each lane its own
        note = "the same w bit for bit"
        if name == "igd_fold" and redesigned:
            floor_ms = n * floor_s[loss] * 1e3
            ms = mean["committed"]
            note = (f"{'every lane its one-lane launch bit for bit' if lanes > 1 else 'both held to the per-row fold'}"
                    f"; against / committed {1 / ratios[-1]:.2f}x; {ms * 1e3 / n:.4f} us/row; byte bound "
                    f"{bound_ms:.4f} ms ({bound_ms / ms:.4f} of it); chain floor {floor_ms:.4f} ms ({n} x "
                    f"{floor_cycles[loss]:.1f} cycles, kernel.chain_probe), {floor_ms / ms:.3f} of it; design "
                    f"{K.fold_middle_design(d)} (CTAs, columns a CTA, resident sub-tiles, bytes a CTA)")
        elif redesigned:
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
        print(f"{name} {instance} ({loss}, {n}x{d}{f', B={lanes}' if lanes > 1 else ''}): committed {', '.join(f'{t:.4f}' for t in turns['committed'])} "
              f"ms, against {', '.join(f'{t:.4f}' for t in turns['against'])} ms; committed / against "
              f"{ratios[-1]:.4f}; {note}", flush=True)
        del x, y, alpha
    print(f"committed / against over the {len(CASES)} instances: {min(ratios):.4f} to {max(ratios):.4f}; {smi}")
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
