#!/usr/bin/env python3
"""Device ms of the attention gradient kernels at a family's heads, for one checkout.

    python3 scripts/torch_attention_bwd_times.py [--root DIR] [--hd 64|128|192] [--heads H/Kv]
        [--softcap C] [--splits N] [--turns N] [--calls N] [--ptxas]

Loads repro_torch from DIR/src (default: this checkout), so the kernels
build from DIR's sources into DIR/build, and times
``kernel.flash_attention_backward`` in bf16 at B 1, S 4,096 and, with
``--hd 128`` (the default), llama3.2-3b's 24/8 heads (the shape each of
the training step's 224 gradient calls has), with ``--hd 192``
nemotron-4's 96/8 heads, with ``--hd 64`` qwen3-moe's 64/4; ``--heads``
takes other heads at that width (grok-1's 48/8, musicgen-medium's 24/24,
starcoder2-7b's 36/4) and ``--softcap`` caps the logits (grok-1's 30; q
is then scaled by 3, past the cap). With CUDA events over ``--calls``
calls (5 by default), in N turns with scaled_dot_product_attention's
backward (``is_causal``, ``enable_gqa``) on the same inputs (none with a
cap: no PyTorch call computes capped attention); then each of the call's
three launches (D, dk/dv, dq) under ``torch.profiler``, device time per
launch. ``--splits``
forces the dk/dv launch's cluster size (a checkout with
``kernel.dkdv_splits``; by default its pick, printed as ``splits``). The
inputs come from one seed, so ``digest`` (sha256 of dq, dk and dv's
bytes) tells whether two checkouts give the same bits. With ``--ptxas`` it
rebuilds the gradient library with ``-Xptxas -v`` and adds each kernel's
registers and spill bytes. Prints one JSON line, with the card's name and
power limit. To compare two checkouts' kernels on one card, run it for
each in turns in one call (A B B A): for example with another commit's
tree unpacked under build/ by `git archive`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

B, S = 1, 4096
HEADS = {64: (64, 4), 128: (24, 8), 192: (96, 8)}  # hd -> (H, Kv): qwen3-moe's, llama3.2-3b's, nemotron-4's
CALLS, PROFILED = 5, 10
# a substring of each launch's kernel names in every checkout (dkdv_kernel,
# dkdv_split_kernel)
LAUNCH_KINDS = {"D": "rowdot_kernel", "dk/dv": "dkdv_", "dq": "dq_kernel"}


def event_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_ms(fn, calls: int) -> dict:
    """Device ms per launch of each of the call's kernels, by kind, from the
    profiler's per-kernel sums over ``calls`` calls: the mean over the
    launches the trace holds, and how many it holds a call (1.0 unless it
    dropped some)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        kind = next((k for k, pat in LAUNCH_KINDS.items() if pat in evt.key), None)
        if kind is None or not us:
            continue
        out[kind] = {"ms": us * 1e-3 / evt.count, "launches_a_call": evt.count / calls, "name": evt.key}
    return out


def ptxas_lines(text: str) -> list:
    """Each kernel's 'Used N registers' and spill lines from ptxas -v, any
    warning, and any 'Potential Performance Loss' note (a serialized wgmma,
    for one)."""
    keep, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'|Function properties for (\S+)", line)
        if m:
            name = m.group(1) or m.group(2)
        if "spill" in line or "Used " in line or "warning" in line.lower() or "Performance" in line:
            keep.append(f"{name}: {line.strip()}")
    return keep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--hd", type=int, choices=sorted(HEADS), default=128)
    ap.add_argument("--heads", help="H/Kv, e.g. 48/8 (default: the width's family, HEADS)")
    ap.add_argument("--softcap", type=float, default=0.0)
    ap.add_argument("--splits", type=int, help="the dk/dv cluster size (default: kernel.dkdv_splits's pick)")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--calls", type=int, default=CALLS, help="calls a timed window")
    ap.add_argument("--ptxas", action="store_true", help="rebuild with -Xptxas -v and report registers and spills")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attention_bwd_times: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels.attention import kernel as AK

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    (H, KV), HD, cap = HEADS[args.hd], args.hd, args.softcap
    if args.heads:
        H, KV = (int(x) for x in args.heads.split("/"))
    pick = getattr(AK, "dkdv_splits", None)
    if args.splits is not None and pick is None:
        ap.error(f"{root} has no dk/dv cluster split (kernel.dkdv_splits)")
    splits = args.splits
    if splits is not None:
        AK.dkdv_splits = lambda *shape: splits  # the wrapper asks it at every call
    elif pick is not None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = pick(B, S, KV, H // KV, sms) if HD in AK.DKDV_SPLIT_WIDTHS else 1
    out = {"root": str(root), "card": card, "source": str(Path(AK.BWD_SOURCE).resolve()),
           "shape": {"B": B, "S": S, "H": H, "Kv": KV, "hd": HD, "softcap": cap, "dtype": "bfloat16"},
           "splits": splits}
    if args.ptxas:
        out["ptxas"] = ptxas_lines(AK.BWD_LIBRARY.build(ptxas_verbose=True))
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = normal(B, S, H, HD), normal(B, S, KV, HD), normal(B, S, KV, HD), normal(B, S, H, HD)
    if cap:
        q = 3.0 * q  # logits past the cap
    o, lse = AK.flash_attention(q, k, v, cap, with_lse=True)
    kernel = lambda: AK.flash_attention_backward(q, k, v, o, lse, do, cap)  # noqa: E731
    if cap:  # no PyTorch call computes capped attention
        turns = [(event_ms(kernel, args.calls), None) for _ in range(args.turns)]
    else:
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
        dos = do.transpose(1, 2)
        library = lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dos, retain_graph=True)  # noqa: E731
        turns = [(event_ms(kernel, args.calls), event_ms(library, args.calls)) for _ in range(args.turns)]
    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    digest = hashlib.sha256(b"".join(t.view(torch.int16).cpu().numpy().tobytes() for t in first)).hexdigest()
    out.update(
        bwd_ms=sum(t[0] for t in turns) / len(turns), turns_ms=[t[0] for t in turns],
        sdpa_bwd_ms=None if cap else sum(t[1] for t in turns) / len(turns),
        sdpa_turns_ms=None if cap else [t[1] for t in turns],
        launches=launch_ms(kernel, PROFILED), profiled_calls=PROFILED, digest=digest[:16],
        rerun_bitwise_equal=all(torch.equal(a, b) for a, b in zip(first, second)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
