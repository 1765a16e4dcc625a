#!/usr/bin/env python3
"""Device ms of the serving kernels at llama3.2-3b's and nemotron-4's decode shapes, for one checkout.

    python3 scripts/torch_serving_kernel_times.py [--root DIR] [--turns N]

Loads repro_torch from DIR/src (default: this checkout), so its kernels
build from DIR's sources into DIR/build, and times flash_attention (B=8,
S=2,048, 24/8 heads, hd 128, bf16), flash_attention[hd192] (nemotron-4's
prefill: B=8, S=2,048, 96/8 heads, hd 192), flash_attention[hd192,lse]
(the forward of the hd-192 gradient: B=1, S=4,096, 96/8 heads, with lse),
flash_decode (B=8, cache 2,176 positions, length 2,176),
flash_decode[hd192] (nemotron-4's decode: B=8, 96/8 heads, hd 192, length
2,080, bf16), both decode shapes in float32, and flash_decode[softcap]
(grok-1's 48/8 heads, hd 128, length 2,080, cap 30) in replayed CUDA
graphs, each in N turns with scaled_dot_product_attention where PyTorch
has the call. Prints one JSON line, with the card's name and power limit,
a digest of each kernel's output (the same inputs, from one seed, in every
checkout) and, for the hd-192 prefill, the kernels SDPA launched with
their device time under torch.profiler. To compare two checkouts' kernels
on one card, run it for each in turns in one call (A B B A): for example
with another commit's tree unpacked under build/ by `git archive`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

B, S, H, KV, HD, LENGTH = 8, 2048, 24, 8, 128, 2176
NEMO_H, NEMO_KV, NEMO_HD, NEMO_LENGTH = 96, 8, 192, 2080
GROK_H, GROK_SOFTCAP = 48, 30.0


def graph_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us_by_kernel(fn) -> dict:
    """Device µs a call of each kernel ``fn`` launches, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 3 for e in prof.key_averages() if e.device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.decode import kernel as DK

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def decode(h, kv, hd, length, dtype=torch.bfloat16, softcap=0.0):
        qd, kc, vc = normal(B, h, hd, dtype=dtype), normal(B, length, kv, hd, dtype=dtype), normal(
            B, length, kv, hd, dtype=dtype)
        library = None if softcap else (lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), enable_gqa=True))
        return lambda: DK.flash_decode(qd, kc, vc, length, softcap)[0], library, 100

    def prefill(b, s, h, kv, hd, with_lse=False):
        q, k, v = normal(b, s, h, hd), normal(b, s, kv, hd), normal(b, s, kv, hd)
        return (lambda: AK.flash_attention(q, k, v, with_lse=with_lse), lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True), 10)

    calls = {
        "flash_attention": prefill(B, S, H, KV, HD),
        "flash_attention[hd192]": prefill(B, S, NEMO_H, NEMO_KV, NEMO_HD),
        "flash_attention[hd192,lse]": prefill(1, 2 * S, NEMO_H, NEMO_KV, NEMO_HD, with_lse=True),
        "flash_decode": decode(H, KV, HD, LENGTH),
        "flash_decode[hd192]": decode(NEMO_H, NEMO_KV, NEMO_HD, NEMO_LENGTH),
        "flash_decode[f32]": decode(H, KV, HD, LENGTH, torch.float32),
        "flash_decode[hd192,f32]": decode(NEMO_H, NEMO_KV, NEMO_HD, NEMO_LENGTH, torch.float32),
        "flash_decode[softcap]": decode(GROK_H, KV, HD, NEMO_LENGTH, softcap=GROK_SOFTCAP),
    }
    out = {"root": str(root), "card": card, "source": str(Path(AK.__file__).resolve())}
    for name, (kernel, library, iters) in calls.items():
        turns = [(graph_ms(kernel, iters), graph_ms(library, iters) if library else None) for _ in range(args.turns)]
        result = kernel()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for part in result if isinstance(result, tuple) else (result,):
            digest.update(part.float().cpu().numpy().tobytes())
        out[name] = {"ms": sum(t[0] for t in turns) / len(turns), "turns_ms": [t[0] for t in turns],
                     "sdpa_ms": sum(t[1] for t in turns) / len(turns) if library else None,
                     "digest": digest.hexdigest()[:16]}
        if name == "flash_attention[hd192]":
            out[name]["sdpa_kernels_us"] = device_us_by_kernel(library)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
