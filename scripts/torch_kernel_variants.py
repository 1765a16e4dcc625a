#!/usr/bin/env python3
"""Time variants of the port's two serving kernels beside the committed ones, on one CUDA card.

    python3 scripts/torch_kernel_variants.py [--tensor-cores | --wide [NAME ...]]

Run from the repository root on a machine with a Hopper card. Each variant
is the committed CUDA source with one textual change, built into the
git-ignored build/variants/ and swapped into the wrapper for its timing.
Times are device ms per launch from a replayed CUDA graph at the serving
shape (flash_attention: B=8, S=2,048, 24/8 heads, hd 128; flash_decode:
B=8, length 2,176 of the same heads), taken in turns with the committed
kernel and scaled_dot_product_attention in the same run; the profiler
splits flash_decode into its partial kernel and its combine. Every
variant but the loads-only one is first held to the plain version (2e-2,
bf16). The card's name and power limit are printed first. With
--tensor-cores it times only the bf16 tensor-core decode instance and its
variants (TC_DECODE_VARIANTS) at nemotron-4's decode shape (B=8, 96/8
heads, hd 192, length 2,080), each at its planned split count and at
TC_SPLITS splits, then the committed instance at TC_LENGTHS. With --wide it
times only the bf16 192-wide flash_attention kernel and its variants
(WIDE_VARIANTS: the persistent grid, key tile and stages, the
consumers' turns, 2^x by exp2f) and probes (WIDE_PROBES, timed only)
at nemotron-4's prefill shape (B=8, S=2,048, 96/8 heads, hd 192) and at
the hd-192 gradient's forward (B=1, S=4,096, with lse), in WIDE_ROUNDS
round-robin rounds with the committed kernel and SDPA, each with ptxas's
registers and spill bytes for its four instances and any wgmma
serialization ptxas reports; NAMEs after --wide pick some of them.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._build import CudaLibrary  # noqa: E402
from repro_torch.kernels.attention import kernel as AK, ref as AR  # noqa: E402
from repro_torch.kernels.decode import kernel as DK, ref as DR  # noqa: E402

B, S, H, KV, HD, LENGTH = 8, 2048, 24, 8, 128, 2176

# (old, new) edits of csrc/flash_decode.cu
DECODE_VARIANTS = {
    # no scores, no softmax, no P V: the loads, barriers and epilogue alone
    "loads_only": [
        ("    // scores: a quarter of hd for every head of the group\n    {", "    if (tid < 0) {"),
        ("    if (warp < NG) {\n      float s[kTile / 32], mx = m;",
         "    if (warp < NG && tid < 0) {\n      float s[kTile / 32], mx = m;"),
        ("      for (int i = 0; i < kTile / L::kPosGroups; ++i) {",
         "      for (int i = 0; i < kTile / L::kPosGroups * (tid >= 0 ? 0 : 1); ++i) {"),
    ],
    # two tiles ahead, as a 3-stage ring usually runs, with the loop's end barrier back
    "two_tiles_ahead": [
        ("  static constexpr int kAhead = kStages - 2;", "  static constexpr int kAhead = kStages - 1;"),
        ("          for (int e = 0; e < 8; ++e) acc[h][e] = fmaf(pr, vf[e], acc[h][e]);\n        }\n      }\n"
         "    }\n  }\n",
         "          for (int e = 0; e < 8; ++e) acc[h][e] = fmaf(pr, vf[e], acc[h][e]);\n        }\n      }\n"
         "    }\n    __syncthreads();\n  }\n"),
    ],
    # splits fastest in launch order, as PR 12 launched them
    "split_fastest": [
        ("const int split = blockIdx.y;", "const int split = blockIdx.x;"),
        ("const int b = blockIdx.x / Kv;", "const int b = blockIdx.y / Kv;"),
        ("const int kvh = blockIdx.x - b * Kv;", "const int kvh = blockIdx.y - b * Kv;"),
        ("const int n_part = gridDim.y;", "const int n_part = gridDim.x;"),
        ("const dim3 grid(B * Kv, splits, H / Kv / NG);", "const dim3 grid(splits, B * Kv, H / Kv / NG);"),
    ],
    # the combine as an ordinary launch after the partial kernel
    "plain_launch_combine": [("  config.numAttrs = 1;", "  config.numAttrs = 0;")],
}
# the bf16 tensor-core instance (heads past 128) at nemotron-4's decode
# shape: (old, new) edits of csrc/flash_decode.cu and the kernel.py
# constants that go with them
TC_DECODE_VARIANTS = {
    # three blocks an SM of one row tile (two of two), as shared memory would
    # allow: ptxas then caps a thread at 168 registers and spills
    "three_blocks": ([("  static constexpr int kBlocks = RT == 1 ? 2 : 1;", "  static constexpr int kBlocks = RT == 1 ? 3 : 2;")],
                     {"TC_BLOCKS_PER_SM": {1: 3, 2: 2}}),
    # a 4-stage ring
    "four_stages": ([("constexpr int kStages = 3;                     // the k/v ring",
                      "constexpr int kStages = 4;                     // the k/v ring")], {}),
    # 64-position tiles, four consumer warps a row tile, one block an SM
    "tile_64": ([("constexpr int kTile = 32;                      // positions a stage",
                  "constexpr int kTile = 64;                      // positions a stage"),
                 ("  static constexpr int kBlocks = RT == 1 ? 2 : 1;", "  static constexpr int kBlocks = 1;")],
                {"TC_TILE": 64, "TC_BLOCKS_PER_SM": {1: 1, 2: 1}}),
}
NEMO_H, NEMO_KV, NEMO_HD, NEMO_LENGTH = 96, 8, 192, 2080
TC_SPLITS = (5, 7, 9, 13, 17)  # split counts timed beside each variant's plan
TC_LENGTHS = (2080, 8192, 32768)  # lengths the committed instance is timed at

# the bf16 192-wide attention kernel: (old, new) edits of
# csrc/flash_attention.cu and the kernel.py constants that go with them
WIDE_VARIANTS = {
    # one block a work item (the grid every item), as before the grid was persistent
    "one_item_a_block": ([("const int grid = static_cast<int>(n_items < sms ? n_items : sms);  // one block an SM",
                           "const int grid = static_cast<int>(n_items);")], {}),
    # 96-position tiles, two stages
    "bk96": ([("constexpr int kBK = 112;            // k/v rows per tile",
               "constexpr int kBK = 96;             // k/v rows per tile")], {"WIDE_BLOCK_K": 96}),
    # the tile shape the design replaced: 64 positions, three stages
    "bk64_3stages": ([("constexpr int kBK = 112;            // k/v rows per tile",
                       "constexpr int kBK = 64;             // k/v rows per tile"),
                      ("constexpr int kStages = 2;          // the k and v rings",
                       "constexpr int kStages = 3;          // the k and v rings")],
                     {"WIDE_BLOCK_K": 64, "WIDE_STAGES": 3}),
    # the consumers issue their products whenever they are ready
    "no_turns": ([("if (w == 1) turn_pass(w);  // warpgroup 0 takes the first turn", ""),
                  ("turn_wait(w);", ";"), ("turn_pass(w);", ";")], {}),
    # O rescaled once P(t-1) V(t-1) is in, before P(t) is packed (on the
    # warpgroup's path), not while Q K(t)^T runs
    "rescale_after_wait": ([("        rescale();\n        issue_pv(n + t - 1);", "        issue_pv(n + t - 1);"),
                            ("        mbar_arrive(v_empty((n + t - 1) % kStages));\n        pack();",
                             "        mbar_arrive(v_empty((n + t - 1) % kStages));\n        rescale();\n        pack();"),
                            ("        rescale();\n        issue_pv(n + n_w - 1);", "        issue_pv(n + n_w - 1);")], {}),
    # warpgroup 0 runs every tile of its q tile, past its own rows too
    "no_skip": ([("const int n_w = (off + min(item.q0 + 64 * (w + 1), S) - 1) / kBK + 1;", "const int n_w = n_k;")], {}),
    # 2^x of the probabilities and rescale factors by exp2f
    "exp2f": ([("corr[r] = ex2(m[r] - m_new);", "corr[r] = exp2f(m[r] - m_new);"),
               ("s[i] = ex2(CAP ? s[i] + neg[r] : fmaf(s[i], scale_log2, neg[r]));",
                "s[i] = exp2f(CAP ? s[i] + neg[r] : fmaf(s[i], scale_log2, neg[r]));")], {}),
}
# timed beside the committed kernel only (their results are not the
# function's): where its time goes
WIDE_PROBES = {
    # no 2^x: the scores' FMA alone
    "no_ex2": ([("s[i] = ex2(CAP ? s[i] + neg[r] : fmaf(s[i], scale_log2, neg[r]));",
                 "s[i] = CAP ? s[i] + neg[r] : fmaf(s[i], scale_log2, neg[r]);")], {}),
    # no softmax: the raw scores packed as P, O never rescaled (the
    # products, the rings and the turns alone)
    "no_softmax": ([("      const int k0 = t * kBK + 2 * (lane % 4) - off;\n      float mx[2] = {kNegInf, kNegInf};",
                     "      corr[0] = corr[1] = 1.0f;\n      if (lane >= 0) return;\n"
                     "      const int k0 = t * kBK + 2 * (lane % 4) - off;\n      float mx[2] = {kNegInf, kNegInf};")], {}),
    # O never rescaled
    "no_rescale": ([("      for (int i = 0; i < kHD / 2; ++i) acc[i] *= corr[(i / 2) % 2];\n    };",
                     "      for (int i = 0; i < 0; ++i) acc[i] *= corr[(i / 2) % 2];\n    };")], {}),
}
WIDE_ROUNDS = 10  # rounds of every library and SDPA in turn, a shape
WIDE_MARKER = "flash_attention_hd192_kernel"
WIDE_SWEEP = ((8, 2048), (2, 4096), (1, 8192))  # (B, S) the committed kernel is timed at

# (old, new) edits of csrc/flash_attention.cu
ATTENTION_VARIANTS = {
    "two_stage_ring": [("constexpr int kStages = 3;      // k/v ring", "constexpr int kStages = 2;      // k/v ring")],
}


def variant(name: str, source: Path, edits, declare) -> CudaLibrary:
    text = source.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: the source no longer contains {old!r}")
        text = text.replace(old, new)
    for header in _build._LOCAL_INCLUDE.findall(text):  # the copy includes the committed headers
        text = text.replace(f'"{header}"', f'"{(source.parent / header).resolve()}"')
    path = ROOT / "build" / "variants" / f"{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return CudaLibrary(name, path, declare)


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


def ptxas_stats(text: str, marker: str) -> str:
    """Registers and spill bytes of each kernel whose mangled name holds
    ``marker``, and the lines where ptxas serializes wgmma, from ptxas -v."""
    regs, spills, serialized, name = [], 0, [], ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'|Function properties for (\S+)", line)
        name = (m.group(1) or m.group(2)) if m else name
        if marker not in name:
            continue
        if "Used " in line:
            regs.append(int(line.split("Used ")[1].split()[0]))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills += int(m.group(1)) + int(m.group(2))
        if "serializ" in line:
            serialized.append(line.strip())
    return f"registers {regs}, {spills} spill bytes" + (f", serialized: {serialized}" if serialized else "")


def decode_split_us(fn) -> str:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    parts = {e.key: e.device_time for e in prof.key_averages() if e.device_time > 0}
    partial = sum(t for k, t in parts.items() if "partial" in k or "tc_kernel" in k)
    combine = sum(t for k, t in parts.items() if "combine" in k)
    return f"partial {partial:.2f} us, combine {combine:.2f} us"


def tensor_core_variants() -> None:
    """The bf16 tensor-core decode instance and TC_DECODE_VARIANTS at
    nemotron-4's decode shape, each at its planned split count and at
    TC_SPLITS, in turns with the committed instance and SDPA."""
    libs = {"committed": (DK.LIBRARY, {})}
    libs.update({n: (variant(f"decode_tc_{n}", DK.SOURCE, e, DK._declare), consts)
                 for n, (e, consts) in TC_DECODE_VARIANTS.items()})
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(libs)) as pool:
        texts = dict(zip(libs, pool.map(lambda lib: lib.build(ptxas_verbose=True), [v[0] for v in libs.values()])))
    gen = torch.Generator(device="cuda").manual_seed(0)
    qd = torch.randn((B, NEMO_H, NEMO_HD), generator=gen, device="cuda").to(torch.bfloat16)
    kc, vc = (torch.randn((B, NEMO_LENGTH, NEMO_KV, NEMO_HD), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    want = DR.decode_attention_ref(qd, kc, vc, NEMO_LENGTH)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), enable_gqa=True)
    kernel = lambda: DK.flash_decode(qd, kc, vc, NEMO_LENGTH)  # noqa: E731
    committed = {name: getattr(DK, name) for name in ("LIBRARY", "TC_TILE", "TC_BLOCKS_PER_SM", "splits_for")}
    for name, (lib, consts) in libs.items():
        for key, value in {**committed, **consts, "LIBRARY": lib}.items():
            setattr(DK, key, value)
        lib._lib = None
        try:
            lib.load()
        except RuntimeError as err:  # a residency the card does not give: report it, time nothing
            print(f"flash_decode[hd192] {name}: {err}", flush=True)
            continue
        for g, w in zip(kernel(), want):
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=2e-2)
        plan = committed["splits_for"](B, NEMO_KV, NEMO_H, NEMO_LENGTH, 132, True)
        line = []
        for splits in (plan, *TC_SPLITS):
            DK.splits_for = lambda *a, s=splits: s
            first, library, second = graph_ms(kernel, 100), graph_ms(sdpa, 100), graph_ms(kernel, 100)
            line.append(f"{splits} splits{' (planned)' if splits == plan else ''} {(first + second) / 2 * 1e3:.2f} us "
                        f"(turns {first * 1e3:.2f}, {second * 1e3:.2f}; SDPA {library * 1e3:.2f})")
            if splits == plan:
                line[-1] += f" [{decode_split_us(kernel)}]"
        print(f"flash_decode[hd192] {name} (ptxas: {ptxas_stats(texts[name], 'flash_decode_tc_kernel')}; "
              f"blocks an SM {DK.TC_BLOCKS_PER_SM}): " + "; ".join(line), flush=True)
    for key, value in committed.items():
        setattr(DK, key, value)
    # the committed instance's rate as the length grows: what a launch's
    # fixed costs (the first tiles' latency, the last wave, the combine)
    # take at the serving length
    for length in TC_LENGTHS:
        kl, vl = (torch.randn((B, length, NEMO_KV, NEMO_HD), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        kernel = lambda: DK.flash_decode(qd, kl, vl, length)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qd[:, :, None], kl.transpose(1, 2), vl.transpose(1, 2), enable_gqa=True)
        reads = lambda: (torch.amax(kl), torch.amax(vl))  # noqa: E731  # a read of the same bytes, for scale
        first, library, second = graph_ms(kernel, 20), graph_ms(sdpa, 20), graph_ms(kernel, 20)
        read_ms = graph_ms(reads, 20)
        ms, nbytes = (first + second) / 2, 2 * kl.numel() * 2
        print(f"flash_decode[hd192] committed at length {length}: {ms * 1e3:.2f} us (turns {first * 1e3:.2f}, "
              f"{second * 1e3:.2f}), {nbytes / ms / 1e9:.3f} TB/s of the cache; SDPA {library * 1e3:.2f} us "
              f"({nbytes / library / 1e9:.3f} TB/s); torch.amax of k and v {read_ms * 1e3:.2f} us "
              f"({nbytes / read_ms / 1e9:.3f} TB/s); {decode_split_us(kernel)}", flush=True)
        del kl, vl


def wide_variants(names=()) -> None:
    """The bf16 192-wide flash_attention kernel beside WIDE_VARIANTS (each
    held to the plain version on one batch row first) and WIDE_PROBES
    (timed only), at nemotron-4's prefill shape and at the hd-192
    gradient's forward (with lse): WIDE_ROUNDS rounds, each timing every
    library and SDPA once in turn, so a drift of the card's clock falls on
    all of them; each library's ms is the mean over the rounds, and its
    ratio to the committed kernel the mean of the rounds' ratios. Then the
    committed kernel at WIDE_SWEEP."""
    libs = {"committed": (AK.LIBRARY, {})}
    libs.update({n: (variant(f"attention_wide_{n}", AK.SOURCE, e, AK._declare), consts)
                 for n, (e, consts) in {**WIDE_VARIANTS, **WIDE_PROBES}.items() if not names or n in names})
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(libs)) as pool:
        texts = dict(zip(libs, pool.map(lambda lib: lib.build(ptxas_verbose=True), [v[0] for v in libs.values()])))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    committed = {name: getattr(AK, name) for name in ("LIBRARY", "WIDE_BLOCK_K", "WIDE_STAGES")}

    def use(name):
        lib, consts = libs[name]
        for key, value in {**committed, **consts, "LIBRARY": lib}.items():
            setattr(AK, key, value)
        return lib

    shapes = {"prefill": (B, S, NEMO_H, NEMO_KV, False), "lse": (1, 2 * S, NEMO_H, NEMO_KV, True)}
    inputs = {key: (normal(b, s, h, NEMO_HD), normal(b, s, kv, NEMO_HD), normal(b, s, kv, NEMO_HD), lse)
              for key, (b, s, h, kv, lse) in shapes.items()}
    q, k, v, _ = inputs["prefill"]
    want = AR.mha_ref(q[:1], k[:1], v[:1]).float()
    for name in libs:
        lib = use(name)
        lib._lib = None
        lib.load()
        if name == "committed" or name in WIDE_VARIANTS:
            torch.testing.assert_close(AK.flash_attention(q[:1], k[:1], v[:1]).float(), want, rtol=2e-2, atol=2e-2)
        print(f"flash_attention[hd192] {name}{'' if name == 'committed' or name in WIDE_VARIANTS else ' (probe: not checked)'}"
              f": BK {AK.block_k(192)}, {AK.WIDE_STAGES} stages; ptxas: {ptxas_stats(texts[name], WIDE_MARKER)}",
              flush=True)
    for key, (qq, kk, vv, lse) in inputs.items():
        calls = {name: (lambda n=name: (use(n), AK.flash_attention(qq, kk, vv, with_lse=lse))) for name in libs}
        calls["SDPA"] = lambda: F.scaled_dot_product_attention(
            qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2), is_causal=True, enable_gqa=True)
        rounds = [{name: graph_ms(fn, 10) for name, fn in calls.items()} for _ in range(WIDE_ROUNDS)]
        clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                                capture_output=True, text=True, timeout=60).stdout.strip()
        for name in calls:
            ms = [r[name] for r in rounds]
            ratio = sum(r[name] / r["committed"] for r in rounds) / len(rounds)
            print(f"flash_attention[hd192] {key} {name}: {sum(ms) / len(ms):.4f} ms (min {min(ms):.4f}, max "
                  f"{max(ms):.4f} over {len(ms)} rounds), {ratio:.4f}x the committed kernel", flush=True)
        print(f"flash_attention[hd192] {key}: SM clock, power after the rounds: {clocks}", flush=True)
    use("committed")
    del inputs, q, k, v
    # the committed kernel's rate as each block's work grows (the same
    # FLOPs at B x S^2 = 8 x 2,048^2): what each work item's fixed costs
    # (its q load, the first k tile's latency, the diagonal, the epilogue)
    # take at S 2,048
    for b, s in WIDE_SWEEP:
        q, k, v = normal(b, s, NEMO_H, NEMO_HD), normal(b, s, NEMO_KV, NEMO_HD), normal(b, s, NEMO_KV, NEMO_HD)
        kernel = lambda: AK.flash_attention(q, k, v)  # noqa: E731
        first, second = graph_ms(kernel, 10), graph_ms(kernel, 10)
        ms, flops = (first + second) / 2, 4 * b * NEMO_H * NEMO_HD * s * (s + 1) // 2
        print(f"flash_attention[hd192] committed at B {b}, S {s}: {ms:.4f} ms (turns {first:.4f}, {second:.4f}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {b * NEMO_H * -(-s // AK.BLOCK_Q)} work items", flush=True)
        del q, k, v


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, f"| torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    if "--tensor-cores" in sys.argv[1:]:
        tensor_core_variants()
        return 0
    if "--wide" in sys.argv[1:]:
        wide_variants(sys.argv[sys.argv.index("--wide") + 1:])
        return 0
    decode = {"committed": DK.LIBRARY}
    decode.update({n: variant(f"decode_{n}", DK.SOURCE, e, DK._declare) for n, e in DECODE_VARIANTS.items()})
    attention = {"committed": AK.LIBRARY}
    attention.update({n: variant(f"attention_{n}", AK.SOURCE, e, AK._declare)
                      for n, e in ATTENTION_VARIANTS.items()})
    from concurrent.futures import ThreadPoolExecutor

    libs = list(decode.values()) + list(attention.values())
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs))

    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    qd, kc, vc = normal(B, H, HD), normal(B, LENGTH, KV, HD), normal(B, LENGTH, KV, HD)
    sdpa_decode = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), enable_gqa=True)
    copy_dst = torch.empty_like(kc)
    copy_ms = graph_ms(lambda: copy_dst.copy_(kc), 100)
    print(f"device copy of one cache ({kc.numel() * 2} bytes read and written): {copy_ms * 1e3:.2f} us, "
          f"{2 * kc.numel() * 2 / copy_ms / 1e9:.3f} TB/s", flush=True)
    want = DR.decode_attention_ref(qd, kc, vc, LENGTH)
    committed_splits = DK.splits_for
    runs = [(name, lib, None) for name, lib in decode.items()]
    runs += [(f"committed, {s} splits", decode["committed"], s) for s in (12, 17, 34)]
    for name, lib, splits in runs:
        DK.LIBRARY = lib
        DK.splits_for = committed_splits if splits is None else (lambda *a, s=splits: s)
        got = DK.flash_decode(qd, kc, vc, LENGTH)
        if name != "loads_only":
            for g, w in zip(got, want):
                torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=2e-2)
        kernel = lambda: DK.flash_decode(qd, kc, vc, LENGTH)  # noqa: E731
        first, library, second = graph_ms(kernel, 100), graph_ms(sdpa_decode, 100), graph_ms(kernel, 100)
        print(f"flash_decode {name}: {(first + second) / 2 * 1e3:.2f} us/launch (turns {first * 1e3:.2f}, "
              f"SDPA {library * 1e3:.2f}, {second * 1e3:.2f}); {decode_split_us(kernel)}", flush=True)
    DK.LIBRARY, DK.splits_for = decode["committed"], committed_splits

    q, k, v = normal(B, S, H, HD), normal(B, S, KV, HD), normal(B, S, KV, HD)
    want = AR.mha_ref(q, k, v).float()
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True)
    for name, lib in attention.items():
        AK.LIBRARY = lib
        torch.testing.assert_close(AK.flash_attention(q, k, v).float(), want, rtol=2e-2, atol=2e-2)
        kernel = lambda: AK.flash_attention(q, k, v)  # noqa: E731
        first, library, second = graph_ms(kernel, 10), graph_ms(sdpa, 10), graph_ms(kernel, 10)
        print(f"flash_attention {name}: {(first + second) / 2:.4f} ms/launch (turns {first:.4f}, "
              f"SDPA {library:.4f}, {second:.4f})", flush=True)
    AK.LIBRARY = attention["committed"]
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
