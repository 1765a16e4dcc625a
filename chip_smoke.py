#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card (Hopper:
the kernels build for sm_90a). Phases, each printed as it ends:

1. build the fused-IGD CUDA kernels from src/repro_torch/kernels/igd_fused/csrc
   (and print igd_fold_minibatch's cluster size and shared memory a CTA);
2. hold each kernel against its plain PyTorch version on the card, for the
   three losses (rtol=2e-4, atol=2e-5, the reference's kernel tolerance;
   TF32 off for matmuls and cuDNN); igd_fold also at the shapes that cut
   its 32-row sub-tile and cross its D = 256 instance boundary, there held
   to both the per-row fold and the tiled fold (ref.igd_fold_tiled_ref) on
   the CPU, and on a 65,536-row Forest prefix to a float64 fold on the CPU
   (beside the per-row float32 fold's distance from it);
   igd_fold_minibatch also to the plain version of its cluster's order
   (ref.igd_fold_minibatch_split_ref) over the full epoch, and to both
   plain versions at N around the 256-row tile and the cluster's span and
   D across its D = 256 instance boundary up to its limit, N = 0 (w0
   exactly) and x, y, alpha off a 16-byte boundary;
3. run the engine end to end on a Forest-shaped table (581,012 x 54 f32,
   UCI Covertype's shape, label-clustered, generated on the card from
   --seed): logreg with no hints (the probe-priced plan must choose
   cuda_fused), a warm repeat that must build nothing, svm under
   shuffle_always + cuda_fused and least_squares under clustered +
   cuda_minibatch by hint; then a small-input agreement check against the
   eager fold on the CPU;
3b. the paper's other execution schemes (eager, no kernel form) on the
   Forest-shaped table cut to SCHEME_ROWS rows at full width (its first and
   last SCHEME_ROWS / 2 rows, so both labels, clustered): logreg with an
   L1 prox (mu > 0, not kernel-eligible) under a memory budget below the
   table's bytes, which the planner must answer with buffered MRS; svm
   segmented (k = 8) and under each shared-memory scheme by hint; each
   run's loss and per-row time on the card beside the probed eager fold;
   the same plans on a 4,096-row slice: one epoch of each scheme's program
   under torch.cuda.set_sync_debug_mode("error") (no scheme reads data
   back to the host), then each run on the card and on the CPU with the
   same draws (draws.HostDraws), held to rtol=2e-4, atol=2e-5; a cold and
   a warm Engine.run wall of a planned
   query (logreg, 2,048 x 32, 5 epochs: benchmarks/engine_bench.py's
   quick query);
3d. stored tables and serving (the engine's data-source and batching
   axes): the lane kernels (B folds in one launch, a block or a cluster a
   lane) against their plain versions on the CPU and every lane against
   its own one-lane launch bit for bit (B 1, 3, 32; shared and stacked
   tables; D 54 and 200 on the Gram and cluster instances, 300 on the
   per-row and one-block ones; N across the sub-tile and tile edges); the
   Forest-shaped table as a ChunkedTable of 65,536-row host chunks,
   logreg (clustered serial by hint; the planner streams it,
   source="table", and picks the lane body by probe)
   and least_squares (cuda_minibatch) for 2 epochs beside the resident
   run (seconds an epoch, from pageable and from pinned host memory,
   bytes to the card an epoch, launches an epoch, distance), one
   igd_fold epoch streamed chunk by chunk against one
   launch and a float64 fold on the CPU; 32 logreg queries (cuda_fused)
   and 8 least_squares queries (cuda_minibatch), shuffle_always, budgets
   3 and 2 alternating, served as one masked fused batch each through
   ServingEngine beside the same queries one at a time through
   Engine.run (queries a second; every kernel lane equal to its
   singleton run bit for bit; one launch an epoch); a fresh server on the
   same plan store that plans and probes nothing;
3e. sharded local SGD (parallelism="sharded" by hint: the planner probes
   no mesh point on one card) on the Forest-shaped table, nothing cut:
   one k = 4 igd_fold lane launch over 4 x 16,384-row segments against
   its plain version; logreg (cuda_fused) at k in (1, 2, 4) x H in
   (1, 3), least_squares (cuda_minibatch) at k in (1, 4), and logreg
   (torch_fold, one epoch) at k in (1, 4) on phase 3b's 12,288-row cut,
   each under clustered, shuffle_once and shuffle_always: k = 1 equal to
   the singleton run bit for bit, one launch an epoch (the k shards are
   the lanes of one launch), losses falling, ms an epoch beside the
   singleton's; a 3-epoch k = 4 clustered run against a float64 replay
   of its blocks and merges (1e-4); the merge tree's ms; 8 logreg
   queries x 4 shards (seeds 0-7, budgets 3 and 2 alternating) served as
   one fused sharded batch, clustered and shuffle_always, beside the same
   queries one at a time (queries a second; every query equal to its own
   sharded run bit for bit; one launch of 32 lanes an epoch); then the
   k = 4 lane launches alone beside the one-lane launch (CUDA events),
   igd_fold_minibatch also on 16-byte-aligned lane strides; the `kernels`
   line's `launches_sharded` counts the sharded runs and drains alone;
3f. obs (repro_torch.obs) around the fused-IGD path, lines tagged [obs]:
   EXPLAIN ANALYZE of phase 3's logreg query (cuda_fused) with a plan
   store in a temporary directory under build/ (drift rows, staleness,
   critical-path phase shares, the engine.kernel spans' total beside the
   gradient wall, launches; a fresh Engine reads the same report back);
   the same query's epoch wall (3 epochs, warm) with tracing off, the
   flight ring only and full tracing, 3 runs each in turns, beside the
   disabled and flight span costs; one traced cuda_fused epoch with the
   ring on under set_sync_debug_mode("error"); a served burst of 16
   logreg cuda_fused + 8 least_squares cuda_minibatch queries
   (shuffle_always, budgets 3 and 2 alternating) and one singleton
   logreg query, under the default SLO rules and the obs HTTP server on
   an ephemeral port, /metrics scraped from a thread while the pump runs
   and parsed (fused lanes, accepted and the logreg latency histogram
   held to the tickets); a forced breach (p99 > 0) whose incident files
   must validate and hold an engine.kernel span; then logreg at D =
   4,097 and least_squares at D = 12,033 (WIDE_ROWS rows): planned past
   the kernels that cannot take D, 2 epochs held to the CPU's run with
   draws.HostDraws (rtol=2e-4, atol=2e-5), and the cuda_fused /
   cuda_minibatch hints past their limits refused naming the limit; the
   `kernels` line's `launches_obs` counts the phase's runs and drains;
4. time each kernel at the main path's shape with CUDA events, beside its
   plain version and its bound; igd_fold also beside its chain floor (N
   times one grad_scale + FMA step timed alone in one warp),
   igd_fold_minibatch beside its tile-chain floor (the tiles times one
   tile's step timed with the tile resident in shared memory); both also
   as lane launches at B = 1, 8, 32 over the shared table, beside 32
   one-lane launches in the same call;
5. build the flash-attention (forward and gradient) and flash-decode CUDA
   kernels from src/repro_torch/kernels/{attention,decode}/csrc (all four
   sources are compiled at once, one nvcc each, when the script starts);
6. hold both against their plain PyTorch versions on the card in float32
   (TF32 off; 2e-5 attention, 5e-5 decode) and bfloat16 (2e-2), the
   reference's tolerances: its test shapes, ragged S, hd 72, decode lengths
   0, 1, 63, 64, 65, 700 and S_max with 1, 3, 4 and 8 q heads per kv head
   (m and l too), the serving path's full shape, and in bf16 q, k, v as
   slices of one fused buffer and k, v as cache[:, :S] views; then the
   instances the other families run (ATTN_EXTRA, DECODE_EXTRA): the
   attention-logit soft cap (30, grok-1's), q rows at cache offsets 1, 127,
   128 and 1,000 (k/v longer than q), heads 80 (zamba2) and 192
   (nemotron-4, the 192-wide instances), flash_decode's out, m and l
   capped and at hd 192, both dtypes, at the same tolerances;
7. serve llama3.2-3b at full width and full depth (28 layers, random
   weights from --seed, float32 params, bfloat16 compute): 8 requests of
   2,048 prompt tokens, one prefill step, one prefill into the KV cache
   and 128 greedy decode steps (S_max 2,176), counting the kernels'
   launches;
7b. serve every other architecture at full width through the same
   builders (random weights from --seed, float32 params, bfloat16
   compute): 8 requests of 2,048 positions (vlm/audio: the prefix
   embeddings and 2,048 - n_prefix tokens), a prefill step, a prefill into
   the cache and 32 greedy decode steps, counting launches (flash_attention
   once per attention application per prefill, flash_decode once per
   application per step, none for xLSTM); depth cut only where the float32
   params beside their bf16 copy do not fit one card (FAMILY_DEPTH:
   qwen3-moe 2 of 94 layers, grok-1 1 of 64, nemotron-4 1 of 96 with
   bfloat16 params). xlstm-350m (no prefill into a cache: an mLSTM refuses
   it, as the reference's does) replays its first 128 tokens through
   decode_step before the greedy steps, and in float32 that replay is held
   to the parallel forward at the reference's 2e-3 over the first
   segment (8 layers; over all 24 the difference is printed). Then
   llama3.2-3b's prompt as two 1,024-token chunks (the second at cache
   index 1,024) against the one-shot prefill (bf16, 2e-2); then each
   family at full width, 1-8 layers (FAMILY_CPU), float32 compute, TF32
   off: a 256-token prefill into the cache (after the prefix) and 8
   teacher-forced steps (the xLSTM replays its prompt), card kernels
   against the CPU's plain path (rtol = atol = 1e-3); nemotron-4's held on
   the blocks' output before the head (its float32 head would not fit
   beside the rest on the CPU's side);
8. hold the card's kernel path to the CPU's plain path on a 2-layer,
   full-width, float32 llama3.2-3b: a 256-token prefill into the cache
   and 8 teacher-forced decode steps, B=2 (rtol = atol = 1e-3);
9. time both attention kernels at the serving path's shapes (device time
   from a replayed CUDA graph, and per eager call), beside their plain
   versions, their bounds and scaled_dot_product_attention, timed in turns
   in the same run (kernel, library, kernel), with the achieved TFLOP/s or
   GB/s and the share of the bound; then the new instances at their
   families' shapes: flash_attention soft-capped (grok-1's heads; no
   library call computes capped attention without compiling), at an
   offset (llama3.2-3b's second chunk; SDPA with a bottom-right causal
   mask) and at hd 192 (nemotron-4's heads; SDPA is_causal), flash_decode
   soft-capped and at hd 192 (SDPA over the cache, out only).

10. LM training on the card (lines tagged [train]): 10a the forward's lse
   and the three gradient kernels (flash_attention_bwd.cu: D, dk/dv, dq;
   bf16 at widths 64 and 128 on wgmma fed by TMA with a producer
   warpgroup, at 192 on mma.sync) against ref.mha_lse_ref /
   ref.mha_backward_ref over hd 64/80/128/136/192
   (80 and 136 padded into the 128- and 192-wide bf16 instances) x
   q heads a kv head 1/3/6/12 x S 37/1,000/2,048 x soft cap off/30, both
   dtypes, TF32 off; FlashAttention's gradient against autograd through
   ref.mha_ref; flash_decode and both IGD kernels refusing an input that
   requires grad; 10b llama3.2-3b at full width, 2 layers, float32, one
   grad_accum=2 IGD-momentum step (B 2, S 512) on the card and on the CPU
   from the same params, every updated param and momentum buffer within
   1e-4 of the CPU's (relative to its largest element); 10c llama3.2-3b at
   full width and depth (float32 params, bf16 activations, remat "full"),
   S 4,096, 8 x 4,096 tokens a step (grad_accum 8), token_stream data on
   the card: 4 IGD steps (momentum 0.9, diminishing(0.002, 200)) then 2
   AdamW steps from the same start, each step's loss, step time (CUDA
   events), tokens/s, model FLOP/s against 989 TFLOP/s, peak memory, the
   launches (flash_attention 28 x 8 x 2 a step, forward and recompute;
   flash_attention_bwd 28 x 8 x 3), the last IGD step's device time by
   kind and idle share under the profiler, the optimizer's update alone;
   10d at full width, 2 layers: 6 fit steps against 3, a checkpoint on
   disk, a fresh fit and 3 more (rtol 1e-6, atol 1e-7); then the gradient
   kernels' and the forward's (lse on and off) times at the training shape
   (B 1, S 4,096, 24/8 heads, hd 128, bf16), where the gradient kernels
   and lse are also held to mha_backward_ref / mha_lse_ref, beside the
   plain version, the bound and SDPA's backward, with each of the call's
   three launches' device time under the profiler; the gradient at hd 192
   (nemotron-4's heads, B 1, S 4,096, 96/8) beside its bound and SDPA's
   backward in turns, and the lse forward beside SDPA's forward in turns.
11. the LM across a mesh (lines tagged [mesh]): 11a the length-sharded
   decode (dist.collectives.sharded_flash_decode) at llama3.2-3b's heads,
   B 8, a 32,768-position bf16 cache as 4 and 16 slices of one cache, at
   lengths 1, 1,000, 8,192, 20,000 and 32,768 (each shard one flash_decode
   launch, counted: zeroed just before, read just after; the kernels line's
   launches_sharded), held to the unsharded kernel and to
   decode_attention_ref (2e-2 bf16, 5e-5 f32 at one case), then through a
   (1, 1) mesh of one NCCL rank, with ms a call beside the one unsharded
   launch in turns; 11b make_train_step(param_shardings=...) on that mesh
   at 10b's shape, 3 steps against the unsharded ones (1e-4 of each leaf's
   largest element; says whether bitwise), and fit(mesh=...) 2 steps with
   a checkpoint, elastic_restore onto no mesh and a fit resuming 2 more,
   against 4 uninterrupted steps on the mesh (10d's tolerances). The
   process group is destroyed at the end of the phase.

The second-to-last lines are one JSON object of per-kernel results and the
card's name and power limit; the last line is the run's verdict. Any
failure exits non-zero before those lines are printed; without a card the
script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

FOREST_ROWS, FOREST_DIM = 581_012, 54  # UCI Covertype (paper Table 1)
FOLD_PREFIX = 16_384  # rows the per-row plain fold is held to on the card
# N not a multiple of 256, D not of 128; one warp, then 8 and 16 warps
RAGGED = ((3_001, 77), (777, 1_500), (257, 4_096))
# igd_fold: N around its 32-row sub-tile, D on both sides of its instance boundary
FOLD_SHAPES = tuple((n, d) for n in (1, 31, 33, 16_385) for d in (54, 128, 256, 257))
F64_PREFIX = 65_536  # rows the kernel is held to a float64 fold on
# igd_fold_minibatch: D across the cluster instance's bound (256) up to the
# one-block kernel's limit (12,032); N around the 256-row tile (and, added
# at run time, around the cluster's span of 256 x its CTAs; N = 0 must
# return w0 exactly)
MB_D = (1, 54, 256, 257, 12_032)
MB_N = (0, 1, 255, 257, 16_385)
KERNEL_RTOL, KERNEL_ATOL = 2e-4, 2e-5
# phase 3b: rows of the Forest-shaped table the eager schemes run on (cut
# so the phase stays within ~90 s on the card: the eager fold costs
# 140-310 us a row there, with the host's speed, MRS 2-3x that), their
# epochs, and the slice held to the CPU
SCHEME_ROWS, SCHEME_EPOCHS, SCHEME_SLICE = 12_288, 2, 4_096
# phase 3c: the other techniques' tables at their sources' widths (see
# techniques() for the sources and the row cuts), the rows each runs
# IGD over, the LMF slice the non-serial schemes run on, and the slice
# held to the CPU
DBLIFE_ROWS, DBLIFE_DIM = 1_024, 41_000  # DBLife (paper Table 1): 16,384 rows
ML_USERS, ML_MOVIES, ML_RATINGS = 6_040, 3_952, 1_000_209  # MovieLens 1M (GroupLens)
ML_SAMPLE = 1_024
CONLL_SENTENCES, CONLL_TOKENS, CONLL_TAGS = 128, 32, 23  # CoNLL-2000 chunking: 23 tags, 8,936 sentences
KALMAN_HORIZON, KALMAN_OBS = 1_024, 8  # paper_tasks.KALMAN: horizon 2,048
SP500_ASSETS, SP500_PERIODS = 500, 1_024  # an S&P 500-sized universe; ten years are 2,520 trading days
TECH_SLICE, SYNC_SLICE = 512, 64
# phase 3d: lane launches (B, D, N), the stored table's chunks and epochs,
# the served queries, and the lane widths timed in phase 4
LANE_B = (1, 3, 32)
LANE_FOLD_D, LANE_FOLD_N = (54, 200, 300), (31, 33, 257)
LANE_MB_D, LANE_MB_N = (54, 200, 300), (255, 257, 2_049)
TABLE_CHUNK, TABLE_EPOCHS = 65_536, 2
SERVE_QUERIES, SERVE_MB_QUERIES = 32, 8
# phase 3e: epochs a sharded run, the lane check's segment rows, the float64
# replay's bound, the queries of the fused sharded batch
SHARD_EPOCHS, SHARD_LANE_ROWS, SHARD_F64_TOL, SHARD_SERVE_QUERIES = 3, 16_384, 1e-4, 8
TIMED_LANES = (1, 8, 32)
# phase 3f: rows of the tables wider than the IGD kernels take (D 4,097 and 12,033)
WIDE_ROWS = 8_192
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
LOSSES = ("lr", "svm", "lsq")

# the serving path: 8 requests of 2,048 prompt tokens, then 128 decode steps
SERVE_B, PROMPT, DECODE_STEPS = 8, 2048, 128
S_MAX = PROMPT + DECODE_STEPS
PROFILED_STEPS = 4  # decode steps under the profiler, after the counted run
# (B, S, H, Kv, hd): the reference's test shapes, then ragged S around the
# 128-row tile, hd between the bf16 kernel's widths, 3 q heads per kv head
ATTN_SHAPES = ((2, 256, 4, 2, 64), (1, 128, 4, 4, 128), (2, 384, 6, 2, 32),
               (1, 300, 4, 2, 64), (2, 1000, 8, 2, 128), (2, 65, 6, 2, 72), (1, 1, 4, 4, 64))
# (B, H, Kv, hd, S, length): the reference's test shapes, then lengths at
# the 64-position tile's edges with 1, 3, 4 and 8 q heads per kv head
DECODE_SHAPES = ((2, 4, 2, 64, 1024, 700), (1, 8, 8, 128, 512, 512), (4, 4, 1, 32, 2048, 1),
                 (2, 2, 2, 128, 2176, 0), (2, 6, 2, 128, 2176, 63), (2, 8, 2, 128, 2176, 64),
                 (2, 16, 2, 128, 2176, 65))
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DECODE_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
CPU_AGREE_TOL = 1e-3  # sums over 3,072 and 8,192 terms in other orders
# phase 6, the other families' instances. (B, S, offset, H, Kv, hd, softcap):
# q rows at positions offset + i over k/v [B, offset + S]
ATTN_EXTRA = ((2, 256, 0, 8, 2, 128, 30.0), (2, 300, 1, 6, 2, 128, 0.0), (2, 300, 127, 6, 2, 128, 0.0),
              (2, 300, 128, 6, 2, 64, 0.0), (1, 1024, 1000, 8, 2, 128, 0.0), (1, 1024, 1000, 8, 2, 128, 30.0),
              (2, 300, 0, 32, 32, 80, 0.0), (1, 256, 77, 4, 4, 80, 30.0), (2, 333, 0, 12, 2, 192, 0.0),
              (1, 1024, 0, 96, 8, 192, 0.0), (2, 200, 128, 6, 2, 192, 30.0))
# (B, H, Kv, hd, S, length, softcap)
DECODE_EXTRA = ((2, 48, 8, 128, 2080, 2049, 30.0), (2, 6, 2, 128, 700, 1, 30.0), (8, 96, 8, 192, 2080, 2049, 0.0),
                (2, 16, 2, 192, 700, 65, 30.0), (2, 12, 1, 192, 300, 0, 0.0), (2, 32, 32, 80, 2080, 2049, 0.0))
# phase 7b: every other architecture, 8 x 2,048 positions, 32 greedy steps;
# the depth cuts of the three whose float32 params and bf16 copy exceed one
# card (qwen3-moe 14.7 GB a layer, grok-1 29.5, nemotron-4 25.8 GB for one
# layer and its bf16 embedding and head)
FAMILY_STEPS, FAMILY_REPLAY = 32, 128
FAMILY_DEPTH = {"qwen3-moe-235b-a22b": dict(n_layers=2), "grok-1-314b": dict(n_layers=1),
                "nemotron-4-340b": dict(n_layers=1, param_dtype="bfloat16")}
# the card-vs-CPU check per family: (layers and other cuts, batch). MoE
# routes groups of 256 tokens there (capacity 24 / 80 slots an expert),
# which keeps the CPU's float32 expert products (every capacity slot of
# every expert, each call) to seconds; hybrid and ssm take one segment
FAMILY_CPU = {"qwen3-moe-235b-a22b": (dict(n_layers=2, moe_block=256), 2),
              "grok-1-314b": (dict(n_layers=1, moe_block=256), 1),
              "nemotron-4-340b": (dict(n_layers=1), 1), "zamba2-2.7b": (dict(n_layers=6), 2),
              "xlstm-350m": (dict(n_layers=8), 2), "internvl2-2b": (dict(n_layers=2), 2),
              "musicgen-medium": (dict(n_layers=2), 2), "minitron-4b": (dict(n_layers=2), 2),
              "starcoder2-7b": (dict(n_layers=2), 2)}
CPU_PROMPT, CPU_STEPS = 256, 8
# phase 10, LM training on the card. 10a: the gradient kernels and the
# forward's lse over hd x g (q heads a kv head) x ragged S x soft cap, both
# dtypes; a gradient sums up to g * S terms, so the absolute part of each
# tolerance is scaled by the plain result's largest entry (at least 1). hd
# 80 (zamba2's) and 136 run padded in the 128- and 192-wide bf16 instances
BWD_HD, BWD_G, BWD_S, BWD_CAPS = (64, 80, 128, 136, 192), (1, 3, 6, 12), (37, 1000, 2048), (0.0, 30.0)
BWD_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
LSE_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (1e-3, 1e-3)}
# 10b: llama3.2-3b at full width, 2 layers, float32, one grad_accum=2 IGD
# step on the card and on the CPU; each updated param within 1e-4 of the
# CPU's, relative to its largest element
TRAIN_CPU_LAYERS, TRAIN_CPU_B, TRAIN_CPU_S, TRAIN_CPU_TOL = 2, 2, 512, 1e-4
# 10c: full width and depth at train_4k's sequence (4,096; configs/base.py
# TRAIN_4K), its global batch of 256 cut to 8 (microbatch 1 x 4,096)
TRAIN_S, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_IGD_STEPS, TRAIN_ADAMW_STEPS = 4096, 8, 8, 4, 2
# IGD's step size in phase 10: diminishing(0.002, 200) with momentum 0.9.
# examples/train_lm.py's 0.02 (set for a ~100M model) diverges at
# llama3.2-3b's width: losses 12.08, 9.63, 18.21, 24.83 over 4 steps on the
# card (PR 23), while the step itself is held to the reference on the CPU
# and to the CPU on the card (10b)
TRAIN_IGD_STEP = (0.002, 200.0)
# 10d: resume at full width, 2 layers: 6 steps against 3 + a checkpoint + 3
RESUME_STEPS, RESUME_B, RESUME_S, RESUME_ACCUM = 6, 2, 1024, 2
RESUME_RTOL, RESUME_ATOL = 1e-6, 1e-7  # the reference's (tests/test_fault_tolerance.py)
# the extra timings of phase 10: the hd 192 gradient (the mma.sync
# kernels) at nemotron-4's heads, and the lse forward beside SDPA's forward
BWD192_SHAPE = (1, 4096, 96, 8, 192)  # (B, S, H, Kv, hd), bf16
# phase 11, the LM across a mesh. 11a: the length-sharded decode at
# llama3.2-3b's heads over decode_32k's 32,768 cached positions, its batch
# of 128 cut to 8 (128 would take 17 GB a layer), as n slices of one cache
# (16: the production mesh's "model" axis); lengths inside shard 0, on a
# boundary, past the middle and full; f32 at one length
MESH_DECODE_B, MESH_DECODE_S = 8, 32768
MESH_SHARDS, MESH_LENGTHS = (4, 16), (1, 1000, 8192, 20000, 32768)
MESH_F32_CASE = (16, 20000)
# 11b: a sharded step at 10b's shape on a (1, 1) mesh of one NCCL rank, held
# to the unsharded step (relative to each leaf's largest element, as 10b);
# fit on the mesh 2 + 2 steps around a checkpoint, resumed with no mesh,
# against 4 uninterrupted steps on the mesh (10d's shape and tolerances)
MESH_TRAIN_TOL, MESH_TRAIN_STEPS, MESH_FIT_STEPS = 1e-4, 3, 4
# the gradient call's three launches, by a substring of their kernels' names,
# and the calls profiled to time each
BWD_KINDS, BWD_PROFILED = {"D": "rowdot_kernel", "dk/dv": "dkdv_kernel", "dq": "dq_kernel"}, 10
# the kernel instances the other families added, each a row of the kernels line
INSTANCES = ("flash_attention[softcap]", "flash_attention[offset]", "flash_attention[hd192]",
             "flash_decode[softcap]", "flash_decode[hd192]")


def _instances(kernel: str, softcap: float, offset: int, hd: int) -> list:
    """The new instances a call of ``kernel`` exercises."""
    tags = [tag for tag, on in (("softcap", softcap > 0), ("offset", offset > 0), ("hd192", hd > 128)) if on]
    return [f"{kernel}[{tag}]" for tag in tags]


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


def ptxas_report(name: str, text: str) -> str:
    regs = [int(line.split("Used ")[1].split()[0]) for line in text.splitlines() if "Used " in line]
    spills = [line for line in text.splitlines()
              if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line]
    if spills:
        raise AssertionError(f"register spills in {name}: {spills}")
    return f"{len(regs)} kernels, max {max(regs)} registers/thread, no spills"


def max_err(got, want, what: str, rtol: float = KERNEL_RTOL, atol: float = KERNEL_ATOL) -> float:
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
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


def sm_clocks_during(fn, launches: int) -> str:
    """nvidia-smi's SM clock (and the reasons it reports for holding it
    down) sampled while ``fn`` runs ``launches`` times back to back."""
    import threading

    fields = "clocks.sm,power.draw,clocks_event_reasons.active"
    try:
        smi(fields)
    except subprocess.CalledProcessError:
        fields = "clocks.sm,power.draw"
    samples, done = [], threading.Event()

    def sample():
        while not done.is_set():
            samples.append(smi(fields))

    torch.cuda.synchronize()
    thread = threading.Thread(target=sample)
    thread.start()
    for _ in range(launches):
        fn()
    torch.cuda.synchronize()
    done.set()
    thread.join()
    mhz = sorted(float(line.split(",")[0].split()[0]) for line in samples)
    if not mhz:
        return "no sample"
    return (f"{len(mhz)} samples ({fields}), SM clock min {mhz[0]:.0f} / median {mhz[len(mhz) // 2]:.0f} / "
            f"max {mhz[-1]:.0f} MHz; last sample: {samples[-1]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch import engine, timing
    from repro_torch.core import draws
    from repro_torch.data import synthetic
    from repro_torch.engine import catalog
    from repro_torch.kernels.igd_fused import kernel as K, ref as R
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.decode import kernel as DK

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi("name,power.limit")
    log("setup", f"{torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda} | TF32 off (matmul, cuDNN)")

    # -- 1. build (every source at once: one nvcc each) ---------------------
    watch = timing.Stopwatch()
    pool = ThreadPoolExecutor(max_workers=4)
    builds = {lib.name: pool.submit(lib.build, ptxas_verbose=True)
              for lib in (K.LIBRARY, AK.LIBRARY, AK.BWD_LIBRARY, DK.LIBRARY)}
    ptxas = builds["igd_fused"].result()
    K._load()
    cluster, mb_smem = K.minibatch_design(FOREST_DIM)
    log("build", f"igd_fused.cu -> {K.library_path().name} in {watch.lap():.2f} s "
        f"({ptxas_report('igd_fused.cu', ptxas)}); igd_fold_minibatch at D={FOREST_DIM}: a cluster of "
        f"{cluster} CTAs, {mb_smem} bytes of dynamic shared memory a CTA")

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
    # the sub-tile's edges and the instance boundary, against both plain folds on the CPU
    fold_errs = {"per-row": 0.0, "tiled": 0.0}
    for n, d in FOLD_SHAPES:
        args_ = inputs(gen, n, d, dev)
        on_cpu = [t.cpu() for t in args_]
        for loss in LOSSES:
            got = K.igd_fold(*args_, loss=loss).cpu()
            for name, plain in (("per-row", R.igd_fold_ref), ("tiled", R.igd_fold_tiled_ref)):
                fold_errs[name] = max(fold_errs[name], max_err(
                    got, plain(*on_cpu, loss=loss), f"igd_fold {loss} {n}x{d} vs the {name} fold"))
    errs["igd_fold"] = max(errs["igd_fold"], *fold_errs.values())
    log("parity", f"igd_fold at N in (1, 31, 33, 16385) x D in (54, 128, 256, 257), lr, svm, lsq: max |err| "
        f"{fold_errs['per-row']:.3g} against the per-row fold, {fold_errs['tiled']:.3g} against the tiled fold")
    # igd_fold_minibatch: the cluster's order over the full epoch, then the
    # tile's and the cluster's edges and the instance boundary, against both
    # plain versions (on the card, TF32 off)
    k = K.MINIBATCH_CLUSTER
    split = functools.partial(R.igd_fold_minibatch_split_ref, parts=k)
    mb_errs = {"plain": 0.0, "split": 0.0}
    for loss in LOSSES:
        mb_errs["split"] = max(mb_errs["split"], max_err(K.igd_fold_minibatch(x, y, alpha, w0, loss=loss),
                                                         split(x, y, alpha, w0, loss=loss),
                                                         f"igd_fold_minibatch {loss} full epoch vs the split fold"))
    mb_shapes = [(n, d) for n in MB_N + (256 * k - 1, 256 * k + 1) for d in MB_D]
    for n, d in mb_shapes:
        args_ = inputs(gen, n, d, dev)
        for loss in LOSSES:
            got = K.igd_fold_minibatch(*args_, loss=loss)
            for name, plain in (("plain", R.igd_fold_minibatch_ref), ("split", split)):
                mb_errs[name] = max(mb_errs[name], max_err(
                    got, plain(*args_, loss=loss), f"igd_fold_minibatch {loss} {n}x{d} vs the {name} fold"))
            if n == 0 and not torch.equal(got, args_[3]):
                raise AssertionError(f"igd_fold_minibatch {loss} 0x{d} did not return w0")
        del args_
    # off a 16-byte boundary: the plain-load path, the same w bit for bit
    for d in (54, 256):
        args_ = inputs(gen, 3_001, d, dev)
        shifted = [torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t) for t in args_[:3]]
        for loss in LOSSES:
            want = K.igd_fold_minibatch(*args_, loss=loss)
            if not torch.equal(K.igd_fold_minibatch(*shifted, args_[3], loss=loss), want):
                raise AssertionError(f"igd_fold_minibatch {loss} 3001x{d}: unaligned rows give another w")
    errs["igd_fold_minibatch"] = max(errs["igd_fold_minibatch"], *mb_errs.values())
    log("parity", f"igd_fold_minibatch: full {FOREST_ROWS}x{FOREST_DIM} epoch vs the split fold (parts={k}) and N in "
        f"{sorted({n for n, _ in mb_shapes})} x D in {MB_D} vs both plain folds, lr, svm, lsq: max |err| "
        f"{mb_errs['plain']:.3g} against the plain fold, {mb_errs['split']:.3g} against the split fold; "
        "N = 0 returned w0; x, y, alpha off a 16-byte boundary gave the same w bit for bit (D 54, 256)")
    # a longer prefix against float64: the per-row float32 fold drifts from it
    # with N (it rounds w every row), so the kernel is held to float64 here
    xf, yf, af = (t[:F64_PREFIX] for t in (x, y, alpha))
    f64 = [t.cpu().double() for t in (xf, yf, af, w0)]
    f32 = [t.cpu() for t in (xf, yf, af, w0)]
    for loss in LOSSES:
        exact = R.igd_fold_ref(*f64, loss=loss)
        got = K.igd_fold(xf, yf, af, w0, loss=loss).cpu().double()
        per_row = R.igd_fold_ref(*f32, loss=loss).double()
        err = max_err(got, exact, f"igd_fold {loss} {F64_PREFIX}x{FOREST_DIM} vs a float64 fold")
        log("parity", f"igd_fold {loss} {F64_PREFIX}x{FOREST_DIM} Forest prefix: kernel vs float64 fold "
            f"max |dw| {err:.3g}; per-row float32 fold vs float64 fold {float((per_row - exact).abs().max()):.3g}")

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
    phase3 = {"logreg": res}
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
        phase3[task] = rh
    launches = dict(K.launches)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    log("e2e", f"main-path launches {launches}")

    # small input: the card's kernel lanes against the CPU's eager fold,
    # on the same rows and the same permutations
    small = {k: v[:4096].contiguous() for k, v in table.items()}
    cpu_eng = engine.Engine(device="cpu", draws=draws.HostDraws())
    gpu_eng = engine.Engine(draws=draws.HostDraws())
    for task in ("logreg", "least_squares"):
        hint = {"ordering": "shuffle_always", "scheme": "serial"}
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

    schemes(args.seed, table, dev)
    techniques(args.seed, table, dev, phase3)
    phase3d = tables_and_serving(args.seed, table, dev)
    phase3e = sharded(args.seed, table, dev)
    phase3f = observability(args.seed, table, dev)

    # -- 4. timings at the main path's shape -------------------------------
    n, d = FOREST_ROWS, FOREST_DIM
    io_bytes = n * (d + 2) * 4 + 2 * d * 4
    fold_calls = [event_ms(lambda: K.igd_fold(x, y, alpha, w0, loss="lr"), 1) for _ in range(5)]
    clocks = sm_clocks_during(lambda: K.igd_fold(x, y, alpha, w0, loss="lr"), 30)
    mb_calls = [event_ms(lambda: K.igd_fold_minibatch(x, y, alpha, w0, loss="lsq"), 2) for _ in range(5)]
    ms = {"igd_fold": sum(fold_calls) / len(fold_calls), "igd_fold_minibatch": sum(mb_calls) / len(mb_calls)}
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
    # the chain floor: the tiled kernel's serial work a row (grad_scale, the
    # multiply by alpha, one FMA) timed alone in one warp, clock64 and events
    floor_cycles, floor_s = K.chain_probe("lr")
    floor_ms = n * floor_s * 1e3
    clock_run = floor_cycles / floor_s / 1e6  # MHz the probe ran at
    row_cycles = ms["igd_fold"] * 1e-3 * clock_run * 1e6 / n
    kernels[0].update(chain_floor_ms=floor_ms, cycles_per_row=row_cycles)
    log("timing", f"igd_fold (lr, {n}x{d}): {ms['igd_fold']:.4f} ms/launch (5 calls: "
        f"{', '.join(f'{t:.4f}' for t in fold_calls)}); chain floor {floor_ms:.3f} ms = {n} rows x "
        f"{floor_cycles:.1f} cycles (grad_scale + FMA timed alone in one warp, {floor_s * 1e9:.2f} ns a step), "
        f"{floor_ms / ms['igd_fold']:.3f} of the kernel's time; the SM ran the probe at {clock_run:.0f} MHz "
        f"(max {clock_mhz:.0f}): the kernel takes {row_cycles:.1f} cycles/row at that clock, "
        f"{ms['igd_fold'] * 1e-3 * clock_mhz * 1e6 / n:.1f} at the max; bytes "
        f"{io_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {card}")
    log("timing", f"igd_fold: nvidia-smi during 30 more launches: {clocks}")
    # the tile-chain floor: one tile's dependent work (margins, block barrier,
    # partial sums, the exchange of partials, w update) with the tile resident
    step_cycles, step_s = K.minibatch_step_probe("lsq", d)
    n_tiles = -(-n // K.TILE)
    tile_floor_ms = n_tiles * step_s * 1e3
    mb_ms, bytes_ms = ms["igd_fold_minibatch"], io_bytes / HBM_BYTES_PER_S * 1e3
    kernels[1].update(tile_floor_ms=tile_floor_ms, cycles_per_tile_step=step_cycles)
    log("timing", f"igd_fold_minibatch (lsq, {n}x{d}): {mb_ms:.4f} ms/launch (5 calls: "
        f"{', '.join(f'{t:.4f}' for t in mb_calls)}), {io_bytes / mb_ms / 1e6:.1f} GB/s of the table; a cluster of "
        f"{cluster} CTAs; tile-chain floor {tile_floor_ms:.4f} ms = {n_tiles} tiles x {step_s * 1e6:.4f} us "
        f"({step_cycles:.0f} cycles a tile with the tile resident: margins, block barrier, partial sums, the "
        f"exchange of partials, w update), {tile_floor_ms / mb_ms:.3f} of the kernel's time; byte bound "
        f"{bytes_ms:.4f} ms, "
        f"{bytes_ms / mb_ms:.4f} of it; {card}")
    log("timing", "library_ms: none — no single PyTorch call computes a serial IGD fold or the "
        "tile-serial minibatch fold")
    # lanes: B folds in one launch over the shared table (a block, or a
    # cluster, a lane), beside 32 one-lane launches in the same call
    for entry, loss, iters in ((kernels[0], "lr", 2), (kernels[1], "lsq", 5)):
        kernel = getattr(K, entry["name"])
        lane_ms, lane_bound = {}, {}
        for b in TIMED_LANES:
            a_b, w_b = alpha.expand(b, n).contiguous(), w0.expand(b, d).contiguous()
            lane_ms[b] = event_ms(lambda: kernel(x, y, a_b, w_b, loss=loss), iters)
            lane_bytes = n * (d + 1) * 4 + b * (n + 2 * d) * 4  # the table once, each lane's alphas and w
            lane_bound[b] = max(lane_bytes / HBM_BYTES_PER_S, b * flops[entry["name"]] / FP32_FLOPS) * 1e3
        singles_ms = event_ms(lambda: [kernel(x, y, alpha, w0, loss=loss) for _ in range(32)], 1)
        entry.update(lane_ms=lane_ms, lane_bound_ms=lane_bound, one_lane_launches_x32_ms=singles_ms,
                     launches_stored_table=phase3d["tables"][entry["name"]],
                     launches_serving=phase3d["serving"][entry["name"]],
                     launches_sharded=phase3e["launches"][entry["name"]],
                     launches_obs=phase3f["launches"][entry["name"]],
                     sharded_lane_ms=phase3e["lane_ms"][entry["name"]],
                     max_abs_err=max(entry["max_abs_err"], phase3d["lane_err"][entry["name"]],
                                     phase3e["lane_err"] if entry["name"] == "igd_fold" else 0.0))
        log("timing", f"{entry['name']} ({loss}, {n}x{d}, shared table) lane launches: " + ", ".join(
            f"B={b} {lane_ms[b]:.4f} ms ({lane_ms[b] / lane_ms[1]:.3f}x B=1; bound {lane_bound[b]:.4f} ms)"
            for b in TIMED_LANES) + f"; 32 one-lane launches {singles_ms:.3f} ms "
            f"({singles_ms / lane_ms[32]:.2f}x the B=32 launch); {card}")

    # -- 5. build the serving path's kernels --------------------------------
    for lib in (AK.LIBRARY, AK.BWD_LIBRARY, DK.LIBRARY):
        report = ptxas_report(lib.source.name, builds[lib.name].result())
        lib.load()
        log("build", f"{lib.source.name} -> {lib.path().name} ({report}); "
            f"{watch.lap():.2f} s since phase 1 ended")
    pool.shutdown()
    kernels += serving(args.seed, dev)
    kernels += training(args.seed, dev, {entry["name"]: entry for entry in kernels})
    mesh_phase(args.seed, dev, {entry["name"]: entry for entry in kernels})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


def schemes(seed: int, table: dict, dev) -> None:
    """Phase 3b: segmented, shared-memory and MRS plans through the
    engine on the card (no kernel: they run eagerly, as the reference runs
    them in XLA), held to the CPU on a slice."""
    import dataclasses

    from repro_torch import engine, timing
    from repro_torch.core import draws, mrs
    from repro_torch.engine import catalog, program

    phase = timing.Stopwatch()
    half = SCHEME_ROWS // 2
    data = {k: torch.cat([v[:half], v[-half:]]).contiguous() for k, v in table.items()}
    n, d = SCHEME_ROWS, FOREST_DIM
    nbytes = sum(v.numel() * v.element_size() for v in data.values())
    log("schemes", f"Forest-shaped table cut to {n} x {d} (rows 0..{half - 1} and the last {half}: "
        f"label-clustered, {nbytes} bytes), {SCHEME_EPOCHS} epochs a run")
    eng = engine.Engine()
    runs = []  # (label, query, plan)

    # the memory budget: an ineligible query (L1 prox: torch_fold only)
    # over a table twice its budget must stream through buffered MRS
    mrs_args = {"dim": d, "mu": 1e-4}
    q_mrs = engine.AnalyticsQuery(task="logreg", data=data, task_args=mrs_args, epochs=SCHEME_EPOCHS,
                                  tolerance=0.0, seed=seed, memory_budget_bytes=nbytes // 2)
    rep = eng.explain(q_mrs)
    print(rep.describe(), flush=True)
    if rep.chosen.scheme != "mrs" or rep.chosen.mrs_buffer < 8:
        raise AssertionError(f"under a budget of {nbytes // 2} bytes the planner chose {rep.chosen}, not MRS")
    runs.append(("logreg mu>0, budget", q_mrs, rep.chosen))
    svm_args = {"dim": d}
    q_seg = engine.AnalyticsQuery(task="svm", data=data, task_args=svm_args, epochs=SCHEME_EPOCHS, tolerance=0.0,
                                  seed=seed, hints={"scheme": "segmented", "num_segments": 8})
    rep_seg = eng.explain(q_seg)
    runs.append(("svm segmented", q_seg, rep_seg.chosen))
    q_sm = dataclasses.replace(q_seg, hints={"scheme": "shared_memory"})
    rep_sm = eng.explain(q_sm)
    log("schemes", f"shared_memory hint: planned {rep_sm.chosen.describe()} over "
        f"{len(rep_sm.candidates)} candidates; each scheme runs that ordering")
    for sm in ("lock", "aig", "nolock"):
        runs.append((f"svm shared_memory/{sm}", q_sm, dataclasses.replace(rep_sm.chosen, sm_scheme=sm)))

    for what, cal in (("logreg mu>0", rep.calibration), ("svm", rep_seg.calibration)):
        log("schemes", f"probed on the card ({what}, {cal.probe_rows}-row slab): eager fold "
            f"{cal.fold_per_row * 1e6:.1f} us a row, segmented {cal.seg_per_row_at(8) * 1e6:.1f} us a row at k = 8, "
            f"merge {cal.merge_seconds * 1e6:.1f} us")
    for label, q, plan in runs:
        res = eng.run(q, plan=plan)
        l0 = float(catalog.get(q.task).make_task(**q.task_args).full_loss(torch.zeros(d, device=dev), data))
        if (res.plan.scheme != plan.scheme or res.kernel_launches or res.model.shape != (d,)
                or not bool(torch.isfinite(res.model).all())):
            raise AssertionError(f"{label}: plan {res.plan}, {res.kernel_launches} kernel launches, or model not finite")
        if not (res.losses and all(map(math.isfinite, res.losses)) and res.losses[-1] < l0):
            raise AssertionError(f"{label}: loss {l0} -> {res.losses}")
        us_row = res.gradient_seconds / (res.epochs * n) * 1e6
        log("schemes", f"{label} ({res.plan.describe()}): {res.epochs} epochs, loss {l0:.6g} -> "
            f"{res.losses[-1]:.6g}; grad {res.gradient_seconds:.3f} s, {us_row:.1f} us a row on the card "
            f"(shuffle {res.shuffle_seconds:.4f} s)")

    # the same plans on a slice (MRS with a reservoir of an eighth of it)
    quarter = SCHEME_SLICE // 2
    small = {k: torch.cat([v[:quarter], v[-quarter:]]).contiguous() for k, v in data.items()}
    runs = [(label, q, dataclasses.replace(plan, mrs_buffer=SCHEME_SLICE // 8) if plan.scheme == "mrs" else plan)
            for label, q, plan in runs]
    # one epoch of each scheme's program, its draws included, with host
    # syncs made errors: the epoch reads nothing back to the host
    for label, q, plan in runs:
        task, agg = eng._aggregate_for(q)
        compiled = program.build_program(task, agg, program.EpochProgram(plan))
        state = agg.initialize(torch.Generator(device=dev).manual_seed(seed))
        if plan.scheme == "mrs":
            zero = mrs.zero_buffer(plan.mrs_buffer, small)
            state = (state, zero, zero, True)
        epoch_draws = draws.TorchDraws().stream(seed, SCHEME_SLICE, dev).epoch()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            compiled.epoch_fn(state, small, epoch_draws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    log("schemes", f"one epoch of each scheme's program on the {SCHEME_SLICE}-row slice ran with "
        "set_sync_debug_mode('error'): no host sync")

    # ... and on the card and on the CPU, with the same draws
    gpu_eng, cpu_eng = engine.Engine(draws=draws.HostDraws()), engine.Engine(device="cpu", draws=draws.HostDraws())
    worst = 0.0
    for label, q, plan in runs:
        qs = dataclasses.replace(q, data=small, epochs=2, memory_budget_bytes=None)
        got = gpu_eng.run(qs, plan=plan).model.cpu()
        want = cpu_eng.run(dataclasses.replace(qs, data={k: v.cpu() for k, v in small.items()}), plan=plan).model
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
            raise AssertionError(f"{label}: the card's run disagrees with the CPU's (max |err| {err:.3g})")
    log("reference", f"{SCHEME_SLICE}x{d} slice, 2 epochs, {len(runs)} scheme plans: card vs CPU with the same "
        f"draws, max |err| {worst:.3g} (rtol={KERNEL_RTOL}, atol={KERNEL_ATOL})")

    # a planned query cold (probes, plan, build) and warm (memo hits)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    from repro_torch.data import synthetic

    bench = synthetic.dense_classification(gen, 2048, 32)
    qb = engine.AnalyticsQuery(task="logreg", data=bench, task_args={"dim": 32}, epochs=5, tolerance=0.0)
    fresh = engine.Engine()
    walls = []
    for _ in range(2):
        watch = timing.Stopwatch()
        res = fresh.run(qb)
        torch.cuda.synchronize()
        walls.append((watch.lap(), res))
    (cold, r_cold), (warm, r_warm) = walls
    if r_warm.trace_count != r_cold.trace_count or fresh.stats["plans_computed"] != 1:
        raise AssertionError(f"warm repeat built or planned again: {fresh.cache_info()}")
    log("e2e", f"planned query (logreg 2048x32, 5 epochs, {r_cold.plan.describe()}): cold {cold * 1e3:.1f} ms "
        f"(probes, plan, build, run), warm {warm * 1e3:.2f} ms (grad {r_warm.gradient_seconds * 1e3:.2f} ms); "
        f"cache {fresh.cache_info()}")
    log("schemes", f"phase 3b took {phase.lap():.1f} s")


def techniques(seed: int, forest: dict, dev, phase3: dict) -> None:
    """Phase 3c: the paper's other techniques (sparse LR/SVM, LMF, CRF,
    Kalman, portfolio) through Engine.run on the card with no hints (LMF
    pinned to shuffle_once, as Fig. 7 pins it), each on a table made on
    the card from --seed at its source's widths:

    - sparse_logreg, sparse_svm (L1 prox, mu = 1e-4): DBLife's 41,000
      features (paper Table 1), 16 non-zeros a row (paper_tasks.DBLIFE);
    - lmf: MovieLens 1M's 6,040 users x 3,952 movies and 1,000,209
      ratings, rank 8 (paper_tasks.MOVIELENS); IGD over a random sample
      of the ratings, kept in the table's row-sorted order;
    - crf: CoNLL-2000 chunking's 23 tags, 32 tokens, 64 features a token
      (paper_tasks.CONLL);
    - kalman: state 16 (paper_tasks.KALMAN), 8 observed;
    - portfolio: 500 assets (an S&P 500-sized universe).

    Rows are cut, widths are not. Each transition is 40-800 small
    launches (torch.func.grad of the task's loss): 1.5-2.1 ms a row on the
    card, CRF 17 ms; and the planner's probes fold 4 x min(rows, 2,048)
    rows before each first run. So each table holds 1,024 rows (DBLife
    16,384; the sample of the ratings 32,768; Kalman's horizon 2,048;
    2,520 trading days), CRF 128 of CoNLL's 8,936 training sentences.

    Then, in the same phase: LMF's factors (a dict model) through the
    segmented, shared-memory (AIG) and MRS schemes on the same sample;
    the Fig. 7 baselines (IRLS beside phase 3's logreg, full-batch GD for
    svm and crf, ALS on all the ratings and on the sample); one epoch of
    every plan's program on a SYNC_SLICE-row slice under
    torch.cuda.set_sync_debug_mode("error"); and every plan on a
    TECH_SLICE-row slice on the card and on the CPU with the same draws
    and initial model (draws.HostDraws), held to rtol=2e-4, atol=2e-5
    (CRF, whose float32 runs drift past that from exact, to a float64
    run on the CPU).
    No technique has a kernel form: the phase must launch no kernel."""
    import dataclasses

    from repro_torch import engine, timing
    from repro_torch.configs import paper_tasks
    from repro_torch.core import draws, mrs, tree, uda
    from repro_torch.data import synthetic
    from repro_torch.engine import program
    from repro_torch.kernels.igd_fused import kernel as K
    from repro_torch.tasks import baselines

    phase = timing.Stopwatch()
    K.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    rank, tags = paper_tasks.MOVIELENS.rank, CONLL_TAGS
    ratings = synthetic.ratings(gen, ML_USERS, ML_MOVIES, ML_RATINGS)

    def subsample(table, n):  # n random rows, in the table's stored order
        pick = torch.sort(torch.randperm(next(iter(table.values())).shape[0], generator=gen, device=dev)[:n]).values
        return {k: v[pick].contiguous() for k, v in table.items()}

    sample = subsample(ratings, ML_SAMPLE)
    lmf_args = {"n_rows": ML_USERS, "n_cols": ML_MOVIES, "rank": rank, "mu": paper_tasks.MOVIELENS.mu}
    cost = tuple(torch.linspace(-0.1, 0.1, SP500_ASSETS).tolist())
    dblife = synthetic.sparse_classification(gen, DBLIFE_ROWS, DBLIFE_DIM, paper_tasks.DBLIFE.nnz)
    cells = [  # (task, table, task_args, epochs, hints)
        ("sparse_logreg", dblife, {"dim": DBLIFE_DIM}, 2, {}),
        ("sparse_svm", dblife, {"dim": DBLIFE_DIM, "mu": 1e-4}, 2, {}),
        ("lmf", sample, lmf_args, 2, {"ordering": "shuffle_once"}),
        ("crf", synthetic.tagged_sequences(gen, CONLL_SENTENCES, CONLL_TOKENS, tags, paper_tasks.CONLL.dim),
         {"n_labels": tags, "feat_dim": paper_tasks.CONLL.dim}, 2, {}),
        ("kalman", synthetic.kalman_series(gen, KALMAN_HORIZON, paper_tasks.KALMAN.dim, KALMAN_OBS),
         {"horizon": KALMAN_HORIZON, "state_dim": paper_tasks.KALMAN.dim, "obs_dim": KALMAN_OBS}, 3, {}),
        ("portfolio", synthetic.returns(gen, SP500_PERIODS, SP500_ASSETS),
         {"n_assets": SP500_ASSETS, "expected_returns": cost}, 3, {}),
    ]
    torch.cuda.synchronize()
    log("techniques", f"tables made on the card in {phase.lap():.2f} s: " + "; ".join(
        f"{name} " + ", ".join(f"{k} {list(v.shape)}" for k, v in data.items()) for name, data, *_ in cells))

    def finite(model):
        return all(bool(torch.isfinite(x).all()) for x in tree.leaves(model))

    def run(eng, label, q, plan=None):
        """One Engine.run with its loss every epoch (target_loss=-inf: the
        stop rule evaluates the objective each epoch and never stops)."""
        q = dataclasses.replace(q, tolerance=0.0, target_loss=-math.inf)
        res = eng.run(q, plan=plan)
        task, _ = eng._aggregate_for(q)
        loss0 = float(task.full_loss(eng.draws.stream(q.seed, q.n_examples, dev).initial_model(task), q.data))
        if (res.kernel_launches or not finite(res.model) or len(res.losses) != q.epochs
                or not all(map(math.isfinite, res.losses)) or not res.losses[-1] < loss0):
            raise AssertionError(f"{label}: {res.kernel_launches} kernel launches, loss {loss0} -> {res.losses}")
        fold = (res.report.calibration if res.report else eng.explain(q).calibration).fold_per_row
        us_row = res.gradient_seconds / (res.epochs * q.n_examples) * 1e6
        log("techniques", f"{label} ({res.plan.describe()}), {q.n_examples} rows: loss {loss0:.6g} -> "
            + ", ".join(f"{x:.6g}" for x in res.losses) + f"; grad {res.gradient_seconds:.3f} s, "
            f"{us_row:.1f} us a row (probed eager fold {fold * 1e6:.1f}); shuffle {res.shuffle_seconds:.4f} s")
        return res

    eng = engine.Engine()
    plans, results = [], {}  # (label, query, plan): what the sync and CPU checks replay
    for name, data, args, epochs, hints in cells:
        q = engine.AnalyticsQuery(task=name, data=data, task_args=args, epochs=epochs, seed=seed, hints=hints)
        results[name] = run(eng, name, q)
        plans.append((name, q, results[name].plan))

    # -- one dict model through each non-serial scheme ---------------------
    # the sample again: the probes of its first run serve these plans too
    nbytes = sum(v.numel() * v.element_size() for v in sample.values())
    q = engine.AnalyticsQuery(task="lmf", data=sample, task_args=lmf_args, epochs=2, seed=seed)
    rep_budget = eng.explain(dataclasses.replace(q, memory_budget_bytes=nbytes // 2))
    q_mrs = dataclasses.replace(q, memory_budget_bytes=nbytes // 2, hints={"scheme": "mrs"})
    mrs_plan = eng.explain(q_mrs).chosen
    sm_plan = dataclasses.replace(eng.explain(dataclasses.replace(q, hints={"scheme": "shared_memory"})).chosen,
                                  sm_scheme="aig")
    log("techniques", f"lmf on {ML_SAMPLE} ratings ({nbytes} bytes) under a budget of {nbytes // 2}: the "
        f"planner chose {rep_budget.chosen.describe()} (ratings have no label column, so the stored order is not "
        f"costed out); MRS by hint: {mrs_plan.describe()}")
    if mrs_plan.scheme != "mrs":
        raise AssertionError(f"an MRS hint under a budget planned {mrs_plan}")
    for label, qs, plan in (("lmf segmented", dataclasses.replace(q, hints={"scheme": "segmented", "num_segments": 8}),
                             None),
                            ("lmf shared_memory/aig", q, sm_plan), ("lmf mrs, budget", q_mrs, mrs_plan)):
        res = run(eng, label, qs, plan)
        if sorted(res.model) != ["L", "R"] or res.plan.scheme != (plan or res.plan).scheme:
            raise AssertionError(f"{label}: plan {res.plan}, model {sorted(res.model)}")
        plans.append((label, qs, res.plan))

    # -- the Fig. 7 baselines ----------------------------------------------
    bgen = torch.Generator(device=dev).manual_seed(seed)
    out = {}

    def timed(key, fn):
        out[key + "_s"] = timing.seconds(lambda: out.__setitem__(key, fn()), dev)
        return out[key]

    n_forest = next(iter(forest.values())).shape[0]
    w_star = timed("irls", lambda: baselines.irls_logistic(forest, steps=25, ridge=1e-3))
    lr_task = engine.get("logreg").make_task(dim=FOREST_DIM)
    lr = phase3["logreg"]
    if not finite(w_star):
        raise AssertionError("IRLS's optimum is not finite")
    log("fig7", f"LR on {n_forest}x{FOREST_DIM}: IRLS (25 Newton steps, ridge 1e-3) {out['irls_s']:.4f} s, loss "
        f"{float(lr_task.full_loss(w_star, forest)):.6g}; IGD (phase 3, {lr.plan.implementation}) {lr.epochs} epochs "
        f"{lr.gradient_seconds:.4f} s, loss {lr.losses[-1]:.6g}")
    svm_task = engine.get("svm").make_task(dim=FOREST_DIM)
    _, svm_losses = timed("svm_gd", lambda: baselines.full_batch_gd(
        svm_task, forest, steps=60, lr=0.5 / n_forest, model=torch.zeros(FOREST_DIM, device=dev)))
    sv = phase3["svm"]
    log("fig7", f"SVM on {n_forest}x{FOREST_DIM}: full-batch GD (60 steps, lr 0.5/n) {out['svm_gd_s']:.4f} s, loss "
        f"{svm_losses[0]:.6g} -> {svm_losses[-1]:.6g}; IGD (phase 3, {sv.plan.implementation}) {sv.epochs} epochs "
        f"{sv.gradient_seconds:.4f} s, loss {sv.losses[-1]:.6g}")
    crf_name, crf_data, crf_args = cells[3][:3]
    crf_task = engine.get(crf_name).make_task(**crf_args)
    _, crf_losses = timed("crf_gd", lambda: baselines.full_batch_gd(
        crf_task, crf_data, steps=25, lr=2e-3, model=crf_task.init_model(bgen)))
    cr = results["crf"]
    log("fig7", f"CRF on {CONLL_SENTENCES} sentences: full-batch GD (25 steps, lr 2e-3) {out['crf_gd_s']:.4f} s, loss "
        f"{crf_losses[0]:.6g} -> {crf_losses[-1]:.6g}; IGD {cr.epochs} epochs {cr.gradient_seconds:.4f} s, "
        f"loss {cr.losses[-1]:.6g}")
    if not (svm_losses[-1] < svm_losses[0] and crf_losses[-1] < crf_losses[0]):
        raise AssertionError("full-batch GD did not lower a loss")
    sweeps = 8
    als_full = timed("als_full", lambda: baselines.als_lmf(ratings, ML_USERS, ML_MOVIES, rank, sweeps=sweeps,
                                                            mu=lmf_args["mu"], generator=bgen))
    als_sample = timed("als_sample", lambda: baselines.als_lmf(sample, ML_USERS, ML_MOVIES, rank, sweeps=sweeps,
                                                                mu=lmf_args["mu"], generator=bgen))
    lmf_task, _ = eng._aggregate_for(plans[2][1])
    full_task = engine.get("lmf").make_task(**lmf_args, **lmf_task.degrees_for(ML_USERS, ML_MOVIES, ML_RATINGS))
    if not (finite(als_full) and finite(als_sample)):
        raise AssertionError("ALS's factors are not finite")
    lm = results["lmf"]
    log("fig7", f"LMF: ALS ({sweeps} sweeps) on all {ML_RATINGS} ratings {out['als_full_s']:.4f} s, loss "
        f"{float(full_task.full_loss(als_full, ratings)):.6g}; on the {ML_SAMPLE}-rating sample "
        f"{out['als_sample_s']:.4f} s, loss {float(lmf_task.full_loss(als_sample, sample)):.6g}; IGD on the sample "
        f"{lm.epochs} epochs {lm.gradient_seconds:.4f} s, loss {lm.losses[-1]:.6g}")

    # -- no host sync: one epoch of every plan's program ---------------------
    for label, q, plan in plans:
        small = {k: v[:SYNC_SLICE] for k, v in q.data.items()}
        task, agg = eng._aggregate_for(q)
        compiled = program.build_program(task, agg, program.EpochProgram(plan))
        run_draws = draws.TorchDraws().stream(seed, SYNC_SLICE, dev)
        state = uda.initial_state(run_draws.initial_model(task))
        if plan.scheme == "mrs":
            zero = mrs.zero_buffer(plan.mrs_buffer, small)
            state = (state, zero, zero, True)
        epoch_draws = run_draws.epoch()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            compiled.epoch_fn(state, small, epoch_draws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    log("techniques", f"one epoch of each of the {len(plans)} plans' programs on a {SYNC_SLICE}-row slice ran with "
        "set_sync_debug_mode('error'): no host sync")

    # -- card against CPU ----------------------------------------------------
    gpu_eng, cpu_eng = engine.Engine(draws=draws.HostDraws()), engine.Engine(device="cpu", draws=draws.HostDraws())

    def float64_run(q, plan):
        """``plan`` over ``q`` (on the CPU) in float64 from the run's own
        initial model and draws, epoch by epoch as the executor runs it."""
        from repro_torch.core import ordering

        task, agg = cpu_eng._aggregate_for(q)
        data = {k: v.double() if v.is_floating_point() else v for k, v in q.data.items()}
        run_draws = cpu_eng.draws.stream(q.seed, q.n_examples, torch.device("cpu"))
        state = uda.initial_state(tree.tree_map(torch.Tensor.double, run_draws.initial_model(task)))
        epoch_fn = program.build_program(task, agg, program.EpochProgram(plan)).epoch_fn
        order = {"clustered": ordering.Clustered, "shuffle_once": ordering.ShuffleOnce,
                 "shuffle_always": ordering.ShuffleAlways}[plan.ordering]()
        for epoch in range(1, q.epochs + 1):
            state = epoch_fn(state, order.order(data, q.n_examples, epoch, run_draws.permutation), run_draws.epoch())
        return state.model

    worst = 0.0
    for label, q, plan in plans:
        small = {k: v[:TECH_SLICE] for k, v in q.data.items()}
        if plan.scheme == "mrs":
            plan = dataclasses.replace(plan, mrs_buffer=TECH_SLICE // 8)
        qs = dataclasses.replace(q, data=small, epochs=2, memory_budget_bytes=None, tolerance=0.0)
        q_cpu = dataclasses.replace(qs, data={k: v.cpu() for k, v in small.items()})
        got = [x.cpu() for x in tree.leaves(gpu_eng.run(qs, plan=plan).model)]
        want = tree.leaves(cpu_eng.run(q_cpu, plan=plan).model)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if q.task == "crf" and plan.scheme != "mrs":
            # CRF's first steps are large (a sentence's loss starts near 100),
            # and they amplify rounding: the CPU's own float32 run lands
            # ~5e-4 from a float64 run, past the tolerance below. So CRF is
            # held to a float64 run: the card's float32 run must land no
            # farther from it than the CPU's float32 run does, twice over
            # (two float32 runs that round differently).
            exact = [x.float() for x in tree.leaves(float64_run(q_cpu, plan))]
            card = max(float((g - x).abs().max()) for g, x in zip(got, exact))
            host = max(float((w - x).abs().max()) for w, x in zip(want, exact))
            if not card <= 2 * host + KERNEL_ATOL:
                raise AssertionError(f"{label}: the card's run is {card:.3g} from a float64 run, the CPU's {host:.3g}")
            log("reference", f"{label}, {next(iter(small.values())).shape[0]} rows, 2 epochs: card vs CPU max |err| "
                f"{err:.3g}; from a float64 run on the CPU: card {card:.3g}, CPU {host:.3g}")
            continue
        worst = max(worst, err)
        for g, w in zip(got, want):
            if not torch.allclose(g, w, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
                raise AssertionError(f"{label}: the card's run disagrees with the CPU's (max |err| {err:.3g})")
    log("reference", f"{TECH_SLICE}-row slices, 2 epochs, the other {len(plans) - 1} plans: card vs CPU with the same "
        f"draws and initial model, max |err| {worst:.3g} (rtol={KERNEL_RTOL}, atol={KERNEL_ATOL})")
    if any(K.launches.values()):
        raise AssertionError(f"the eager techniques launched a kernel: {dict(K.launches)}")
    log("techniques", f"phase 3c took {phase.lap():.1f} s after its tables; no kernel launched")


def tables_and_serving(seed: int, table: dict, dev) -> dict:
    """Phase 3d: the lane kernels against their plain versions and their
    own one-lane launches; a stored (host-chunked) Forest table streamed
    through the engine beside the resident run; 32 + 8 queries served as
    fused masked batches beside the same queries one at a time; a warm
    start from the plan store. Returns the kernels' launches on the
    phase's paths (counts zeroed just before, read just after)."""
    import dataclasses
    import shutil
    import threading

    from repro_torch import engine, timing
    from repro_torch.engine import executor, serve
    from repro_torch.kernels.igd_fused import kernel as K, ref as R

    phase = timing.Stopwatch()
    n, d = FOREST_ROWS, FOREST_DIM

    # -- lane kernels: plain versions (on the CPU) and one-lane launches ----
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    worst = {"igd_fold": 0.0, "igd_fold_minibatch": 0.0}
    cases = 0
    for name, plain, dims, rows in (("igd_fold", R.igd_fold_ref, LANE_FOLD_D, LANE_FOLD_N),
                                    ("igd_fold_minibatch", R.igd_fold_minibatch_ref, LANE_MB_D, LANE_MB_N)):
        kernel = getattr(K, name)
        for b in LANE_B:
            for dd in dims:
                for nn in rows:
                    for shared in (True, False):
                        lead = () if shared else (b,)
                        x = torch.randn(lead + (nn, dd), generator=gen, device=dev) / dd**0.5
                        y = torch.sign(torch.randn(lead + (nn,), generator=gen, device=dev))
                        alpha = 0.1 / (1.0 + (torch.arange(nn, device=dev)
                                              + torch.randint(0, 5 * nn, (b, 1), generator=gen, device=dev)) / nn)
                        w0 = 0.01 * torch.randn((b, dd), generator=gen, device=dev)
                        loss = LOSSES[cases % 3]
                        got = kernel(x, y, alpha, w0, loss=loss)
                        for i in range(b):
                            xi, yi = (x, y) if shared else (x[i], y[i])
                            if not torch.equal(got[i], kernel(xi, yi, alpha[i].contiguous(), w0[i].contiguous(),
                                                              loss=loss)):
                                raise AssertionError(f"{name} B={b} {nn}x{dd} lane {i}: not its one-lane launch")
                        on_cpu = [t.cpu() for t in (x, y, alpha, w0)]
                        worst[name] = max(worst[name], max_err(
                            got.cpu(), R.lanes_ref(plain, *on_cpu, loss=loss),
                            f"{name} B={b} {nn}x{dd} {'shared' if shared else 'stacked'} vs its plain version"))
                        cases += 1
    log("tables", f"lane kernels: {cases} launches (B in {LANE_B}; igd_fold D in {LANE_FOLD_D} x N in "
        f"{LANE_FOLD_N}, igd_fold_minibatch D in {LANE_MB_D} x N in {LANE_MB_N}; shared and stacked tables; "
        f"lr, svm, lsq in turn): every lane equal to its own one-lane launch bit for bit; max |err| against the "
        f"plain version igd_fold {worst['igd_fold']:.3g}, igd_fold_minibatch {worst['igd_fold_minibatch']:.3g} "
        f"(rtol={KERNEL_RTOL}, atol={KERNEL_ATOL})")

    # -- a stored table: host chunks streamed to the card --------------------
    host = {k: v.cpu() for k, v in table.items()}
    alpha = engine.get("logreg").step_size(n)(torch.arange(n, dtype=torch.int32))
    w0 = torch.zeros(d)
    exact = {}  # a float64 epoch on the CPU, beside the card's work
    f64 = threading.Thread(target=lambda: exact.update(w=R.igd_fold_ref(
        host["x"].double(), host["y"].double(), alpha.double(), w0.double(), loss="lr")))
    f64.start()
    tab = engine.ChunkedTable.from_arrays(host, TABLE_CHUNK)
    pinned = engine.ChunkedTable.from_arrays({k: v.pin_memory() for k, v in host.items()}, TABLE_CHUNK)
    table_launches = {"igd_fold": 0, "igd_fold_minibatch": 0}
    eng = engine.Engine()
    for task, hints in (("logreg", {"ordering": "clustered", "scheme": "serial"}),
                        ("least_squares", {"ordering": "clustered", "scheme": "serial",
                                           "implementation": "cuda_minibatch"})):
        q = engine.AnalyticsQuery(task=task, data=tab, task_args={"dim": d}, epochs=TABLE_EPOCHS,
                                  tolerance=0.0, seed=seed, hints=hints)
        rep = eng.explain(q)
        moved0 = eng.stats["bytes_to_device"]
        K.reset_launches()  # the streamed run alone: not the probes, nor the runs beside it
        res = eng.run(q)
        for name in table_launches:
            table_launches[name] += K.launches[name]
        moved = eng.stats["bytes_to_device"] - moved0 - tab.data_bytes()  # less the objective's one copy
        if res.plan.source != "table" or res.kernel_launches != TABLE_EPOCHS * tab.num_chunks:
            raise AssertionError(f"{task}: plan {res.plan}, {res.kernel_launches} launches; a chunk stream "
                                 f"launches {tab.num_chunks} an epoch")
        resident = eng.run(dataclasses.replace(q, data=table, hints={}),
                           plan=dataclasses.replace(res.plan, source="memory"))
        if res.plan.implementation == "cuda_minibatch":
            # 65,536-row chunks are whole 256-row tiles: the same steps
            if not torch.equal(res.model, resident.model):
                raise AssertionError(f"{task}: the minibatch chunk stream differs from the resident run")
        dist = max_err(res.model, resident.model, f"{task} chunk stream vs the resident run")
        # the same chunks in page-locked host memory: the copies leave the
        # host at once and run on the copy engine, in stream order
        res_pinned = eng.run(dataclasses.replace(q, data=pinned))
        if not torch.equal(res_pinned.model, res.model):
            raise AssertionError(f"{task}: the pinned chunk stream differs from the pageable one")
        epoch_ms = {k: r.gradient_seconds / TABLE_EPOCHS * 1e3 for k, r in
                    (("pageable", res), ("pinned", res_pinned), ("resident", resident))}
        log("tables", f"{task} over a ChunkedTable of {tab.num_chunks} host chunks of {TABLE_CHUNK} rows "
            f"({tab.chunk_shapes()}): plan {rep.chosen.describe()}; {res.kernel_launches // TABLE_EPOCHS} "
            f"launches an epoch; ms an epoch streamed from pageable host memory {epoch_ms['pageable']:.2f} "
            f"({epoch_ms['pageable'] / epoch_ms['resident']:.3f}x), from pinned {epoch_ms['pinned']:.2f} "
            f"({epoch_ms['pinned'] / epoch_ms['resident']:.3f}x), resident {epoch_ms['resident']:.2f}; "
            f"{moved / TABLE_EPOCHS:.0f} bytes to the card an epoch; max |dw| vs the resident run {dist:.3g} "
            f"(pinned: the same w bit for bit); loss {res.losses[-1]:.6g}; {smi('name,power.limit')}")
    # one epoch a chunk at a time at the kernel, against one launch and float64
    w_stream = w0.to(dev)
    for i, chunk in enumerate(tab.chunks()):
        rows = slice(i * TABLE_CHUNK, i * TABLE_CHUNK + chunk["x"].shape[0])
        w_stream = K.igd_fold(chunk["x"].to(dev), chunk["y"].to(dev), alpha[rows].to(dev), w_stream, loss="lr")
    w_one = K.igd_fold(table["x"], table["y"], alpha.to(dev), w0.to(dev), loss="lr")
    f64.join()
    to_one = max_err(w_stream, w_one, "igd_fold chunk stream vs one launch, one epoch")
    to_f64 = max_err(w_stream.cpu().double(), exact["w"], "igd_fold chunk stream vs a float64 fold")
    one_f64 = float((w_one.cpu().double() - exact["w"]).abs().max())
    log("tables", f"igd_fold lr, one {n}x{d} epoch in {tab.num_chunks} launches (a chunk each, w carried): "
        f"max |dw| {to_one:.3g} vs one launch, {to_f64:.3g} vs a float64 fold (one launch: {one_f64:.3g}); "
        f"stored-table path launches {table_launches}")

    # -- serving: fused masked batches against the same queries one by one ---
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "plan_cache_smoke")
    shutil.rmtree(cache_dir, ignore_errors=True)
    serving_launches = {"igd_fold": 0, "igd_fold_minibatch": 0}
    kernel_of = {"cuda_fused": "igd_fold", "cuda_minibatch": "igd_fold_minibatch"}
    for task, impl, count, batch in (("logreg", "cuda_fused", SERVE_QUERIES, SERVE_QUERIES),
                                     ("least_squares", "cuda_minibatch", SERVE_MB_QUERIES, SERVE_MB_QUERIES)):
        hints = {"ordering": "shuffle_always", "scheme": "serial", "implementation": impl}
        queries = [engine.AnalyticsQuery(task=task, data=table, task_args={"dim": d}, tolerance=0.0, seed=s,
                                          epochs=3 if s % 2 == 0 else 2, hints=hints) for s in range(count)]
        srv = serve.ServingEngine(serve.ServeConfig(max_batch=batch, cache_dir=cache_dir),
                                  engine=executor.Engine(plan_store=serve.PlanStore(cache_dir)))
        for q in queries:  # plan first: the walls below are warm
            srv.engine.explain(q)
        K.reset_launches()  # the fused drain alone: not the probes, nor the singleton runs
        watch = timing.Stopwatch()
        tickets = [srv.submit(q) for q in queries]
        srv.drain()
        torch.cuda.synchronize()
        fused_s = watch.lap()
        fused_launches = sum(K.launches.values())
        for name in serving_launches:
            serving_launches[name] += K.launches[name]
        singles = [srv.engine.run(q) for q in queries]
        torch.cuda.synchronize()
        single_s = watch.lap()
        if (srv.stats["batches"] != 1 or srv.stats["masked_batches"] != 1
                or fused_launches != max(q.epochs for q in queries)):
            raise AssertionError(f"{task}: {srv.stats}, {fused_launches} launches for one fused batch")
        diff = 0.0
        for t, single in zip(tickets, singles):
            if t.error is not None or t.result.epochs != single.epochs:
                raise AssertionError(f"{task}: ticket {t.error or t.result.epochs}")
            diff = max(diff, float((t.result.model - single.model).abs().max()))
            if not bool(torch.isfinite(t.result.model).all()):
                raise AssertionError(f"{task}: a served model is not finite")
        if diff != 0.0:
            raise AssertionError(f"{task}: a kernel lane differs from its singleton run by {diff:.3g}")
        log("serving", f"{count} {task} queries ({impl}, shuffle_always, budgets 3 and 2 alternating, "
            f"max_batch={batch}): {srv.stats['batches']} batch, {srv.stats['fused_lanes']} fused lanes, "
            f"{srv.stats['masked_batches']} masked; {fused_launches} {kernel_of[impl]} launches for the batch "
            f"(one an epoch); drain {fused_s:.3f} s = {count / fused_s:.2f} queries/s; the same queries one at a "
            f"time through Engine.run {single_s:.3f} s = {count / single_s:.2f} queries/s "
            f"({single_s / fused_s:.2f}x); max |lane - singleton| {diff}")
        if task == "logreg":
            # -- warm start: a fresh server on the same store plans nothing
            warm = serve.ServingEngine(serve.ServeConfig(max_batch=batch, cache_dir=cache_dir))
            for q in queries:
                warm.submit(q)
            warm.drain()
            st = warm.engine.stats
            if st["plans_computed"] != 0 or st["probe_runs"] != 0 or not st["plan_disk_hits"]:
                raise AssertionError(f"warm start planned or probed: {st}")
            log("serving", f"warm start on {cache_dir} ({warm.engine.plan_store.size()} entries): "
                f"plans_computed {st['plans_computed']}, probe_runs {st['probe_runs']}, "
                f"plan_disk_hits {st['plan_disk_hits']}; {warm.stats['batches']} fused batch")
    if not all(table_launches.values()) or not all(serving_launches.values()):
        raise AssertionError(f"a kernel never launched: tables {table_launches}, serving {serving_launches}")
    shutil.rmtree(cache_dir, ignore_errors=True)
    log("tables", f"phase 3d took {phase.lap():.1f} s")
    return {"tables": table_launches, "serving": serving_launches, "lane_err": worst}


def sharded(seed: int, table: dict, dev) -> dict:
    """Phase 3e: sharded local SGD (parallelism="sharded", by hint) on the
    Forest-shaped table, the k shards as the lanes of the IGD kernels:
    k = 1 against the singleton run bit for bit (every ordering and lane
    body), one k = 4 lane launch against its plain version, a 3-epoch
    k = 4 clustered run against a float64 replay of its blocks and
    merges, ms an epoch at k = 1, 2, 4 and H = 1, 3 beside the singleton,
    the merge's ms, and 8 queries x 4 shards served as one fused sharded
    batch beside the same queries one at a time. Returns the kernels'
    launches on the sharded runs (counts zeroed just before each run or
    drain, read just after) and the lane check's error."""
    import dataclasses

    import numpy as np

    from repro_torch import engine, timing
    from repro_torch.core import uda
    from repro_torch.dist import data_parallel as dp
    from repro_torch.engine import catalog, serve, shard
    from repro_torch.kernels.igd_fused import kernel as K, ref as R

    phase = timing.Stopwatch()
    n, d = FOREST_ROWS, FOREST_DIM
    comp = shard.compensated_step_size(catalog.get("logreg").step_size(n), 4)  # k = 4's schedule
    launches = {"igd_fold": 0, "igd_fold_minibatch": 0}
    eng = engine.Engine()

    def plan_for(ordering, impl, k=0, h=1):
        if not k:
            return engine.Plan(ordering, implementation=impl)
        return engine.Plan(ordering, implementation=impl, parallelism="sharded", num_shards=k, merge_period=h)

    def run(q, plan, counted=True):
        if counted:
            K.reset_launches()
        res = eng.run(q, plan=plan)
        if counted:
            for name in launches:
                launches[name] += K.launches[name]
        if not bool(torch.isfinite(res.model).all()) or res.model.shape != (d,):
            raise AssertionError(f"{plan.describe()}: the model is not a finite [{d}] vector")
        if plan.implementation != "torch_fold" and res.kernel_launches != res.epochs:
            raise AssertionError(f"{plan.describe()}: {res.kernel_launches} launches in {res.epochs} epochs")
        return res

    def query(task, data, epochs=SHARD_EPOCHS, s=seed):
        return engine.AnalyticsQuery(task=task, data=data, task_args={"dim": d}, epochs=epochs, tolerance=0.0,
                                     seed=s)

    # -- the hint path: the planner plans the sharded axis on one card -----
    hinted = engine.AnalyticsQuery(task="logreg", data=table, task_args={"dim": d}, epochs=SHARD_EPOCHS,
                                   tolerance=0.0, seed=seed, hints={"parallelism": "sharded", "num_shards": 4,
                                                                    "merge_period": 1,
                                                                    "implementation": "cuda_fused"})
    rep = eng.explain(hinted)
    if rep.chosen.parallelism != "sharded" or rep.calibration.shard:
        raise AssertionError(f"hinted plan {rep.chosen}; one card must have no probed mesh point")
    log("sharded", f"hinted plan: {rep.chosen.describe()} ({rep.chosen.axes()}); device_count "
        f"{rep.calibration.device_count}, probe (f) not run on one card")
    run(hinted, rep.chosen)

    # -- one k = 4 lane launch against its plain version ---------------------
    seg_rows = SHARD_LANE_ROWS
    xs, ys = (t[:4 * seg_rows].reshape((4, seg_rows) + tuple(t.shape[1:])) for t in (table["x"], table["y"]))
    steps = torch.arange(seg_rows, dtype=torch.int32, device=dev)
    alphas = torch.stack([comp(steps + i * seg_rows) for i in range(4)])
    w0s = 0.01 * torch.randn((4, d), generator=torch.Generator(device=dev).manual_seed(seed + 23), device=dev)
    got = K.igd_fold(xs, ys, alphas, w0s, loss="lr")
    lane_err = max_err(got.cpu(), R.lanes_ref(R.igd_fold_ref, *(t.cpu() for t in (xs, ys, alphas, w0s)), loss="lr"),
                       f"igd_fold 4 lanes x {seg_rows} rows vs its plain version")
    log("sharded", f"igd_fold 4 lanes over 4 x {seg_rows} x {d} stacked segments (one launch): max |err| "
        f"{lane_err:.3g} against ref.lanes_ref (rtol={KERNEL_RTOL}, atol={KERNEL_ATOL})")

    # -- k = 1 is the singleton run, bit for bit; ms an epoch ----------------
    half = SCHEME_ROWS // 2
    cut = {k: torch.cat([v[:half], v[-half:]]).contiguous() for k, v in table.items()}
    epoch_ms = {}
    for task, impl, data, ks, hs, epochs in (
            ("logreg", "cuda_fused", table, (1, 2, 4), (1, 3), SHARD_EPOCHS),
            ("least_squares", "cuda_minibatch", table, (1, 4), (1,), SHARD_EPOCHS),
            ("logreg", "torch_fold", cut, (1, 4), (1,), 1)):
        rows = next(iter(data.values())).shape[0]
        for ordering in ("clustered", "shuffle_once", "shuffle_always"):
            q = query(task, data, epochs)
            single = run(q, plan_for(ordering, impl), counted=False)
            one = run(q, plan_for(ordering, impl, 1))
            if not torch.equal(one.model, single.model) or one.losses != single.losses:
                raise AssertionError(f"{task} {ordering} {impl}: sharded k = 1 is not the singleton run "
                                     f"(max |dw| {float((one.model - single.model).abs().max()):.3g})")
            epoch_ms[(impl, ordering, 0, 1)] = single.gradient_seconds / single.epochs * 1e3
            line = [f"singleton {epoch_ms[(impl, ordering, 0, 1)]:.3f} ms/epoch"]
            for k in ks:
                for h in hs:
                    res = one if (k, h) == (1, 1) else run(q, plan_for(ordering, impl, k, h))
                    ms = res.gradient_seconds / res.epochs * 1e3
                    epoch_ms[(impl, ordering, k, h)] = ms
                    if not res.losses[-1] < float(catalog.get(task).make_task(dim=d).full_loss(
                            torch.zeros(d, device=dev), data)):
                        raise AssertionError(f"{task} {ordering} {impl} k={k} H={h}: loss did not fall")
                    line.append(f"k={k} H={h} {ms:.3f} ms/epoch ({res.kernel_launches / res.epochs:.0f} "
                                f"launch(es)/epoch, loss {res.losses[-1]:.6g}, place {res.shuffle_seconds * 1e3:.2f} ms)")
            log("sharded", f"{task} {impl} {ordering} {rows} x {d}, {epochs} epoch(s): k = 1 equals the singleton "
                f"run bit for bit; " + "; ".join(line))
    mb_aligned = all((n // k) % 4 == 0 and (n // k) * d % 4 == 0 for k in (4,))
    log("sharded", f"igd_fold_minibatch at k = 4: a lane holds {n // 4} rows, y's lane stride {n // 4 * 4} bytes "
        f"({'on' if mb_aligned else 'off'} 16-byte boundaries): the cluster instance "
        f"{'takes bulk copies' if mb_aligned else 'runs its plain-load path'}; clustered epoch "
        f"{epoch_ms[('cuda_minibatch', 'clustered', 4, 1)]:.3f} ms vs the singleton's "
        f"{epoch_ms[('cuda_minibatch', 'clustered', 0, 1)]:.3f} ms")

    # -- a 3-epoch k = 4 clustered run against a float64 replay -------------
    k, rps = 4, n // 4
    res = run(query("logreg", table), plan_for("clustered", "cuda_fused", k, 1))
    task = catalog.get("logreg").make_task(dim=d)
    x64 = table["x"].cpu().double().numpy().reshape(k, rps, d)
    y64 = table["y"].cpu().double().numpy().reshape(k, rps)
    w = eng.draws.stream(seed, n, dev).initial_model(task).cpu().double().numpy()
    for epoch in range(SHARD_EPOCHS):
        a = comp(epoch * rps + torch.arange(rps, dtype=torch.int32))  # float32, as the lanes take them
        a64 = a.double().numpy()
        lanes = np.repeat(w[None], k, axis=0)
        for i in range(rps):  # one float64 fold a segment, the 4 segments side by side
            xi = x64[:, i]
            m = y64[:, i] * np.einsum("ld,ld->l", lanes, xi)
            lanes -= ((-y64[:, i] / (1.0 + np.exp(m))) * a64[i])[:, None] * xi
        merged, wt = lanes[0], float(rps)
        for j in range(1, k):  # the merge tree: left to right, weights = rows folded
            wa = wt / (wt + rps)
            merged, wt = wa * merged + (1.0 - wa) * lanes[j], wt + rps
        w = merged
    f64_err = float(np.abs(res.model.cpu().double().numpy() - w).max())
    if not f64_err <= SHARD_F64_TOL:
        raise AssertionError(f"k = 4 clustered run is {f64_err:.3g} from its float64 replay")
    log("sharded", f"logreg k = 4 H = 1 clustered, {SHARD_EPOCHS} epochs (cuda_fused, one 4-lane launch an epoch): "
        f"max |w - w_float64| {f64_err:.3g} (<= {SHARD_F64_TOL}) against a float64 replay of the same blocks and "
        f"merges")

    # -- the merge ---------------------------------------------------------------
    agg = eng._compile(hinted, rep.chosen).program.runner.agg
    bank_models = torch.randn((4, d), generator=torch.Generator(device=dev).manual_seed(seed + 29), device=dev)
    bank = uda.IGDState(bank_models, torch.full((4,), rps, dtype=torch.int32, device=dev),
                        torch.full((4,), float(rps), device=dev))
    merge_ms = event_ms(lambda: dp.merge_stacked(agg, bank, 4), 50)
    log("sharded", f"merge tree of 4 lanes ([{d}] models, 3 merges): {merge_ms:.4f} ms (CUDA events, mean of 50)")

    # -- 8 queries x 4 shards served as one fused sharded batch --------------
    served = {}
    for ordering in ("clustered", "shuffle_always"):
        hints = {"ordering": ordering, "parallelism": "sharded", "num_shards": 4, "merge_period": 1,
                 "implementation": "cuda_fused"}
        queries = [engine.AnalyticsQuery(task="logreg", data=table, task_args={"dim": d}, tolerance=0.0, seed=s,
                                          epochs=3 if s % 2 == 0 else 2, hints=hints)
                   for s in range(SHARD_SERVE_QUERIES)]
        srv = serve.ServingEngine(serve.ServeConfig(max_batch=SHARD_SERVE_QUERIES), engine=eng)
        for q in queries:  # plan first: the walls below are warm
            eng.explain(q)
        K.reset_launches()
        watch = timing.Stopwatch()
        tickets = [srv.submit(q) for q in queries]
        srv.drain()
        torch.cuda.synchronize()
        fused_s = watch.lap()
        fused_launches = K.launches["igd_fold"]
        launches["igd_fold"] += fused_launches
        singles = [eng.run(q) for q in queries]
        torch.cuda.synchronize()
        single_s = watch.lap()
        if srv.stats["batches"] != 1 or srv.stats["masked_batches"] != 1 or fused_launches != 3:
            raise AssertionError(f"sharded serving {ordering}: {srv.stats}, {fused_launches} launches")
        for t, single in zip(tickets, singles):
            if t.error is not None or not torch.equal(t.result.model, single.model):
                raise AssertionError(f"sharded serving {ordering}: a query differs from its own sharded run "
                                     f"({t.error})")
        served[ordering] = (SHARD_SERVE_QUERIES / fused_s, SHARD_SERVE_QUERIES / single_s)
        log("sharded", f"{SHARD_SERVE_QUERIES} logreg queries x 4 shards ({4 * SHARD_SERVE_QUERIES} lanes, "
            f"cuda_fused, {ordering}, budgets 3 and 2 alternating): one fused sharded batch, {fused_launches} "
            f"igd_fold launches (one an epoch), drain {fused_s:.3f} s = {served[ordering][0]:.2f} queries/s; one at "
            f"a time through Engine.run {single_s:.3f} s = {served[ordering][1]:.2f} queries/s "
            f"({single_s / fused_s:.2f}x); every query equal to its own sharded run bit for bit")
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on the sharded path: {launches}")

    # -- the lane launches alone (CUDA events, after the counted runs): the
    # k = 4 segments of an epoch beside the one-lane launch of the whole
    # table; igd_fold_minibatch also on 4 x (n/4 - 1) rows, whose lane
    # strides keep 16-byte boundaries (a trimmed view, for the timing only)
    lane_ms = {}
    base = catalog.get("logreg").step_size(n)(torch.arange(n, dtype=torch.int32, device=dev))
    w1 = torch.zeros(d, device=dev)
    for name, loss, iters in (("igd_fold", "lr", 3), ("igd_fold_minibatch", "lsq", 10)):
        kernel = getattr(K, name)
        layouts = {"1 lane": (table["x"], table["y"], base, w1)}
        for label, r in (("4 lanes", rps), ("4 lanes, aligned", rps - 1)):
            if label.endswith("aligned") and name == "igd_fold":
                continue
            xs4 = table["x"][:4 * r].view(4, r, d)
            ys4 = table["y"][:4 * r].view(4, r)
            layouts[label] = (xs4, ys4, comp(torch.arange(r, dtype=torch.int32, device=dev)).expand(4, r)
                              .contiguous(), w1.expand(4, d).contiguous())
        lane_ms[name] = {label: event_ms(lambda a=args: kernel(*a, loss=loss), iters)
                         for label, args in layouts.items()}
        log("sharded", f"{name} ({loss}, CUDA events): " + ", ".join(
            f"{label} {ms:.4f} ms" for label, ms in lane_ms[name].items())
            + f" (the whole {n} x {d} table an epoch; aligned = 4 x {rps - 1} rows)")
    log("sharded", f"phase 3e took {phase.lap():.1f} s; sharded launches {launches}")
    return {"launches": launches, "lane_err": lane_err, "epoch_ms": epoch_ms, "merge_ms": merge_ms,
            "served": served, "lane_ms": lane_ms}


def observability(seed: int, table: dict, dev) -> dict:
    """Phase 3f: repro_torch.obs around the fused-IGD kernel path on the
    Forest-shaped table. EXPLAIN ANALYZE of phase 3's logreg query (the
    plan must be cuda_fused): its drift rows, the engine.kernel spans'
    total beside the run's gradient wall, a fresh engine reading the
    report back from the plan store; the same query's epoch wall with
    tracing off, with the flight ring only and traced, in turns, and the
    span costs; one traced cuda_fused epoch under
    set_sync_debug_mode("error") with the ring on (no hook syncs); a
    served burst (16 logreg cuda_fused lanes, 8 least_squares
    cuda_minibatch lanes, then one singleton logreg query) with /metrics
    scraped from a thread while the pump runs, then a forced SLO breach
    whose incident file must hold an engine.kernel span; and the
    wide-table planning repair: D = 4,097 and 12,033 planned past the
    kernels, run and held to the CPU, their kernel hints refused. Returns
    the kernels' launches on the phase's paths (zeroed just before each,
    read just after)."""
    import dataclasses
    import shutil
    import tempfile
    import threading
    import urllib.request

    from repro_torch import engine, obs, timing
    from repro_torch.core import draws, uda
    from repro_torch.data import synthetic
    from repro_torch.engine import executor, serve
    from repro_torch.kernels.igd_fused import kernel as K
    from repro_torch.launch import obs_server
    from repro_torch.obs import attribution, export, flight, slo, trace

    phase = timing.Stopwatch()
    card = smi("name,power.limit")
    n, d = FOREST_ROWS, FOREST_DIM
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="obs_smoke_", dir=build)
    launches = {"igd_fold": 0, "igd_fold_minibatch": 0}

    def counted(fn):
        K.reset_launches()
        out = fn()
        for name in launches:
            launches[name] += K.launches[name]
        return out

    # -- EXPLAIN ANALYZE of phase 3's query --------------------------------
    flight.disable()  # the serving phases before this one left the ring on
    store = serve.PlanStore(root)
    eng = engine.Engine(plan_store=store)
    q = engine.AnalyticsQuery(task="logreg", data=table, task_args={"dim": d}, epochs=10, tolerance=0.0,
                              seed=seed)
    plan = eng.explain(q).chosen  # probes first: the analyzed run alone is counted
    if plan.implementation != "cuda_fused":
        raise AssertionError(f"phase 3's logreg query planned {plan.implementation}, not cuda_fused")
    ring = flight.enable(capacity=4096)  # mirrors the analyzed run's spans
    analysis = counted(lambda: eng.explain_analyze(q))
    spans = ring.snapshot_spans()
    flight.disable()
    run_launches = sum(K.launches.values())
    kernel_spans = [s for s in spans if s["name"] == "engine.kernel"]
    kernel_s = sum(s["dur"] for s in kernel_spans)
    grad_s = next(r.measured_s for r in analysis.rows if r.axis == "implementation")
    if (analysis.plan["implementation"] != "cuda_fused" or run_launches != analysis.epochs_run
            or len(kernel_spans) != analysis.epochs_run):
        raise AssertionError(f"EXPLAIN ANALYZE ran {analysis.plan}: {run_launches} launches, "
                             f"{len(kernel_spans)} engine.kernel spans in {analysis.epochs_run} epochs")
    for r in analysis.rows:
        log("obs", f"EXPLAIN ANALYZE {r.axis}: predicted {r.predicted_s:.6f} s, measured {r.measured_s:.6f} s, "
            f"drift {r.ratio:.4f}x ({r.detail}); {card}")
    phases = attribution.PhaseReport.from_dict(analysis.attribution)
    log("obs", f"EXPLAIN ANALYZE total: predicted {analysis.predicted_total_s:.6f} s, measured "
        f"{analysis.measured_total_s:.6f} s, drift {analysis.drift:.4f}x, stale {analysis.stale}; "
        f"{analysis.epochs_run} epochs, {run_launches} igd_fold launches; engine.kernel spans {kernel_s:.6f} s "
        f"beside gradient_seconds {grad_s:.6f} s ({kernel_s / grad_s:.5f}x); phase shares "
        + ", ".join(f"{p} {phases.share(p):.4f}" for p in attribution.PHASES) + f" ({phases.describe()}); {card}")
    if engine.Engine(plan_store=serve.PlanStore(root)).load_analysis(q) != analysis:
        raise AssertionError("a fresh engine on the same plan store did not read the report back")
    log("obs", f"a fresh Engine on the same plan store read the same report back: {sorted(os.listdir(store.root))}")

    # -- the epoch wall: tracing off, the flight ring only, full tracing ----
    q3 = dataclasses.replace(q, epochs=3)
    eng.run(q3)  # warm: planned and built
    modes = ("off", "flight", "traced")
    walls = {m: [] for m in modes}
    for turn in range(3):
        for mode in (modes if turn % 2 == 0 else modes[::-1]):
            if mode == "flight":
                flight.enable(capacity=256)
            with (obs.tracing() if mode == "traced" else obs.NULL_SPAN):
                res = counted(lambda: eng.run(q3))
            flight.disable()
            walls[mode].append((res.shuffle_seconds + res.gradient_seconds) / res.epochs)
    epoch_s = {m: sum(v) / len(v) for m, v in walls.items()}
    off_cost = trace.disabled_span_cost()
    flight.enable(capacity=256)
    ring_cost = flight.recording_span_cost()
    log("obs", f"epoch wall (shuffle + fold, {plan.ordering}/cuda_fused, 3 epochs, 3 runs each in turns): "
        f"tracing off {epoch_s['off'] * 1e3:.4f} ms, flight ring only {epoch_s['flight'] * 1e3:.4f} ms "
        f"({epoch_s['flight'] / epoch_s['off']:.5f}x), full tracing {epoch_s['traced'] * 1e3:.4f} ms "
        f"({epoch_s['traced'] / epoch_s['off']:.5f}x); each run (ms): "
        + "; ".join(f"{m} " + ", ".join(f"{w * 1e3:.4f}" for w in v) for m, v in walls.items())
        + f"; span() with tracing off {off_cost * 1e9:.1f} ns, with the flight ring {ring_cost * 1e9:.1f} ns "
        f"(2 spans an epoch: epoch, engine.kernel); {card}")

    # -- no hook syncs: one traced cuda_fused epoch, the ring on ------------
    compiled = eng._compile(q3, plan)
    stream = draws.TorchDraws().stream(seed, n, dev)
    state = uda.initial_state(stream.initial_model(compiled.program.agg.task))
    ordering = executor._ORDERINGS[plan.ordering]()
    examples = ordering.order(table, n, 1, stream.permutation)
    epoch_draws = stream.epoch()
    torch.cuda.synchronize()
    with obs.tracing() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            with obs.span("epoch", index=1), obs.span("engine.kernel", implementation=plan.implementation):
                state = counted(lambda: compiled.program.epoch_fn(state, examples, epoch_draws))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(state.model).all()) or [s["name"] for s in rec.spans] != ["engine.kernel", "epoch"]:
        raise AssertionError(f"the traced epoch: spans {rec.spans}")
    log("obs", f"one traced {plan.ordering}/cuda_fused epoch_fn with the flight ring on ran "
        f"under set_sync_debug_mode('error'): no host sync; spans {[s['name'] for s in rec.spans]}, "
        f"{len(flight.get().snapshot_spans())} in the ring")
    flight.disable()

    # -- a served burst, /metrics scraped while the pump runs ---------------
    cache_dir = os.path.join(root, "serve")
    srv = serve.ServingEngine(serve.ServeConfig(max_batch=16, cache_dir=cache_dir, flight_capacity=256,
                                                slo_rules=slo.default_serve_rules()),
                              engine=executor.Engine(plan_store=serve.PlanStore(cache_dir)))
    server = obs_server.start(0)
    burst = [engine.AnalyticsQuery(task=task, data=table, task_args={"dim": d}, tolerance=0.0, seed=s,
                                   epochs=3 if s % 2 == 0 else 2,
                                   hints={"ordering": "shuffle_always", "scheme": "serial", "implementation": impl})
             for task, impl, count in (("logreg", "cuda_fused", 16), ("least_squares", "cuda_minibatch", 8))
             for s in range(count)]
    # a stop rule keeps this one singleton: Engine.run, with engine.kernel spans
    solo = engine.AnalyticsQuery(task="logreg", data=table, task_args={"dim": d}, epochs=3, tolerance=1e-9,
                                 seed=seed, hints={"ordering": "shuffle_always", "implementation": "cuda_fused"})
    for x in burst + [solo]:  # plan first: the drain is warm
        srv.engine.explain(x)
    scrapes, stop = [], threading.Event()

    def scrape():
        while not scrapes or not stop.wait(0.02):
            text = urllib.request.urlopen(server.url + "/metrics", timeout=10).read().decode()
            scrapes.append((timing.now(), export.parse_prometheus(text)))

    thread = threading.Thread(target=scrape)
    thread.start()
    while not scrapes:
        stop.wait(0.01)
    tickets = [srv.submit(x) for x in burst + [solo]]
    watch = timing.Stopwatch()
    drain_start = timing.now()
    counted(srv.drain)
    drain_s = watch.lap()
    drain_end = timing.now()
    stop.set()
    thread.join(timeout=60)
    if thread.is_alive() or any(t.error is not None for t in tickets):
        raise AssertionError(f"the burst: scraper alive {thread.is_alive()}, errors "
                             f"{[t.error for t in tickets if t.error]}")
    # the registry is the process's: the earlier phases' servers counted
    # into it too, so the burst is read as the change from the scrape taken
    # before its first submit
    base = scrapes[0][1]

    def delta(p, key):
        return p.get(key, 0.0) - base.get(key, 0.0)

    mid = [p for t, p in scrapes if drain_start < t < drain_end]
    final = export.parse_prometheus(urllib.request.urlopen(server.url + "/metrics", timeout=10).read().decode())
    lanes = [delta(p, ("serve_fused_lanes_total", ())) for _, p in scrapes]
    logreg_done = sum(t.query.task == "logreg" for t in tickets)
    want = {("serve_fused_lanes_total", ()): srv.stats["fused_lanes"],
            ("serve_accepted_total", ()): len(tickets),
            ("serve_latency_s_logreg_count", ()): logreg_done,
            ("serve_latency_s_logreg_bucket", (("le", "+Inf"),)): logreg_done,
            ("serve_latency_s_least_squares_count", ()): 8}
    if (srv.stats["fused_lanes"] != 24 or srv.stats["batches"] != 2 or srv.stats["singleton_queries"] != 1
            or any(delta(final, k) != v for k, v in want.items()) or lanes != sorted(lanes)
            or not all(delta(p, ("serve_accepted_total", ())) == len(tickets) for p in mid)):
        raise AssertionError(f"/metrics disagrees with the tickets: {srv.stats}, "
                             f"{ {k: delta(final, k) for k in want} }, lanes seen {lanes}")
    mean_s = (delta(final, ("serve_latency_s_logreg_sum", ()))
              / delta(final, ("serve_latency_s_logreg_count", ())))
    log("obs", f"served burst: {len(tickets)} queries ({srv.stats['batches']} fused batches, "
        f"{srv.stats['fused_lanes']} lanes, {srv.stats['singleton_queries']} singleton) drained in {drain_s:.3f} s; "
        f"{len(scrapes)} /metrics scrapes ({len(mid)} while the pump ran, fused lanes seen "
        f"{sorted(set(lanes))}), each parsed by parse_prometheus; the burst's change in serve_fused_lanes_total "
        f"{delta(final, ('serve_fused_lanes_total', ())):.0f}, serve_accepted_total "
        f"{delta(final, ('serve_accepted_total', ())):.0f}, serve_latency_s_logreg_count "
        f"{delta(final, ('serve_latency_s_logreg_count', ())):.0f} (mean latency {mean_s:.4f} s); SLO breaches "
        f"under the default rules {srv.metrics()['slo_breaches']}; {card}")

    # -- a forced breach: its incident file holds the flight ring -----------
    forced = slo.SLOMonitor((slo.SLORule("forced_latency", "serve.latency_s.*", stat="p99", threshold=0.0),),
                            interval_s=0.0, incident_dir=os.path.join(cache_dir, "incidents"))
    events = forced.evaluate()
    if not events:
        raise AssertionError("the forced breach fired nothing")
    for event in events:
        header, span_count = slo.validate_incident(event["incident_path"])
        with open(event["incident_path"]) as f:
            names = [json.loads(line)["name"] for line in f.read().splitlines()[1:]]
        if "engine.kernel" not in names or span_count != header["flight_spans"]:
            raise AssertionError(f"incident {event['incident_path']}: {span_count} spans, no engine.kernel")
    log("obs", f"forced breach (p99 of serve.latency_s.* > 0): {len(events)} incident files "
        f"({', '.join(os.path.basename(e['incident_path']) for e in events)}), each valid, "
        f"{span_count} flight spans with {names.count('engine.kernel')} engine.kernel spans")
    obs_server.stop()
    flight.disable()

    # -- the wide-table repair: D past the kernels plans, runs, matches -----
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    card_eng = engine.Engine(draws=draws.HostDraws())
    host_eng = engine.Engine(device="cpu", draws=draws.HostDraws())
    for task, dd, hint, limit in (("logreg", 4_097, "cuda_fused", "4096"),
                                  ("least_squares", 12_033, "cuda_minibatch", "12032")):
        wide = synthetic.dense_classification(gen, WIDE_ROWS, dd)
        qw = engine.AnalyticsQuery(task=task, data=wide, task_args={"dim": dd}, epochs=2, tolerance=0.0, seed=seed)
        rep = card_eng.explain(qw)
        if rep.chosen.implementation not in ("torch_fold", "cuda_minibatch") or (
                dd > K.MINIBATCH_MAX_DIM and rep.chosen.implementation != "torch_fold"):
            raise AssertionError(f"D={dd}: planned {rep.chosen.implementation}")
        watch.lap()
        got = counted(lambda: card_eng.run(qw))
        run_s = watch.lap()
        want = host_eng.run(dataclasses.replace(qw, data={k: v.cpu() for k, v in wide.items()}), plan=rep.chosen)
        err = max_err(got.model, want.model.to(dev), f"{task} D={dd} on the card vs the CPU")
        try:
            card_eng.explain(dataclasses.replace(qw, hints={"implementation": hint}))
        except ValueError as e:
            if limit not in str(e):
                raise AssertionError(f"D={dd}: the {hint} hint raised without naming {limit}: {e}")
            refusal = str(e)
        else:
            raise AssertionError(f"D={dd}: a {hint} hint past its kernel's limit planned")
        log("obs", f"{task} {WIDE_ROWS}x{dd}: planned {rep.chosen.describe()} (probe (e) priced "
            f"{sorted(rep.calibration.impl_per_row) or 'no kernel'}); 2 epochs on the card in {run_s:.3f} s, "
            f"loss {got.losses[-1]:.6g}; max |dw| vs the CPU run {err:.3g} (rtol={KERNEL_RTOL}, atol={KERNEL_ATOL}); "
            f"the {hint} hint refused: {refusal}; {card}")
        del wide
    shutil.rmtree(root, ignore_errors=True)
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on the obs path: {launches}")
    log("obs", f"phase 3f took {phase.lap():.1f} s; obs-path launches {launches}")
    return {"launches": launches, "epoch_s": epoch_s, "span_cost_s": {"off": off_cost, "flight": ring_cost}}


def graph_ms(fn, iters: int) -> float:
    """Mean device ms per call over ``iters`` calls captured in one CUDA
    graph and replayed: the host's cost of launching each call (Python,
    ctypes, allocation) is left out, which a loop of calls cannot do when
    the host is slower than the kernel."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_busy(fn, by_name=None):
    """(host wall s, device busy s, top device events) of one call of
    ``fn`` under torch.profiler. Busy is the union of the device events'
    intervals (no double counting); None if the trace has no device time.
    ``by_name``, a dict, receives each device event name's total us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import timing

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        watch = timing.Stopwatch()
        fn()
        torch.cuda.synchronize()
        wall = watch.lap()
    spans, top_names = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            spans.append((e.time_range.start, e.time_range.end))
            top_names[e.name[:40]] = top_names.get(e.name[:40], 0.0) + (e.time_range.end - e.time_range.start)
            if by_name is not None:
                by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    top = sorted(((round(t * 1e-3, 3), k) for k, t in top_names.items()), reverse=True)[:5]
    return wall, (busy * 1e-6 if busy > 0 else None), top


def kernel_ms_by_kind(fn, calls: int, kinds: dict) -> dict:
    """(device ms a launch, launches traced) of each kind of kernel ``fn``
    launches once a call (``kinds``: kind -> a substring of the kernels'
    names), from torch.profiler's per-kernel sums over ``calls`` calls
    after a warm-up. The mean is over the launches the trace holds (late in
    a long process it can drop some); ms is None for a kind it holds none
    of (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = {kind: 0.0 for kind in kinds}, {kind: 0 for kind in kinds}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        for kind, pat in kinds.items():
            if pat in evt.key and us:
                total[kind] += us * 1e-3
                count[kind] += evt.count
    return {kind: (total[kind] / count[kind] if count[kind] else None, count[kind]) for kind in kinds}


def serving(seed: int, dev) -> list:
    """Phases 6-9: the LM serving path. Returns the two kernels' entries."""
    import torch.nn.functional as F

    from repro_torch import timing
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import kernel as AK, ref as AR
    from repro_torch.kernels.decode import kernel as DK, ref as DR
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_arch("llama3.2-3b")
    h, kv, hd, layers = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    path_attn = (SERVE_B, PROMPT, h, kv, hd)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- 6. kernels against their plain versions -----------------------------
    errs = {"flash_attention": {}, "flash_decode": {}}
    for dtype in (torch.float32, torch.bfloat16):
        e = 0.0
        for b, s, nh, nkv, d in ATTN_SHAPES + (path_attn,):
            q, k, v = normal((b, s, nh, d), dtype), normal((b, s, nkv, d), dtype), normal((b, s, nkv, d), dtype)
            tol = ATTN_TOL[dtype]
            e = max(e, max_err(AK.flash_attention(q, k, v), AR.mha_ref(q, k, v),
                               f"flash_attention {dtype} {(b, s, nh, nkv, d)}", tol, tol))
            del q, k, v
        errs["flash_attention"][dtype] = e
        e = 0.0
        cases = DECODE_SHAPES + tuple((SERVE_B, h, kv, hd, S_MAX, n) for n in (1, 700, S_MAX))
        for b, nh, nkv, d, s, length in cases:
            q, kc, vc = normal((b, nh, d), dtype), normal((b, s, nkv, d), dtype), normal((b, s, nkv, d), dtype)
            got, want = DK.flash_decode(q, kc, vc, length), DR.decode_attention_ref(q, kc, vc, length)
            what, tol = f"flash_decode {dtype} {(b, nh, nkv, d, s, length)}", DECODE_TOL[dtype]
            e = max(e, *(max_err(g, w, f"{what} {part}", tol, tol)
                         for g, w, part in zip(got, want, ("out", "m", "l"))))
        errs["flash_decode"][dtype] = e
    # in place: q, k, v as slices of one fused buffer, k and v as prefixes
    # of the serving path's cache (bf16, the serving path's heads)
    e, tol = 0.0, ATTN_TOL[torch.bfloat16]
    fused = normal((2, 1000, h + 2 * kv, hd), torch.bfloat16)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + kv], fused[:, :, h + kv:]
    e = max(e, max_err(AK.flash_attention(q, k, v), AR.mha_ref(q.contiguous(), k.contiguous(), v.contiguous()),
                       "flash_attention bf16 fused-buffer slices", tol, tol))
    kc, vc = normal((SERVE_B, S_MAX, kv, hd), torch.bfloat16), normal((SERVE_B, S_MAX, kv, hd), torch.bfloat16)
    q = normal((SERVE_B, PROMPT, h, hd), torch.bfloat16)
    e = max(e, max_err(AK.flash_attention(q, kc[:, :PROMPT], vc[:, :PROMPT]),
                       AR.mha_ref(q, kc[:, :PROMPT].contiguous(), vc[:, :PROMPT].contiguous()),
                       "flash_attention bf16 cache[:, :S] views", tol, tol))
    errs["flash_attention"][torch.bfloat16] = max(errs["flash_attention"][torch.bfloat16], e)
    del fused, q, k, v, kc, vc
    # the other families' instances: soft cap, q rows at a cache offset, hd 80 and 192
    inst_errs = {name: 0.0 for name in INSTANCES}
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[dtype]
        for b, s, off, nh, nkv, d, cap in ATTN_EXTRA:
            q = 3.0 * normal((b, s, nh, d), dtype)
            kc, vc = normal((b, off + s + 5, nkv, d), dtype), normal((b, off + s + 5, nkv, d), dtype)
            k, v = kc[:, :off + s], vc[:, :off + s]
            e = max_err(AK.flash_attention(q, k, v, cap), AR.mha_ref(q, k.contiguous(), v.contiguous(), cap),
                        f"flash_attention {dtype} (B, S, offset, H, Kv, hd, softcap) {(b, s, off, nh, nkv, d, cap)}",
                        tol, tol)
            for name in _instances("flash_attention", cap, off, d) or ["flash_attention"]:
                if name == "flash_attention":
                    errs[name][dtype] = max(errs[name][dtype], e)
                else:
                    inst_errs[name] = max(inst_errs[name], e)
        tol = DECODE_TOL[dtype]
        for b, nh, nkv, d, s, length, cap in DECODE_EXTRA:
            q, kc, vc = 3.0 * normal((b, nh, d), dtype), normal((b, s, nkv, d), dtype), normal((b, s, nkv, d), dtype)
            got, want = DK.flash_decode(q, kc, vc, length, cap), DR.decode_attention_ref(q, kc, vc, length, cap)
            what = f"flash_decode {dtype} (B, H, Kv, hd, S, length, softcap) {(b, nh, nkv, d, s, length, cap)}"
            e = max(max_err(g, w, f"{what} {part}", tol, tol) for g, w, part in zip(got, want, ("out", "m", "l")))
            for name in _instances("flash_decode", cap, 0, d) or ["flash_decode"]:
                if name == "flash_decode":
                    errs[name][dtype] = max(errs[name][dtype], e)
                else:
                    inst_errs[name] = max(inst_errs[name], e)
    del q, k, v, kc, vc
    log("parity", "new instances max |err| (both dtypes; tol 2e-5 / 5e-5 f32, 2e-2 bf16): "
        + ", ".join(f"{name} {e:.3g}" for name, e in inst_errs.items()))
    for name, by in errs.items():
        log("parity", f"{name} max |err| f32 {by[torch.float32]:.3g}, bf16 {by[torch.bfloat16]:.3g} "
            f"(tol {(ATTN_TOL if name == 'flash_attention' else DECODE_TOL)[torch.float32]:g} / 2e-2)")

    # -- 7. llama3.2-3b serving at full width and depth -----------------------
    watch = timing.Stopwatch()
    params = lm.init_lm(cfg, gen, dev)
    torch.cuda.synchronize()
    log("serve", f"llama3.2-3b init on the card: {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
        f"float32 params in {watch.lap():.2f} s")
    prompt = torch.randint(0, cfg.vocab, (SERVE_B, PROMPT), generator=gen, device=dev)
    prefill_step, decode_step = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
    # warm-up at a short prompt: the bf16 copies, cuBLAS handles, first launches
    prefill_step(params, {"tokens": prompt[:, :128]})
    tok, cache = decode_step(params, {"tokens": prompt[:, :128], "cache": lm.init_cache(cfg, SERVE_B, 136, dev)})
    decode_step(params, {"tokens": tok[:, None], "cache": cache})
    del cache
    torch.cuda.synchronize()
    log("serve", f"warm-up (bf16 copies of the weights, short prompt) {watch.lap():.2f} s")

    AK.reset_launches()
    DK.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    logits = prefill_step(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = watch.lap()
    if AK.launches["flash_attention"] != layers or DK.launches["flash_decode"]:
        raise AssertionError(f"prefill launched {AK.launches} {DK.launches}, not {layers} flash_attention")
    if logits.shape != (SERVE_B, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite [8, vocab]")
    cache = lm.init_cache(cfg, SERVE_B, S_MAX + PROFILED_STEPS, dev)
    tok, cache = decode_step(params, {"tokens": prompt, "cache": cache})
    torch.cuda.synchronize()
    cache_prefill_s = watch.lap()
    if not torch.equal(tok.long(), logits.argmax(-1)):
        raise AssertionError(f"first token {tok.tolist()} is not the prefill's argmax {logits.argmax(-1).tolist()}")
    if AK.launches["flash_attention"] != 2 * layers or cache["index"] != PROMPT:
        raise AssertionError(f"prefill into the cache: {AK.launches}, index {cache['index']}")
    out = [tok]
    for i in range(DECODE_STEPS):
        tok, cache = decode_step(params, {"tokens": tok[:, None], "cache": cache})
        out.append(tok)
        if DK.launches["flash_decode"] != layers * (i + 1):
            raise AssertionError(f"decode step {i}: {DK.launches}, not {layers} per step")
    torch.cuda.synchronize()
    decode_s = watch.lap()
    launches = {**AK.launches, **DK.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = torch.stack(out, 1)
    if cache["index"] != S_MAX or not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"decode ended at index {cache['index']} or made ids out of range")
    log("serve", f"{SERVE_B} x ({PROMPT} + {DECODE_STEPS}) tokens, {layers} layers: prefill "
        f"{prefill_s * 1e3:.1f} ms ({SERVE_B * PROMPT / prefill_s:.0f} tokens/s), prefill into the cache "
        f"{cache_prefill_s * 1e3:.1f} ms, decode {decode_s * 1e3 / DECODE_STEPS:.2f} ms/step "
        f"({SERVE_B * DECODE_STEPS / decode_s:.1f} tokens/s), peak {peak_gb:.2f} GB allocated")
    log("serve", f"main-path launches {launches} (flash_attention {layers} per prefill, "
        f"flash_decode {layers} per step); first tokens {toks[:, :6].tolist()}")
    # where the time goes, after the counted run: one prefill and a few
    # decode steps past S_max under the profiler
    for what, fn in (
        ("prefill step", lambda: prefill_step(params, {"tokens": prompt})),
        (f"{PROFILED_STEPS} decode steps", lambda: [decode_step(params, {"tokens": tok[:, None], "cache": cache})
                                                   for _ in range(PROFILED_STEPS)]),
    ):
        wall, busy, top = device_busy(fn)
        share = "not measured (no device time in the trace)" if busy is None else \
            f"device busy {busy * 1e3:.2f} ms = {busy / wall:.3f} of the wall, idle {1 - busy / wall:.3f}"
        log("profile", f"{what}: wall {wall * 1e3:.2f} ms (profiler on), {share}; top device ms {top}")
    del params, cache, prefill_step, decode_step
    torch.cuda.empty_cache()

    # -- 7b. every other architecture at full width -------------------------
    fam = families(gen, dev)

    # -- 8. full width, 2 layers, float32: the card's kernels vs the CPU's plain path
    small = cfg.scaled(n_layers=2, dtype="float32")
    p_gpu = lm.init_lm(small, gen, dev)
    p_cpu = _tree_to(p_gpu, "cpu")
    ids = torch.randint(0, small.vocab, (2, 256 + 8), generator=gen, device=dev)
    worst = 0.0
    for device, p in ((dev, p_gpu), ("cpu", p_cpu)):
        cache = lm.init_cache(small, 2, 264, device)
        logits, cache = lm.decode_step(p, ids[:, :256].to(device), cache, small)
        steps = [logits.cpu()]
        for t in range(8):
            logits, cache = lm.decode_step(p, ids[:, 256 + t:257 + t].to(device), cache, small)
            steps.append(logits.cpu())
        if device == dev:
            card = steps
    for i, (got, want) in enumerate(zip(card, steps)):
        worst = max(worst, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=CPU_AGREE_TOL, atol=CPU_AGREE_TOL):
            raise AssertionError(f"step {i}: card and CPU logits disagree (max |err| {worst:.3g})")
    log("reference", f"2-layer full-width f32 llama3.2-3b, B=2, 256-token prefill + 8 decode steps: "
        f"card kernels vs CPU plain path, max |logit err| {worst:.3g} (tol {CPU_AGREE_TOL:g})")
    del p_gpu, p_cpu, cache
    torch.cuda.empty_cache()

    # -- 9. timings at the serving path's shapes (bf16) ----------------------
    bf = torch.bfloat16
    q, k, v = normal((SERVE_B, PROMPT, h, hd), bf), normal((SERVE_B, PROMPT, kv, hd), bf), normal((SERVE_B, PROMPT, kv, hd), bf)
    qd, kc, vc = normal((SERVE_B, h, hd), bf), normal((SERVE_B, S_MAX, kv, hd), bf), normal((SERVE_B, S_MAX, kv, hd), bf)
    length = S_MAX
    sdpa = F.scaled_dot_product_attention
    calls = {  # (kernel, library call, launches per timing)
        "flash_attention": (lambda: AK.flash_attention(q, k, v),
                            lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                         is_causal=True, enable_gqa=True), 10),
        "flash_decode": (lambda: DK.flash_decode(qd, kc, vc, length),
                         lambda: sdpa(qd[:, :, None], kc[:, :length].transpose(1, 2),
                                      vc[:, :length].transpose(1, 2), enable_gqa=True), 100),
    }
    turns, library_ms = {}, {}
    for name, (kernel, library, iters) in calls.items():  # kernel, library, kernel
        first = graph_ms(kernel, iters)
        library_ms[name] = graph_ms(library, iters)
        turns[name] = (first, graph_ms(kernel, iters))
    ms = {name: sum(t) / 2 for name, t in turns.items()}
    eager_ms = {name: event_ms(kernel, iters) for name, (kernel, _, iters) in calls.items()}
    plain_ms = {"flash_attention": timing.seconds(lambda: AR.mha_ref(q, k, v), dev) * 1e3,
                "flash_decode": timing.seconds(lambda: DR.decode_attention_ref(qd, kc, vc, length), dev) * 1e3}
    work = {
        # q, k, v read once and o written once, bf16; causal half of QK^T and PV
        "flash_attention": (2 * SERVE_B * PROMPT * (h + kv) * hd * 2,
                            4 * SERVE_B * h * hd * PROMPT * (PROMPT + 1) // 2, BF16_FLOPS),
        # the cache's k and v up to length, q and out (bf16), m and l (f32)
        "flash_decode": (2 * SERVE_B * length * kv * hd * 2 + 2 * SERVE_B * h * hd * 2 + 2 * SERVE_B * h * 4,
                         4 * SERVE_B * h * hd * length, BF16_FLOPS),
    }
    entries = []
    for name, source, replaces in (
        ("flash_attention", "src/repro_torch/kernels/attention/csrc/flash_attention.cu",
         "src/repro/kernels/attention/kernel.py:63"),
        ("flash_decode", "src/repro_torch/kernels/decode/csrc/flash_decode.cu",
         "src/repro/kernels/decode/kernel.py:62"),
    ):
        nbytes, flops, peak = work[name]
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        bound = max(bytes_ms, ops_ms)
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(errs[name].values()),
            "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": library_ms[name],
        })
        rate = (f"{flops / ms[name] / 1e9:.1f} TFLOP/s" if ops_ms > bytes_ms
                else f"{nbytes / ms[name] / 1e9:.3f} TB/s")
        log("timing", f"{name}: {ms[name]:.4f} ms/launch on the device (CUDA graph; turns kernel "
            f"{turns[name][0]:.4f}, library {library_ms[name]:.4f}, kernel {turns[name][1]:.4f}), {rate}, "
            f"{bound / ms[name]:.3f} of the bound; {eager_ms[name]:.4f} ms per call in a loop of eager calls "
            f"(host launch included); bound {bound:.4f} ms "
            f"({'bytes' if bytes_ms >= ops_ms else 'operations'}: {nbytes} bytes at 3.35 TB/s {bytes_ms:.4f} ms, "
            f"{flops} FLOP at {peak / 1e12:g} TFLOP/s {ops_ms:.4f} ms); plain {plain_ms[name]:.3f} ms; "
            f"scaled_dot_product_attention {library_ms[name]:.4f} ms (CUDA graph), "
            f"kernel/library {ms[name] / library_ms[name]:.2f}")
    log("timing", f"shapes: flash_attention q [{SERVE_B}, {PROMPT}, {h}, {hd}], k/v [{SERVE_B}, {PROMPT}, {kv}, {hd}] "
        f"bf16; flash_decode q [{SERVE_B}, {h}, {hd}], cache [{SERVE_B}, {S_MAX}, {kv}, {hd}] bf16, length {length}; "
        "the library decode call computes out only, not m and l")
    for entry in entries:
        entry["launches_families"] = fam["launches"][entry["name"]]
    del q, k, v, qd, kc, vc
    torch.cuda.empty_cache()
    entries += instance_timings(normal, inst_errs, fam["instances"], dev)
    return entries


def instance_timings(normal, errs: dict, launches: dict, dev) -> list:
    """Phase 9, the instances the other families added, at their shapes
    (bf16): the kernel in a replayed CUDA graph in turns with its library
    call where PyTorch has one, its plain version (at B = 2 where the full
    batch's float32 logits would not fit), and its bound."""
    import torch.nn.functional as F

    from repro_torch import timing
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import kernel as AK, ref as AR
    from repro_torch.kernels.decode import kernel as DK, ref as DR

    bf, sdpa = torch.bfloat16, F.scaled_dot_product_attention
    grok, nemo, llama = get_arch("grok-1-314b"), get_arch("nemotron-4-340b"), get_arch("llama3.2-3b")
    length = PROMPT + FAMILY_STEPS
    entries = []
    # (name, arch, S, offset, softcap, plain batch)
    for name, cfg, s, off, cap, plain_b in (
        ("flash_attention[softcap]", grok, PROMPT, 0, grok.logit_softcap, SERVE_B),
        ("flash_attention[offset]", llama, PROMPT // 2, PROMPT // 2, 0.0, SERVE_B),
        ("flash_attention[hd192]", nemo, PROMPT, 0, 0.0, 2),
    ):
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = normal((SERVE_B, s, h, hd), bf)
        k, v = normal((SERVE_B, off + s, kv, hd), bf), normal((SERVE_B, off + s, kv, hd), bf)
        kernel = functools.partial(AK.flash_attention, q, k, v, cap)
        if cap:
            library = None
        elif off:
            mask = torch.ones((s, off + s), dtype=torch.bool, device=dev).tril(off)  # bottom-right causal
            library = functools.partial(lambda m: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                       attn_mask=m, enable_gqa=True), mask)
        else:
            library = lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),  # noqa: E731
                                   is_causal=True, enable_gqa=True)
        first = graph_ms(kernel, 10)
        lib_ms = graph_ms(library, 10) if library else None
        ms = (first + graph_ms(kernel, 10)) / 2
        plain_ms = timing.seconds(lambda: AR.mha_ref(q[:plain_b], k[:plain_b], v[:plain_b], cap), dev) * 1e3
        pairs = s * off + s * (s + 1) // 2  # (q row, key) pairs under the causal mask
        nbytes = 2 * SERVE_B * (s * h + (off + s) * kv) * hd * 2
        flops = 4 * SERVE_B * h * hd * pairs
        entries.append(_entry(name, "attention", "src/repro/kernels/attention/kernel.py:63", launches[name],
                              errs[name], ms, plain_ms, nbytes, flops, lib_ms, plain_b))
        log("timing", f"{name} ({cfg.name}: q [{SERVE_B}, {s}, {h}, {hd}] at offset {off}, k/v [{SERVE_B}, {off + s}, "
            f"{kv}, {hd}], softcap {cap:g}, bf16): {ms:.4f} ms (CUDA graph; turns {first:.4f}"
            + (f", library {lib_ms:.4f}" if lib_ms else ", no library call") + f"), "
            f"{flops / ms / 1e9:.1f} TFLOP/s; bound {entries[-1]['bound_ms']:.4f} ms ({entries[-1]['bound_by']}); "
            f"plain {plain_ms:.3f} ms at B={plain_b}; launches on the families' paths {launches[name]}")
        del q, k, v
    for name, cfg, cap in (("flash_decode[softcap]", grok, grok.logit_softcap), ("flash_decode[hd192]", nemo, 0.0)):
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        qd, kc, vc = normal((SERVE_B, h, hd), bf), normal((SERVE_B, length, kv, hd), bf), normal((SERVE_B, length, kv, hd), bf)
        kernel = functools.partial(DK.flash_decode, qd, kc, vc, length, cap)
        library = None if cap else (lambda: sdpa(qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                                                 enable_gqa=True))
        first = graph_ms(kernel, 100)
        lib_ms = graph_ms(library, 100) if library else None
        ms = (first + graph_ms(kernel, 100)) / 2
        plain_ms = timing.seconds(lambda: DR.decode_attention_ref(qd, kc, vc, length, cap), dev) * 1e3
        nbytes = 2 * SERVE_B * length * kv * hd * 2 + 2 * SERVE_B * h * hd * 2 + 2 * SERVE_B * h * 4
        flops = 4 * SERVE_B * h * hd * length
        entries.append(_entry(name, "decode", "src/repro/kernels/decode/kernel.py:62", launches[name], errs[name],
                              ms, plain_ms, nbytes, flops, lib_ms, SERVE_B))
        log("timing", f"{name} ({cfg.name}: q [{SERVE_B}, {h}, {hd}], cache [{SERVE_B}, {length}, {kv}, {hd}], "
            f"softcap {cap:g}, bf16): {ms:.4f} ms (CUDA graph; turns {first:.4f}"
            + (f", library {lib_ms:.4f}" if lib_ms else ", no library call") + f"), "
            f"{nbytes / ms / 1e9:.3f} TB/s; bound {entries[-1]['bound_ms']:.4f} ms ({entries[-1]['bound_by']}); "
            f"plain {plain_ms:.3f} ms; launches on the families' paths {launches[name]}")
        del qd, kc, vc
    return entries


def _entry(name, kind, replaces, launches, err, ms, plain_ms, nbytes, flops, library_ms, plain_batch) -> dict:
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    source = f"src/repro_torch/kernels/{kind}/csrc/flash_{kind}.cu"
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": library_ms,
            "plain_batch": plain_batch}


def families(gen, dev) -> dict:
    """Phase 7b: every other architecture through make_prefill_step and
    make_decode_step at full width (FAMILY_DEPTH's cuts), llama3.2-3b's
    chunked prefill, and each family's card run against the CPU's plain
    path (FAMILY_CPU). Returns the launches by instance and the timing
    shapes' sources."""
    from repro_torch import timing
    from repro_torch.configs import all_archs, get_arch
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.decode import kernel as DK
    from repro_torch.launch import serve
    from repro_torch.models import lm

    phase = timing.Stopwatch()
    s_max = PROMPT + FAMILY_STEPS
    inst = {name: 0 for name in INSTANCES}
    total = {"flash_attention": 0, "flash_decode": 0}
    rows = {}
    for name in sorted(all_archs()):
        if name == "llama3.2-3b":
            continue  # phases 7 and 8
        cfg = get_arch(name).scaled(**FAMILY_DEPTH.get(name, {}))
        watch = timing.Stopwatch()
        params = lm.init_lm(cfg, gen, dev)
        torch.cuda.synchronize()
        init_s = watch.lap()
        n_tok = PROMPT - cfg.n_prefix
        prompt = torch.randint(0, cfg.vocab, (SERVE_B, n_tok), generator=gen, device=dev)
        batch = {"tokens": prompt}
        if cfg.n_prefix:
            batch["prefix_embeds"] = 0.02 * torch.randn((SERVE_B, cfg.n_prefix, cfg.d_model), generator=gen,
                                                        device=dev).bfloat16()
        apps = {"hybrid": cfg.n_layers // max(cfg.attn_every, 1), "ssm": 0}.get(cfg.family, cfg.n_layers)
        # warm-up at a short prompt: the builders' bf16 copies, cuBLAS handles, first launches
        prefill_step, decode_step = serve.make_prefill_step(cfg), serve.make_decode_step(cfg)
        short = {k: v[:, :128] for k, v in batch.items()}
        prefill_step(params, short)
        if cfg.family != "ssm":
            decode_step(params, {**short, "cache": lm.init_cache(cfg, SERVE_B, 256, dev)})
        else:
            decode_step(params, {"tokens": prompt[:, :1], "cache": lm.init_cache(cfg, SERVE_B, 8, dev)})
        torch.cuda.synchronize()
        warm_s = watch.lap()

        AK.reset_launches()
        DK.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        logits = prefill_step(params, batch)
        torch.cuda.synchronize()
        prefill_s = watch.lap()
        if logits.shape != (SERVE_B, cfg.vocab) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: prefill logits are not finite [{SERVE_B}, vocab]")
        if (AK.launches["flash_attention"], DK.launches["flash_decode"]) != (apps, 0):
            raise AssertionError(f"{name}: prefill launched {AK.launches} {DK.launches}, not {apps} flash_attention")
        extra = ""
        if cfg.family == "ssm":
            # no prefill into a cache (an mLSTM refuses it): replay the
            # prompt's first tokens through decode_step, then step greedily
            cache = lm.init_cache(cfg, SERVE_B, s_max, dev)
            for t in range(FAMILY_REPLAY):
                tok, cache = decode_step(params, {"tokens": prompt[:, t:t + 1], "cache": cache})
            torch.cuda.synchronize()
            cache_prefill_s = watch.lap()
            extra = f"; replay of {FAMILY_REPLAY} tokens through decode_step {cache_prefill_s * 1e3:.1f} ms"
            extra += "; " + _xlstm_replay_check(cfg, params, prompt, lm)
            watch.lap()
        else:
            cache = lm.init_cache(cfg, SERVE_B, s_max, dev)
            tok, cache = decode_step(params, {**batch, "cache": cache})
            torch.cuda.synchronize()
            cache_prefill_s = watch.lap()
            if AK.launches["flash_attention"] != 2 * apps or cache["index"] != PROMPT:
                raise AssertionError(f"{name}: prefill into the cache launched {AK.launches}, index {cache['index']}")
            if not torch.equal(tok.long(), logits.argmax(-1)):
                raise AssertionError(f"{name}: first tokens {tok.tolist()} are not the prefill's argmax "
                                     f"{logits.argmax(-1).tolist()}")
            extra = f"; prefill into the cache {cache_prefill_s * 1e3:.1f} ms, first token = the prefill's argmax"
        out = [tok]
        before = DK.launches["flash_decode"]
        for i in range(FAMILY_STEPS):
            tok, cache = decode_step(params, {"tokens": tok[:, None], "cache": cache})
            out.append(tok)
        torch.cuda.synchronize()
        decode_s = watch.lap()
        toks = torch.stack(out, 1)
        if DK.launches["flash_decode"] - before != apps * FAMILY_STEPS:
            raise AssertionError(f"{name}: {DK.launches['flash_decode'] - before} flash_decode launches in "
                                 f"{FAMILY_STEPS} steps, not {apps} per step")
        if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"{name}: decode made ids out of range")
        launches = {**AK.launches, **DK.launches}
        for kernel in total:
            total[kernel] += launches[kernel]
        tags = (_instances("flash_attention", cfg.logit_softcap, 0, cfg.hd)
                + _instances("flash_decode", cfg.logit_softcap, 0, cfg.hd))
        for tag in tags:
            inst[tag] += launches[tag.split("[")[0]]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        depth = (f"{cfg.n_layers} of {get_arch(name).n_layers} layers"
                 + (f", params {cfg.param_dtype}" if cfg.param_dtype != "float32" else "")
                 if name in FAMILY_DEPTH else f"{cfg.n_layers} layers (full depth)")
        rows[name] = dict(prefill_ms=prefill_s * 1e3, decode_ms=decode_s * 1e3 / FAMILY_STEPS, peak_gb=peak_gb,
                          launches=launches, depth=depth)
        log("families", f"{name} [{cfg.family}, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, "
            f"{depth}]: init {init_s:.2f} s, warm-up {warm_s:.2f} s; {SERVE_B} x {PROMPT} positions"
            + (f" ({cfg.n_prefix} prefix + {n_tok} tokens)" if cfg.n_prefix else "")
            + f": prefill {prefill_s * 1e3:.1f} ms ({SERVE_B * PROMPT / prefill_s:.0f} positions/s){extra}; "
            f"decode {decode_s * 1e3 / FAMILY_STEPS:.2f} ms/step ({FAMILY_STEPS} greedy steps, "
            f"{SERVE_B * FAMILY_STEPS / decode_s:.1f} tokens/s); peak {peak_gb:.2f} GB allocated; launches "
            f"{launches} ({apps} attention applications a call)")
        del params, cache, prefill_step, decode_step, logits, batch
        torch.cuda.empty_cache()

    # llama3.2-3b's prompt in two chunks, the second at cache index 1,024,
    # through lm.decode_step on one bf16 copy of the weights
    cfg = get_arch("llama3.2-3b")
    params = lm.cast_params(lm.init_lm(cfg, gen, dev), cfg)
    prompt = torch.randint(0, cfg.vocab, (SERVE_B, PROMPT), generator=gen, device=dev)
    one_shot = lm.prefill(params, prompt, cfg)
    cache = lm.init_cache(cfg, SERVE_B, PROMPT, dev)
    half = PROMPT // 2
    _, cache = lm.decode_step(params, prompt[:, :half], cache, cfg)
    AK.reset_launches()
    watch = timing.Stopwatch()
    logits, cache = lm.decode_step(params, prompt[:, half:], cache, cfg)
    torch.cuda.synchronize()
    chunk_s = watch.lap()
    inst["flash_attention[offset]"] += AK.launches["flash_attention"]
    total["flash_attention"] += AK.launches["flash_attention"]
    if AK.launches["flash_attention"] != cfg.n_layers or cache["index"] != PROMPT:
        raise AssertionError(f"chunk at index {half}: {AK.launches}, index {cache['index']}")
    chunk_err = max_err(logits, one_shot, f"llama3.2-3b {half} + {half}-token chunked prefill vs one shot",
                        2e-2, 2e-2)
    log("families", f"llama3.2-3b chunked prefill: {half} tokens, then {half} at cache index {half} "
        f"({cfg.n_layers} flash_attention launches at offset {half}, {chunk_s * 1e3:.1f} ms for the second chunk), "
        f"last logits vs the one-shot {PROMPT}-token prefill max |err| {chunk_err:.3g} (bf16 tol 2e-2)")
    del params, cache, one_shot, logits
    torch.cuda.empty_cache()

    # each family at full width, float32, the card's kernels vs the CPU's plain path
    worst = {}
    for name, (cut, b) in FAMILY_CPU.items():
        cfg = get_arch(name).scaled(dtype="float32", **cut)
        p_gpu = lm.init_lm(cfg, gen, dev)
        hidden_only = name == "nemotron-4-340b"
        if hidden_only:
            del p_gpu["lm_head"]
        p_cpu = _tree_to(p_gpu, "cpu")
        n_tok = CPU_PROMPT + CPU_STEPS
        ids = torch.randint(0, cfg.vocab, (b, n_tok), generator=gen, device=dev).cpu()
        prefix = (0.02 * torch.randn((b, cfg.n_prefix, cfg.d_model), generator=gen, device=dev)).cpu() \
            if cfg.n_prefix else None
        runs = {}
        for device, p in ((dev, p_gpu), ("cpu", p_cpu)):
            AK.reset_launches()
            DK.reset_launches()
            cache = lm.init_cache(cfg, b, n_tok + cfg.n_prefix, device)

            def call(tokens, cache, pre=None):
                if hidden_only:
                    x, cache = lm.hidden_states(p, tokens.to(device), cfg, cache=cache,
                                                prefix_embeds=None if pre is None else pre.to(device))
                    return x[:, -1].cpu(), cache
                logits, cache = lm.decode_step(p, tokens.to(device), cache, cfg,
                                               prefix_embeds=None if pre is None else pre.to(device))
                return logits.cpu(), cache

            if cfg.family == "ssm":
                outs = []
                for t in range(n_tok):
                    o, cache = call(ids[:, t:t + 1], cache)
                    outs.append(o)
            else:
                o, cache = call(ids[:, :CPU_PROMPT], cache, prefix)
                outs = [o]
                for t in range(CPU_PROMPT, n_tok):
                    o, cache = call(ids[:, t:t + 1], cache)
                    outs.append(o)
            runs[str(device)] = (outs, dict(AK.launches), dict(DK.launches))
            del cache
        apps = {"hybrid": cfg.n_layers // max(cfg.attn_every, 1), "ssm": 0}.get(cfg.family, cfg.n_layers)
        card_runs = runs[str(dev)]
        want_launches = (apps, apps * (n_tok if cfg.family == "ssm" else CPU_STEPS) if apps else 0)
        if (card_runs[1]["flash_attention"], card_runs[2]["flash_decode"]) != want_launches:
            raise AssertionError(f"{name} card run launched {card_runs[1]} {card_runs[2]}, not {want_launches}")
        if cfg.family == "ssm" and card_runs[1]["flash_attention"]:
            raise AssertionError(f"{name}: the xLSTM launched attention kernels")
        e = 0.0
        for i, (got, want) in enumerate(zip(card_runs[0], runs["cpu"][0])):
            e = max(e, float((got - want).abs().max()))
            if not torch.allclose(got, want, rtol=CPU_AGREE_TOL, atol=CPU_AGREE_TOL):
                raise AssertionError(f"{name} call {i}: card and CPU disagree (max |err| {e:.3g})")
        worst[name] = e
        log("reference", f"{name} [{cfg.family}] at full width, {cfg.n_layers} layers, f32, B={b}"
            + (f", moe_block {cfg.moe_block}" if "moe_block" in cut else "")
            + (f", prefix {cfg.n_prefix}" if cfg.n_prefix else "")
            + (f": replay of {n_tok} tokens" if cfg.family == "ssm" else
               f": {CPU_PROMPT}-token prefill into the cache + {CPU_STEPS} steps")
            + f"; card kernels vs CPU plain path, max |{'hidden state before the head' if hidden_only else 'logit'} "
            f"err| {e:.3g} (tol {CPU_AGREE_TOL:g}); card launches {card_runs[1]} {card_runs[2]}")
        del p_gpu, p_cpu, runs, card_runs
        torch.cuda.empty_cache()
    log("families", f"phase 7b took {phase.lap():.1f} s; launches on its paths {total}, by instance {inst}")
    return {"launches": total, "instances": inst, "rows": rows, "cpu_err": worst, "chunk_err": chunk_err}


def _xlstm_replay_check(cfg, params, prompt, lm) -> str:
    """The reference's own check (tests/test_models.py), in float32: the
    parallel forward over the first FAMILY_REPLAY tokens and the same
    tokens replayed through decode_step agree within 2e-3 (B = 2), held
    on the first segment (slstm_every layers, full width). Over all 24
    layers float32 rounding grows past that bound in both packages (the
    reference reads 1.3e-2 at full depth on the CPU), so the full depth's
    difference is printed beside it, not held."""
    ids = prompt[:2, :FAMILY_REPLAY]
    seg = {**params, "mlstm": params["mlstm"][:1], "slstm": params["slstm"][:1]}
    diffs = []
    for c, p in ((cfg.scaled(dtype="float32", n_layers=cfg.slstm_every), seg), (cfg.scaled(dtype="float32"), params)):
        par, _, _ = lm.forward(p, ids, c)
        cache = lm.init_cache(c, 2, FAMILY_REPLAY, ids.device)
        worst = 0.0
        for t in range(FAMILY_REPLAY):
            logits, cache = lm.decode_step(p, ids[:, t:t + 1], cache, c)
            worst = max(worst, float((logits - par[:, t]).abs().max()))
        diffs.append(worst)
    if diffs[0] >= 2e-3:
        raise AssertionError(f"xLSTM parallel vs replayed logits differ by {diffs[0]:.3g} over one segment "
                             "(float32, tol 2e-3)")
    return (f"float32 parallel forward vs {FAMILY_REPLAY}-token replay max |logit err| {diffs[0]:.3g} over the "
            f"first segment ({cfg.slstm_every} layers; tol 2e-3), {diffs[1]:.3g} over all {cfg.n_layers} (not held)")


def training(seed: int, dev, entries: dict) -> list:
    """Phase 10, LM training on the card. Returns the flash_attention_bwd
    entry of the kernels line and adds the training path's launches and
    the lse timings to flash_attention's entry."""
    import re
    import shutil

    import torch.nn.functional as F

    from repro_torch import timing
    from repro_torch.configs import get_arch
    from repro_torch.core import igd
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.data import synthetic
    from repro_torch.kernels.attention import kernel as AK, ops as A, ref as AR
    from repro_torch.kernels.decode import kernel as DK
    from repro_torch.kernels.igd_fused import kernel as K
    from repro_torch.launch import train
    from repro_torch.launch.train_loop import fit
    from repro_torch.models import lm
    from repro_torch.optim import AdamW, IGD

    phase = timing.Stopwatch()
    card = smi("name,power.limit")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def igd_opt():
        return IGD(igd.diminishing(*TRAIN_IGD_STEP), momentum=0.9)

    # -- 10a. lse and the gradient kernels against their plain versions ------
    errs = {"lse": 0.0, "bwd": 0.0, "bwd_rel": {}}
    for dtype in (torch.float32, torch.bfloat16):
        worst_rel = 0.0
        for hd in BWD_HD:
            for g in BWD_G:
                for s in BWD_S:
                    for cap in BWD_CAPS:
                        b, kv = (2 if s < 64 else 1), (2 if g < 6 else 1)
                        h = g * kv
                        q = 3.0 * normal((b, s, h, hd), dtype)  # logits past the cap
                        k, v = normal((b, s, kv, hd), dtype), normal((b, s, kv, hd), dtype)
                        do = normal((b, s, h, hd), dtype)
                        o, lse = AK.flash_attention(q, k, v, cap, with_lse=True)
                        grads = AK.flash_attention_backward(q, k, v, o, lse, do, cap)
                        what = f"{dtype} (B, S, H, Kv, hd, softcap) {(b, s, h, kv, hd, cap)}"
                        errs["lse"] = max(errs["lse"], max_err(lse, AR.mha_lse_ref(q, k, cap), f"lse {what}",
                                                               *LSE_TOL[dtype]))
                        rtol, atol = BWD_TOL[dtype]
                        for name, got, want in zip(("dq", "dk", "dv"), grads,
                                                   AR.mha_backward_ref(q, k, v, o, lse, do, cap)):
                            scale = max(1.0, float(want.float().abs().max()))
                            e = max_err(got, want, f"flash_attention_bwd {name} {what}", rtol, atol * scale)
                            errs["bwd"], worst_rel = max(errs["bwd"], e), max(worst_rel, e / scale)
                        del q, k, v, do, o, lse, grads
        errs["bwd_rel"][dtype] = worst_rel
    n_cases = len(BWD_HD) * len(BWD_G) * len(BWD_S) * len(BWD_CAPS)
    log("train", f"10a lse and flash_attention_bwd (D, dk/dv, dq) vs mha_lse_ref / mha_backward_ref, {n_cases} shapes "
        f"a dtype (hd {BWD_HD} x g {BWD_G} x S {BWD_S} x softcap {BWD_CAPS}): lse max |err| {errs['lse']:.3g}; "
        f"gradients max |err| {errs['bwd']:.3g}, relative to the largest entry f32 "
        f"{errs['bwd_rel'][torch.float32]:.3g} (tol 2e-4 + 2e-5), bf16 {errs['bwd_rel'][torch.bfloat16]:.3g} (tol 2e-2)")
    for dtype in (torch.float32, torch.bfloat16):  # the Function's gradient against autograd through mha_ref
        shapes = ((1, 1000, 24, 128), (1, 1000, 8, 128), (1, 1000, 8, 128))
        ins = [normal(shape, dtype).requires_grad_() for shape in shapes]
        plain = [t.detach().clone().requires_grad_() for t in ins]
        weight = normal((1, 1000, 24, 128), torch.float32)
        (A.mha(*ins).float() * weight).sum().backward()
        (AR.mha_ref(*plain).float() * weight).sum().backward()
        for name, got, want in zip("qkv", ins, plain):
            rtol, atol = BWD_TOL[dtype]
            scale = max(1.0, float(want.grad.float().abs().max()))
            errs["bwd"] = max(errs["bwd"], max_err(got.grad, want.grad, f"FlashAttention d{name} {dtype} vs autograd "
                                                   "through mha_ref", rtol, atol * scale))
        del ins, plain, weight
    refused = []
    qd, kc = normal((1, 4, 64), torch.bfloat16).requires_grad_(), normal((1, 64, 2, 64), torch.bfloat16)
    x, y, alpha, w0 = inputs(gen, 300, 54, dev)
    w0.requires_grad_()
    for what, call in (("flash_decode", lambda: DK.flash_decode(qd, kc, kc, 8)),
                       ("igd_fold", lambda: K.igd_fold(x, y, alpha, w0)),
                       ("igd_fold_minibatch", lambda: K.igd_fold_minibatch(x, y, alpha, w0))):
        try:
            call()
        except ValueError as e:
            if "no backward" not in str(e):
                raise
            refused.append(what)
        else:
            raise AssertionError(f"{what} took an input that requires grad")
    log("train", f"10a FlashAttention's gradient (1 x 1000, 24/8 heads, hd 128, f32 and bf16) matches autograd through "
        f"mha_ref; {', '.join(refused)} refuse an input that requires grad; 10a took {phase.lap():.1f} s")

    # -- 10b. full width, 2 layers, float32: one step on the card and on the CPU
    small = get_arch("llama3.2-3b").scaled(n_layers=TRAIN_CPU_LAYERS, dtype="float32")
    p_gpu = lm.init_lm(small, gen, dev)
    p_cpu = _tree_to(p_gpu, "cpu")
    tokens = torch.randint(0, small.vocab, (TRAIN_CPU_B, TRAIN_CPU_S), generator=gen, device=dev)
    runs = {}
    for where, p in (("card", p_gpu), ("cpu", p_cpu)):
        device = dev if where == "card" else torch.device("cpu")
        opt = igd_opt()
        state = opt.init(p)
        watch = timing.Stopwatch()
        p, state, metrics = train.make_train_step(small, opt, grad_accum=2)(p, state, {"tokens": tokens.to(device)}, 0)
        timing.sync(device)
        runs[where] = (leaves(p), leaves(state), float(metrics["loss"]), watch.lap())
    worst = {"params": 0.0, "momentum": 0.0}
    for kind, i in (("params", 0), ("momentum", 1)):
        for got, want in zip(runs["card"][i], runs["cpu"][i]):
            err = float((got.detach().cpu() - want.detach()).abs().max()) / max(float(want.detach().abs().max()), 1e-30)
            worst[kind] = max(worst[kind], err)
            if err > TRAIN_CPU_TOL:
                raise AssertionError(f"10b: a {kind} leaf {tuple(want.shape)} on the card is {err:.3g} of its largest "
                                     f"element from the CPU's (tol {TRAIN_CPU_TOL:g})")
    if abs(runs["card"][2] - runs["cpu"][2]) > TRAIN_CPU_TOL * abs(runs["cpu"][2]):
        raise AssertionError(f"10b: loss {runs['card'][2]} on the card, {runs['cpu'][2]} on the CPU")
    log("train", f"10b llama3.2-3b full width, {TRAIN_CPU_LAYERS} layers, float32, TF32 off, B {TRAIN_CPU_B} x S "
        f"{TRAIN_CPU_S}, one grad_accum=2 IGD-momentum step from the same params: loss card {runs['card'][2]:.7f}, "
        f"CPU {runs['cpu'][2]:.7f}; max |card - CPU| / max |CPU| over the leaves: params {worst['params']:.3g}, "
        f"momentum (the step's gradient) {worst['momentum']:.3g} (tol {TRAIN_CPU_TOL:g}); the step took "
        f"{runs['card'][3]:.2f} s on the card, {runs['cpu'][3]:.2f} s on the CPU; 10b took {phase.lap():.1f} s")
    del p_gpu, p_cpu, runs, state, p
    torch.cuda.empty_cache()

    # -- 10c. llama3.2-3b at full width and depth, S 4,096 --------------------
    cfg = get_arch("llama3.2-3b")
    h, kv, hd, n_layers = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    data = synthetic.token_stream(gen, TRAIN_BATCH * TRAIN_IGD_STEPS, TRAIN_S, cfg.vocab)["tokens"]
    tokens_a_step = TRAIN_BATCH * TRAIN_S
    mm_params = n_layers * (cfg.d_model * (h + 2 * kv) * hd + h * hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff) \
        + cfg.d_model * cfg.vocab
    flops_a_token = 6 * mm_params + 6 * n_layers * h * hd * (TRAIN_S + 1)  # causal attention, forward + backward
    per_step = {"flash_attention": n_layers * TRAIN_ACCUM * 2, "flash_attention_bwd": n_layers * TRAIN_ACCUM * 3}
    split = {}

    def run(name, opt, n_steps, profile_last):
        init = torch.Generator(device=dev)
        init.manual_seed(seed + 11)  # the same start for both optimizers
        params = lm.init_lm(cfg, init, dev)
        state = opt.init(params)
        step_fn = train.make_train_step(cfg, opt, grad_accum=TRAIN_ACCUM)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in (AK, DK, K):
            mod.reset_launches()
        losses, norms, ms = [], [], []
        for t in range(n_steps):
            batch = {"tokens": data[t * TRAIN_BATCH:(t + 1) * TRAIN_BATCH]}
            out = {}
            if profile_last and t == n_steps - 1:
                by_name = {}
                wall, busy, top = device_busy(lambda: out.update(m=step_fn(params, state, batch, t)[2]), by_name)
                split.update(wall=wall, busy=busy, top=top, by_name=by_name)
                ms.append(wall * 1e3)
            else:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out["m"] = step_fn(params, state, batch, t)[2]
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            losses.append(float(out["m"]["loss"]))
            norms.append(float(out["m"]["grad_norm"]))
            got = {k: AK.launches[k] for k in per_step}
            if (got != {k: (t + 1) * n for k, n in per_step.items()} or DK.launches["flash_decode"]
                    or any(K.launches.values())):
                raise AssertionError(f"10c {name} step {t}: launches {got}, not {per_step} a step "
                                     f"(flash_decode {DK.launches}, IGD {K.launches})")
        launches = {k: AK.launches[k] for k in per_step}
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"10c {name}: a loss is not finite: {losses}")
        log("train", f"10c {name}: llama3.2-3b {n_layers} layers at full width, float32 params, bf16 activations, remat "
            f"{cfg.remat_policy}, {TRAIN_BATCH} x {TRAIN_S} tokens a step (grad_accum {TRAIN_ACCUM}): losses "
            + ", ".join(f"{v:.5f}" for v in losses) + "; gradient norms " + ", ".join(f"{v:.4g}" for v in norms)
            + "; step ms (CUDA events"
            + (", the last under the profiler" if profile_last else "") + ") " + ", ".join(f"{v:.1f}" for v in ms)
            + f"; peak {peak:.2f} GB allocated; launches {launches} ({per_step} a step); {card}")
        return params, state, losses, ms, launches, peak

    params, state, igd_losses, igd_ms, launches, igd_peak = run(
        f"IGD (momentum 0.9, diminishing{TRAIN_IGD_STEP})", igd_opt(), TRAIN_IGD_STEPS, True)
    if not igd_losses[-1] < igd_losses[0]:
        raise AssertionError(f"10c: the last IGD loss {igd_losses[-1]} is not below the first {igd_losses[0]}")
    # the optimizer alone: one update of the 28-layer params from zero gradients (CUDA events)
    zeros = tree_map(torch.zeros_like, params)
    opt_ms = timing.seconds(lambda: igd_opt().update(params, zeros, state, TRAIN_IGD_STEPS), dev) * 1e3
    del params, state, zeros
    torch.cuda.empty_cache()
    steady = igd_ms[1:-1] or igd_ms[:1]  # past the first step's allocations, before the profiled one
    step_ms = sum(steady) / len(steady)
    tokens_s = tokens_a_step / (step_ms * 1e-3)
    mfu = flops_a_token * tokens_s / BF16_FLOPS
    kinds = {"GEMMs": re.compile(r"gemm|xmma|nvjet|cutlass|cublas", re.I),
             "attention forward": re.compile(r"flash_attention_(bf16|f32)_kernel"),
             "attention backward": re.compile(r"dkdv_kernel|dq_kernel|rowdot_kernel")}
    by_kind = {kind: 0.0 for kind in list(kinds) + ["other (norms, rope, MLP activations, cross-entropy, optimizer)"]}
    for name, us in split["by_name"].items():
        kind = next((k for k, pat in kinds.items() if pat.search(name)), None)
        by_kind[kind or list(by_kind)[-1]] += us * 1e-3
    idle = "not measured (no device time in the trace)" if split["busy"] is None else \
        f"{1 - split['busy'] / split['wall']:.4f} idle ({split['busy'] * 1e3:.1f} ms busy of {split['wall'] * 1e3:.1f})"
    log("train", f"10c IGD: {step_ms:.1f} ms a step (mean of steps 2..{TRAIN_IGD_STEPS - 1}), {tokens_s:.0f} tokens/s, "
        f"model FLOP/s {flops_a_token * tokens_s / 1e12:.1f} T ({flops_a_token:.4g} FLOP a token: 6 x {mm_params} matmul "
        f"params + causal attention) = {mfu:.4f} of 989 TFLOP/s bf16 dense; peak {igd_peak:.2f} GB; the optimizer's "
        f"update alone {opt_ms:.1f} ms; {card}")
    log("train", f"10c IGD last step under the profiler: device ms by kind "
        + ", ".join(f"{k} {v:.1f}" for k, v in by_kind.items()) + f"; device {idle}; top {split['top']}")
    adam = run("AdamW (lr 3e-4, wd 0.1)", AdamW(), TRAIN_ADAMW_STEPS, False)
    adam_losses, adam_peak = adam[2], adam[5]
    del adam
    torch.cuda.empty_cache()
    log("train", f"10c AdamW from the same start: losses {adam_losses}, peak {adam_peak:.2f} GB; 10c took "
        f"{phase.lap():.1f} s")

    # -- 10d. resume at full width, 2 layers ---------------------------------
    small = get_arch("llama3.2-3b").scaled(n_layers=TRAIN_CPU_LAYERS)
    init = lm.init_lm(small, gen, dev)
    data = {"tokens": synthetic.token_stream(gen, RESUME_B * RESUME_STEPS, RESUME_S, small.vocab)["tokens"]}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(optimizer=igd_opt(), global_batch=RESUME_B, grad_accum=RESUME_ACCUM, log_every=0, seed=seed,
              params=init, device=dev, ckpt_every=RESUME_STEPS + 1, log_fn=lambda msg: log("train", msg))
    full = fit(small, data, steps=RESUME_STEPS, **kw)
    fit(small, data, steps=RESUME_STEPS // 2, ckpt_dir=root, **kw)
    resumed = fit(small, data, steps=RESUME_STEPS, ckpt_dir=root, **kw)
    shutil.rmtree(root, ignore_errors=True)
    if resumed.resumed_from != RESUME_STEPS // 2:
        raise AssertionError(f"10d: resumed from {resumed.resumed_from}")
    worst = 0.0
    for a, b in zip(leaves(full.params) + [torch.tensor(full.losses[RESUME_STEPS // 2:])],
                    leaves(resumed.params) + [torch.tensor(resumed.losses)]):
        a, b = a.detach(), b.detach()
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(b, a, rtol=RESUME_RTOL, atol=RESUME_ATOL):
            raise AssertionError(f"10d: the resumed run differs from the uninterrupted one by {worst:.3g}")
    log("train", f"10d llama3.2-3b full width, {TRAIN_CPU_LAYERS} layers, {RESUME_STEPS} fit steps against "
        f"{RESUME_STEPS // 2} + a checkpoint on disk + a fresh fit's {RESUME_STEPS // 2}: losses {full.losses}; max "
        f"|difference| {worst:.3g} (rtol {RESUME_RTOL:g}, atol {RESUME_ATOL:g}); 10d took {phase.lap():.1f} s")
    del full, resumed, init, data
    torch.cuda.empty_cache()

    # -- timings at the training shape (B 1, S 4,096, 24/8 heads, hd 128, bf16) --
    bf = torch.bfloat16
    q, do = normal((1, TRAIN_S, h, hd), bf), normal((1, TRAIN_S, h, hd), bf)
    k, v = normal((1, TRAIN_S, kv, hd), bf), normal((1, TRAIN_S, kv, hd), bf)
    o, lse = AK.flash_attention(q, k, v, with_lse=True)
    # the gradient kernels and lse held to their plain versions at the shape
    # 10c gives them (the microbatch of one layer), as 10a holds its grid
    what = f"at the training shape (B 1, S {TRAIN_S}, {h}/{kv} heads, hd {hd}, bf16)"
    errs["lse"] = max(errs["lse"], max_err(lse, AR.mha_lse_ref(q, k), f"lse {what}", *LSE_TOL[bf]))
    train_rel = 0.0
    for name, got, want in zip(("dq", "dk", "dv"), AK.flash_attention_backward(q, k, v, o, lse, do),
                               AR.mha_backward_ref(q, k, v, o, lse, do)):
        scale = max(1.0, float(want.float().abs().max()))
        e = max_err(got, want, f"flash_attention_bwd {name} {what}", BWD_TOL[bf][0], BWD_TOL[bf][1] * scale)
        errs["bwd"], train_rel = max(errs["bwd"], e), max(train_rel, e / scale)
    errs["bwd_rel"][bf] = max(errs["bwd_rel"][bf], train_rel)
    del got, want
    torch.cuda.empty_cache()
    off_a = graph_ms(lambda: AK.flash_attention(q, k, v), 10)
    on_a = graph_ms(lambda: AK.flash_attention(q, k, v, with_lse=True), 10)
    on_b = graph_ms(lambda: AK.flash_attention(q, k, v, with_lse=True), 10)
    off_b = graph_ms(lambda: AK.flash_attention(q, k, v), 10)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    dos = do.transpose(1, 2)
    kernel = lambda: AK.flash_attention_backward(q, k, v, o, lse, do)  # noqa: E731
    library = lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dos, retain_graph=True)  # noqa: E731
    first = event_ms(kernel, 5)
    library_ms = event_ms(library, 5)
    bwd_ms = (first + event_ms(kernel, 5)) / 2
    launch_ms = kernel_ms_by_kind(kernel, BWD_PROFILED, BWD_KINDS)
    plain_ms = timing.seconds(lambda: AR.mha_backward_ref(q, k, v, o, lse, do), dev) * 1e3
    pairs = TRAIN_S * (TRAIN_S + 1) // 2
    flops = 2.5 * 4 * h * hd * pairs  # the five products over the causal half: 2.5x the forward's
    nbytes = (4 * TRAIN_S * h * hd + 4 * TRAIN_S * kv * hd) * 2 + h * TRAIN_S * 4  # q, o, do, dq; k, v, dk, dv; lse
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound = max(bytes_ms, ops_ms)
    log("timing", f"flash_attention_bwd (B 1, S {TRAIN_S}, {h}/{kv} heads, hd {hd}, bf16; D, dk/dv and dq): "
        f"{bwd_ms:.4f} ms a call (CUDA events over 5 calls; turns kernel {first:.4f}, SDPA backward {library_ms:.4f}), "
        f"{flops / bwd_ms / 1e9:.1f} TFLOP/s, {bound / bwd_ms:.3f} of the bound {bound:.4f} ms (operations: {flops:.4g} "
        f"FLOP at 989 TFLOP/s; bytes {nbytes} at 3.35 TB/s {bytes_ms:.4f} ms); plain {plain_ms:.2f} ms; "
        f"scaled_dot_product_attention's backward {library_ms:.4f} ms, kernel/library {bwd_ms / library_ms:.2f}; "
        f"device ms a launch (profiler, {BWD_PROFILED} calls) "
        + ", ".join(f"{k} " + ("not measured" if v is None else f"{v:.4f} ({n} traced)")
                    for k, (v, n) in launch_ms.items())
        + "; "
        f"against mha_backward_ref / mha_lse_ref at this shape max |err| relative to the largest entry "
        f"{train_rel:.3g} (tol 2e-2); {card}")
    log("timing", f"flash_attention at the training shape (CUDA graph, in turns lse off, on, on, off): "
        f"{off_a:.4f}, {on_a:.4f}, {on_b:.4f}, {off_b:.4f} ms; lse on / off {(on_a + on_b) / (off_a + off_b):.4f}")
    del q, k, v, o, lse, do, qs, ks, vs, sdpa_out, dos
    torch.cuda.empty_cache()
    extra = training_extra_timings(normal, dev, card)
    entries["flash_attention"].update(
        launches_training=launches["flash_attention"], training_ms_lse_off=(off_a + off_b) / 2,
        training_ms_lse_on=(on_a + on_b) / 2, max_abs_err_lse=errs["lse"], training_ms_lse=extra["lse_ms"],
        training_library_ms=extra["lse_library_ms"])
    log("train", f"the timings took {phase.lap():.1f} s")
    return [{
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/attention/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:63", "launches": launches["flash_attention_bwd"],
        "max_abs_err": errs["bwd"], "ms": bwd_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": library_ms,
        "max_rel_err": max(errs["bwd_rel"].values()), "launches_per_step": per_step["flash_attention_bwd"],
        "launch_ms": {kind: ms for kind, (ms, _) in launch_ms.items()},
        "train_step_ms": step_ms, "train_tokens_s": tokens_s, "train_mfu": mfu, "train_peak_gb": igd_peak,
        **{k: v for k, v in extra.items() if k.startswith("hd192")},
    }]


def training_extra_timings(normal, dev, card: str) -> dict:
    """Two more timings of phase 10: the hd 192 gradient (the mma.sync
    kernels, which the main path does not launch) at nemotron-4's heads,
    with its bound and SDPA's backward in turns; and SDPA's forward
    (is_causal, enable_gqa) in turns with the lse forward at the training
    shape. Returns the numbers for the kernels line."""
    import torch.nn.functional as F

    from repro_torch import timing
    from repro_torch.kernels.attention import kernel as AK, ref as AR

    bf = torch.bfloat16
    b, s, h, kv, hd = BWD192_SHAPE
    q, do = normal((b, s, h, hd), bf), normal((b, s, h, hd), bf)
    k, v = normal((b, s, kv, hd), bf), normal((b, s, kv, hd), bf)
    o, lse = AK.flash_attention(q, k, v, with_lse=True)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    dos = do.transpose(1, 2)
    kernel = lambda: AK.flash_attention_backward(q, k, v, o, lse, do)  # noqa: E731
    library = lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dos, retain_graph=True)  # noqa: E731
    turns = [event_ms(kernel, 3), event_ms(library, 3), event_ms(library, 3), event_ms(kernel, 3)]
    del sdpa_out, qs, ks, vs
    torch.cuda.empty_cache()
    plain = []
    plain_ms = timing.seconds(lambda: plain.append(AR.mha_backward_ref(q, k, v, o, lse, do)), dev) * 1e3
    rel = 0.0
    for name, got, want in zip(("dq", "dk", "dv"), kernel(), plain[0]):
        scale = max(1.0, float(want.float().abs().max()))
        rel = max(rel, max_err(got, want, f"flash_attention_bwd {name} at hd 192", BWD_TOL[bf][0],
                               BWD_TOL[bf][1] * scale) / scale)
    del plain
    torch.cuda.empty_cache()
    flops = 2.5 * 4 * h * hd * (s * (s + 1) // 2)
    nbytes = (4 * s * h * hd + 4 * s * kv * hd) * 2 + h * s * 4
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    out = {"hd192_ms": (turns[0] + turns[3]) / 2, "hd192_library_ms": (turns[1] + turns[2]) / 2,
           "hd192_bound_ms": max(bytes_ms, ops_ms), "hd192_bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "hd192_plain_ms": plain_ms, "hd192_max_rel_err": rel}
    log("timing", f"flash_attention_bwd at hd 192 (B {b}, S {s}, {h}/{kv} heads, bf16; the mma.sync kernels, "
        f"0 launches on the main path): in turns kernel {turns[0]:.4f}, SDPA backward {turns[1]:.4f}, "
        f"{turns[2]:.4f}, kernel {turns[3]:.4f} ms a call (CUDA events over 3 calls); bound "
        f"{out['hd192_bound_ms']:.4f} ms ({out['hd192_bound_by']}: {flops:.4g} FLOP at 989 TFLOP/s {ops_ms:.4f} ms, "
        f"{nbytes} bytes at 3.35 TB/s {bytes_ms:.4f} ms), {out['hd192_bound_ms'] / out['hd192_ms']:.3f} of it; "
        f"kernel/library {out['hd192_ms'] / out['hd192_library_ms']:.2f}; plain (mha_backward_ref) {plain_ms:.2f} "
        f"ms, the kernel against it max |err| relative to the largest entry {rel:.3g} (tol 2e-2); {card}")
    del q, k, v, o, lse, do, dos
    torch.cuda.empty_cache()
    h, kv, hd = 24, 8, 128
    q = normal((1, TRAIN_S, h, hd), bf)
    k, v = normal((1, TRAIN_S, kv, hd), bf), normal((1, TRAIN_S, kv, hd), bf)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    kernel = lambda: AK.flash_attention(q, k, v, with_lse=True)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)  # noqa: E731
    turns = [graph_ms(kernel, 10), graph_ms(library, 10), graph_ms(library, 10), graph_ms(kernel, 10)]
    out["lse_ms"], out["lse_library_ms"] = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    log("timing", f"flash_attention with lse (the training forward) at B 1, S {TRAIN_S}, {h}/{kv} heads, hd {hd}, "
        f"bf16 (CUDA graph, in turns): kernel {turns[0]:.4f}, SDPA forward (is_causal, enable_gqa) {turns[1]:.4f}, "
        f"{turns[2]:.4f}, kernel {turns[3]:.4f} ms; kernel/library {out['lse_ms'] / out['lse_library_ms']:.2f}; "
        f"{card}")
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    return out


def mesh_phase(seed: int, dev, entries: dict) -> None:
    """Phase 11, the LM across a device mesh, on the one card.

    11a: the length-sharded decode (``dist.collectives.sharded_flash_decode``)
    at llama3.2-3b's heads over a 32,768-position bf16 cache, as 4 and 16
    slices of one cache (each shard one ``flash_decode`` launch on its
    slice, then the combine), at lengths 1, 1,000, 8,192, 20,000 and
    32,768; held to the unsharded kernel and to ``decode_attention_ref``
    (2e-2 bf16; 5e-5 f32 at one case); then through a (1, 1) mesh of one
    NCCL rank; the launches counted (zeroed just before, read just after)
    and the ms a call of the n launches plus the combine beside the one
    unsharded launch.

    11b: ``make_train_step(param_shardings=...)`` on that mesh at 10b's
    shape against the unsharded step; ``fit(mesh=...)`` 2 steps with a
    checkpoint, ``elastic_restore`` onto no mesh, and a fit without a mesh
    resuming 2 more, against 4 uninterrupted steps on the mesh. The process
    group is destroyed at the end of the phase, failed or not. Adds the
    launches to the kernels line's entries."""
    import shutil

    import torch.distributed as dist

    from repro_torch import timing
    from repro_torch.configs import get_arch
    from repro_torch.core import igd
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.data import synthetic
    from repro_torch.dist import collectives, sharding as shd
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.decode import kernel as DK, ref as DR
    from repro_torch.launch import mesh as mesh_mod, train
    from repro_torch.launch.elastic import elastic_restore
    from repro_torch.launch.train_loop import fit
    from repro_torch.models import lm
    from repro_torch.optim import IGD

    phase = timing.Stopwatch()
    card = smi("name,power.limit")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 12)
    cfg = get_arch("llama3.2-3b")
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, s = MESH_DECODE_B, MESH_DECODE_S

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- 11a. the length-sharded decode on the kernel -------------------------
    q, kc, vc = normal((b, h, hd), torch.bfloat16), normal((b, s, kv, hd), torch.bfloat16), \
        normal((b, s, kv, hd), torch.bfloat16)
    cases = [(n, length) for n in MESH_SHARDS for length in MESH_LENGTHS]
    DK.reset_launches()
    outs = {(n, length): collectives.sharded_flash_decode(q, kc, vc, length, mesh_mod.AbstractMesh({"model": n}))
            for n, length in cases}
    torch.cuda.synchronize()
    launches = DK.launches["flash_decode"]
    if launches != sum(n for n, _ in cases):
        raise AssertionError(f"11a: {launches} flash_decode launches for {len(cases)} sharded calls, not one a shard "
                             f"({sum(n for n, _ in cases)})")
    errs = {"kernel": 0.0, "plain": 0.0}
    for (n, length), got in outs.items():
        what = f"11a sharded_flash_decode bf16 n {n} length {length}"
        errs["kernel"] = max(errs["kernel"], max_err(got, DK.flash_decode(q, kc, vc, length)[0],
                                                     f"{what} vs the unsharded kernel", 2e-2, 2e-2))
        errs["plain"] = max(errs["plain"], max_err(got, DR.decode_attention_ref(q, kc, vc, length)[0],
                                                   f"{what} vs decode_attention_ref", 2e-2, 2e-2))
    del outs
    n32, len32 = MESH_F32_CASE
    q32, k32, v32 = q.float(), kc.float(), vc.float()
    got = collectives.sharded_flash_decode(q32, k32, v32, len32, mesh_mod.AbstractMesh({"model": n32}))
    err32 = max(max_err(got, DK.flash_decode(q32, k32, v32, len32)[0], "11a f32 vs the unsharded kernel", 5e-5, 5e-5),
                max_err(got, DR.decode_attention_ref(q32, k32, v32, len32)[0], "11a f32 vs decode_attention_ref",
                        5e-5, 5e-5))
    del q32, k32, v32, got
    torch.cuda.empty_cache()
    timings = {}
    for n, length in ((4, 8192), (16, 8192), (4, MESH_DECODE_S), (16, MESH_DECODE_S)):
        am = mesh_mod.AbstractMesh({"model": n})
        one = lambda: DK.flash_decode(q, kc, vc, length)  # noqa: E731
        sharded = lambda: collectives.sharded_flash_decode(q, kc, vc, length, am)  # noqa: E731
        timings[(n, length)] = [event_ms(one, 20), event_ms(sharded, 20), event_ms(sharded, 20), event_ms(one, 20)]
    log("mesh", f"11a sharded_flash_decode (llama3.2-3b heads {h}/{kv}, hd {hd}, B {b}, a {s}-position bf16 cache; "
        f"n shards x lengths {MESH_SHARDS} x {MESH_LENGTHS}): {launches} flash_decode launches for {len(cases)} calls "
        f"(one a shard); max |err| vs the unsharded kernel {errs['kernel']:.3g}, vs decode_attention_ref "
        f"{errs['plain']:.3g} (tol 2e-2); f32 at n {n32}, length {len32}: {err32:.3g} (tol 5e-5); 11a's checks took "
        f"{phase.lap():.1f} s")
    log("mesh", "11a ms a call (CUDA events over 20 calls, in turns unsharded, sharded, sharded, unsharded; a sharded "
        "call is n launches and the combine): " + "; ".join(
            f"n {n} length {length}: {t[0]:.4f}, {t[1]:.4f}, {t[2]:.4f}, {t[3]:.4f} ms "
            f"(sharded / unsharded {(t[1] + t[2]) / (t[0] + t[3]):.2f})" for (n, length), t in timings.items())
        + f"; {card}")

    # -- 11a, 11b through a (1, 1) mesh of one NCCL rank ------------------------
    mesh_mod.init_world(device=dev)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_mesh_ckpt")
    try:
        mesh = mesh_mod.make_host_mesh(1, 1, device=dev)
        DK.reset_launches()
        got = {length: collectives.sharded_flash_decode(q, kc, vc, length, mesh) for length in MESH_LENGTHS}
        torch.cuda.synchronize()
        group_launches = DK.launches["flash_decode"]
        for length, out in got.items():
            errs["kernel"] = max(errs["kernel"], max_err(out, DK.flash_decode(q, kc, vc, length)[0],
                                                         f"11a NCCL mesh length {length} vs the kernel", 2e-2, 2e-2))
        if group_launches != len(MESH_LENGTHS):
            raise AssertionError(f"11a NCCL mesh: {group_launches} launches for {len(MESH_LENGTHS)} calls")
        del q, kc, vc, got
        torch.cuda.empty_cache()
        log("mesh", f"11a through make_host_mesh(1, 1) (world-1 NCCL group, all-reduce combine): {group_launches} "
            f"launches, max |err| vs the unsharded kernel {errs['kernel']:.3g}; {mesh}")

        # -- 11b. a sharded train step ------------------------------------------
        small = cfg.scaled(n_layers=TRAIN_CPU_LAYERS, dtype="float32")
        params = lm.init_lm(small, gen, dev)
        tokens = torch.randint(0, small.vocab, (TRAIN_CPU_B, TRAIN_CPU_S), generator=gen, device=dev)
        opt = IGD(igd.diminishing(*TRAIN_IGD_STEP), momentum=0.9)
        plain_p = tree_map(lambda x: x.clone(), params)
        plain_o = opt.init(plain_p)
        plain_step = train.make_train_step(small, opt, grad_accum=2)
        shd.set_activation_ctx(mesh)
        pshard = shd.shardings(shd.param_specs(params, small, mesh), mesh)
        sp = shd.distribute(params, pshard)
        so = tuple(shd.distribute(t, pshard) for t in opt.init(params))
        batch = shd.distribute({"tokens": tokens}, shd.shardings(shd.batch_specs(small, "train", mesh, TRAIN_CPU_B),
                                                                  mesh))
        sharded_step = train.make_train_step(small, opt, grad_accum=2, param_shardings=pshard)
        for mod in (AK, DK):
            mod.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        sharded_ms, plain_ms = [], []
        for step in range(MESH_TRAIN_STEPS):  # the first step also fills DTensor's sharding caches
            start.record()
            sp, so, sm = sharded_step(sp, so, batch, step)
            end.record()
            end.synchronize()
            sharded_ms.append(start.elapsed_time(end))
        step_launches = {k: AK.launches[k] for k in ("flash_attention", "flash_attention_bwd")}
        if not all(step_launches.values()):
            raise AssertionError(f"11b: the sharded steps launched {step_launches}")
        for step in range(MESH_TRAIN_STEPS):
            start.record()
            plain_p, plain_o, pm = plain_step(plain_p, plain_o, {"tokens": tokens}, step)
            end.record()
            end.synchronize()
            plain_ms.append(start.elapsed_time(end))
        worst, bitwise = 0.0, True
        for got_t, want in zip(leaves(shd.full(sp)) + leaves(shd.full(so)), leaves(plain_p) + leaves(plain_o)):
            got_t, want = got_t.detach(), want.detach()
            bitwise = bitwise and torch.equal(got_t, want)
            err = float((got_t - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            worst = max(worst, err)
            if err > MESH_TRAIN_TOL:
                raise AssertionError(f"11b: a leaf {tuple(want.shape)} of the sharded step is {err:.3g} of its "
                                     f"largest element from the unsharded step's (tol {MESH_TRAIN_TOL:g})")
        loss_gap = abs(float(sm["loss"]) - float(pm["loss"]))
        if loss_gap > MESH_TRAIN_TOL * abs(float(pm["loss"])):
            raise AssertionError(f"11b: loss {float(sm['loss'])} sharded, {float(pm['loss'])} unsharded")
        log("mesh", f"11b make_train_step(param_shardings=...) on make_host_mesh(1, 1), llama3.2-3b full width, "
            f"{TRAIN_CPU_LAYERS} layers, float32, B {TRAIN_CPU_B} x S {TRAIN_CPU_S}, grad_accum 2, IGD momentum: last loss "
            f"{float(sm['loss']):.7f} against {float(pm['loss']):.7f} unsharded; max |sharded - unsharded| / max "
            f"|unsharded| over params and momentum {worst:.3g} (tol {MESH_TRAIN_TOL:g}), "
            f"{'bitwise equal' if bitwise else 'not bitwise equal'} after {MESH_TRAIN_STEPS} steps; launches "
            f"{step_launches}; step ms (CUDA events) sharded (DTensor) "
            + ", ".join(f"{v:.1f}" for v in sharded_ms) + ", unsharded " + ", ".join(f"{v:.1f}" for v in plain_ms)
            + f"; {card}")
        del params, plain_p, plain_o, sp, so, batch
        torch.cuda.empty_cache()

        # fit on the mesh around a checkpoint, resumed with no mesh
        small = cfg.scaled(n_layers=TRAIN_CPU_LAYERS)
        init = lm.init_lm(small, gen, dev)
        data = {"tokens": synthetic.token_stream(gen, RESUME_B * MESH_FIT_STEPS, RESUME_S, small.vocab)["tokens"]}
        shutil.rmtree(root, ignore_errors=True)
        kw = dict(optimizer=opt, global_batch=RESUME_B, grad_accum=RESUME_ACCUM, log_every=0, seed=seed,
                  params=init, device=dev, ckpt_every=MESH_FIT_STEPS + 1, log_fn=lambda msg: log("mesh", msg))
        AK.reset_launches()
        full = fit(small, data, steps=MESH_FIT_STEPS, mesh=mesh, **kw)
        fit_launches = {k: AK.launches[k] for k in ("flash_attention", "flash_attention_bwd")}
        half = fit(small, data, steps=MESH_FIT_STEPS // 2, mesh=mesh, ckpt_dir=root, **kw)
        rp, ro, meta = elastic_restore(root, small, opt, None, device=dev)
        if meta["step"] != MESH_FIT_STEPS // 2 or any(shd.is_dtensor(x) for x in leaves(rp)):
            raise AssertionError(f"11b: elastic_restore onto no mesh gave step {meta['step']}")
        for a, b_ in zip(leaves(rp) + leaves(ro), leaves(shd.full(half.params)) + leaves(shd.full(half.opt_state))):
            if not torch.equal(a, b_.detach()):
                raise AssertionError("11b: the restored leaves differ from the checkpointed ones")
        resumed = fit(small, data, steps=MESH_FIT_STEPS, ckpt_dir=root, **kw)
        if resumed.resumed_from != MESH_FIT_STEPS // 2:
            raise AssertionError(f"11b: resumed from {resumed.resumed_from}")
        worst = 0.0
        for a, b_ in zip(leaves(shd.full(full.params)) + [torch.tensor(full.losses[MESH_FIT_STEPS // 2:])],
                         leaves(resumed.params) + [torch.tensor(resumed.losses)]):
            a, b_ = a.detach(), b_.detach()
            worst = max(worst, float((a - b_).abs().max()))
            if not torch.allclose(b_, a, rtol=RESUME_RTOL, atol=RESUME_ATOL):
                raise AssertionError(f"11b: the resumed run differs from the uninterrupted one by {worst:.3g}")
        log("mesh", f"11b fit(mesh=make_host_mesh(1, 1)) llama3.2-3b full width, {TRAIN_CPU_LAYERS} layers, "
            f"{MESH_FIT_STEPS} steps of {RESUME_B} x {RESUME_S} (losses {full.losses}) against {MESH_FIT_STEPS // 2} "
            f"on the mesh + a checkpoint + elastic_restore onto no mesh (bitwise the checkpointed leaves) + a fit "
            f"with no mesh resuming {MESH_FIT_STEPS // 2}: max |difference| {worst:.3g} (rtol {RESUME_RTOL:g}, "
            f"atol {RESUME_ATOL:g}); the {MESH_FIT_STEPS} mesh steps launched {fit_launches}; 11b took "
            f"{phase.lap():.1f} s")
        del full, half, resumed, init, data, rp, ro
        torch.cuda.empty_cache()
    finally:
        shd.set_activation_ctx(None)
        shutil.rmtree(root, ignore_errors=True)
        dist.destroy_process_group()
    entries["flash_decode"].update(launches_sharded=launches + group_launches, sharded_max_abs_err=errs["kernel"],
                                   sharded_f32_max_abs_err=err32,
                                   sharded_ms={f"n{n}_len{length}": (t[1] + t[2]) / 2
                                               for (n, length), t in timings.items()})
    entries["flash_attention"].update(launches_mesh=step_launches["flash_attention"] + fit_launches["flash_attention"],
                                      mesh_step_ms=sharded_ms, mesh_plain_step_ms=plain_ms)
    entries["flash_attention_bwd"]["launches_mesh"] = step_launches["flash_attention_bwd"] + \
        fit_launches["flash_attention_bwd"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    sys.exit(main())
