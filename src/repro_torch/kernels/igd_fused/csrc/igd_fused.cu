// Fused IGD transition kernels for Hopper (sm_90a), bound through a plain
// C interface (loaded with ctypes by kernels/igd_fused/kernel.py).
//
// igd_fold — replaces the Pallas TPU kernel
//   src/repro/kernels/igd_fused/kernel.py: igd_fold (_igd_kernel).
//   Per row i: wx = w.x_i; margin = y_i*wx (lr, svm) or wx (lsq);
//   c = grad_scale(margin, y_i) * alpha_i; w -= c * x_i.
//   Row i+1 reads the w that row i wrote, so the rows cannot run in
//   parallel. The bytes (N*(D+2)*4) would take microseconds at 3.35 TB/s;
//   the serial chain takes N times its dependent latency. igd_fold_launch
//   picks one of three instances by D; together they take every D >= 1.
//
//   D <= 256: tiled Gram look-ahead (igd_fold_gram_kernel). Inside a
//   sub-tile of T = 32 rows that starts from w_0,
//     w_i = w_0 - sum_{k<i} c_k x_k,  so  w_i.x_i = p_i - sum_{k<i} c_k G_ki
//   with p = X_T w_0 and G = X_T X_T^T. p and G do not depend on the
//   chain, so the serial work left is a scalar recurrence over T values:
//   c_k = grad_scale(r_k, y_k) * alpha_k, then r_j -= c_k G_kj for j > k.
//   What bounds it: that recurrence, i.e. the dependent latency of
//   grad_scale (for lr __expf and an approximate reciprocal, see
//   grad_scale_fast) and one FMA a row, not bytes, once the rest of the
//   block keeps up with it.
//   Design: one block of 8 warps; rows, y and alpha stream into shared
//   memory through cp.async double-buffered stages (a multiple of T rows,
//   rows padded to a stride whose 16-byte slots miss each other's banks;
//   the pad columns hold zeros, so the dots need no masks), a warp a row
//   and a lane a column (8-byte copies for even D), with no arithmetic a
//   float beyond an address.
//   Warp 0 runs the chain: lane j holds r_j; every lane computes the same
//   c_k bit for bit and lane j applies its FMA with G_kj. The broadcast of
//   r_k+1 is taken from lane k+1 a step early, during grad_scale, and
//   finished with one FMA by G_k,k+1. The loop is unrolled by 8, not in
//   full, so that it stays in the instruction cache; each step loads the
//   next step's operands ahead. While warp 0 runs sub-tile s, the helpers
//   prepare s+1 without touching the chain: four product warps form
//   G_{s+1} and C_{s+1} = X_{s+1} X_s^T (4 x 4 register blocks a lane),
//   and three vector warps apply c_{s-1} to w (one thread per column, the
//   sum taken first in row order, so w is rounded once a sub-tile), form
//   q_{s+1} = X_{s+1} w and move the stages. Warp 0 then starts s+1 from
//   p_{s+1} = q_{s+1} - C_{s+1} c_s: one block barrier a sub-tile, and no
//   w update or dot between two chains.
//   Numerics: on 581,012 Forest-shaped rows (lr), this fold is nearer a
//   float64 fold than the per-row float32 fold is, because the per-row
//   fold rounds w at every row; ref.igd_fold_tiled_ref is its plain
//   version, and the tests hold it to the per-row fold and a float64 one.
//
//   D > 256: the Gram look-ahead over a cluster (igd_fold_cluster_kernel),
//   in two launches of one call (three past D 4,096). A per-row design here
//   pays a D-long dot on every row's chain: a warp's shuffle butterfly and,
//   past one warp, a block barrier a row (the per-row chain that ran D 257
//   to 4,096 before this design: 800-900 cycles a row at D 1,000,
//   1,750-2,000 at 4,096, against the chain step's ~83; 1,739 at D 4,097
//   for a 1,024-thread block's step alone). The tiled algebra above takes every D-long sum off the chain;
//   what kept it at D <= 256 is that one block cannot form G, C, q and the
//   update over a wide row fast enough. So:
//   Pass 1 (igd_fold_gram_prepass_kernel, then igd_fold_gram_sum_kernel),
//   over the whole card: G_v and C_v = X_v X_{v-1}^T of every sub-tile v,
//   32 x 32 each in float32 on the CUDA cores (no TF32), into scratch the
//   wrapper allocates; lanes that share a table share its pass. 2 N 32 D
//   FMAs: 0.06 ms at 8,192 x 4,097 and 0.19 ms at 12,033 at 67 TFLOP/s.
//   Past D 4,096, kPpSplit blocks a sub-tile and segment each sum a quarter
//   of D, then the quarters are summed in order (320 floats a row: 10 MB at
//   8,192 rows); at D <= 4,096 one block a sub-tile sums all of D and
//   writes G and C once (64 floats a row, a quarter of a row of the table
//   at D 257, and no sum launch; two or four parts measured no faster).
//   Past D 4,096 the split into quarters buys 2-3% over one block a sub-tile; summing
//   the quarters by a launch of their own costs less than the two ways
//   tried without one (H100 SXM, 8,192 x 4,097 / 12,033, the whole call):
//   the four blocks as a cluster adding through distributed shared memory
//   took 1.05x / 1.08x, and pass 2 adding them as it copies G and C in (a
//   32 KB stage, so a ring a slot shallower) 1.04x / 1.14x.
//   A 16-CTA cluster of ~227 KB a CTA takes most of a GPC, so the wrapper
//   checks at load that one fits the card (igd_fused_fold_clusters_fit, and
//   igd_fused_fold_middle_clusters_fit at every cluster size the middle
//   instance takes).
//   Pass 2 (igd_fold_cluster_kernel): a cluster of CTAS CTAs a lane, CTA q
//   owning w's column slice [q * slice, q * slice + slice), slice =
//   ceil(D / CTAS): past D 4,096 CTAS = kFcCluster = 16 (non-portable);
//   at 256 < D <= 4,096 the fewest of 1, 2, 4, 8, 16 whose slices are at
//   most kFmMaxSlice columns, or 16 (middle_ctas: 4 up to D 512, 8 up to
//   1,024, 16 above; D alone picks it, never the number of lanes, so a
//   lane's w is its one-lane launch's bit for bit).
//   w's slice lies in shared memory up to
//   kFcSmemMaxSlice floats (48 KB: D <= kFoldClusterSmemMaxDim = 196,608)
//   and in the lane's output row above. Warp 0 of every CTA runs the same
//   scalar recurrence (chain(), the Gram instance's) from the same p and
//   G, so every CTA computes the same c bit for bit and c never crosses
//   CTAs. Nine consumer warps apply c_{s-1} to the slice and form their
//   partials of q_{s+1} = X_{s+1} w_s in one pass, and push the CTA's 32
//   partial margins into every CTA (st.async into distributed shared
//   memory, completing on the receiver's mbarrier); warp 0 sums the CTAS in
//   a fixed tree of log2(CTAS) rounds and starts the next chain from p_{s+1} = q_{s+1} -
//   C_{s+1} c_s. One barrier a sub-tile, one push of 32 floats a CTA a
//   sub-tile, no barrier a row.
//   The middle instance keeps its rows resident (RESIDENT): a CTA's slice
//   of a 32-row sub-tile is at most 32 x 256 floats (32 KB), so every
//   sub-tile's slice stays in one shared-memory slot from its copy to its
//   update (5 slots: X_{s-1}, X_s, X_{s+1} and two on their way), and the
//   table crosses HBM once. The producer warp copies each sub-tile in
//   once, a row a lane by bulk copies as below, as soon as its slot is
//   free. (Copied by the consumers' own 16-byte cp.async instead, the
//   steps took 1.3-1.4x as long: issuing the copies sat on the consumers'
//   path, which is the step's longer one.) What bounds it (clock64 in rank
//   0, the `clocks` variant of scripts/torch_igd_variants.py --middle, H100
//   SXM): a step is the longer of warp 0's path (the chain's 32 steps,
//   ~3,150 cycles, then C c and p) and the consumers' (the copies of G, C,
//   y and alpha issued, ~790; the pass, ~2,150 at 125 columns a CTA and
//   ~3,050 at 256; the reduction and the push, ~500). Up to 128 columns a
//   CTA the two are even, near the chain (D 1,000 on 8 CTAs: ~3,650
//   cycles a sub-tile); past D 2,048 the 16 CTAs' wider slices put the
//   consumers on the step (~4,400 at D 4,096), and the pre-pass takes a
//   quarter of the call (0.38 of 1.6 ms at 16,384 x 4,096). Wider slices
//   on fewer CTAs cost 1.12x at D 1,000 (4 CTAs) and more CTAs gain
//   nothing once the chain is the longer path; the wide instance moved
//   down as it is (16 CTAs, each sub-tile copied twice) took 1.08-1.32x,
//   and the look-ahead in one CTA a lane (streamed) 1.4x at D 300 to 10x
//   at 4,096.
//   Past D 4,096 rows come into shared memory as panels (32 rows x a column chunk of
//   the slice) through a ring that one producer warp keeps full with bulk
//   copies (cp.async.bulk, a row a lane, each span widened to 16-byte
//   boundaries: at odd D rows start anywhere, and a 2-D TMA map needs a
//   row stride of 16-byte multiples). A bulk copy costs ~40 ns however
//   small (measured: 192 copies of 0.5-1 KB a step took 7-8 us), so the
//   panels are as wide as a ring of at least kFcRingMin slots allows
//   (fold_panels: the whole 257-column slice at D 4,097, a ring of 6; two
//   chunks of 377 at 12,033, a ring of 4). Whole sub-tiles cannot stay
//   resident: one 16-CTA slice of a sub-tile is 96 KB at D 12,033, and a
//   sub-tile is used twice two steps apart (X_{s+1} for q, X_{s-1} for the
//   update), so the update's panels are copied again, from L2. Per
//   sub-tile a CTA moves 2 x 32 x slice x 4 bytes (66 KB at D 4,097, 193
//   KB at 12,033) through the ring and reads them once from it.
//   What bounds it (clock64 in rank 0, the `clocks` variant of
//   scripts/torch_igd_variants.py --wide): at D 4,097 the chain's 32
//   steps, ~3,200 cycles a sub-tile beside the consumers' ~3,000; at 12,033
//   the consumers' pass over the panels (~7,500 cycles a sub-tile), with
//   the pre-pass a quarter of the time at both. The chain floor (N x one
//   step, kernel.chain_probe) is
//   0.35 ms at 8,192 rows; the bytes (134 MB at 8,192 x 4,097) 0.04 ms.
//   ref.igd_fold_tiled_ref is this algebra and order in plain PyTorch.

//   All loop over exactly N rows and take D as it is: no padding of the
//   inputs (a padded D would change the dot's length and order). One fold
//   is one block (a cluster past D 256), so one fold leaves most SMs idle.
//
// Lanes — the counterpart of jax.vmap over the Pallas call (the reference
//   fuses a serving batch by vmapping kernel.py:74 and :119). Every C
//   entry takes `lanes` independent folds and launches them at once: a
//   grid of `lanes` blocks (igd_fold to D 256) or of `lanes` clusters (gridDim = (CTAs, lanes), clusterDim
//   = (CTAs, 1, 1)). Block (or cluster) b reads its rows at
//   x + s * xy_lane_rows * D, y + s * xy_lane_rows with s = b /
//   lanes_per_xy, its alphas at alpha + b * alpha_lane_stride and w0 +
//   b * D, writes wout + b * D, and runs exactly the arithmetic of a
//   one-lane launch, so each lane's w is the one-lane launch's bit for
//   bit. xy_lane_rows is 0 when every lane reads one shared table (a
//   fused clustered batch) and N for stacked or permuted per-lane copies;
//   alpha_lane_stride is N (each lane has its own steps). lanes_per_xy is
//   1 but for the fused sharded batch: B queries over the k segments of
//   one partitioned table, lane s * B + q reading segment s, so no segment
//   is copied B times (the *_segments_launch entries take it; the others
//   pass 1). No sum crosses lanes. Launch limits: the Gram instance's
//   ~200 KB of shared memory leaves one block an SM, so 132 lanes run in
//   one wave; the minibatch clusters take 8 SMs a lane (16 past D 256)
//   and the wide fold's 16, so 16 or 8 lanes fill the card and more run
//   in further waves (the middle fold's CTAS: 1 to 16); lanes <= 65535
//   (gridDim.y). The cluster folds' pre-pass runs once a segment: lanes
//   over one shared table share it.
//
// igd_fold_minibatch — replaces the Pallas TPU kernel
//   src/repro/kernels/igd_fused/kernel.py: igd_fold_minibatch
//   (_minibatch_kernel). One mean-gradient step per 256-row tile:
//   wx = X_t w; c = grad_scale * alpha; w -= (c X_t) / 256.
//   What bounds it: tiles are serial (tile t+1 reads the w tile t wrote),
//   so the kernel takes n_tiles times one tile's dependent work (margins,
//   the update's sum, a barrier) or the table's bytes over the rate at
//   which the SMs it runs on can pull them, whichever is longer. One SM
//   pulling rows with per-thread loads reaches ~8 GB/s: 16 ms for the
//   130 MB Forest table, where the bytes alone take 0.039 ms.
//   igd_fold_minibatch_launch picks one of two instances by D; together
//   they take every D >= 1.
//
//   D <= 256: a thread-block cluster of kMbCluster CTAs on as many SMs
//   (igd_minibatch_cluster_kernel). Each tile's 256 rows are split into
//   kMbCluster row shares, one a CTA. Each CTA streams its shares of the
//   coming tiles into a shared-memory ring ahead of use: one thread issues
//   three bulk copies a tile (cp.async.bulk of the share's x, y and alpha,
//   as they lie in memory) completing on the slot's mbarrier, a ring's
//   depth ahead. Per tile, each CTA: computes its rows' margins (a warp a
//   row, lanes across D, w in registers, a shuffle sum) and c; block
//   barrier; sums its partial update u = sum_i c_i x_i in row order (a
//   thread a column) and pushes it into its slot of every CTA's receive
//   buffer (16-byte st.async stores into distributed shared memory, four
//   columns each, completing on the receiver's own mbarrier); every warp
//   waits on its CTA's mbarrier, sums the kMbCluster partials in rank
//   order from local shared memory and applies w -= (sum) / 256 to its
//   own registers. Every warp of every CTA forms the same sum in the same
//   order, so w is the same bit for bit everywhere: no all-reduce through
//   device memory, no cluster-wide barrier and no remote load a tile (the
//   first design, a cluster barrier and remote loads, spent most of its
//   tile step there). The receive buffers alternate by tile parity, so a
//   CTA can be sent tile t+1's partials while it still reads tile t's.
//   ref.igd_fold_minibatch_split_ref is this order in plain PyTorch.
//   Bulk copies need 16-byte aligned sources: with x, y or alpha off a
//   16-byte boundary, and for the ragged last tile's short shares, the
//   CTA's threads copy the share with plain loads when its turn comes.
//
//   D > 256: the column-slice cluster (igd_minibatch_slice_kernel), a
//   cluster of kMsCluster = 16 CTAs a lane (non-portable), CTA q owning
//   w's column slice [q * slice, q * slice + slice), slice = ceil(D / 16),
//   in shared memory up to kMsSmemMaxSlice floats (48 KB: D <=
//   kMinibatchSliceSmemMaxDim = 196,608) and in the lane's output row above.
//   What bounds it on this card: a tile's rows are needed twice, for the
//   margins and, once c is known, for the update, and every byte comes
//   into the 16 SMs of one cluster (at 8,192 x 12,033 a tile is 12.3 MB,
//   771 KB a CTA a pass); so bytes per SM at 16 SMs bound the wide tables
//   (0.1177 ms of HBM at 8,192 x 12,033 spread over 16 of 132 SMs), and at
//   narrow D the exchange a tile (every CTA needs every row's margin over
//   all 16 slices before any column can be updated). What the design does
//   about each:
//   - the bytes: where a tile's slice fits twice beside the rest
//     (RESIDENT: D <= kMinibatchResidentMaxDim = 1,424) it is copied once,
//     one tile ahead, by the consumers' 16-byte cp.async (a warp a row, a
//     lane 16 bytes of its span; a bulk copy a row took 1.16x as long at D
//     1,000: ~30 ns a copy however small), and stays from the margins to
//     the update, so the table crosses HBM once. Past it, a producer warp
//     streams the margins pass's rows into a ring of shared-memory slots,
//     a bulk copy (cp.async.bulk) a row a lane, completing on the slot's
//     mbarrier: at odd D rows start anywhere and a 2-D TMA map needs a row
//     stride of 16-byte multiples, so each span is widened to 16-byte
//     boundaries and read shifted (x, y and alpha may start off 16 bytes:
//     the same w). Panels are as wide as kMsMaxPanel columns (a panel of
//     half the width, twice the copies, took 1.4-1.6x as long). The update
//     reads the tile again from global memory, where the margins pass left
//     it in L2, sixteen rows' loads in flight a thread (copying it through
//     the ring again took as long, and a single warp's 16-byte cp.async in
//     place of the bulk copies 5x longer). Measured at 8,192 x 12,033
//     (clock64 in rank 0, scripts/torch_minibatch_variants.py --slice):
//     ~39,000 cycles a tile for the margins pass, at the ring's copy rate
//     (its copies alone take ~34,000), and ~28,500 for the update's loads
//     from L2, each ~50 GB/s an SM; 1.15-1.22 ms a launch.
//   - the exchange: the partial margins are pushed, not pulled. After the
//     margins pass (a warp 1, 2 or 4 rows at a time, lanes across the
//     slice, the rows' butterflies interleaved) one consumer barrier; 64
//     threads send the CTA's 256 partials to every CTA's receive buffer
//     with 16-byte st.async stores that complete on the receiver's own
//     mbarrier (the D <= 256 instance's scheme; the buffers alternate by
//     tile parity); 256 threads wait on their own CTA's mbarrier, sum the
//     16 partials of a row in rank order, so every CTA forms the same c bit
//     for bit, and take y and alpha loaded at the tile's start. No
//     cluster barrier and no remote load a tile: ~1,440 cycles a tile
//     (kernel.minibatch_wide_step_probe times the skeleton alone).
//   - the update: a thread owns a column (two past kMsConsumers columns
//     a chunk) and sums c_r x_rj over the tile's rows in row order, then
//     w_j -= sum / 256; where a chunk is at most half the consumers wide
//     (the resident tier), the rows split into blocks, a thread a (block,
//     column), the blocks' sums added in block order: every consumer
//     thread works, and w is rounded once a tile and never crosses CTAs.
//   The CTA count and the geometry depend on D alone (never on the number
//   of lanes), so a lane's w is its one-lane launch's bit for bit; the
//   wrapper checks at load that the 16-CTA cluster fits the card
//   (igd_fused_minibatch_clusters_fit).
//
//   All: the ragged last tile sums only its real rows and still divides
//   by 256, which is the reference's padded semantics.
//
// igd_minibatch_step_probe_launch times the cluster instance's dependent
// work of one tile with the tile already resident in shared memory (no
// copies: margins, the block barrier, the partial sums, the exchange of
// partials, the w update), clock64 in rank 0 around a loop of tiles.
//
// igd_chain_probe_kernel is no port of a TPU kernel: it times the tiled
// instances' dependent chain alone (clock64 around grad_scale_fast + FMA
// in one warp), which chip_smoke.py reports as igd_fold's floor at every
// D. igd_minibatch_wide_step_probe_launch times the column-slice
// instance's exchange a tile alone in the same way, for its floor.
//
// No kernel allocates; all launch on the caller's stream. Each C
// entry returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernels do not take).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kLossLr = 0;
constexpr int kLossSvm = 1;
constexpr int kLossLsq = 2;

constexpr int kWarp = 32;
constexpr int kFoldMaxDim = 4096;        // igd_fold's middle instance; the wide one above it
constexpr int kTile = 256;               // minibatch rows per step
constexpr int kGramMaxDim = 256;         // tiled Gram instance: one column a thread
constexpr int kSub = 32;                 // T: rows a sub-tile, one a lane of the chain warp
constexpr int kGramWarps = 8;            // warp 0 runs the chain, warps 1-7 help
constexpr int kGramThreads = kWarp * kGramWarps;
constexpr int kHelperThreads = kGramThreads - kWarp;
constexpr int kVectorWarps = 3;         // warps 4, 6, 7: loads, the w update, q
constexpr int kVectorThreads = kVectorWarps * kWarp;
constexpr int kProductRows = kSub + 1;   // the look-ahead product: C's 32 rows, then q
constexpr int kGramStageFloats = 24576;  // per stage (96 KB): two stages + G, P, w, c < 227 KB
constexpr int kGramMaxTileRows = 256;
constexpr unsigned kFull = 0xffffffffu;
// igd_fold_minibatch's cluster instance (D <= kMbMaxDim)
constexpr int kMbCluster = 8;                    // CTAs a cluster, one row share of a tile each
constexpr int kMbRows = kTile / kMbCluster;      // rows a share
constexpr int kMbWarps = 8;
constexpr int kMbThreads = kMbWarps * kWarp;
constexpr int kMbRowsPerWarp = (kMbRows + kMbWarps - 1) / kMbWarps;
constexpr int kMbMaxDim = 256;                   // one column a thread in the partial sums
constexpr int kMbMaxStages = 8;                  // ring slots, each one share of a tile
constexpr int kMbRingBytes = 180 * 1024;
constexpr int kMbBarBytes = 128;                 // the mbarriers, 16-byte padded
static_assert(kTile % kMbCluster == 0 && kMbRows % 4 == 0, "shares of 16-byte multiples");
static_assert(kMbMaxDim <= kMbThreads, "one column a thread");
static_assert((kMbMaxStages + 2) * 8 <= kMbBarBytes, "the mbarriers fit their header");
// igd_fold's middle and wide instances (past kGramMaxDim): the Gram
// pre-pass, then a cluster a lane (see the head of this file)
constexpr int kGramFloats = 2 * kSub * kSub;  // a sub-tile's G | C in the pre-pass's scratch
constexpr int kPpThreads = 4 * kWarp;         // the pre-pass: a 16 x 32 block of G | C a warp
constexpr int kPpChunk = 64;                  // columns a pre-pass stage
constexpr int kPpLd = kPpChunk + 4;           // an odd multiple of 16 bytes: no bank conflicts
// The cluster kernel's warps: warp 0 runs the chain with its scheduler
// (warps 0, 4, 8: warp w issues on scheduler w % 4) to itself but for the
// producer (warp 4, which mostly waits) and an idle warp 8; the other nine
// are the consumers, a column a thread.
constexpr int kFcWarps = 12;
constexpr int kFcProducerWarp = 4;
constexpr int kFcConsumerWarps = kFcWarps - kFcWarps / 4;
constexpr int kFcConsumers = kFcConsumerWarps * kWarp;
constexpr int kFcThreads = kFcWarps * kWarp;
constexpr int kFcStepThreads = kWarp + kFcConsumers;  // the step barrier's: warp 0 and the consumers
// A panel column takes four consumer lanes (l, l^1, l^2, l^3), lane g of
// them rows g, g + 4, ..., g + 28, so a warp works 8 columns at a time and
// the loops over rows stay short: fully unrolled over 32 rows, the pass
// was ~6 KB of straight-line code a variant, run once a step out of the
// instruction cache (measured: ~3,900 cycles for one column a thread).
// With the panel's row stride at 8 mod 32 floats the four lanes' rows
// fall 8 banks apart, so a warp's load of 4 rows x 8 columns is one
// wavefront (rows 8 apart at a stride of 0 mod 32 were 4-way conflicts).
constexpr int kFcRowGroup = 8;
constexpr int kFcGroups = kSub / kFcRowGroup;
constexpr int kFcColumnsAtOnce = kFcConsumers / kFcGroups;
constexpr int kFcRingMin = 3, kFcRingMax = 8;  // panel slots: the ring's depth, set by the panel's size
constexpr int kFcBarBytes = 256;              // the mbarriers: q's [2], full [ring], empty [ring]
static_assert((2 + 2 * kFcRingMax) * 8 <= kFcBarBytes, "the mbarriers fit their header");
constexpr int kFcCluster = 16;                // CTAs a lane of the wide instance (a non-portable size)
constexpr int kFcSmemMaxSlice = 12288;        // w's slice in shared memory up to 48 KB a CTA
constexpr int kFoldClusterSmemMaxDim = kFcCluster * kFcSmemMaxSlice;
// a CTA's shared memory but the ring and w, in a cluster of `ctas`:
// received q, G, C (+ a row's slack), y, alpha, c, the consumers' partials
constexpr int fc_fixed_floats(int ctas) {
  return 2 * ctas * kSub + 4 * kSub * kSub + 2 * kSub + 8 * kSub + 2 * kSub + kFcConsumerWarps * kSub;
}
constexpr int kSmemOptIn = 232448;            // the 227 KB a block may opt into
constexpr int kPpSplit = 4;                   // the wide pre-pass's blocks a sub-tile, each a quarter of D
// The middle instance (kGramMaxDim < D <= kFoldMaxDim): the cluster kernel
// with each sub-tile's slice resident in shared memory from its q to its
// update, on the fewest CTAs (a power of two, at most kFcCluster) whose
// slices are at most kFmMaxSlice columns; its pre-pass takes one block a
// sub-tile (no sum launch, 64 floats of scratch a row).
constexpr int kFmMaxSlice = 128;
constexpr int kFmSlots = 5;  // resident sub-tiles: s - 1, s, s + 1 and two on their way

// CTAs a lane of the middle instance at D: set by D alone, never by lanes.
constexpr int middle_ctas(int d) {
  int ctas = 1;
  while (ctas < kFcCluster && (d + ctas - 1) / ctas > kFmMaxSlice) ctas *= 2;
  return ctas;
}
constexpr int kFcPrefetchAhead = 2;           // sub-tiles fetched into L2 ahead of their q
static_assert(2 * 2 * kSub * kPpLd * sizeof(float) <= 48 * 1024, "the pre-pass's two stages are static");
// igd_fold_minibatch past kMbMaxDim: the column-slice cluster (see the
// head of this file)
constexpr int kMsCluster = 16;                // CTAs a lane (a non-portable cluster size)
constexpr int kMsConsumerWarps = 16;          // and one producer warp after them
constexpr int kMsConsumers = kMsConsumerWarps * kWarp;
constexpr int kMsThreads = kMsConsumers + kWarp;
constexpr int kMsMaxPanel = 2 * kMsConsumers;  // columns a panel: two a consumer thread in the update
constexpr int kMsMinRows = kMsConsumerWarps;  // rows a streamed panel: one a consumer warp at least
constexpr int kMsRingMin = 4, kMsRingMax = 8;  // panel slots, set by the panel's size
constexpr int kMsBarBytes = 256;              // the mbarriers: the partials' [2], full [ring], empty [ring]
static_assert((2 + 2 * kMsRingMax) * 8 <= kMsBarBytes, "the mbarriers fit their header");
constexpr int kMsSmemMaxSlice = 12288;        // w's slice in shared memory up to 48 KB a CTA
constexpr int kMinibatchSliceSmemMaxDim = kMsCluster * kMsSmemMaxSlice;
// received partials [2][16][256], margins [256], c [256], the update's row-group sums [512]
constexpr int kMsFixedFloats = 2 * kMsCluster * kTile + 2 * kTile + kMsConsumers;
static_assert(kTile % kMsConsumerWarps == 0 && kTile <= kMsConsumers, "a row a consumer thread in the exchange");

// The column-slice instance's resident tier (see slice_panels)
// a span of `cols` floats widened by up to 3, in whole float4s
__host__ __device__ constexpr int span_ld(int cols) { return (cols + 3 + 3) / 4 * 4; }

constexpr size_t slice_fixed_bytes(int slice) {
  return kMsBarBytes + (kMsFixedFloats + static_cast<size_t>(slice <= kMsSmemMaxSlice ? slice : 0)) * sizeof(float);
}

constexpr size_t slice_slot_bytes(int rows, int ldp) { return static_cast<size_t>(rows) * ldp * sizeof(float); }

constexpr bool slice_resident(int slice) {
  return slice <= kMsMaxPanel && slice_fixed_bytes(slice) + 2 * slice_slot_bytes(kTile, span_ld(slice)) <= kSmemOptIn;
}

// The last D whose slice stays resident from the margins to the update.
constexpr int slice_resident_max_dim() {
  int d = kMbMaxDim;
  while (slice_resident((d + kMsCluster) / kMsCluster)) ++d;  // D + 1's slice
  return d;
}
constexpr int kMinibatchResidentMaxDim = slice_resident_max_dim();
constexpr int kMsResidentMaxSlice = (kMinibatchResidentMaxDim + kMsCluster - 1) / kMsCluster;
static_assert(span_ld(kMsResidentMaxSlice) <= 4 * kWarp, "a resident row's span in one warp's 16-byte chunks");

// d loss / d (w.x), given wx = w.x (the kernel forms the margin itself).
template <int LOSS>
__device__ __forceinline__ float grad_scale(float wx, float y) {
  if (LOSS == kLossLsq) return wx - y;
  const float m = y * wx;
  if (LOSS == kLossLr) return -y * (1.0f / (1.0f + expf(m)));  // -y*sigmoid(-m)
  return m < 1.0f ? -y : 0.0f;
}

// grad_scale for the tiled instance's chain: lr takes __expf and an
// approximate reciprocal (__fdividef: MUFU.RCP, within 2 ulp) where
// grad_scale takes IEEE expf and division. Measured on the H100, it cuts
// the chain's dependent latency by a third, and the fold stays within the
// reference's kernel tolerance of the per-row and float64 folds
// (chip_smoke.py, tests/test_torch_cuda.py). svm and lsq are unchanged.
template <int LOSS>
__device__ __forceinline__ float grad_scale_fast(float wx, float y) {
  if (LOSS == kLossLr) return -y * __fdividef(1.0f, 1.0f + __expf(y * wx));
  return grad_scale<LOSS>(wx, y);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A barrier of the helper warps alone (id 1; __syncthreads is id 0).
__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kHelperThreads) : "memory");
}

// A barrier of the vector warps alone (id 2).
__device__ __forceinline__ void vector_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kVectorThreads) : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

// The tiled instance's stage load, by the vector warps: rows [row0, row0 +
// rows) of x into a stage laid out as x[tile_rows][ld] | y[tile_rows] |
// alpha[tile_rows], a warp a row and a lane a column, two columns (8 bytes)
// a copy when D is even and x 8-byte aligned. The pad columns [d, ld) are
// not written. No division a float: the loads' issue stays off the steps.
__device__ __forceinline__ void load_rows(float* stage, const float* x, const float* y,
                                          const float* alpha, long long row0, int rows, int d,
                                          int ld, int tile_rows, bool pairs, int vw, int lane) {
  const float* src = x + row0 * d;
  if (pairs) {
#pragma unroll 4
    for (int r = vw; r < rows; r += kVectorWarps) {
      for (int c = 2 * lane; c < d; c += 2 * kWarp) cp_async8(stage + r * ld + c, src + r * d + c);
    }
  } else {
#pragma unroll 4
    for (int r = vw; r < rows; r += kVectorWarps) {
      for (int c = lane; c < d; c += kWarp) cp_async4(stage + r * ld + c, src + r * d + c);
    }
  }
  float* ys = stage + tile_rows * ld;
  for (int i = vw * kWarp + lane; i < rows; i += kVectorWarps * kWarp) {
    cp_async4(ys + i, y + row0 + i);
    cp_async4(ys + tile_rows + i, alpha + row0 + i);
  }
}

// A 16 x 32 block of a product of two sub-tiles, by one warp:
// out[k][j] = a_k . b_j for k < 16 (rows of xa) and j < 32 (rows of xb),
// over the first dp columns (the pad columns are zero). Lane (a, b) =
// (lane % 8, lane / 8) keeps the 4 x 4 sums k in {b, b+4, b+8, b+12},
// j in {a, a+8, a+16, a+24}: per 4 columns, 8 LDS.128 feed 64 FMAs, and
// the rows a lane reads fall in distinct 16-byte bank groups (the row
// stride is an odd multiple of 16 bytes), so each load is one wavefront.
__device__ __forceinline__ void product_block(const float* xa, const float* xb, float* out,
                                              int dp, int ld, int lane) {
  const int a = lane & 7, b = lane >> 3;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll 2  // one step's loads beside the other's FMAs
  for (int c = 0; c < dp; c += 4) {
    float4 ak[4], bj[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ak[i] = *reinterpret_cast<const float4*>(xa + (b + 4 * i) * ld + c);
      bj[i] = *reinterpret_cast<const float4*>(xb + (a + 8 * i) * ld + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(ak[i].x, bj[j].x, acc[i][j]);
        acc[i][j] = fmaf(ak[i].y, bj[j].y, acc[i][j]);
        acc[i][j] = fmaf(ak[i].z, bj[j].z, acc[i][j]);
        acc[i][j] = fmaf(ak[i].w, bj[j].w, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(b + 4 * i) * kSub + a + 8 * j] = acc[i][j];
  }
}

// q = X_T w for the sub-tile at xs, by one warp: lane j's row . w.
__device__ __forceinline__ float row_dot(const float* xs, const float* ws, int dp, int ld,
                                         int lane) {
  const float* xr = xs + lane * ld;
  float acc = 0.0f;
  for (int c = 0; c < dp; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(xr + c);
    const float4 b = *reinterpret_cast<const float4*>(ws + c);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
  return acc;
}

// The scalar recurrence of one sub-tile, in warp 0, from r = p (lane j
// holds r_j). Every lane holds the final r_k and computes the same c_k;
// lane j then subtracts c_k G_kj (lanes j <= k update a value no step
// reads again). The broadcast is off the chain: r_k+1 less its last term
// was shuffled from lane k+1 during step k-1's grad_scale, so step k ends
// with r_k+1 = that - c_k G_k,k+1, one FMA. The loop is unrolled by 8,
// not in full: 32 steps of grad_scale would not stay in the instruction
// cache, and a fetch on the chain costs more than the step. So each step loads
// the next step's G_k+1,j, G_k+1,k+2, y and alpha ahead of use. Writes c
// to cs[0..31] (0 past m).
template <int LOSS>
__device__ __forceinline__ void chain(float r, const float* gram, const float* ys,
                                      const float* as, float* cs, int m, int lane) {
  float gk = gram[lane], sk = gram[1], yk = ys[0], ak = as[0], mine = 0.0f;
  float rk = __shfl_sync(kFull, r, 0);
  float ahead = __shfl_sync(kFull, r, 1);
#pragma unroll 8
  for (int k = 0; k < m; ++k) {
    // k + 1 <= 32: past the last step these read G's other buffer and the
    // stage's next y and alpha, within shared memory and never used
    const float* next = gram + (k + 1) * kSub;
    const float gn = next[lane], sn = next[k + 2], yn = ys[k + 1], an = as[k + 1];
    const float c = grad_scale_fast<LOSS>(rk, yk) * ak;
    r = fmaf(-c, gk, r);
    rk = fmaf(-c, sk, ahead);
    ahead = __shfl_sync(kFull, r, k + 2);
    if (lane == k) mine = c;
    gk = gn;
    sk = sn;
    yk = yn;
    ak = an;
  }
  cs[lane] = mine;
}

// w -= X_T^T c over the first m rows of a sub-tile, for the columns
// first, first + step, ... < d: the sum first, in row order, then one
// rounding of w.
__device__ __forceinline__ void apply_step(float* ws, const float* xs, const float* cs, int m,
                                           int d, int ld, int first, int step) {
  for (int j = first; j < d; j += step) {
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < m; ++k) acc = fmaf(cs[k], xs[k * ld + j], acc);
    ws[j] -= acc;
  }
}

// Smem: two stages of stage_floats (x rows at stride ld, then y, alpha);
// G [2][32][32]; P [2][33][32], the look-ahead product (rows 0-31:
// C = X_next X_T^T, row 32: q = X_next w); w [ld]; c [2][32]. G, P and c
// are double-buffered: warp 0 reads one while the helpers fill the other.
//
// Step s (s = -1 only prepares sub-tile 0): warp 0 turns q and C c_{s-1}
// into p_s = X_s w_s (w_s is w after sub-tile s-1), then runs the chain,
// writing c_s. Meanwhile the product warps (1, 2, 3, 5: not 4, which
// shares warp 0's scheduler) form G_{s+1} and C_{s+1} = X_{s+1} X_s^T, 16
// rows each, and the vector warps (4, 6, 7) apply c_{s-1} to w (w_s),
// issue the stage loads and form q_{s+1} = X_{s+1} w_s, so that
// p_{s+1} = q_{s+1} - C_{s+1} c_s. One block barrier a step.
template <int LOSS>
__global__ void __launch_bounds__(kGramThreads)
    igd_fold_gram_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         const float* __restrict__ alpha, const float* __restrict__ w0,
                         float* __restrict__ wout, long long n, int d, int ld, int tile_rows,
                         int stage_floats, int vec, long long xy_lane_rows,
                         long long alpha_lane_stride, int lanes_per_xy) {
  extern __shared__ __align__(16) float smem[];
  {  // lane blockIdx.x: the only change from a one-lane launch
    const long long b = blockIdx.x;
    // the x/y segment lane b reads (32-bit division: b < 65536 and no 64-bit divide call)
    const long long s = static_cast<unsigned>(b) / static_cast<unsigned>(lanes_per_xy);
    x += s * xy_lane_rows * d;
    y += s * xy_lane_rows;
    alpha += b * alpha_lane_stride;
    w0 += b * d;
    wout += b * d;
  }
  float* gram = smem + 2 * stage_floats;
  float* prod = gram + 2 * kSub * kSub;
  float* ws = prod + 2 * kProductRows * kSub;
  float* cs = ws + ld;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int pw = warp >= 1 && warp <= 3 ? warp - 1 : (warp == 5 ? 3 : -1);  // product warp
  const int vw = warp == 4 ? 0 : (warp >= 6 ? warp - 5 : -1);               // vector warp
  const int vtid = vw * kWarp + lane;
  const int dp = (d + 3) & ~3;  // the dots run over dp columns; [d, dp) are zero

  for (int i = tid; i < 2 * tile_rows * (ld - d); i += kGramThreads) {
    const int rr = i / (ld - d);
    smem[(rr / tile_rows) * stage_floats + (rr % tile_rows) * ld + d + i % (ld - d)] = 0.0f;
  }
  for (int i = tid; i < ld; i += kGramThreads) ws[i] = i < d ? w0[i] : 0.0f;
  for (int i = tid; i < 2 * kSub; i += kGramThreads) cs[i] = 0.0f;

  const int n_sub = static_cast<int>((n + kSub - 1) / kSub);
  const int n_stages = static_cast<int>((n + tile_rows - 1) / tile_rows);
  auto rows_in = [&](int v) {
    const long long left = n - static_cast<long long>(v) * tile_rows;
    return static_cast<int>(left < tile_rows ? left : tile_rows);
  };
  auto load = [&](int v) {  // stage v, by the vector warps
    const long long row0 = static_cast<long long>(v) * tile_rows;
    load_rows(smem + (v & 1) * stage_floats, x, y, alpha, row0, rows_in(v), d, ld, tile_rows,
              vec != 0, vw, lane);
  };
  // sub-tile s sits in stage u at row `base`; sub-tile t = s + 1 at (u1, base1)
  int u = 0, base = -kSub, u1 = 0, base1 = 0;
  __syncthreads();  // the pad columns, w and c are set
  for (int s = -1; s < n_sub; ++s) {
    const int t = s + 1;
    const float* xs = smem + (u & 1) * stage_floats + base * ld;  // X_s (s >= 0)
    const float* xt = smem + (u1 & 1) * stage_floats + base1 * ld;  // X_t (t < n_sub)
    if (warp == 0) {
      if (s >= 0) {
        const float* pb = prod + (s & 1) * kProductRows * kSub;
        float r = pb[kSub * kSub + lane];  // q_s
        if (s > 0) {  // less C_s c_{s-1}
          const float* cp = cs + ((s - 1) & 1) * kSub;
          float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
          for (int k = 0; k < kSub; k += 4) {
            a0 = fmaf(pb[k * kSub + lane], cp[k], a0);
            a1 = fmaf(pb[(k + 1) * kSub + lane], cp[k + 1], a1);
            a2 = fmaf(pb[(k + 2) * kSub + lane], cp[k + 2], a2);
            a3 = fmaf(pb[(k + 3) * kSub + lane], cp[k + 3], a3);
          }
          r -= (a0 + a1) + (a2 + a3);
        }
        const long long left = n - static_cast<long long>(s) * kSub;
        const float* ys = smem + (u & 1) * stage_floats + tile_rows * ld + base;
        chain<LOSS>(r, gram + (s & 1) * kSub * kSub, ys, ys + tile_rows,
                    cs + (s & 1) * kSub, left < kSub ? static_cast<int>(left) : kSub, lane);
      }
    } else if (vw >= 0) {
      if (s > 0) {  // w_s = w_{s-1} - X_{s-1}^T c_{s-1}
        apply_step(ws, smem + ((base == 0 ? u - 1 : u) & 1) * stage_floats +
                           (base == 0 ? tile_rows - kSub : base - kSub) * ld,
                   cs + ((s - 1) & 1) * kSub, kSub, d, ld, vtid, kVectorThreads);
        vector_sync();
      }
      if (s < 0) {
        load(0);
        cp_async_commit();
        if (n_stages > 1) load(1);
        cp_async_commit();  // possibly empty: keeps "wait for all but one" exact
      } else if (base == 0 && u >= 1 && u + 1 < n_stages) {
        load(u + 1);  // into stage u-1's buffer: its last reader was the update above
        cp_async_commit();
      }
      if (t < n_sub && base1 == 0) {  // t opens stage u1: its loads are in flight
        if (s < 0) {
          cp_async_wait_one();
        } else {
          cp_async_wait_all();
        }
        helpers_sync();
      }
      if (vw == 0 && t < n_sub) prod[(t & 1) * kProductRows * kSub + kSub * kSub + lane] =
          row_dot(xt, ws, dp, ld, lane);
    } else {
      if (t < n_sub && base1 == 0) helpers_sync();
      if (t < n_sub) {  // G_t (product warps 0, 1) and C_t = X_t X_s^T (2, 3; unread for t = 0)
        const int half = (pw & 1) * 16;
        float* out = pw < 2 ? gram + (t & 1) * kSub * kSub : prod + (t & 1) * kProductRows * kSub;
        product_block((pw < 2 || s < 0 ? xt : xs) + half * ld, xt, out + half * kSub, dp, ld,
                      lane);
      }
    }
    __syncthreads();  // c_s, G_t, C_t and q_t, and stage u1 are visible to all
    u = u1;
    base = base1;
    base1 += kSub;
    if (base1 == tile_rows) {
      base1 = 0;
      ++u1;
    }
  }

  if (n_sub > 0) {  // the last sub-tile's step
    const int last = (n_sub - 1) * kSub;
    apply_step(ws, smem + ((last / tile_rows) & 1) * stage_floats + (last % tile_rows) * ld,
               cs + ((n_sub - 1) & 1) * kSub, static_cast<int>(n - last), d, ld, tid,
               kGramThreads);
  }
  __syncthreads();
  for (int j = tid; j < d; j += kGramThreads) wout[j] = ws[j];
}

// Cycles of `steps` dependent steps of igd_fold_gram_kernel's chain,
// c = grad_scale_fast(r) * alpha then r -= c * g, timed alone in one warp
// (as the chain runs: every lane the same values). out[0] = cycles,
// out[1] = the final r's bits (which keeps the loop).
template <int LOSS>
__global__ void igd_chain_probe_kernel(float r, float yv, float av, float gv, int steps,
                                       long long* out) {
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < steps; ++i) {
    const float c = grad_scale_fast<LOSS>(r, yv) * av;
    r = fmaf(-c, gv, r);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = __float_as_int(r);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory into this
// CTA's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Dynamic shared memory of the cluster instance: mbarriers (the ring's
// [kMbMaxStages], then the partials' [2]; padded to kMbBarBytes) |
// partials received [2][kMbCluster][kMbMaxDim] | c [kMbRows] |
// ring [stages][kMbRows * (d + 2)] (a slot: x[kMbRows][d] | y | alpha).
__host__ __device__ constexpr int mb_slot_floats(int d) { return kMbRows * (d + 2); }

__host__ __device__ constexpr size_t mb_smem_bytes(int d, int stages) {
  return kMbBarBytes + (2 * kMbCluster * kMbMaxDim + kMbRows +
                        static_cast<size_t>(stages) * mb_slot_floats(d)) * sizeof(float);
}

int mb_stages(int d) {
  const int by_bytes = kMbRingBytes / (mb_slot_floats(d) * static_cast<int>(sizeof(float)));
  return by_bytes < kMbMaxStages ? by_bytes : kMbMaxStages;
}

// Bytes of partials a CTA receives a tile: every rank's columns, four a store.
__host__ __device__ constexpr uint32_t mb_partial_bytes(int d) {
  return kMbCluster * ((d + 3) / 4) * 4 * sizeof(float);
}

// This CTA's rows of tile t (all of them before the last, ragged tile).
__device__ __forceinline__ int share_rows(long long t, long long n, long long full_tiles,
                                          int rank) {
  if (t < full_tiles) return kMbRows;
  const long long left = n - t * kTile - rank * kMbRows;
  return static_cast<int>(left < 0 ? 0 : (left < kMbRows ? left : kMbRows));
}

// One thread: tile t's share of x, y and alpha into ring slot xs, three
// bulk copies completing on bar.
__device__ __forceinline__ void issue_share(float* xs, uint64_t* bar, const float* x,
                                            const float* y, const float* alpha, long long t,
                                            int rank, int d) {
  const long long row0 = t * kTile + rank * kMbRows;
  const uint32_t xbytes = kMbRows * d * sizeof(float), vbytes = kMbRows * sizeof(float);
  mbar_expect_tx(bar, xbytes + 2 * vbytes);
  bulk_copy(xs, x + row0 * d, xbytes, bar);
  bulk_copy(xs + kMbRows * d, y + row0, vbytes, bar);
  bulk_copy(xs + kMbRows * d + kMbRows, alpha + row0, vbytes, bar);
}

// This CTA's share of tile t: c_r for its rows, into cs (a warp a row,
// lanes across D, the tile-start w in registers).
template <int LOSS, int VPL>
__device__ __forceinline__ void tile_margins(const float* xs, const float* ys, const float* as,
                                             const float (&w)[VPL], float* cs, int rows, int d,
                                             int warp, int lane) {
  float dot[kMbRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kMbRowsPerWarp; ++i) {
    const int r = warp + kMbWarps * i;
    float acc = 0.0f;
    if (r < rows) {
      const float* xr = xs + r * d;
#pragma unroll
      for (int m = 0; m < VPL; ++m) {
        const int j = lane + kWarp * m;
        if (j < d) acc = fmaf(w[m], xr[j], acc);
      }
    }
    dot[i] = acc;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < kMbRowsPerWarp; ++i) dot[i] += __shfl_xor_sync(kFull, dot[i], o);
  }
  // lane i takes row warp + kMbWarps * i: the scales in parallel
  float mine = 0.0f;
#pragma unroll
  for (int i = 0; i < kMbRowsPerWarp; ++i) mine = lane == i ? dot[i] : mine;
  const int r = warp + kMbWarps * lane;
  if (lane < kMbRowsPerWarp && r < rows) cs[r] = grad_scale<LOSS>(mine, ys[r]) * as[r];
}

// This CTA's partial update of column tid, u = sum_r c_r x_r,tid over its
// rows in row order (0 past D).
__device__ __forceinline__ float tile_partial(const float* xs, const float* cs, int rows, int d,
                                              int tid) {
  float u = 0.0f;
  if (tid < d) {
#pragma unroll 8
    for (int r = 0; r < rows; ++r) u = fmaf(cs[r], xs[r * d + tid], u);
  }
  return u;
}

// Push this CTA's partial into its slot [rank] of every CTA's receive
// buffer for the tile's parity: lanes 4i gather columns 4i..4i+3 by
// shuffles and send them as one 16-byte st.async, which completes on the
// receiver's own mbarrier. Called by every thread (the shuffles).
__device__ __forceinline__ void send_partial(float u, float* recv, uint64_t* recv_bar, int parity,
                                             int rank, int d, int tid) {
  const float u1 = __shfl_down_sync(kFull, u, 1);
  const float u2 = __shfl_down_sync(kFull, u, 2);
  const float u3 = __shfl_down_sync(kFull, u, 3);
  if (tid % 4 == 0 && tid < d) {
    const uint32_t dst = smem_u32(recv + (parity * kMbCluster + rank) * kMbMaxDim + tid);
    const uint32_t bar = smem_u32(recv_bar + parity);
#pragma unroll
    for (int q = 0; q < kMbCluster; ++q) {
      uint32_t rdst, rbar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rdst) : "r"(dst), "r"(q));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(bar), "r"(q));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
          "[%5];\n" ::"r"(rdst),
          "r"(__float_as_uint(u)), "r"(__float_as_uint(u1)), "r"(__float_as_uint(u2)),
          "r"(__float_as_uint(u3)), "r"(rbar)
          : "memory");
    }
  }
}

// w -= (sum over ranks, in rank order, of the received partials) / TILE,
// by every warp for its own lanes' columns.
template <int VPL>
__device__ __forceinline__ void tile_update(const float* slots, float (&w)[VPL], int d,
                                            int lane) {
#pragma unroll
  for (int m = 0; m < VPL; ++m) {
    const int j = lane + kWarp * m;
    if (j < d) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < kMbCluster; ++q) s += slots[q * kMbMaxDim + j];
      w[m] = w[m] - s / static_cast<float>(kTile);
    }
  }
}

// The cluster instance (D <= kMbMaxDim; w in registers, VPL = ceil(D/32)
// a lane). RESIDENT is the step probe: no copies, `n / kTile` tiles of
// made-up rows that stay in slot 0, clock64 around the loop into probe.
template <int LOSS, int VPL, bool RESIDENT>
__global__ void __launch_bounds__(kMbThreads)
    igd_minibatch_cluster_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                 const float* __restrict__ alpha, const float* __restrict__ w0,
                                 float* __restrict__ wout, long long n, int d, int stages,
                                 int vec, long long* probe, long long xy_lane_rows,
                                 long long alpha_lane_stride, int lanes_per_xy) {
  extern __shared__ __align__(16) unsigned char mb_smem[];
  if (!RESIDENT) {  // lane blockIdx.y, one cluster a lane: the only change from a one-lane launch
    const long long b = blockIdx.y;
    // the x/y segment lane b reads (32-bit division: b < 65536 and no 64-bit divide call)
    const long long s = static_cast<unsigned>(b) / static_cast<unsigned>(lanes_per_xy);
    x += s * xy_lane_rows * d;
    y += s * xy_lane_rows;
    alpha += b * alpha_lane_stride;
    w0 += b * d;
    wout += b * d;
  }
  uint64_t* bars = reinterpret_cast<uint64_t*>(mb_smem);  // the ring's
  uint64_t* recv_bar = bars + kMbMaxStages;                  // the partials', [2]
  float* recv = reinterpret_cast<float*>(mb_smem + kMbBarBytes);
  float* cs = recv + 2 * kMbCluster * kMbMaxDim;  // [kMbRows]
  float* ring = cs + kMbRows;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int slot_floats = mb_slot_floats(d);
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long full_tiles = n / kTile;  // every share of these is full
  const uint32_t partial_bytes = mb_partial_bytes(d);

  float w[VPL];
#pragma unroll
  for (int m = 0; m < VPL; ++m) {
    const int j = lane + kWarp * m;
    w[m] = j < d ? (RESIDENT ? 0.01f : w0[j]) : 0.0f;
  }
  // a share goes by bulk copies when it is whole and the sources are aligned
  const long long bulk_tiles = vec ? (share_rows(full_tiles, n, full_tiles, rank) == kMbRows
                                          ? full_tiles + 1 : full_tiles) : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + s, 1);
    for (int s = 0; s < 2; ++s) mbar_init(recv_bar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // tiles 0 and 1 expect their partials; tile t re-arms its slot for t + 2
    for (int s = 0; s < 2; ++s) mbar_expect_tx(recv_bar + s, partial_bytes);
  }
  if (RESIDENT) {
    for (int i = tid; i < kMbRows * d; i += kMbThreads) ring[i] = 0.01f * static_cast<float>(i % 13 - 6);
    for (int i = tid; i < kMbRows; i += kMbThreads) {
      ring[kMbRows * d + i] = i % 2 ? 1.0f : -1.0f;
      ring[kMbRows * d + kMbRows + i] = 0.01f;
    }
  }
  cluster.sync();  // barriers set and armed, every CTA of the cluster running
  if (!RESIDENT && tid == 0) {
    for (int s = 0; s < stages - 1 && s < bulk_tiles; ++s) {
      issue_share(ring + s * slot_floats, bars + s, x, y, alpha, s, rank, d);
    }
  }

  const long long clock0 = clock64();
  int slot = 0;          // tile t's ring slot: t % stages
  uint32_t parity = 0;   // of its mbarrier's phase: (t / stages) & 1
  for (long long t = 0; t < n_tiles; ++t) {
    const int rows = RESIDENT ? kMbRows : share_rows(t, n, full_tiles, rank);
    float* xs = ring + (RESIDENT ? 0 : slot) * slot_floats;
    float* ys = xs + kMbRows * d;
    float* as = ys + kMbRows;
    if (!RESIDENT) {
      if (t < bulk_tiles) {
        mbar_wait(bars + slot, parity);
      } else if (rows > 0) {  // off a 16-byte boundary, or the ragged last tile
        const long long row0 = t * kTile + rank * kMbRows;
        for (int i = tid; i < rows * d; i += kMbThreads) xs[i] = x[row0 * d + i];
        for (int i = tid; i < rows; i += kMbThreads) {
          ys[i] = y[row0 + i];
          as[i] = alpha[row0 + i];
        }
        __syncthreads();
      }
    }
    const int half = static_cast<int>(t & 1);  // the partials' slot and its phase parity
    tile_margins<LOSS, VPL>(xs, ys, as, w, cs, rows, d, warp, lane);
    __syncthreads();  // c is complete; every warp is past the previous tile's update
    if (!RESIDENT) {
      // the slot before this one was last read before the previous tile's
      // partials went out: refill it, a ring's depth ahead, from the last
      // thread (idle in the partial sums while D <= 224), off the margins'
      // path
      const long long ahead = t + stages - 1;
      const int before = slot == 0 ? stages - 1 : slot - 1;
      if (tid == kMbThreads - 1 && ahead < bulk_tiles) {
        issue_share(ring + before * slot_floats, bars + before, x, y, alpha, ahead, rank, d);
      }
      if (++slot == stages) {
        slot = 0;
        parity ^= 1u;
      }
    }
    const float u = tile_partial(xs, cs, rows, d, tid);
    send_partial(u, recv, recv_bar, half, rank, d, tid);
    mbar_wait(recv_bar + half, static_cast<uint32_t>((t >> 1) & 1));
    tile_update<VPL>(recv + half * kMbCluster * kMbMaxDim, w, d, lane);
    if (tid == 0 && t + 2 < n_tiles) mbar_expect_tx(recv_bar + half, partial_bytes);
  }
  const long long clock1 = clock64();

  cluster.sync();  // no CTA leaves while its partials may still be in flight
  if (RESIDENT) {
    if (rank == 0 && tid == 0) {
      probe[0] = clock1 - clock0;
      probe[1] = __float_as_int(w[0]);
    }
  } else if (rank == 0 && warp == 0) {
#pragma unroll
    for (int m = 0; m < VPL; ++m) {
      const int j = lane + kWarp * m;
      if (j < d) wout[j] = w[m];
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The 16-byte boundary below a row's first element, in floats: the row
// starts `shift` floats into its span, shift = address / 4 mod 4 (rows of
// odd D start anywhere), which moves by d mod 4 from row to row.
__device__ __forceinline__ int panel_shift(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// igd_fold's middle and wide instances, pass 1: for sub-tile v = blockIdx.x
// of segment blockIdx.y (rows segment * seg_rows + [32 v, 32 v + 32)), the
// 64 x 32 block [G_v; C_v] = [X_v; X_{v-1}] X_v^T over part blockIdx.z of
// the columns (gridDim.z parts of whole chunks) into
// grams[segment][v][part] (G [32][32] | C [32][32], C[k][j] =
// x_{v-1,k}.x_{v,j}); rows past N and the rows of X_{-1} are zero. Each
// chunk of kPpChunk columns comes in as 16-byte loads of each row's span
// widened to 16-byte boundaries (a thread 9 of them, held in registers
// while the previous chunk is summed) and goes into shared memory shifted
// back to its columns; warp q forms rows [16 q, 16 q + 16) of the block,
// each lane a 4 x 4 register block as product_block does, the sums
// running over the columns in order. (Its first design took 4-byte
// cp.async copies: four times the requests, 0.2 ms at 8,192 x 4,097.)
__global__ void __launch_bounds__(kPpThreads)
    igd_fold_gram_prepass_kernel(const float* __restrict__ x, float* __restrict__ grams, long long n,
                                 int d, long long seg_rows) {
  constexpr int kSpan = kPpChunk / 4 + 1;                                  // float4s a row's span
  constexpr int kSlots = (2 * kSub * kSpan + kPpThreads - 1) / kPpThreads;  // float4s a thread
  __shared__ __align__(16) float stage[2][2 * kSub * kPpLd];
  const int v = blockIdx.x, tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int n_sub = static_cast<int>((n + kSub - 1) / kSub);
  // part blockIdx.z: whole chunks [first, last) of the columns
  const int parts = static_cast<int>(gridDim.z);
  const int all = (d + kPpChunk - 1) / kPpChunk, per = (all + parts - 1) / parts;
  const int first = blockIdx.z * per, last = first + per < all ? first + per : all;
  x += static_cast<long long>(blockIdx.y) * seg_rows * d;
  grams += ((static_cast<long long>(blockIdx.y) * n_sub + v) * parts + blockIdx.z) * kGramFloats;
  const long long left = n - static_cast<long long>(v) * kSub;
  const int rows_v = left < kSub ? static_cast<int>(left) : kSub;
  // rows 0-31: X_v's; rows 32-63: X_{v-1}'s, which lie just before them
  auto real = [&](int r) { return r < kSub ? r < rows_v : v > 0; };
  auto row_at = [&](int r, int c0) {
    return x + (static_cast<long long>(v) * kSub + (r < kSub ? r : r - 2 * kSub)) * d + c0;
  };
  float4 held[kSlots];
  auto fetch = [&](int chunk) {
    const int c0 = chunk * kPpChunk, len = d - c0 < kPpChunk ? d - c0 : kPpChunk;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int sl = tid + i * kPpThreads, r = sl / kSpan, q = sl % kSpan;
      held[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (sl < 2 * kSub * kSpan && real(r)) {
        const float* p = row_at(r, c0);
        const int e = panel_shift(p);
        if (4 * q < e + len) held[i] = __ldg(reinterpret_cast<const float4*>(p - e) + q);
      }
    }
  };
  auto stash = [&](int chunk, float* st) {
    const int c0 = chunk * kPpChunk, len = d - c0 < kPpChunk ? d - c0 : kPpChunk;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int sl = tid + i * kPpThreads, r = sl / kSpan, q = sl % kSpan;
      if (sl < 2 * kSub * kSpan) {
        const int e = real(r) ? panel_shift(row_at(r, c0)) : 0;
        const float got[4] = {held[i].x, held[i].y, held[i].z, held[i].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = 4 * q + u - e;
          if (col >= 0 && col < kPpChunk) st[r * kPpLd + col] = col < len ? got[u] : 0.0f;
        }
      }
    }
  };
  const int a = lane & 7, b = lane >> 3;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  if (first < last) fetch(first);
  for (int chunk = first; chunk < last; ++chunk) {
    // stage chunk & 1 was last read two chunks ago, before the barrier below
    // of the previous chunk, which every warp has passed
    stash(chunk, stage[chunk & 1]);
    __syncthreads();
    if (chunk + 1 < last) fetch(chunk + 1);  // in flight while this chunk is summed
    const float* xb = stage[chunk & 1];
    const float* xa = xb + 16 * warp * kPpLd;
#pragma unroll 2
    for (int c = 0; c < kPpChunk; c += 4) {
      float4 ak[4], bj[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ak[i] = *reinterpret_cast<const float4*>(xa + (b + 4 * i) * kPpLd + c);
        bj[i] = *reinterpret_cast<const float4*>(xb + (a + 8 * i) * kPpLd + c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(ak[i].x, bj[j].x, acc[i][j]);
          acc[i][j] = fmaf(ak[i].y, bj[j].y, acc[i][j]);
          acc[i][j] = fmaf(ak[i].z, bj[j].z, acc[i][j]);
          acc[i][j] = fmaf(ak[i].w, bj[j].w, acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) grams[(16 * warp + b + 4 * i) * kSub + a + 8 * j] = acc[i][j];
  }
}

// One round of a transposing warp sum: of the 2 O values a lane holds,
// lanes with lane bit X keep [O, 2 O), the others [0, O), each adding its
// partner's (lane ^ X). Templates, so that every index is a constant and
// v stays in registers.
template <int O, int X, int N>
__device__ __forceinline__ void transpose_round(float (&v)[N], int lane) {
  const bool upper = (lane & X) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float keep = upper ? v[i + O] : v[i];
    const float send = upper ? v[i] : v[i + O];
    v[i] = keep + __shfl_xor_sync(kFull, send, X);
  }
}

// One warp, a row a lane: bulk copies of rows [32 v, 32 v + 32) of x (those
// below n), columns [col0, col0 + len) of each, into `slot` (rows at a
// stride of ldp floats, each span widened to 16-byte boundaries); lane 0
// arms `full` with the panel's bytes.
__device__ __forceinline__ void issue_panel(float* slot, uint64_t* full, const float* x, long long n,
                                            long long d, int v, int col0, int len, int ldp, int lane) {
  const long long row = static_cast<long long>(v) * kSub + lane;
  uint32_t bytes = 0;
  const float* src = x;
  if (row < n) {
    const float* p = x + row * d + col0;
    const int e = panel_shift(p);
    src = p - e;
    bytes = static_cast<uint32_t>((e + len + 3) / 4 * 16);
  }
  const uint32_t total = __reduce_add_sync(kFull, bytes);
  if (lane == 0) mbar_expect_tx(full, total);
  if (bytes) bulk_copy(slot + lane * ldp, src, bytes, full);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One consumer lane's share of columns j and j + kFcColumnsAtOnce of a
// panel (the two in flight together): rows g, g + 4, ..., g + 28 of each,
// at offsets ou / oq in the X_{s-1} / X_t panels (us, qs). UPDATE: the
// four lanes of a column sum c_k u_kj over the first mu rows (each its 8
// rows in order, then the four sums in a butterfly, which leaves the same
// bits in all four) and w_j -= that sum, so w is rounded once a sub-tile;
// Q: acc[i] += q_{g+4i,j} w_j over the first mq rows, with the updated w,
// column j first. Every lane of the warp calls it (the shuffles).
__device__ __forceinline__ void panel_pass(float* w, const float* us, const float* qs,
                                           const int (&ou)[kFcRowGroup], const int (&oq)[kFcRowGroup],
                                           const float (&c)[kFcRowGroup], int g, int mu, int mq,
                                           int j, int len, bool upd, bool q,
                                           float (&acc)[kFcRowGroup]) {
  const int j2 = j + kFcColumnsAtOnce;
  const bool la = j < len, lb = j2 < len;
  float wa = la ? w[j] : 0.0f, wb = lb ? w[j2] : 0.0f;
  if (upd) {
    float ua = 0.0f, ub = 0.0f;
#pragma unroll
    for (int i = 0; i < kFcRowGroup; ++i) {
      const bool in = g + kFcGroups * i < mu;
      ua = fmaf(c[i], la && in ? us[ou[i] + j] : 0.0f, ua);
      ub = fmaf(c[i], lb && in ? us[ou[i] + j2] : 0.0f, ub);
    }
    ua += __shfl_xor_sync(kFull, ua, 1);
    ub += __shfl_xor_sync(kFull, ub, 1);
    ua += __shfl_xor_sync(kFull, ua, 2);
    ub += __shfl_xor_sync(kFull, ub, 2);
    wa -= ua;
    wb -= ub;
    if (g == 0) {  // the column's writer
      if (la) w[j] = wa;
      if (lb) w[j2] = wb;
    }
  }
  if (q) {
#pragma unroll
    for (int i = 0; i < kFcRowGroup; ++i) {
      const bool in = g + kFcGroups * i < mq;
      acc[i] = fmaf(la && in ? qs[oq[i] + j] : 0.0f, wa, acc[i]);
      acc[i] = fmaf(lb && in ? qs[oq[i] + j2] : 0.0f, wb, acc[i]);
    }
  }
}

// igd_fold's middle and wide instances, pass 2: a cluster of CTAS CTAs a
// lane (lane blockIdx.y), CTA q owning w's column slice [q * slice, q *
// slice + slice) for the whole fold, in shared memory (W_SHARED) or in the
// lane's output row. Warp 0 runs the chains, warp 4 streams rows in (not
// RESIDENT), the nine consumers (the warps not on warp 0's scheduler) work
// the slice. Step s (s = -1 only prepares sub-tile 0; t = s + 1):
//   warp 0 runs the chain of sub-tile s from r = p_s, G_s, y and alpha in
//   shared memory (chain(), as the Gram instance's), writing c_s; it forms
//   C_t c_s (C_t copied in a step ahead), then waits on its mbarrier for
//   every CTA's partial q_t, sums the CTAS in a fixed tree and sets r = p_t
//   = q_t - C_t c_s. Every CTA runs the same chain from the same p and G,
//   so every CTA holds the same c bit for bit.
//   the consumers copy G_t, C_{t+1}, y_t and alpha_t into shared memory
//   (cp.async) and fetch a sub-tile ahead into L2 (a share of its span a
//   CTA); then, panel by panel (32 rows x `panel` columns of
//   the slice), they apply c_{s-1} to w with X_{s-1}'s panel (w_s) and form
//   their partials of q_t = X_t w_s with X_t's (panel_pass: four lanes a
//   column, two columns at a time); the warps' partials meet in shared
//   memory (one consumer barrier), the first consumer warp sums them in
//   warp order and pushes the CTA's 32 values into its slot of every CTA's
//   receive buffer (st.async into distributed shared memory, completing on
//   the receiver's mbarrier).
//   warp 4 runs ahead through the same sequence of panels (X_{s-1}'s and
//   X_t's of each column chunk, step after step), a ring of ring_slots
//   slots of bulk copies (a row a lane, completing on the slot's full
//   mbarrier; the consumer warps release it on its empty one). x is read
//   twice a sub-tile, the second time (the update's) two steps after the
//   first, from L2; rows stay in shared memory only while a panel is in use.
//   RESIDENT (one panel: the whole slice): sub-tile v's slice stays in slot
//   v % ring_slots from its copy to its update, so x crosses HBM once, and
//   no L2 prefetch runs. Warp 4 copies the sub-tiles in order (bulk copies,
//   a row a lane, completing on the slot's full mbarrier), each into its
//   slot once every consumer warp has released the sub-tile before it there
//   (its empty mbarrier, after that one's update); the consumers wait on
//   full before a sub-tile's q.
// One barrier of warp 0 and the consumers a step. The receive buffers
// alternate by t's parity: a CTA sends q_t only after its warp 0 has read
// q_{t-1} (the barrier ending step s - 1 follows that read), which needed
// every CTA's q_{t-1}, each sent after its own warp 0 had read q_{t-2},
// the slot's last use.
template <int LOSS, int CTAS, bool W_SHARED, bool RESIDENT>
__global__ void __launch_bounds__(kFcThreads)
    igd_fold_cluster_kernel(const float* __restrict__ x, const float* __restrict__ y,
                            const float* __restrict__ alpha, const float* __restrict__ w0,
                            float* __restrict__ wout, const float* __restrict__ grams, long long n,
                            int d, int slice, int panel, int ldp, int ring_slots,
                            long long xy_lane_rows, long long alpha_lane_stride, int lanes_per_xy) {
  extern __shared__ __align__(16) unsigned char fc_smem[];
  const int n_sub = static_cast<int>((n + kSub - 1) / kSub);
  {  // lane blockIdx.y, one cluster a lane: the only change from a one-lane launch
    const long long b = blockIdx.y;
    // the x/y segment lane b reads (32-bit division: b < 65536 and no 64-bit divide call)
    const long long s = static_cast<unsigned>(b) / static_cast<unsigned>(lanes_per_xy);
    x += s * xy_lane_rows * d;
    y += s * xy_lane_rows;
    alpha += b * alpha_lane_stride;
    w0 += b * d;
    wout += b * d;
    grams += (xy_lane_rows > 0 ? s : 0) * n_sub * kGramFloats;  // the segment's pre-pass
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const bool consumer = warp % 4 != 0;
  const int cw = warp - 1 - warp / 4, ct = cw * kWarp + lane;  // a consumer's warp and thread
  uint64_t* recv_bar = reinterpret_cast<uint64_t*>(fc_smem);  // [2]
  uint64_t* full = recv_bar + 2;                               // [ring_slots]
  uint64_t* empty = full + ring_slots;                         // [ring_slots]
  float* recv = reinterpret_cast<float*>(fc_smem + kFcBarBytes);  // [2][CTAS][32]
  float* gram = recv + 2 * CTAS * kSub;                        // [2][32][32], then a row's slack
  float* cbuf = gram + 2 * kSub * kSub + 2 * kSub;             // C: [2][32][32]
  float* ysb = cbuf + 2 * kSub * kSub;                         // [2][64]
  float* asb = ysb + 4 * kSub;                                 // [2][64]
  float* cs = asb + 4 * kSub;                                  // [2][32]
  float* part = cs + 2 * kSub;                                 // [kFcConsumerWarps][32]
  float* ring = part + kFcConsumerWarps * kSub;                // [ring_slots][32][ldp]: panels or sub-tiles
  const int j0 = rank * slice;
  const int cols = d - j0 < slice ? d - j0 : slice;  // > 0: d > (CTAS - 1)^2
  float* w = W_SHARED ? ring + ring_slots * kSub * ldp : wout + j0;
  const int chunks = (cols + panel - 1) / panel;  // column chunks: panel columns, the last fewer
  const int dm = d & 3;
  const uint32_t q_bytes = static_cast<uint32_t>(CTAS * kSub * sizeof(float));
  auto rows_of = [&](int v) {
    const long long left = n - static_cast<long long>(v) * kSub;
    return left < kSub ? static_cast<int>(left) : kSub;
  };
  auto prefetch_sub = [&](int v) {  // this CTA's share of sub-tile v's span into L2
    if (v >= n_sub) return;
    const long long bytes = static_cast<long long>(rows_of(v)) * d * sizeof(float);
    const long long share = (bytes / CTAS + 127) / 128 * 128;
    const char* base = reinterpret_cast<const char*>(x + static_cast<long long>(v) * kSub * d);
    const long long end = (rank + 1) * share < bytes ? (rank + 1) * share : bytes;
    for (long long off = rank * share + 128LL * ct; off < end; off += 128LL * kFcConsumers) {
      prefetch_l2(reinterpret_cast<const float*>(base + off));
    }
  };

  if (tid == 0) {
    mbar_init(recv_bar, 1);
    mbar_init(recv_bar + 1, 1);
    for (int i = 0; i < ring_slots; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kFcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < 2 && t < n_sub; ++t) mbar_expect_tx(recv_bar + t, q_bytes);
  }
  if (consumer) {  // (a cluster barrier follows, so any thread may set any column)
    for (int j = ct; j < cols; j += kFcConsumers) w[j] = w0[j0 + j];
    for (int v = 0; !RESIDENT && v < kFcPrefetchAhead; ++v) prefetch_sub(v);
  }
  cluster.sync();  // barriers set and armed, every CTA of the cluster running

  if (warp == kFcProducerWarp && RESIDENT) {  // every sub-tile's slice, into its slot once it is free
    for (int v = 0; v < n_sub; ++v) {
      const int slot = v % ring_slots;
      if (v >= ring_slots) mbar_wait(empty + slot, static_cast<uint32_t>((v / ring_slots - 1) & 1));
      issue_panel(ring + slot * kSub * ldp, full + slot, x, n, d, v, j0, cols, ldp, lane);
    }
  } else if (warp == kFcProducerWarp) {  // every panel of the fold, in the consumers' order (streamed)
    int seq = 0;
    for (int s = -1; s <= n_sub; ++s) {
      for (int c = 0; c < chunks; ++c) {
        const int col0 = j0 + c * panel, len = cols - c * panel < panel ? cols - c * panel : panel;
        for (int v = s - 1; v <= s + 1; v += 2) {  // X_{s-1}'s panel (the update), then X_{s+1}'s (q)
          if (v == s - 1 ? s < 1 : v >= n_sub) continue;
          const int slot = seq % ring_slots;
          if (seq >= ring_slots) mbar_wait(empty + slot, static_cast<uint32_t>((seq / ring_slots - 1) & 1));
          issue_panel(ring + slot * kSub * ldp, full + slot, x, n, d, v, col0, len, ldp, lane);
          ++seq;
        }
      }
    }
  } else if (consumer) {
    int seq = 0;
    // step s's panels: X_{s-1}'s (UPDATE, if s >= 1) and X_{s+1}'s (Q, if s + 1 < n_sub)
    const int g = lane % kFcGroups;  // this lane's rows of every column: g, g + 4, ..., g + 28
    const int jw = cw * (kWarp / kFcGroups) + lane / kFcGroups;  // and its first column of a panel
    auto panels = [&](int s, float (&acc)[kFcRowGroup]) {
      const bool upd = s >= 1, q = s + 1 < n_sub;
      float c[kFcRowGroup];
#pragma unroll
      for (int i = 0; i < kFcRowGroup; ++i) c[i] = upd ? cs[((s - 1) & 1) * kSub + g + kFcGroups * i] : 0.0f;
      const int mu = upd ? rows_of(s - 1) : 0, mq = q ? rows_of(s + 1) : 0;
      for (int ch = 0; ch < chunks; ++ch) {
        const int col0 = j0 + ch * panel, len = cols - ch * panel < panel ? cols - ch * panel : panel;
        const float* us = ring;
        const float* qs = ring;
        int su = 0, sq = 0;
        if (RESIDENT) {  // sub-tile v in slot v % ring_slots, landed before its q (step v - 1)
          if (upd) us = ring + ((s - 1) % ring_slots) * kSub * ldp;
          if (q) {
            qs = ring + ((s + 1) % ring_slots) * kSub * ldp;
            mbar_wait(full + (s + 1) % ring_slots, static_cast<uint32_t>(((s + 1) / ring_slots) & 1));
          }
        } else if (upd) {
          su = seq % ring_slots;
          mbar_wait(full + su, static_cast<uint32_t>((seq / ring_slots) & 1));
          us = ring + su * kSub * ldp;
          ++seq;
        }
        if (!RESIDENT && q) {
          sq = seq % ring_slots;
          mbar_wait(full + sq, static_cast<uint32_t>((seq / ring_slots) & 1));
          qs = ring + sq * kSub * ldp;
          ++seq;
        }
        const int eu = upd ? panel_shift(x + static_cast<long long>(s - 1) * kSub * d + col0) : 0;
        const int eq = q ? panel_shift(x + static_cast<long long>(s + 1) * kSub * d + col0) : 0;
        // this lane's rows in the two panels (rows 4 apart share their shift)
        int ou[kFcRowGroup], oq[kFcRowGroup];
#pragma unroll
        for (int i = 0; i < kFcRowGroup; ++i) {
          ou[i] = (g + kFcGroups * i) * ldp + ((eu + g * dm) & 3);
          oq[i] = (g + kFcGroups * i) * ldp + ((eq + g * dm) & 3);
        }
        float* wc = w + ch * panel;
        for (int jb = jw - lane / kFcGroups; jb < len; jb += 2 * kFcColumnsAtOnce) {  // warp-uniform
          panel_pass(wc, us, qs, ou, oq, c, g, mu, mq, jb + lane / kFcGroups, len, upd, q, acc);
        }
        __syncwarp();
        if (RESIDENT && lane == 0 && upd) {  // this warp is done with sub-tile s - 1
          mbar_arrive(empty + (s - 1) % ring_slots);
        } else if (!RESIDENT && lane == 0) {  // this warp is done with the chunk's slots
          if (upd) mbar_arrive(empty + su);
          if (q) mbar_arrive(empty + sq);
        }
      }
    };
    for (int s = -1; s < n_sub; ++s) {
      const int t = s + 1;
      if (t + 1 < n_sub) {  // C_{t+1}, which warp 0 reads at the end of the next step
        const float* g = grams + static_cast<long long>(t + 1) * kGramFloats + kSub * kSub;
        float* gd = cbuf + ((t + 1) & 1) * kSub * kSub;
        for (int i = ct; i < kSub * kSub / 4; i += kFcConsumers) cp_async16(gd + 4 * i, g + 4 * i);
      }
      if (t < n_sub) {  // G_t, y_t and alpha_t for the next step's chain
        const float* g = grams + static_cast<long long>(t) * kGramFloats;
        float* gd = gram + (t & 1) * kSub * kSub;
        for (int i = ct; i < kSub * kSub / 4; i += kFcConsumers) cp_async16(gd + 4 * i, g + 4 * i);
        if (ct < kSub) {
          const long long row = static_cast<long long>(t) * kSub + ct;
          if (ct < rows_of(t)) {
            cp_async4(ysb + (t & 1) * 2 * kSub + ct, y + row);
            cp_async4(asb + (t & 1) * 2 * kSub + ct, alpha + row);
          } else {
            ysb[(t & 1) * 2 * kSub + ct] = 0.0f;
            asb[(t & 1) * 2 * kSub + ct] = 0.0f;
          }
        }
      }
      cp_async_commit();
      if (!RESIDENT) prefetch_sub(t + kFcPrefetchAhead);
      float acc[kFcRowGroup];
#pragma unroll
      for (int i = 0; i < kFcRowGroup; ++i) acc[i] = 0.0f;
      panels(s, acc);
      if (t < n_sub) {  // the CTA's q_t: the warps' partials in warp order, to every CTA
        // over the warp's 8 columns (lane bits 2-4): lane l ends with row
        // g + 4 (l / 4) = l
        transpose_round<4, 16>(acc, lane);
        transpose_round<2, 8>(acc, lane);
        transpose_round<1, 4>(acc, lane);
        part[cw * kSub + lane] = acc[0];
        asm volatile("bar.sync 1, %0;\n" ::"n"(kFcConsumers) : "memory");  // the consumers alone
        if (cw == 0) {
          float q = 0.0f;
#pragma unroll
          for (int i = 0; i < kFcConsumerWarps; ++i) q += part[i * kSub + lane];
          const float q1 = __shfl_down_sync(kFull, q, 1);
          const float q2 = __shfl_down_sync(kFull, q, 2);
          const float q3 = __shfl_down_sync(kFull, q, 3);
          if (lane % 4 == 0) {
            const uint32_t dst = smem_u32(recv + ((t & 1) * CTAS + rank) * kSub + lane);
            const uint32_t bar = smem_u32(recv_bar + (t & 1));
            for (int c = 0; c < CTAS; ++c) {
              uint32_t rdst, rbar;
              asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rdst) : "r"(dst), "r"(c));
              asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(bar), "r"(c));
              asm volatile(
                  "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, "
                  "%4}, [%5];\n" ::"r"(rdst),
                  "r"(__float_as_uint(q)), "r"(__float_as_uint(q1)), "r"(__float_as_uint(q2)),
                  "r"(__float_as_uint(q3)), "r"(rbar)
                  : "memory");
            }
          }
        }
      }
      cp_async_wait_all();
      asm volatile("bar.sync 2, %0;\n" ::"n"(kFcStepThreads) : "memory");  // c_s, G_t, C_t+1 visible
    }
    if (n_sub > 0) {  // the last sub-tile's step
      float unused[kFcRowGroup];
      panels(n_sub, unused);
    }
    if (W_SHARED && g == 0) {  // each column by the lane that updated it: no barrier needed
      for (int ch = 0; ch < chunks; ++ch) {
        const int len = cols - ch * panel < panel ? cols - ch * panel : panel;
        for (int j = jw; j < len; j += kFcColumnsAtOnce) wout[j0 + ch * panel + j] = w[ch * panel + j];
      }
    }
  } else if (warp == 0) {  // the chains
    float r = 0.0f;  // lane j holds row j's p of the coming sub-tile
    for (int s = -1; s < n_sub; ++s) {
      const int t = s + 1;
      if (s >= 0) {
        chain<LOSS>(r, gram + (s & 1) * kSub * kSub, ysb + (s & 1) * 2 * kSub,
                    asb + (s & 1) * 2 * kSub, cs + (s & 1) * kSub, rows_of(s), lane);
        __syncwarp();  // every lane's c_s is in shared memory
      }
      if (t < n_sub) {
        float cc = 0.0f;  // (C_t c_s)_lane, formed while the partials of q_t are on their way
        if (s >= 0) {
          const float* cp = cs + (s & 1) * kSub;
          const float* cb = cbuf + (t & 1) * kSub * kSub + lane;
          float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
          for (int k = 0; k < kSub; k += 4) {
            a0 = fmaf(cb[k * kSub], cp[k], a0);
            a1 = fmaf(cb[(k + 1) * kSub], cp[k + 1], a1);
            a2 = fmaf(cb[(k + 2) * kSub], cp[k + 2], a2);
            a3 = fmaf(cb[(k + 3) * kSub], cp[k + 3], a3);
          }
          cc = (a0 + a1) + (a2 + a3);
        }
        mbar_wait(recv_bar + (t & 1), static_cast<uint32_t>((t >> 1) & 1));
        const float* qb = recv + (t & 1) * CTAS * kSub + lane;
        float part_q[CTAS];  // the CTAs' partials, summed as a fixed tree of log2(CTAS) rounds
#pragma unroll
        for (int c = 0; c < CTAS; ++c) part_q[c] = qb[c * kSub];
        static_assert(CTAS >= 1 && CTAS <= 16 && (CTAS & (CTAS - 1)) == 0, "a power of two, at most 16");
        if constexpr (CTAS >= 16) {  // each round written out, so part_q stays in registers
#pragma unroll
          for (int c = 0; c < 8; ++c) part_q[c] += part_q[c + 8];
        }
        if constexpr (CTAS >= 8) {
#pragma unroll
          for (int c = 0; c < 4; ++c) part_q[c] += part_q[c + 4];
        }
        if constexpr (CTAS >= 4) {
#pragma unroll
          for (int c = 0; c < 2; ++c) part_q[c] += part_q[c + 2];
        }
        if constexpr (CTAS >= 2) part_q[0] += part_q[1];
        if (lane == 0 && t + 2 < n_sub) mbar_expect_tx(recv_bar + (t & 1), q_bytes);
        r = part_q[0] - cc;
      }
      asm volatile("bar.sync 2, %0;\n" ::"n"(kFcStepThreads) : "memory");
    }
  }
  cluster.sync();  // no CTA leaves while its partials may still be in flight
}

// One warp, a row a lane: bulk copies of `rows` rows of x, `len` columns of
// each from src (row 0's first column; rows d floats apart), into `slot`
// (rows at a stride of ldp floats, each span widened to 16-byte
// boundaries: the row lands panel_shift floats into its span); lane 0 arms
// `full` with the panel's bytes.
__device__ __forceinline__ void issue_slice_rows(float* slot, uint64_t* full, const float* src, int rows, int len,
                                                 int d, int ldp, int lane) {
  uint32_t bytes = 0;
  for (int r = lane; r < rows; r += kWarp) {
    bytes += static_cast<uint32_t>((panel_shift(src + static_cast<long long>(r) * d) + len + 3) / 4 * 16);
  }
  const uint32_t total = __reduce_add_sync(kFull, bytes);
  if (lane == 0) mbar_expect_tx(full, total);
  for (int r = lane; r < rows; r += kWarp) {
    const float* p = src + static_cast<long long>(r) * d;
    const int e = panel_shift(p);
    bulk_copy(slot + r * ldp, p - e, static_cast<uint32_t>((e + len + 3) / 4 * 16), full);
  }
}

// A barrier of the column-slice kernel's consumer warps alone (id 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kMsConsumers) : "memory");
}

// Pass 1 of the column-slice kernel over one panel: consumer warp cw takes
// its rows r = cw, cw + 16, ... (GROUP at once, w read once for them),
// lanes across the panel's len columns (row r at r * ldp plus its shift,
// which moves by d mod 4 from row to row), each row's sum in 4 / GROUP
// interleaved partials, then summed across the lanes (the GROUP rows'
// butterflies interleaved), and sets mg[r] to the warp's sum (or adds it,
// for a later column chunk of the same rows).
template <int GROUP>
__device__ __forceinline__ void slice_margins(const float* xs, const float* wc, float* mg, int rows, int len, int ldp,
                                              int e0, int dm, bool add, int cw, int lane) {
  constexpr int kParts = 4 / GROUP;
  for (int r = cw; r < rows; r += kMsConsumerWarps * GROUP) {
    const float* xr[GROUP];
    float acc[GROUP][kParts];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int rr = r + kMsConsumerWarps * i < rows ? r + kMsConsumerWarps * i : r;  // past the rows: r again
      xr[i] = xs + rr * ldp + ((e0 + rr * dm) & 3);
#pragma unroll
      for (int k = 0; k < kParts; ++k) acc[i][k] = 0.0f;
    }
    int j = lane;
    for (; j + (kParts - 1) * kWarp < len; j += kParts * kWarp) {
#pragma unroll
      for (int k = 0; k < kParts; ++k) {
        const float wj = wc[j + k * kWarp];
#pragma unroll
        for (int i = 0; i < GROUP; ++i) acc[i][k] = fmaf(xr[i][j + k * kWarp], wj, acc[i][k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kParts; ++k) {
      if (j + k * kWarp < len) {
        const float wj = wc[j + k * kWarp];
#pragma unroll
        for (int i = 0; i < GROUP; ++i) acc[i][k] = fmaf(xr[i][j + k * kWarp], wj, acc[i][k]);
      }
    }
    float sum[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      sum[i] = acc[i][0];
#pragma unroll
      for (int k = 1; k < kParts; ++k) sum[i] += acc[i][k];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < GROUP; ++i) sum[i] += __shfl_xor_sync(kFull, sum[i], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const int rr = r + kMsConsumerWarps * i;
        if (rr < rows) mg[rr] = add ? mg[rr] + sum[i] : sum[i];
      }
    }
  }
}

// Pass 2 of the column-slice kernel: the sum over rows [r0, r1) in order
// of c_r x_rj for column j of a chunk (and, with `two`, for column j +
// kMsConsumers into u1), its rows either in a resident slot (FROM_L2
// false: row r at r * ldp plus its shift, which moves by d mod 4 from row
// to row) or in global memory, where pass 1 left them in L2 (xg: row 0's
// first column of the chunk, rows d floats apart). Sixteen rows' loads
// are issued before their FMAs.
template <bool FROM_L2>
__device__ __forceinline__ void slice_update(const float* xs, const float* xg, const float* cs, int r0, int r1,
                                             int ldp, int e0, int dm, long long d, int j, bool two, float& u0,
                                             float& u1) {
  auto at = [&](int r) {
    if constexpr (FROM_L2) {
      return xg + r * d + j;
    } else {
      return xs + r * ldp + ((e0 + r * dm) & 3) + j;
    }
  };
  auto load = [&](const float* p) {
    if constexpr (FROM_L2) {
      return __ldcg(p);
    } else {
      return *p;
    }
  };
  int r = r0;
  for (; r + 16 <= r1; r += 16) {
    float a[16], b[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      a[k] = load(at(r + k));
      b[k] = two ? load(at(r + k) + kMsConsumers) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      u0 = fmaf(cs[r + k], a[k], u0);
      if (two) u1 = fmaf(cs[r + k], b[k], u1);
    }
  }
  for (; r < r1; ++r) {
    u0 = fmaf(cs[r], load(at(r)), u0);
    if (two) u1 = fmaf(cs[r], load(at(r) + kMsConsumers), u1);
  }
}

// Consumer threads 0-63: this CTA's 256 partial margins into its slot
// [rank] of every CTA's receive buffer for the tile's parity, four rows a
// 16-byte st.async, each completing on the receiver's own mbarrier.
__device__ __forceinline__ void push_margins(const float* margins, float* recv, uint64_t* recv_bar, int half,
                                             int rank, int ct) {
  if (ct >= kTile / 4) return;
  const float4 v = reinterpret_cast<const float4*>(margins)[ct];
  const uint32_t dst = smem_u32(recv + (half * kMsCluster + rank) * kTile + 4 * ct);
  const uint32_t bar = smem_u32(recv_bar + half);
#pragma unroll
  for (int q = 0; q < kMsCluster; ++q) {
    uint32_t rdst, rbar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rdst) : "r"(dst), "r"(q));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(bar), "r"(q));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(rdst),
        "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)),
        "r"(rbar)
        : "memory");
  }
}

// Consumer thread r < 256: waits for every CTA's partials of the tile,
// sums row r's in rank order and sets c_r = grad_scale(m_r, y_r) * alpha_r
// (0 past the tile's rows); thread 0 then arms the buffer for tile t + 2.
template <int LOSS>
__device__ __forceinline__ void take_margins(const float* recv, uint64_t* recv_bar, float* cs, int half,
                                             uint32_t phase, int rows, float yv, float av, int ct, bool rearm) {
  if (ct >= kTile) return;
  mbar_wait(recv_bar + half, phase);
  const float* p = recv + half * kMsCluster * kTile + ct;
  float m = p[0];
#pragma unroll
  for (int q = 1; q < kMsCluster; ++q) m += p[q * kTile];
  cs[ct] = ct < rows ? grad_scale<LOSS>(m, yv) * av : 0.0f;
  if (ct == 0 && rearm) mbar_expect_tx(recv_bar + half, static_cast<uint32_t>(kMsCluster * kTile * sizeof(float)));
}

// igd_fold_minibatch past kMbMaxDim: the column-slice cluster. A cluster
// of kMsCluster CTAs a lane (lane blockIdx.y), CTA q owning w's column
// slice [q * slice, q * slice + cols) for the whole fold, in shared memory
// (W_SHARED) or in the lane's output row. Per tile:
//   the rows: RESIDENT (prows == 256: the tile's slice fits twice): the
//   consumers copy tile t + 1's slice into the other of two slots with
//   16-byte cp.async while they work tile t, and both passes read the
//   slot. Streamed: warp kMsConsumerWarps (the producer) keeps a ring of
//   `slots` panels (prows rows x `panel` columns of the slice; row panels
//   outer, column chunks inner) full with bulk copies, a row a lane, each
//   span widened to 16-byte boundaries, completing on the slot's full
//   mbarrier; each consumer warp releases a slot on its empty one.
//   pass 1 (margins): warp cw takes a panel's rows cw, cw + 16, ...
//   (slice_margins), lanes across the columns with the tile-start w, its
//   warp sums into margins[r], column chunk after chunk in order;
//   the exchange: one consumer barrier; threads 0-63 push the CTA's 256
//   partial margins, four rows a 16-byte st.async, into slot [rank] of
//   every CTA's receive buffer for the tile's parity, completing on the
//   receiver's own mbarrier; thread r < 256 waits on its own CTA's, sums
//   row r's kMsCluster partials in rank order (every CTA the same bits)
//   and sets c_r = grad_scale(m_r, y_r) * alpha_r (y_r and alpha_r loaded
//   at the tile's start); one consumer barrier;
//   pass 2 (update, slice_update): column chunks in order, a thread a
//   column (two past kMsConsumers columns) summing c_r x_rj over the
//   tile's rows in order, or, where a chunk is at most half the consumers
//   wide, over one of `groups` contiguous blocks of rows, the blocks'
//   sums then added in block order; w_j -= sum / 256; a streamed tile's
//   rows are read from global memory, where pass 1 left them in L2. One
//   consumer barrier ends the tile.
// The receive buffers alternate by tile parity: a CTA sends tile t + 2's
// partials only after its update of t + 1, which needed every CTA's
// margins of t + 1, each sent after that CTA had read its buffer of t.
template <int LOSS, bool W_SHARED>
__global__ void __launch_bounds__(kMsThreads, 1)
    igd_minibatch_slice_kernel(const float* __restrict__ x, const float* __restrict__ y,
                               const float* __restrict__ alpha, const float* __restrict__ w0,
                               float* __restrict__ wout, long long n, int d, int slice, int panel,
                               int ldp, int prows, int slots, long long xy_lane_rows,
                               long long alpha_lane_stride, int lanes_per_xy) {
  extern __shared__ __align__(16) unsigned char ms_smem[];
  {  // lane blockIdx.y, one cluster a lane: the only change from a one-lane launch
    const long long b = blockIdx.y;
    // the x/y segment lane b reads (32-bit division: b < 65536 and no 64-bit divide call)
    const long long s = static_cast<unsigned>(b) / static_cast<unsigned>(lanes_per_xy);
    x += s * xy_lane_rows * d;
    y += s * xy_lane_rows;
    alpha += b * alpha_lane_stride;
    w0 += b * d;
    wout += b * d;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  uint64_t* recv_bar = reinterpret_cast<uint64_t*>(ms_smem);  // [2]
  uint64_t* full = recv_bar + 2;                               // [slots]
  uint64_t* empty = full + slots;                              // [slots]
  float* recv = reinterpret_cast<float*>(ms_smem + kMsBarBytes);  // [2][kMsCluster][256]
  float* margins = recv + 2 * kMsCluster * kTile;                 // [256]
  float* cs = margins + kTile;                                    // [256]
  float* sums = cs + kTile;                                       // [kMsConsumers]
  float* ring = sums + kMsConsumers;                              // [slots][prows][ldp]
  const int j0 = rank * slice;
  const int cols = d - j0 < slice ? d - j0 : slice;  // > 0: d > kMbMaxDim
  float* w = W_SHARED ? ring + slots * prows * ldp : wout + j0;
  const int chunks = (cols + panel - 1) / panel;
  const bool resident = prows == kTile;  // (one chunk: the host's geometry)
  const int dm = d & 3;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const uint32_t recv_bytes = static_cast<uint32_t>(kMsCluster * kTile * sizeof(float));
  auto tile_rows = [&](long long t) {
    const long long left = n - t * kTile;
    return left < kTile ? static_cast<int>(left) : kTile;
  };

  if (tid == 0) {
    mbar_init(recv_bar, 1);
    mbar_init(recv_bar + 1, 1);
    for (int i = 0; i < slots; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kMsConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < 2 && t < n_tiles; ++t) mbar_expect_tx(recv_bar + t, recv_bytes);
  }
  if (warp < kMsConsumerWarps) {  // (a cluster barrier follows, so any thread may set any column)
    for (int j = tid; j < cols; j += kMsConsumers) w[j] = w0[j0 + j];
  }
  cluster.sync();  // barriers set and armed, every CTA of the cluster running

  if (warp == kMsConsumerWarps && !resident) {  // the producer: pass 1's panels, in order
    int seq = 0;
    auto issue = [&](long long row0, int p, int ch, int rows) {
      const int slot = seq % slots;
      if (seq >= slots) mbar_wait(empty + slot, static_cast<uint32_t>((seq / slots - 1) & 1));
      const int rp = rows - p * prows < prows ? rows - p * prows : prows;
      const int len = cols - ch * panel < panel ? cols - ch * panel : panel;
      issue_slice_rows(ring + slot * prows * ldp, full + slot, x + (row0 + p * prows) * d + j0 + ch * panel,
                       rp, len, d, ldp, lane);
      ++seq;
    };
    for (long long t = 0; t < n_tiles; ++t) {
      const int rows = tile_rows(t), np = (rows + prows - 1) / prows;
      for (int p = 0; p < np; ++p) {
        for (int ch = 0; ch < chunks; ++ch) issue(t * kTile, p, ch, rows);
      }
    }
  } else if (warp < kMsConsumerWarps) {
    const int cw = warp, ct = tid;
    int seq = 0;
    auto next_slot = [&]() {  // wait for the sequence's next panel
      const int slot = seq % slots;
      mbar_wait(full + slot, static_cast<uint32_t>((seq / slots) & 1));
      ++seq;
      return ring + slot * prows * ldp;
    };
    auto release = [&](const float* xs) {  // this warp is done with the slot
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (xs - ring) / (prows * ldp));
    };
    // tile t's slice into slot t & 1 by 16-byte cp.async, one group: a
    // warp a row at a time (rows cw, cw + 16, ...), a lane a 16-byte chunk
    // of the row's span (at most 24 of them: slice <= 89)
    auto fetch_tile = [&](long long t) {
      if (t < n_tiles) {
        const int rows = tile_rows(t);
        for (int r = cw; r < rows; r += kMsConsumerWarps) {
          const float* p = x + (t * kTile + r) * d + j0;
          const int e = panel_shift(p);
          if (4 * lane < e + cols) cp_async16(ring + ((t & 1) * kTile + r) * ldp + 4 * lane, p - e + 4 * lane);
        }
      }
      cp_async_commit();
    };
    if (resident) fetch_tile(0);
    for (long long t = 0; t < n_tiles; ++t) {
      const long long row0 = t * kTile;
      const int rows = tile_rows(t), np = (rows + prows - 1) / prows;
      const int half = static_cast<int>(t & 1);
      float yv = 0.0f, av = 0.0f;  // row ct's, for c after the exchange
      if (ct < rows) {
        yv = y[row0 + ct];
        av = alpha[row0 + ct];
      }
      if (resident) {  // tile t landed (each thread's copies), then every thread's; tile t + 1 on its way
        fetch_tile(t + 1);
        cp_async_wait_one();
        consumers_sync();
      }
      // pass 1: this CTA's partial margins of the tile's rows
      const float* kept = nullptr;  // RESIDENT: the tile's slot, kept for pass 2
      for (int p = 0; p < np; ++p) {
        const int rp = rows - p * prows < prows ? rows - p * prows : prows;
        for (int ch = 0; ch < chunks; ++ch) {
          const float* xs = resident ? ring + (t & 1) * kTile * ldp : next_slot();
          const int len = cols - ch * panel < panel ? cols - ch * panel : panel;
          const int e0 = panel_shift(x + (row0 + p * prows) * d + j0 + ch * panel);
          if (prows >= kMsConsumerWarps * 4) {
            slice_margins<4>(xs, w + ch * panel, margins + p * prows, rp, len, ldp, e0, dm, ch > 0, cw, lane);
          } else if (prows >= kMsConsumerWarps * 2) {
            slice_margins<2>(xs, w + ch * panel, margins + p * prows, rp, len, ldp, e0, dm, ch > 0, cw, lane);
          } else {
            slice_margins<1>(xs, w + ch * panel, margins + p * prows, rp, len, ldp, e0, dm, ch > 0, cw, lane);
          }
          if (resident) {
            kept = xs;
          } else {
            release(xs);
          }
        }
      }
      consumers_sync();  // margins complete
      push_margins(margins, recv, recv_bar, half, rank, ct);
      take_margins<LOSS>(recv, recv_bar, cs, half, static_cast<uint32_t>((t >> 1) & 1), rows, yv, av, ct,
                         t + 2 < n_tiles);
      consumers_sync();  // c complete
      // pass 2: w -= (c X_t) / 256, column by column over the tile's rows in
      // order; where a chunk is at most half the consumers wide, its rows in
      // `groups` contiguous blocks, a thread a (block, column), the blocks'
      // sums then added in block order
      for (int ch = 0; ch < chunks; ++ch) {
        const int len = cols - ch * panel < panel ? cols - ch * panel : panel;
        const int cpg = (len + kWarp - 1) / kWarp * kWarp;
        const int groups = 2 * cpg <= kMsConsumers ? kMsConsumers / cpg : 1;
        const int g = ct / cpg, j = groups > 1 ? ct - g * cpg : ct, rb = (rows + groups - 1) / groups;
        const int r0 = g * rb, r1 = rows < r0 + rb ? rows : r0 + rb;
        const int e0 = panel_shift(x + row0 * d + j0 + ch * panel);
        float u0 = 0.0f, u1 = 0.0f;
        if (g < groups && j < len) {
          if (resident) {
            slice_update<false>(kept, nullptr, cs, r0, r1, ldp, e0, dm, d, j, false, u0, u1);
          } else {
            slice_update<true>(nullptr, x + row0 * d + j0 + ch * panel, cs, r0, r1, ldp, e0, dm, d, j,
                               groups == 1 && j + kMsConsumers < len, u0, u1);
          }
        }
        float* wc = w + ch * panel;
        if (groups > 1) {
          if (g < groups) sums[ct] = u0;
          consumers_sync();
          if (ct < len) {
            for (int k = 1; k < groups; ++k) u0 += sums[k * cpg + ct];
          }
        }
        if (ct < len) wc[ct] = wc[ct] - u0 / static_cast<float>(kTile);
        if (groups == 1 && ct + kMsConsumers < len) {
          wc[ct + kMsConsumers] = wc[ct + kMsConsumers] - u1 / static_cast<float>(kTile);
        }
      }
      consumers_sync();  // w complete for the next tile's margins
    }
    if (W_SHARED) {  // each column by the thread that updated it
      for (int ch = 0; ch < chunks; ++ch) {
        const int len = cols - ch * panel < panel ? cols - ch * panel : panel;
        for (int j = ct; j < len; j += kMsConsumers) wout[j0 + ch * panel + j] = w[ch * panel + j];
      }
    }
  }
  cluster.sync();  // no CTA leaves while its partials may still be in flight
}

// Cycles of `steps` tiles of igd_minibatch_slice_kernel's dependent
// skeleton with no row traffic: the consumer barrier, the push of 256
// partial margins to every CTA, the wait, the 16-way sums and c, the
// consumer barrier. out[0] = rank 0's cycles, out[1] = a c's bits.
template <int LOSS>
__global__ void __launch_bounds__(kMsThreads, 1) igd_minibatch_slice_step_probe_kernel(int steps, long long* out) {
  extern __shared__ __align__(16) unsigned char ms_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  uint64_t* recv_bar = reinterpret_cast<uint64_t*>(ms_smem);
  float* recv = reinterpret_cast<float*>(ms_smem + kMsBarBytes);
  float* margins = recv + 2 * kMsCluster * kTile;
  float* cs = margins + kTile;
  const uint32_t recv_bytes = static_cast<uint32_t>(kMsCluster * kTile * sizeof(float));
  if (tid == 0) {
    mbar_init(recv_bar, 1);
    mbar_init(recv_bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < 2 && t < steps; ++t) mbar_expect_tx(recv_bar + t, recv_bytes);
  }
  if (tid < kTile) cs[tid] = 0.0f;
  cluster.sync();
  const long long t0 = clock64();
  if (tid < kMsConsumers) {
    for (int t = 0; t < steps; ++t) {
      if (tid < kTile) margins[tid] = cs[(tid + t) % kTile] + 0.01f;
      consumers_sync();
      push_margins(margins, recv, recv_bar, t & 1, rank, tid);
      take_margins<LOSS>(recv, recv_bar, cs, t & 1, static_cast<uint32_t>((t >> 1) & 1), kTile,
                         (tid & 1) ? 1.0f : -1.0f, 0.01f, tid, t + 2 < steps);
      consumers_sync();
    }
  }
  const long long t1 = clock64();
  cluster.sync();
  if (rank == 0 && tid == 0) {
    out[0] = t1 - t0;
    out[1] = __float_as_int(cs[0]);
  }
}

// Lane strides that keep every lane's x, y and alpha on the base pointers'
// 16-byte boundaries (whole floats of 4).
__host__ __device__ constexpr bool lanes_keep_16(long long xy_lane_rows, long long alpha_lane_stride,
                                                 int d) {
  return (xy_lane_rows * d) % 4 == 0 && xy_lane_rows % 4 == 0 && alpha_lane_stride % 4 == 0;
}

template <int LOSS, int VPL, bool RESIDENT>
cudaError_t launch_mb_cluster(const float* x, const float* y, const float* alpha,
                              const float* w0, float* wout, long long n, int d,
                              long long* probe, int lanes, long long xy_lane_rows,
                              long long alpha_lane_stride, int lanes_per_xy,
                              cudaStream_t stream) {
  const int stages = mb_stages(d);
  if (stages < 2) return cudaErrorInvalidValue;
  const int vec = !RESIDENT && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(alpha) % 16 == 0 &&
                  lanes_keep_16(xy_lane_rows, alpha_lane_stride, d);
  const size_t smem = mb_smem_bytes(d, stages);
  auto kernel = igd_minibatch_cluster_kernel<LOSS, VPL, RESIDENT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (kMbCluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMbCluster, lanes, 1);
  cfg.blockDim = dim3(kMbThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMbCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, y, alpha, w0, wout, n, d, stages, vec, probe,
                           xy_lane_rows, alpha_lane_stride, lanes_per_xy);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int LOSS, bool RESIDENT>
cudaError_t launch_mb_cluster_any(const float* x, const float* y, const float* alpha,
                                  const float* w0, float* wout, long long n, int d,
                                  long long* probe, int lanes, long long xy_lane_rows,
                                  long long alpha_lane_stride, int lanes_per_xy,
                                  cudaStream_t stream) {
#define REPRO_MB_CASE(V)                                                                   \
  return launch_mb_cluster<LOSS, V, RESIDENT>(x, y, alpha, w0, wout, n, d, probe, lanes, \
                                              xy_lane_rows, alpha_lane_stride,         \
                                              lanes_per_xy, stream)
  if (d <= 32) REPRO_MB_CASE(1);
  if (d <= 64) REPRO_MB_CASE(2);
  if (d <= 128) REPRO_MB_CASE(4);
  REPRO_MB_CASE(8);
#undef REPRO_MB_CASE
}

// A launch of `grid` blocks of `threads` threads in clusters of `cluster`
// along x, `smem` bytes of dynamic shared memory a block: the kernel's
// attributes set, and the configuration in cfg (its attribute in attr),
// for a launch or an occupancy query.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, dim3 grid, int cluster, int threads, size_t smem,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = {};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// `lanes` clusters of `cluster` CTAs (gridDim = (cluster, lanes)).
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int cluster, int threads, int lanes, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_config(kernel, dim3(cluster, lanes, 1), cluster, threads, smem, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The column-slice instance's geometry at D (slice = ceil(D / kMsCluster)
// columns a CTA): RESIDENT where a tile's slice (256 rows) fits twice
// beside the rest, as one panel a slot; else panels of the fewest column
// chunks of at most kMsMaxPanel columns (so the fewest, largest bulk
// copies) and of the most rows (128 down to kMsMinRows) that leave a ring
// of kMsRingMin slots (kMsMinRows where none does: 3 slots at D 12,033);
// the ring then takes as many slots as fit, up to kMsRingMax (resident:
// two slots, this tile and the next). {panel columns, row stride in floats,
// rows a panel, slots, bytes a CTA}.
struct SlicePanels {
  int panel, ldp, prows, slots;
  size_t smem;
};

SlicePanels slice_panels(int slice) {
  const size_t fixed = slice_fixed_bytes(slice);
  const size_t room = kSmemOptIn - fixed;
  int panel = slice, prows = kTile;
  if (!slice_resident(slice)) {
    const int chunks = (slice + kMsMaxPanel - 1) / kMsMaxPanel;
    panel = (slice + chunks - 1) / chunks;
    prows = kTile / 2;
    while (prows > kMsMinRows && room / slice_slot_bytes(prows, span_ld(panel)) < kMsRingMin) prows /= 2;
  }
  const int ldp = span_ld(panel);
  const size_t fit = room / slice_slot_bytes(prows, ldp);
  const int slots = prows == kTile ? 2 : fit < kMsRingMax ? static_cast<int>(fit) : kMsRingMax;
  return {panel, ldp, prows, slots, fixed + slots * slice_slot_bytes(prows, ldp)};
}

template <int LOSS>
cudaError_t launch_mb_slice(const float* x, const float* y, const float* alpha, const float* w0, float* wout,
                            long long n, int d, int lanes, long long xy_lane_rows, long long alpha_lane_stride,
                            int lanes_per_xy, cudaStream_t stream) {
  const int slice = (d + kMsCluster - 1) / kMsCluster;
  const SlicePanels pn = slice_panels(slice);
  if (slice <= kMsSmemMaxSlice) {
    return launch_cluster(igd_minibatch_slice_kernel<LOSS, true>, kMsCluster, kMsThreads, lanes, pn.smem, stream,
                          x, y, alpha, w0, wout, n, d, slice, pn.panel, pn.ldp, pn.prows, pn.slots, xy_lane_rows,
                          alpha_lane_stride, lanes_per_xy);
  }
  return launch_cluster(igd_minibatch_slice_kernel<LOSS, false>, kMsCluster, kMsThreads, lanes, pn.smem, stream, x,
                        y, alpha, w0, wout, n, d, slice, pn.panel, pn.ldp, pn.prows, pn.slots, xy_lane_rows,
                        alpha_lane_stride, lanes_per_xy);
}

template <int LOSS>
cudaError_t launch_minibatch(const float* x, const float* y, const float* alpha, const float* w0,
                             float* wout, long long n, int d, int lanes, long long xy_lane_rows,
                             long long alpha_lane_stride, int lanes_per_xy, cudaStream_t stream) {
  if (d > kMbMaxDim) {
    return launch_mb_slice<LOSS>(x, y, alpha, w0, wout, n, d, lanes, xy_lane_rows, alpha_lane_stride,
                                 lanes_per_xy, stream);
  }
  return launch_mb_cluster_any<LOSS, false>(x, y, alpha, w0, wout, n, d, nullptr, lanes, xy_lane_rows,
                                            alpha_lane_stride, lanes_per_xy, stream);
}

template <int LOSS>
cudaError_t launch_gram(const float* x, const float* y, const float* alpha, const float* w0,
                        float* wout, long long n, int d, int lanes, long long xy_lane_rows,
                        long long alpha_lane_stride, int lanes_per_xy, cudaStream_t stream) {
  int ld = (d + 3) & ~3;  // 16-byte rows at an odd multiple of 16 bytes: no bank conflicts
  if ((ld / 4) % 2 == 0) ld += 4;
  int tile_rows = kGramStageFloats / (ld + 2) / kSub * kSub;  // 64 or more for D <= 256
  if (tile_rows > kGramMaxTileRows) tile_rows = kGramMaxTileRows;
  const int stage_floats = (tile_rows * (ld + 2) + 3) / 4 * 4;
  // 8-byte copies (a lane's rows start xy_lane_rows * d floats on: even for even d)
  const int vec = d % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  const size_t smem = (2 * static_cast<size_t>(stage_floats) + 2 * kSub * kSub +
                       2 * kProductRows * kSub + ld + 2 * kSub) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      igd_fold_gram_kernel<LOSS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  igd_fold_gram_kernel<LOSS><<<lanes, kGramThreads, smem, stream>>>(
      x, y, alpha, w0, wout, n, d, ld, tile_rows, stage_floats, vec, xy_lane_rows,
      alpha_lane_stride, lanes_per_xy);
  return cudaGetLastError();
}

// The tables a lane launch reads: one shared table (xy_lane_rows 0), or
// a segment for each lanes_per_xy lanes.
int fold_segments(int lanes, long long xy_lane_rows, int lanes_per_xy) {
  return xy_lane_rows > 0 ? lanes / lanes_per_xy : 1;
}

// Pre-pass blocks a sub-tile at D: kPpSplit for the wide instance, one (no
// sum launch) for the middle one.
int prepass_split(int d) { return d > kFoldMaxDim ? kPpSplit : 1; }

// The cluster instances' scratch: the pre-pass's partial G | C blocks of
// every segment's sub-tiles (64 floats a row a part), then, with more than
// one part, their sums; none at D <= kGramMaxDim.
long long fold_scratch_floats(long long n, int d, int lanes, long long xy_lane_rows,
                              int lanes_per_xy) {
  if (d <= kGramMaxDim) return 0;
  const int split = prepass_split(d);
  return static_cast<long long>(fold_segments(lanes, xy_lane_rows, lanes_per_xy)) *
         ((n + kSub - 1) / kSub) * kGramFloats * (split > 1 ? split + 1 : 1);
}

// A cluster instance's geometry: {CTAs a lane, panel columns, row stride in
// floats, slots (panels of the ring, or resident sub-tiles), bytes a CTA}.
struct FoldPanels {
  int ctas, panel, ldp, slots;
  size_t smem;
};

// A panel's row stride: a span of `panel` floats widened by up to 3, to
// whole float4s, then to 8 mod 32, where the consumers' loads miss each
// other's banks.
constexpr int panel_ld(int panel) {
  const int ldp = (panel + 3 + 3) / 4 * 4;
  return ldp + (8 - ldp % 32 + 32) % 32;
}

// The streamed geometry of a slice on a cluster of `ctas` CTAs (the wide
// instance's, kFcCluster): the fewest column chunks a slice (so the
// fewest, largest bulk copies) whose panels leave a ring of at least
// kFcRingMin slots in the shared memory that w's slice and the rest leave
// free; the ring then takes as many slots as fit, up to kFcRingMax.
FoldPanels fold_panels(int slice, int ctas) {
  const size_t fixed = kFcBarBytes + (fc_fixed_floats(ctas) + (slice <= kFcSmemMaxSlice ? slice : 0)) *
                                         sizeof(float);
  for (int chunks = 1;; ++chunks) {
    const int panel = (slice + chunks - 1) / chunks;
    const int ldp = panel_ld(panel);
    const size_t slot = static_cast<size_t>(kSub) * ldp * sizeof(float);
    const long long fit = (static_cast<long long>(kSmemOptIn) - static_cast<long long>(fixed)) /
                          static_cast<long long>(slot);
    if (fit >= kFcRingMin) {
      const int slots = fit < kFcRingMax ? static_cast<int>(fit) : kFcRingMax;
      return {ctas, panel, ldp, slots, fixed + slots * slot};
    }
  }
}

// The middle instance's geometry at D: middle_ctas(D) CTAs, each slice one
// panel, kFmSlots resident sub-tiles.
constexpr FoldPanels middle_panels(int d) {
  const int ctas = middle_ctas(d), slice = (d + ctas - 1) / ctas, ldp = panel_ld(slice);
  const size_t fixed = kFcBarBytes + (fc_fixed_floats(ctas) + static_cast<size_t>(slice)) * sizeof(float);
  return {ctas, slice, ldp, kFmSlots, fixed + kFmSlots * static_cast<size_t>(kSub) * ldp * sizeof(float)};
}

constexpr bool middle_fits() {
  for (int d = kGramMaxDim + 1; d <= kFoldMaxDim; ++d) {
    if (middle_panels(d).smem > kSmemOptIn) return false;
  }
  return true;
}
static_assert(middle_fits(), "kFmSlots resident sub-tiles fit at every middle D");
static_assert((2 + 2 * kFmSlots) * 8 <= kFcBarBytes, "the middle's mbarriers fit their header");

// The wide pre-pass's parts summed in part order into the scratch's G | C
// blocks: floats [total) of sums from [total / kGramFloats][kPpSplit][kGramFloats].
__global__ void igd_fold_gram_sum_kernel(const float* __restrict__ parts, float* __restrict__ sums,
                                         long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* p = parts + (i / kGramFloats) * kPpSplit * kGramFloats + i % kGramFloats;
  float acc = p[0];
#pragma unroll
  for (int k = 1; k < kPpSplit; ++k) acc += p[k * kGramFloats];
  sums[i] = acc;
}

template <int LOSS, int CTAS, bool W_SHARED, bool RESIDENT>
cudaError_t launch_fold_cluster(const FoldPanels& pn, const float* x, const float* y, const float* alpha,
                                const float* w0, float* wout, const float* grams, long long n, int d, int lanes,
                                long long xy_lane_rows, long long alpha_lane_stride, int lanes_per_xy,
                                cudaStream_t stream) {
  return launch_cluster(igd_fold_cluster_kernel<LOSS, CTAS, W_SHARED, RESIDENT>, CTAS, kFcThreads, lanes, pn.smem,
                        stream, x, y, alpha, w0, wout, grams, n, d, (d + CTAS - 1) / CTAS, pn.panel, pn.ldp, pn.slots,
                        xy_lane_rows, alpha_lane_stride, lanes_per_xy);
}

// igd_fold past kGramMaxDim: the pre-pass (and, for the wide instance, the
// sum of its parts), then the cluster kernel, middle or wide by D.
template <int LOSS>
cudaError_t launch_fold_clustered(const float* x, const float* y, const float* alpha,
                                  const float* w0, float* wout, long long n, int d, int lanes,
                                  long long xy_lane_rows, long long alpha_lane_stride,
                                  int lanes_per_xy, float* scratch, cudaStream_t stream) {
  const int segments = fold_segments(lanes, xy_lane_rows, lanes_per_xy);
  const long long n_sub = (n + kSub - 1) / kSub;
  const int split = prepass_split(d);
  const long long sums_at = split > 1 ? segments * n_sub * kGramFloats * split : 0;  // where the sums start
  if (n > 0) {  // pass 1: every segment's G and C, over the whole card
    if (scratch == nullptr) return cudaErrorInvalidValue;
    igd_fold_gram_prepass_kernel<<<dim3(static_cast<unsigned>(n_sub), segments, split),
                                   kPpThreads, 0, stream>>>(x, scratch, n, d, xy_lane_rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (split > 1) {
      const long long total = segments * n_sub * kGramFloats;
      igd_fold_gram_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
          scratch, scratch + sums_at, total);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  const float* grams = scratch == nullptr ? nullptr : scratch + sums_at;
#define REPRO_FOLD_CLUSTER(C, S, R)                                                                      \
  return launch_fold_cluster<LOSS, C, S, R>(pn, x, y, alpha, w0, wout, grams, n, d, lanes, xy_lane_rows, \
                                            alpha_lane_stride, lanes_per_xy, stream)
  if (d > kFoldMaxDim) {
    const FoldPanels pn = fold_panels((d + kFcCluster - 1) / kFcCluster, kFcCluster);
    if ((d + kFcCluster - 1) / kFcCluster <= kFcSmemMaxSlice) REPRO_FOLD_CLUSTER(kFcCluster, true, false);
    REPRO_FOLD_CLUSTER(kFcCluster, false, false);
  }
  const FoldPanels pn = middle_panels(d);
  switch (pn.ctas) {
    case 1:
      REPRO_FOLD_CLUSTER(1, true, true);
    case 2:
      REPRO_FOLD_CLUSTER(2, true, true);
    case 4:
      REPRO_FOLD_CLUSTER(4, true, true);
    case 8:
      REPRO_FOLD_CLUSTER(8, true, true);
    case 16:
      REPRO_FOLD_CLUSTER(16, true, true);
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FOLD_CLUSTER
}

// Clusters of a cluster instance of igd_fold (`smem` bytes a CTA) that the
// card can hold at once, the least over the losses
// (cudaOccupancyMaxActiveClusters); -1 on an error.
template <int CTAS, bool W_SHARED, bool RESIDENT>
int fold_clusters_fit(size_t smem) {
  int least = -1;
  auto fit = [&](auto kernel) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int n = 0;
    if (cluster_config(kernel, dim3(CTAS, 1, 1), CTAS, kFcThreads, smem, nullptr, &cfg, &attr) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
      return false;
    least = least < 0 || n < least ? n : least;
    return true;
  };
  if (!fit(igd_fold_cluster_kernel<kLossLr, CTAS, W_SHARED, RESIDENT>) ||
      !fit(igd_fold_cluster_kernel<kLossSvm, CTAS, W_SHARED, RESIDENT>) ||
      !fit(igd_fold_cluster_kernel<kLossLsq, CTAS, W_SHARED, RESIDENT>))
    return -1;
  return least;
}

template <int LOSS>
cudaError_t launch_fold_any(const float* x, const float* y, const float* alpha,
                            const float* w0, float* wout, long long n, int d, int lanes,
                            long long xy_lane_rows, long long alpha_lane_stride,
                            int lanes_per_xy, float* scratch, cudaStream_t stream) {
  if (d <= kGramMaxDim) {
    return launch_gram<LOSS>(x, y, alpha, w0, wout, n, d, lanes, xy_lane_rows,
                             alpha_lane_stride, lanes_per_xy, stream);
  }
  return launch_fold_clustered<LOSS>(x, y, alpha, w0, wout, n, d, lanes, xy_lane_rows, alpha_lane_stride,
                                     lanes_per_xy, scratch, stream);
}

template <int LOSS>
cudaError_t launch_chain_probe(int steps, long long* out, cudaStream_t stream) {
  igd_chain_probe_kernel<LOSS><<<1, kWarp, 0, stream>>>(0.1f, 1.0f, 0.01f, 0.5f, steps, out);
  return cudaGetLastError();
}

template <int LOSS>
cudaError_t launch_mb_slice_step_probe(int steps, long long* out, cudaStream_t stream) {
  return launch_cluster(igd_minibatch_slice_step_probe_kernel<LOSS>, kMsCluster, kMsThreads, 1,
                        kMsBarBytes + kMsFixedFloats * sizeof(float), stream, steps, out);
}

// Clusters of igd_fold_minibatch's column-slice instance at D (D >
// kMbMaxDim) that the card can hold at once, the least over the losses
// (cudaOccupancyMaxActiveClusters); -1 on an error.
template <bool W_SHARED>
int slice_clusters_fit(size_t smem) {
  int least = -1;
  auto fit = [&](auto kernel) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int n = 0;
    if (cluster_config(kernel, dim3(kMsCluster, 1, 1), kMsCluster, kMsThreads, smem, nullptr, &cfg, &attr) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
      return false;
    least = least < 0 || n < least ? n : least;
    return true;
  };
  if (!fit(igd_minibatch_slice_kernel<kLossLr, W_SHARED>) || !fit(igd_minibatch_slice_kernel<kLossSvm, W_SHARED>) ||
      !fit(igd_minibatch_slice_kernel<kLossLsq, W_SHARED>))
    return -1;
  return least;
}

// The lane arguments of every entry: 1 <= lanes <= kMaxLanes, strides >= 0,
// and lanes a whole number of groups of lanes_per_xy.
constexpr int kMaxLanes = 65535;

bool bad_lanes(int lanes, long long xy_lane_rows, long long alpha_lane_stride, int lanes_per_xy) {
  return lanes < 1 || lanes > kMaxLanes || xy_lane_rows < 0 || alpha_lane_stride < 0 ||
         lanes_per_xy < 1 || lanes % lanes_per_xy != 0;
}

// The two folds' entries below, with every lane argument (the extern "C"
// entries without lanes_per_xy pass 1).
int fold_entry(const float* x, const float* y, const float* alpha, const float* w0,
               float* wout, long long n, int d, int loss, int lanes, long long xy_lane_rows,
               int lanes_per_xy, long long alpha_lane_stride, float* scratch, void* stream) {
  if (n < 0 || d < 1) return cudaErrorInvalidValue;
  if (bad_lanes(lanes, xy_lane_rows, alpha_lane_stride, lanes_per_xy)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kLossLr:
      return launch_fold_any<kLossLr>(x, y, alpha, w0, wout, n, d, lanes, xy_lane_rows,
                                      alpha_lane_stride, lanes_per_xy, scratch, s);
    case kLossSvm:
      return launch_fold_any<kLossSvm>(x, y, alpha, w0, wout, n, d, lanes, xy_lane_rows,
                                       alpha_lane_stride, lanes_per_xy, scratch, s);
    case kLossLsq:
      return launch_fold_any<kLossLsq>(x, y, alpha, w0, wout, n, d, lanes, xy_lane_rows,
                                       alpha_lane_stride, lanes_per_xy, scratch, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int minibatch_entry(const float* x, const float* y, const float* alpha, const float* w0,
                    float* wout, long long n, int d, int loss, int lanes,
                    long long xy_lane_rows, int lanes_per_xy, long long alpha_lane_stride,
                    void* stream) {
  if (n < 0 || d < 1) return cudaErrorInvalidValue;
  if (bad_lanes(lanes, xy_lane_rows, alpha_lane_stride, lanes_per_xy)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kLossLr:
      return launch_minibatch<kLossLr>(x, y, alpha, w0, wout, n, d, lanes, xy_lane_rows,
                                       alpha_lane_stride, lanes_per_xy, s);
    case kLossSvm:
      return launch_minibatch<kLossSvm>(x, y, alpha, w0, wout, n, d, lanes, xy_lane_rows,
                                        alpha_lane_stride, lanes_per_xy, s);
    case kLossLsq:
      return launch_minibatch<kLossLsq>(x, y, alpha, w0, wout, n, d, lanes, xy_lane_rows,
                                        alpha_lane_stride, lanes_per_xy, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The instance boundaries (the kernels take every D >= 1): igd_fold's
// middle instance up to the first (its Gram instance up to
// igd_fused_gram_max_dim), its wide instance above, with w in
// shared memory up to the second; igd_fold_minibatch's column-slice
// cluster (past kMbMaxDim) keeps a tile's slice resident up to the third
// and w's slices in shared memory up to the fourth.
int igd_fused_fold_register_max_dim() { return kFoldMaxDim; }

int igd_fused_fold_cluster_smem_max_dim() { return kFoldClusterSmemMaxDim; }

int igd_fused_minibatch_resident_max_dim() { return kMinibatchResidentMaxDim; }

int igd_fused_minibatch_slice_smem_max_dim() { return kMinibatchSliceSmemMaxDim; }

int igd_fused_gram_max_dim() { return kGramMaxDim; }

int igd_fused_tile() { return kTile; }

const char* igd_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int igd_fused_max_lanes() { return kMaxLanes; }

// `lanes` folds in one launch (see "Lanes" at the head of this file).
// scratch: igd_fused_fold_scratch_floats(n, d, lanes, xy_lane_rows,
// lanes_per_xy) floats (none at D <= kGramMaxDim; lanes_per_xy 1 here).
int igd_fold_launch(const float* x, const float* y, const float* alpha, const float* w0,
                    float* wout, long long n, int d, int loss, int lanes,
                    long long xy_lane_rows, long long alpha_lane_stride, float* scratch,
                    void* stream) {
  return fold_entry(x, y, alpha, w0, wout, n, d, loss, lanes, xy_lane_rows, 1,
                    alpha_lane_stride, scratch, stream);
}

// The same, with lanes_per_xy consecutive lanes reading one x/y segment.
int igd_fold_segments_launch(const float* x, const float* y, const float* alpha,
                             const float* w0, float* wout, long long n, int d, int loss,
                             int lanes, long long xy_lane_rows, int lanes_per_xy,
                             long long alpha_lane_stride, float* scratch, void* stream) {
  return fold_entry(x, y, alpha, w0, wout, n, d, loss, lanes, xy_lane_rows, lanes_per_xy,
                    alpha_lane_stride, scratch, stream);
}

long long igd_fused_fold_scratch_floats(long long n, int d, int lanes, long long xy_lane_rows,
                                        int lanes_per_xy) {
  return fold_scratch_floats(n, d, lanes, xy_lane_rows, lanes_per_xy);
}

// out = {CTAs a lane, panel columns, ring slots, shared memory bytes a
// CTA} of igd_fold's wide instance at D (D > kFoldMaxDim).
int igd_fused_fold_design(int d, long long* out) {
  if (d <= kFoldMaxDim) return cudaErrorInvalidValue;
  const FoldPanels pn = fold_panels((d + kFcCluster - 1) / kFcCluster, kFcCluster);
  out[0] = pn.ctas;
  out[1] = pn.panel;
  out[2] = pn.slots;
  out[3] = static_cast<long long>(pn.smem);
  return 0;
}

// Clusters of igd_fold's wide instance at D (D > kFoldMaxDim) that the
// card holds at once; 0 if none fits, -1 on an error.
int igd_fused_fold_clusters_fit(int d) {
  if (d <= kFoldMaxDim) return -1;
  const int slice = (d + kFcCluster - 1) / kFcCluster;
  const size_t smem = fold_panels(slice, kFcCluster).smem;
  return slice <= kFcSmemMaxSlice ? fold_clusters_fit<kFcCluster, true, false>(smem)
                                  : fold_clusters_fit<kFcCluster, false, false>(smem);
}

// The most columns a CTA of igd_fold's middle instance owns.
int igd_fused_fold_middle_max_slice() { return kFmMaxSlice; }

// out = {CTAs a lane, columns a CTA (its one panel), resident sub-tiles,
// shared memory bytes a CTA} of igd_fold's middle instance at D
// (kGramMaxDim < D <= kFoldMaxDim).
int igd_fused_fold_middle_design(int d, long long* out) {
  if (d <= kGramMaxDim || d > kFoldMaxDim) return cudaErrorInvalidValue;
  const FoldPanels pn = middle_panels(d);
  out[0] = pn.ctas;
  out[1] = pn.panel;
  out[2] = pn.slots;
  out[3] = static_cast<long long>(pn.smem);
  return 0;
}

// Clusters of igd_fold's middle instance at D that the card holds at once;
// 0 if none fits, -1 on an error or a D outside the instance.
int igd_fused_fold_middle_clusters_fit(int d) {
  if (d <= kGramMaxDim || d > kFoldMaxDim) return -1;
  const FoldPanels pn = middle_panels(d);
  switch (pn.ctas) {
    case 1:
      return fold_clusters_fit<1, true, true>(pn.smem);
    case 2:
      return fold_clusters_fit<2, true, true>(pn.smem);
    case 4:
      return fold_clusters_fit<4, true, true>(pn.smem);
    case 8:
      return fold_clusters_fit<8, true, true>(pn.smem);
    case 16:
      return fold_clusters_fit<16, true, true>(pn.smem);
    default:
      return -1;
  }
}

int igd_chain_probe_launch(int loss, int steps, long long* out, void* stream) {
  if (steps < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kLossLr:
      return launch_chain_probe<kLossLr>(steps, out, s);
    case kLossSvm:
      return launch_chain_probe<kLossSvm>(steps, out, s);
    case kLossLsq:
      return launch_chain_probe<kLossLsq>(steps, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int igd_fold_minibatch_launch(const float* x, const float* y, const float* alpha,
                              const float* w0, float* wout, long long n, int d, int loss,
                              int lanes, long long xy_lane_rows, long long alpha_lane_stride,
                              void* stream) {
  return minibatch_entry(x, y, alpha, w0, wout, n, d, loss, lanes, xy_lane_rows, 1,
                         alpha_lane_stride, stream);
}

int igd_fold_minibatch_segments_launch(const float* x, const float* y, const float* alpha,
                                       const float* w0, float* wout, long long n, int d,
                                       int loss, int lanes, long long xy_lane_rows,
                                       int lanes_per_xy, long long alpha_lane_stride,
                                       void* stream) {
  return minibatch_entry(x, y, alpha, w0, wout, n, d, loss, lanes, xy_lane_rows, lanes_per_xy,
                         alpha_lane_stride, stream);
}

int igd_fused_minibatch_cluster() { return kMbCluster; }

int igd_fused_minibatch_cluster_max_dim() { return kMbMaxDim; }

// Dynamic shared memory a CTA of igd_fold_minibatch's instance takes at D.
long long igd_fused_minibatch_smem_bytes(int d) {
  if (d < 1) return 0;
  if (d > kMbMaxDim) return static_cast<long long>(slice_panels((d + kMsCluster - 1) / kMsCluster).smem);
  return static_cast<long long>(mb_smem_bytes(d, mb_stages(d)));
}

// CTAs a lane of igd_fold_minibatch's column-slice instance (D > kMbMaxDim).
int igd_fused_minibatch_slice_cluster() { return kMsCluster; }

// out = {CTAs a lane, panel columns, rows a panel, ring slots, shared
// memory bytes a CTA} of igd_fold_minibatch's column-slice instance at D
// (D > kMbMaxDim); rows a panel 256 where the tile's slice stays resident.
int igd_fused_minibatch_slice_design(int d, long long* out) {
  if (d <= kMbMaxDim) return cudaErrorInvalidValue;
  const SlicePanels pn = slice_panels((d + kMsCluster - 1) / kMsCluster);
  out[0] = kMsCluster;
  out[1] = pn.panel;
  out[2] = pn.prows;
  out[3] = pn.slots;
  out[4] = static_cast<long long>(pn.smem);
  return 0;
}

// Clusters of the column-slice instance at D (D > kMbMaxDim) that the card
// holds at once; 0 if none fits, -1 on an error.
int igd_fused_minibatch_clusters_fit(int d) {
  if (d <= kMbMaxDim) return -1;
  const int slice = (d + kMsCluster - 1) / kMsCluster;
  const size_t smem = slice_panels(slice).smem;
  return slice <= kMsSmemMaxSlice ? slice_clusters_fit<true>(smem) : slice_clusters_fit<false>(smem);
}

// out[0] = SM cycles of `steps` tiles of the column-slice instance's
// dependent skeleton alone (the push of the partial margins, the wait, the
// 16-way sums and c, two consumer barriers), rank 0's clock64.
int igd_minibatch_wide_step_probe_launch(int loss, int steps, long long* out, void* stream) {
  if (steps < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kLossLr:
      return launch_mb_slice_step_probe<kLossLr>(steps, out, s);
    case kLossSvm:
      return launch_mb_slice_step_probe<kLossSvm>(steps, out, s);
    case kLossLsq:
      return launch_mb_slice_step_probe<kLossLsq>(steps, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// out[0] = SM cycles of `steps` tiles of the cluster instance's dependent
// work at D with the tile resident (rank 0's clock64), out[1] = bits of w[0].
int igd_minibatch_step_probe_launch(int loss, int d, int steps, long long* out, void* stream) {
  if (steps < 1 || d < 1 || d > kMbMaxDim) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(steps) * kTile;
  switch (loss) {
    case kLossLr:
      return launch_mb_cluster_any<kLossLr, true>(nullptr, nullptr, nullptr, nullptr, nullptr, n, d, out, 1,
                                                     0, 0, 1, s);
    case kLossSvm:
      return launch_mb_cluster_any<kLossSvm, true>(nullptr, nullptr, nullptr, nullptr, nullptr, n, d, out, 1,
                                                     0, 0, 1, s);
    case kLossLsq:
      return launch_mb_cluster_any<kLossLsq, true>(nullptr, nullptr, nullptr, nullptr, nullptr, n, d, out, 1,
                                                     0, 0, 1, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
