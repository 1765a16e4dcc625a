// Causal GQA flash attention for Hopper (sm_90a), bound through a plain C
// interface (loaded with ctypes by kernels/attention/kernel.py).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/attention/kernel.py:63 flash_attention (_attn_kernel).
//   out[b, i, h] = softmax_{j <= off + i}(cap(q[b, i, h] . k[b, j, h // g] * scale)) v[b, j, h // g]
//   with the online softmax (m, l, acc) in float32, the reference's -1e30
//   sentinel for masked logits and max(l, 1e-30) as the denominator.
//   k and v may be longer than q (Skv >= S): q row i then sits at absolute
//   position off + i, off = Skv - S, as a prefill chunk written into a KV
//   cache at index off (the reference's q_pos = cache_index + i, kv_limit =
//   cache_index + S, models/layers.py). cap(x) = softcap * tanh(x / softcap)
//   on the scaled logit before the mask when softcap > 0 (grok-1's
//   attention-logit cap, the reference's _soft_cap), the identity otherwise.
//   With a non-null lse ([B, H, S] float32), both kernels also write each q
//   row's log-sum-exp of its scaled (capped) logits, m + log l in natural
//   units, in the epilogue: what the gradient kernels
//   (flash_attention_bwd.cu) recompute P from. The serving path passes
//   null and writes nothing: in the bf16 kernel lse is a template flag, so
//   the serving instances are the code they were without it.
//
// What bounds it on this card: operations. At the serving path's shape
// (B=8, S=2048, H=24, Kv=8, hd=128, bf16) the causal half of QK^T and PV is
// 4*B*H*hd*S(S+1)/2 = 2.06e11 FLOP, 0.209 ms at the tensor cores' 989
// TFLOP/s, against 0.08 ms for the 268 MB of q, k, v and o.
//
// Three kernels, picked by dtype and width; none is a fallback for another.
//
// bfloat16 at widths 64 and 128, the serving path (namespace tc): a
// tensor-core kernel in the manner of FlashAttention-3, since only wgmma
// reaches the card's bf16 rate.
// - A block owns a 128-row q tile of one (b, h): warpgroup 0 is the
//   producer (one thread issues every TMA load; setmaxnreg gives its
//   registers away), warpgroups 1 and 2 are consumers, each owning 64 q
//   rows, so one k/v tile feeds both.
// - Tiles arrive by TMA: one 4-D tensor map (hd, heads, positions, batch)
//   per operand, encoded from the tensor's own strides, so q, k and v are
//   read in place (cache[:, :s] views included). A box is 64 columns (128
//   bytes, the 128-byte swizzle's span) by 128 q rows or 128 k/v rows; a
//   tile is HD/64 boxes. Out-of-bounds boxes are zero-filled, which covers a
//   ragged S and any hd below the instantiated width HD (64 or 128).
// - k and v tiles stream through a ring of kStages stages, each with its
//   own full barriers (k and v apart, so QK^T starts before v lands) and one
//   empty barrier that both consumers arrive on when done.
// - S = Q K^T: wgmma m64n128k16, both operands K-major from shared memory
//   as they lie. O += P V: P is the A operand from registers, rounded to
//   bf16 from the S accumulator, whose register layout is the A fragment's;
//   V is the B operand from shared memory, MN-major (the descriptor's
//   transpose bit), wgmma m64nHDk16. m, l and O stay in f32 registers; exp2
//   with the scale folded into log2 units (with a cap, the cap is taken in
//   natural units and then multiplied by log2 e). The cap is a template
//   flag, so the uncapped instances carry no tanh.
// - Causal work: k/v tiles past the q tile's last row are never loaded, and
//   only tiles that reach past its first row (the last one or two) are
//   masked in registers: the tile loop runs the unmasked tiles, then the
//   masked ones, each a body with the mask as a compile-time flag. Tiles are taken longest first across all heads
//   (grid.y counts q tiles from the end).
// - The output is written from registers, bf16 pairs, true hd columns and
//   rows below S only.
//
// bfloat16 at width 192 (nemotron-4's heads; hd 136..191 zero-filled into
// it), namespace wide: the same contract, producer, tensor maps, masking
// and epilogue, redesigned for the width in the manner of
// FlashAttention-3's 192-wide forward. It replaces the 128-wide design
// fitted to 192 by halving its key tile (64 keys, three stages), which ran
// at 0.46 of the bound, 1.35x SDPA at nemotron-4's prefill on an H100 SXM
// at 700 W. What bounds it: operations, 4*B*H*hd*S(S+1)/2 = 1.24e12 FLOP
// at B 8, S 2,048, 96/8 heads (1.25 ms at 989 TFLOP/s, against 0.20 ms for
// the bytes). What the design does about what held the fit back:
// 1. Key tiles of kBK = 112 (two stages) in place of 64 (three): each
//    tile's fixed costs (barrier waits, the row max and sum, the rescale
//    of 96 accumulators a thread) are paid per 112 keys, and Q K^T runs as
//    m64n112k16. Shared memory: 1 KB + 48 KB of Q + 2 x (42 + 42) KB =
//    217 KB. k and v have rings of their own (full and empty barriers
//    apiece), loaded k one tile ahead of v, as the consumers take them.
// 2. The two consumers take turns to issue each tile's products (named
//    barriers 1 and 2, as the gradient's kernels do): one warpgroup's
//    softmax then runs while the other's products hold the tensor cores,
//    instead of both softmaxes at once beside idle tensor cores.
// 3. Within a warpgroup the softmax overlaps a product too: each turn
//    issues S(t) = Q K(t)^T, rescales O by tile t-1's factors while that
//    runs, and issues O += P(t-1) V(t-1); the warpgroup then waits for S(t)
//    alone (wgmma.wait_group 1) and runs tile t's softmax while P(t-1)
//    V(t-1) is still on the tensor cores. This keeps one score tile (56
//    floats a thread) and one P tile (28 registers) live beside O's 96,
//    which fits 240 registers at 112 keys; overlapping the softmax with
//    S(t+1) instead would keep two score tiles live. The row sums stay per
//    thread until the epilogue (the quad's max is shared, so its shares
//    scale alike), which saves two shuffles a row a tile.
// 4. 2^x by ex2.approx.ftz on log2e-scaled logits at every site, the
//    scale folded into one FMA a score (the row max is taken on the raw
//    scores); the cap is softcap * tanh(x / softcap) in natural units
//    (tanh_fast), then scaled by log2 e.
// 5. One block an SM (217 KB of shared memory), so the grid is persistent:
//    G blocks (the SMs, or fewer items) walk the (b, h, q tile) items
//    longest first, block k taking items k, k + G, ...; q has a full and an
//    empty barrier, so the producer loads the next item's q and first k
//    tiles as soon as the consumers' last Q K^T of an item is in, while
//    they finish its softmax, last P V and epilogue. The rings run on
//    across items.
// 6. Causal work: no tile past a q tile's last row is loaded, and
//    warpgroup 0 runs no products on a tile wholly past its own 64 rows
//    (it keeps the turns and releases the tile's stages once they land).
//
// float32, the reference's parity checks: the CUDA-core kernel (TF32 tensor
// cores would break the reference's 2e-5). One block of 256 threads per
// (64-row q tile, b*h); the q tile is staged in shared memory once and
// 64-row k/v tiles stream in through cp.async, double-buffered up to hd 128
// and single-buffered above (two stages at hd 192 would not fit); each
// thread owns 4 q rows, a 4x4 block of the score tile and 4 x hd/16 outputs;
// a row's 16 threads are a half-warp, so the row max and sum are shuffles.
// Shared-memory rows are padded by 16 bytes so that the 16-byte reads of
// eight neighbouring rows hit distinct banks.
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry returns cudaGetLastError() (or cudaErrorInvalidValue for arguments
// the kernels do not take, or a tensor map the driver refuses).

#include "hopper.cuh"  // TMA, mbarriers, wgmma, the tensor-map encoder (shared with the gradient)

#include <type_traits>

namespace {

constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 64;            // k/v rows per tile
constexpr int kThreads = 256;      // 16 row groups x 16 threads
constexpr int kMaxHd = 192;
constexpr int kCols = kMaxHd / 16;  // output columns per thread
constexpr int kPLd = kBK + 4;      // row stride of the probability tile
constexpr int kPad = 4;           // shared-memory row padding (16 bytes)
constexpr float kNegInf = -1e30f;

// k/v stages of the f32 kernel: two (double-buffered) up to hd 128, one above
__host__ __device__ constexpr int f32_stages(int hd) { return hd <= 128 ? 2 : 1; }

// four consecutive elements of a shared-memory row
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros (rows past S)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// rows [row0, row0 + 64) of one head, row stride `stride` elements, into a
// shared tile of row stride `ld`; rows at or past `rows` are zero-filled
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride, int row0,
                                          int rows, int hd, int ld) {
  constexpr int kPerChunk = 4;
  const int per_row = hd / kPerChunk;
  for (int c = threadIdx.x; c < kBK * per_row; c += kThreads) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * kPerChunk;
    const bool valid = row0 + r < rows;
    const float* g = src + (valid ? static_cast<long long>(row0 + r) * stride : 0) + col;
    cp_async16(dst + r * ld + col, g, valid);
  }
}

// f32 tiles take up to 186 KB of shared memory, so one block per SM: it
// may use every register a thread can have. q rows are [0, S), k/v rows
// [0, Skv); q row i sits at absolute position Skv - S + i.
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ o, int S, int Skv,
                               int H, int Kv, int hd, float scale, float softcap, long long qsb,
                               long long qss, long long qsh, long long ksb, long long kss,
                               long long ksh, long long vsb, long long vss, long long vsh,
                               float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = hd + kPad;
  const int stages = f32_stages(hd);
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = sq + kBQ * ld;           // `stages` tiles
  float* sv = sk + stages * kBK * ld;  // `stages` tiles
  float* sp = reinterpret_cast<float*>(sv + stages * kBK * ld);

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x);  // longest tiles first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / Kv);
  const int q0 = qi * kBQ;
  const int off = Skv - S;  // absolute position of q row 0
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % 16;  // score columns tx + 16j, output columns tx + 16c

  load_tile(sq, qb, qss, q0, S, hd, ld);
  load_tile(sk, kb, kss, 0, Skv, hd, ld);
  load_tile(sv, vb, vss, 0, Skv, hd, ld);
  cp_async_commit();

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int n_k = (off + min(q0 + kBQ, S) - 1) / kBK + 1;  // causal skip
  for (int t = 0; t < n_k; ++t) {
    const int st = stages == 2 ? (t & 1) : 0;
    if (stages == 2) {
      if (t + 1 < n_k) {
        load_tile(sk + (st ^ 1) * kBK * ld, kb, kss, (t + 1) * kBK, Skv, hd, ld);
        load_tile(sv + (st ^ 1) * kBK * ld, vb, vss, (t + 1) * kBK, Skv, hd, ld);
      }
      cp_async_commit();
      cp_async_wait_one();
    } else {
      if (t > 0) {  // the stage was freed by the previous iteration's last barrier
        load_tile(sk, kb, kss, t * kBK, Skv, hd, ld);
        load_tile(sv, vb, vss, t * kBK, Skv, hd, ld);
      }
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    const float* ks = sk + st * kBK * ld;
    const float* vs = sv + st * kBK * ld;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(sq + (ty * 4 + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    const int k0 = t * kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = off + q0 + ty * 4 + i;  // absolute position
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        s[i][j] = (k0 + tx + 16 * j <= row) ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off2 = 8; off2 > 0; off2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off2));
      const float corr = expf(m[i] - mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        sum += p;
        sp[(ty * 4 + i) * kPLd + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off2 = 8; off2 > 0; off2 >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off2);
      l[i] = l[i] * corr + sum;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty * 4 + i) * kPLd + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        if (col < hd) {
          const float vv = vs[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
    __syncthreads();  // the next iteration's loads overwrite a stage and sp
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[(static_cast<long long>(b) * H + h) * S + row] = m[i] + logf(denom);
    float* orow = o + ((static_cast<long long>(b) * S + row) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) orow[col] = acc[i][c] / denom;
    }
  }
}

size_t f32_smem_bytes(int hd) {
  return (kBQ + 2 * f32_stages(hd) * kBK) * static_cast<size_t>(hd + kPad) * sizeof(float) +
         kBQ * kPLd * sizeof(float);
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv, int H,
               int Kv, int hd, float scale, float softcap, const long long* qs, const long long* ks,
               const long long* vs, float* lse, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (static_cast<long long>(B) * H > 65535) return cudaErrorInvalidValue;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_attention_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, Skv, H, Kv, hd, scale, softcap, qs[0], qs[1], qs[2], ks[0], ks[1],
      ks[2], vs[0], vs[1], vs[2], lse);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;        // q rows per block: two consumer warpgroups x 64
constexpr int kStages = 3;      // k/v ring
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Tiles {
  static constexpr int kBK = 128;           // k/v rows per tile
  static constexpr int kQ = kBQ * HD * 2;   // bytes of the q tile: HD/64 boxes of 128 x 64
  static constexpr int kKV = kBK * HD * 2;  // bytes of one k (or v) tile: HD/64 boxes of kBK x 64
  static constexpr int kBars = 1 + 3 * kStages;  // q full; k full, v full, k/v empty per stage
  // the swizzled tiles need 1024-byte alignment, which the base is rounded up to
  static constexpr int kSmem = 1024 + kQ + 2 * kStages * kKV + 8 * kBars;
};
static_assert(Tiles<128>::kSmem <= 232448, "the 128-wide instance must fit a block's shared memory");

// grid (B*H, q tiles); block y counts q tiles from the last, so the
// longest tiles of every head go first. q rows are [0, S), k/v rows [0, Skv);
// q row i sits at absolute position Skv - S + i. CAP: logits capped as
// softcap * tanh(x * scale / softcap) (`scale_log2` is then softcap * log2 e
// and `cap_arg` scale / softcap); otherwise x * scale_log2 (scale * log2 e).
// LSE: write each row's log-sum-exp into `lse` (a template flag, so the
// serving path's instances compile without it).
template <int HD, bool CAP, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                __nv_bfloat16* __restrict__ o, int S, int Skv, int H, int Kv,
                                int hd, float scale_log2, float cap_arg, float* __restrict__ lse) {
  static_assert(HD <= 128, "HD 192 is the wide namespace's kernel");
  using T = Tiles<HD>;
  constexpr int kBK = T::kBK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + T::kQ;                // kStages k tiles
  const uint32_t sv = sk + kStages * T::kKV;     // kStages v tiles
  const uint32_t bars = sv + kStages * T::kKV;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto kv_empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.y);
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / Kv);
  const int q0 = qi * kBQ;
  const int off = Skv - S;                               // absolute position of q row 0
  const int n_k = (off + min(q0 + kBQ, S) - 1) / kBK + 1;  // causal: no tile past the q tile
  const int t_masked = (off + q0 + 1) / kBK;  // the first tile reaching past the q tile's first row
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(kv_empty(st), 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQ);
#pragma unroll
      for (int c = 0; c < HD / kBoxCols; ++c)
        tma_load(sq + c * kBQ * kRowBytes, &qmap, q_full, c * kBoxCols, h, q0, b);
      for (int t = 0; t < n_k; ++t) {
        const int st = t % kStages;
        mbar_wait(kv_empty(st), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(st), T::kKV);
#pragma unroll
        for (int c = 0; c < HD / kBoxCols; ++c)
          tma_load(sk + st * T::kKV + c * kBK * kRowBytes, &kmap, k_full(st), c * kBoxCols, kvh,
                   t * kBK, b);
        mbar_expect_tx(v_full(st), T::kKV);
#pragma unroll
        for (int c = 0; c < HD / kBoxCols; ++c)
          tma_load(sv + st * T::kKV + c * kBK * kRowBytes, &vmap, v_full(st), c * kBoxCols, kvh,
                   t * kBK, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int slice = (wg - 1) * 64;                  // the warpgroup's rows in the q tile
    const int r0 = q0 + slice + warp * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
    const uint32_t q_slice = sq + slice * kRowBytes;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    // one k/v tile; MASKED (a compile-time flag) for the tiles from t_masked on
    auto tile = [&](const int t, auto masked_tag) {
      constexpr bool kMasked = decltype(masked_tag)::value;
      const int st = t % kStages;
      const int phase = (t / kStages) & 1;

      // S = Q K^T over hd, 16 columns a step
      float s[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = 0.0f;
      mbar_wait(k_full(st), phase);
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t box = kk / 4, within = (kk % 4) * 32;  // 64-column box, 16-column step
        wgmma_ss<kBK>(s, sw128_desc(q_slice + box * kBQ * kRowBytes + within, 16, 1024),
                      sw128_desc(sk + st * T::kKV + box * kBK * kRowBytes + within, 16, 1024),
                      kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(s);

      // online softmax over the tile, in log2 units; only a tile reaching
      // past the q tile's first row has masked entries. Key columns are
      // counted from the q rows' offset once a tile, which keeps the offset
      // out of the per-element test
      const int k0 = t * kBK + 2 * (lane % 4) - off;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int row = r0 + 8 * ((i / 2) % 2);
        const int col = k0 + 8 * (i / 4) + (i % 2);
        const float y = CAP ? scale_log2 * tanhf(s[i] * cap_arg) : s[i] * scale_log2;
        const float x = (kMasked && col > row) ? kNegInf : y;
        s[i] = x;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
      }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const float p = exp2f(s[i] - m[(i / 2) % 2]);
        s[i] = p;
        sum[(i / 2) % 2] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i / 2) % 2];
      // P in bf16, as the A fragments of kBK/16 k-steps
      uint32_t pa[kBK / 4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
        pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }

      // O += P V over the tile's rows, 16 a step
      mbar_wait(v_full(st), phase);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<HD>(acc, pa + 4 * kk,
                     sw128_desc(sv + st * T::kKV + kk * 16 * kRowBytes, kBK * kRowBytes, 1024));
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      mbar_arrive(kv_empty(st));
    };
    // the unmasked tiles, then the masked ones: the select stays out of the main loop
    int t = 0;
    for (; t < min(t_masked, n_k); ++t) tile(t, std::false_type{});
    for (; t < n_k; ++t) tile(t, std::true_type{});

    // epilogue: rows below S, the true hd columns; lse in natural units
    const float inv[2] = {1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= S) continue;
      if (LSE && lane % 4 == 0)
        lse[(static_cast<long long>(b) * H + h) * S + row] = (m[r] + log2f(fmaxf(l[r], 1e-30f))) * kLn2;
      __nv_bfloat16* orow = o + ((static_cast<long long>(b) * S + row) * H + h) * hd;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        if (col < hd)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

template <int HD, bool CAP, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv, int H,
           int Kv, int hd, float scale, float softcap, const long long* layouts, float* lse,
           cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {kBQ, Tiles<HD>::kBK, Tiles<HD>::kBK};
  for (int i = 0; i < 3; ++i)
    if (!encode(&maps[i], ptrs[i], layouts + 11 * i, rows[i])) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16_kernel<HD, CAP, LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<HD>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  const float scale_log2 = CAP ? softcap * kLog2e : scale * kLog2e;
  const float cap_arg = CAP ? scale / softcap : 0.0f;
  flash_attention_bf16_kernel<HD, CAP, LSE><<<grid, kThreads, Tiles<HD>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), S, Skv, H, Kv, hd, scale_log2,
      cap_arg, lse);
  return cudaGetLastError();
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv, int H,
              int Kv, int hd, float scale, float softcap, const long long* layouts, float* lse,
              cudaStream_t stream) {
  const bool cap = softcap > 0.0f;
  if (lse != nullptr) {
    if (cap) return launch<HD, true, true>(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, layouts, lse, stream);
    return launch<HD, false, true>(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, layouts, lse, stream);
  }
  if (cap) return launch<HD, true, false>(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, layouts, lse, stream);
  return launch<HD, false, false>(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, layouts, lse, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel at HD 192 (see the note at the top)
// ---------------------------------------------------------------------------
namespace wide {

constexpr int kHD = 192;
constexpr int kBQ = tc::kBQ;        // q rows per block: two consumer warpgroups x 64
constexpr int kBK = 112;            // k/v rows per tile
constexpr int kStages = 2;          // the k and v rings
constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr int kQ = kBQ * kHD * 2;   // bytes of the q tile: three boxes of 128 x 64
constexpr int kKV = kBK * kHD * 2;  // bytes of one k (or v) tile: three boxes of kBK x 64
constexpr int kBars = 2 + 4 * kStages;  // q full, q empty; k full, v full, k empty, v empty per stage
// the swizzled tiles need 1024-byte alignment, which the base is rounded up to
constexpr int kSmem = 1024 + kQ + 2 * kStages * kKV + 8 * kBars;
static_assert(kBK % 16 == 0 && kBK <= 256, "a tile is whole k16 steps of P V and one wgmma N (and box) of Q K^T");
static_assert(kSmem <= 232448, "the 192-wide instance must fit a block's shared memory");

// The work items are the (b, h, q tile) triples, longest first: item j is
// q tile n_q - 1 - j / (B*H) of head (b, h) = j % (B*H). Block k takes
// items k, k + G, k + 2G, ... of a grid of G blocks (one an SM), so each
// block's producer loads the next item's q and first k tiles while its
// consumers finish the item before (kernel.py's persistent_items mirrors
// the order).
struct Item {
  int b, h, q0;
};
__device__ __forceinline__ Item item_at(int j, int BH, int H, int n_q) {
  const int bh = j % BH;
  return {bh / H, bh % H, (n_q - 1 - j / BH) * kBQ};
}

// arguments as the tc kernel's, with B first
template <bool CAP, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_hd192_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 __nv_bfloat16* __restrict__ o, int B, int S, int Skv, int H, int Kv,
                                 int hd, float scale_log2, float cap_arg, float* __restrict__ lse) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + kQ;               // kStages k tiles
  const uint32_t sv = sk + kStages * kKV;    // kStages v tiles
  const uint32_t bars = sv + kStages * kKV;
  const uint32_t q_full = bars, q_empty = bars + 8u;
  auto k_full = [&](int st) { return bars + 8u * (2 + st); };
  auto v_full = [&](int st) { return bars + 8u * (2 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8u * (2 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8u * (2 + 3 * kStages + st); };

  const int n_q = (S + kBQ - 1) / kBQ, BH = B * H, n_items = BH * n_q;
  const int off = Skv - S;  // absolute position of q row 0
  const int g = H / Kv;
  // k/v tiles of a q tile (causal: none past its last row), and the first
  // that reaches past its first row
  auto tiles = [&](int q0) { return (off + min(q0 + kBQ, S) - 1) / kBK + 1; };
  auto first_masked = [&](int q0) { return (off + q0 + 1) / kBK; };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);  // every consumer thread arrives once its last Q K^T is in
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 2 * 128);
      mbar_init(v_empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // k and v tiles run through their rings in the order the block takes
  // them: the block's n-th tile (over all its items) sits in stage n %
  // kStages, in the ring's (n / kStages)-th round
  if (wg == 0) {
    // ---- producer: each item's q, then k one tile ahead of v, as the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full, uint32_t empty, int n, int pos,
                      int kvh, int b) {
        mbar_wait(empty + 8u * (n % kStages), ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8u * (n % kStages), kKV);
#pragma unroll
        for (int c = 0; c < kHD / kBoxCols; ++c)
          tma_load(ring + (n % kStages) * kKV + c * kBK * kRowBytes, map, full + 8u * (n % kStages),
                   c * kBoxCols, kvh, pos, b);
      };
      int n = 0;
      for (int j = blockIdx.x, it = 0; j < n_items; j += gridDim.x, ++it) {
        const Item item = item_at(j, BH, H, n_q);
        const int kvh = item.h / g, n_k = tiles(item.q0);
        mbar_wait(q_empty, (it & 1) ^ 1);
        mbar_expect_tx(q_full, kQ);
#pragma unroll
        for (int c = 0; c < kHD / kBoxCols; ++c)
          tma_load(sq + c * kBQ * kRowBytes, &qmap, q_full, c * kBoxCols, item.h, item.q0, item.b);
        load(&kmap, sk, k_full(0), k_empty(0), n, 0, kvh, item.b);
        for (int t = 0; t < n_k; ++t) {
          if (t + 1 < n_k) load(&kmap, sk, k_full(0), k_empty(0), n + t + 1, (t + 1) * kBK, kvh, item.b);
          load(&vmap, sv, v_full(0), v_empty(0), n + t, t * kBK, kvh, item.b);
        }
        n += n_k;
      }
    }
  } else {
    // ---- consumers: 64 q rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int row_in_tile = w * 64 + warp * 16 + lane / 4;  // this thread's rows in a q tile, and + 8
    const uint32_t q_slice = sq + w * 64 * kRowBytes;

    float acc[kHD / 2];   // O, the accumulators' layout of m64n192
    float s[kBK / 2];     // a tile's scores, then its probabilities
    uint32_t p[kBK / 4];  // the probabilities in bf16: the A fragments of kBK/16 k-steps
    // m: the rows' running max in log2 units; l: this thread's share of the
    // rows' sums (the quad's shares are added once, in the epilogue)
    float m[2], l[2], corr[2];

    // S = Q K^T over hd, 16 columns a step, into s, from the block's n-th tile
    auto issue_qk = [&](const int n) {
      const int st = n % kStages;
      mbar_wait(k_full(st), (n / kStages) & 1);
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kHD / 16; ++kk) {
        const uint32_t box = kk / 4, within = (kk % 4) * 32;  // 64-column box, 16-column step
        wgmma_ss<kBK>(s, sw128_desc(q_slice + box * kBQ * kRowBytes + within, 16, 1024),
                      sw128_desc(sk + st * kKV + box * kBK * kRowBytes + within, 16, 1024), kk > 0);
      }
      wg_commit();
    };
    // O += P V over the tile's rows, 16 a step; V MN-major (the transpose bit)
    auto issue_pv = [&](const int n) {
      const int st = n % kStages;
      mbar_wait(v_full(st), (n / kStages) & 1);
      fence_regs(acc);
      fence_regs(p);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<kHD>(acc, p + 4 * kk, sw128_desc(sv + st * kKV + kk * 16 * kRowBytes, kBK * kRowBytes, 1024));
      wg_commit();
    };
    // the online softmax of tile t's scores in s, in log2 units: s becomes P,
    // m and l move on, corr the factor O is to be rescaled by. Only a tile
    // reaching past the q tile's first row (MASKED, a compile-time flag) has
    // masked entries; key columns are counted from the q rows' offset, which
    // keeps the offset out of the per-element test
    auto softmax = [&](const int t, const int r0, auto masked_tag) {
      constexpr bool kMasked = decltype(masked_tag)::value;
      const int k0 = t * kBK + 2 * (lane % 4) - off;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int row = r0 + 8 * ((i / 2) % 2);
        const int col = k0 + 8 * (i / 4) + (i % 2);
        // uncapped, the raw score (the scale is folded into the exponent below)
        float x = CAP ? scale_log2 * tanh_fast(s[i] * cap_arg) : s[i];
        if (kMasked && col > row) x = kNegInf;
        s[i] = x;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
      }
      float neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], CAP ? mx[r] : mx[r] * scale_log2);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        neg[r] = -m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i / 2) % 2;
        s[i] = ex2(CAP ? s[i] + neg[r] : fmaf(s[i], scale_log2, neg[r]));
        sum[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
    };
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
        p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
    };

    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < kHD / 2; ++i) acc[i] *= corr[(i / 2) % 2];
    };

    if (w == 1) turn_pass(w);  // warpgroup 0 takes the first turn
    int n = 0;                 // the block's tiles so far
    for (int j = blockIdx.x, it = 0; j < n_items; j += gridDim.x, ++it) {
      const Item item = item_at(j, BH, H, n_q);
      const int r0 = item.q0 + row_in_tile, n_k = tiles(item.q0), t_masked = first_masked(item.q0);
      // this warpgroup's tiles: none past its own last row (warpgroup 0's
      // 64 rows may end a tile early)
      const int n_w = (off + min(item.q0 + 64 * (w + 1), S) - 1) / kBK + 1;
#pragma unroll
      for (int i = 0; i < kHD / 2; ++i) acc[i] = 0.0f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.0f;
      mbar_wait(q_full, it & 1);

      // tile 0: its scores, then its probabilities (O is still 0)
      turn_wait(w);
      issue_qk(n);
      turn_pass(w);
      wg_wait<0>();
      fence_regs(s);
      mbar_arrive(k_empty(n % kStages));
      if (n_w == 1) mbar_arrive(q_empty);  // the item's last read of q
      if (t_masked == 0) softmax(0, r0, std::true_type{});
      else softmax(0, r0, std::false_type{});
      pack();
      // tile t >= 1: S(t) = Q K(t)^T, O rescaled by tile t-1's factors while
      // it runs, and O += P(t-1) V(t-1), all in one turn; the softmax of
      // tile t runs while P(t-1) V(t-1) (and the other warpgroup's
      // products) are on the tensor cores
      auto step = [&](const int t, auto masked_tag) {
        turn_wait(w);
        issue_qk(n + t);
        rescale();
        issue_pv(n + t - 1);
        turn_pass(w);
        wg_wait<1>();
        fence_regs(s);
        mbar_arrive(k_empty((n + t) % kStages));
        if (t == n_w - 1) mbar_arrive(q_empty);
        softmax(t, r0, masked_tag);
        wg_wait<0>();
        fence_regs(acc);
        fence_regs(p);
        mbar_arrive(v_empty((n + t - 1) % kStages));
        pack();
      };
      // the last product: O += P V of the warpgroup's last tile
      auto last_pv = [&]() {
        turn_wait(w);
        rescale();
        issue_pv(n + n_w - 1);
        turn_pass(w);
        wg_wait<0>();
        fence_regs(acc);
        fence_regs(p);
        mbar_arrive(v_empty((n + n_w - 1) % kStages));
      };
      // the unmasked tiles, then the masked ones: the select stays out of the main loop
      int t = 1;
      for (; t < min(t_masked, n_w); ++t) step(t, std::false_type{});
      for (; t < n_w; ++t) step(t, std::true_type{});
      last_pv();
      // tiles past the warpgroup's rows: no products, but the turns go on
      // (the other warpgroup's tile n_w's products take the turn after the
      // last P V), and each tile's ring stages are released once they have
      // landed (a release before would count towards the stage's last round)
      for (; t < n_k; ++t) {
        turn_wait(w);
        turn_pass(w);
        mbar_wait(k_full((n + t) % kStages), ((n + t) / kStages) & 1);
        mbar_arrive(k_empty((n + t) % kStages));
        mbar_wait(v_full((n + t) % kStages), ((n + t) / kStages) & 1);
        mbar_arrive(v_empty((n + t) % kStages));
      }
      n += n_k;

      // epilogue: the quad's shares of l added; rows below S, the true hd
      // columns; lse in natural units
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const float inv[2] = {1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f)};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= S) continue;
        if (LSE && lane % 4 == 0)
          lse[(static_cast<long long>(item.b) * H + item.h) * S + row] =
              (m[r] + log2f(fmaxf(l[r], 1e-30f))) * tc::kLn2;
        __nv_bfloat16* orow = o + ((static_cast<long long>(item.b) * S + row) * H + item.h) * hd;
#pragma unroll
        for (int jj = 0; jj < kHD / 8; ++jj) {
          const int col = 8 * jj + 2 * (lane % 4);
          if (col < hd)
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack_bf16(acc[4 * jj + 2 * r] * inv[r], acc[4 * jj + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

template <bool CAP, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv, int H, int Kv,
           int hd, float scale, float softcap, const long long* layouts, float* lse, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {kBQ, kBK, kBK};
  for (int i = 0; i < 3; ++i)
    if (!encode(&maps[i], ptrs[i], layouts + 11 * i, rows[i])) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_hd192_kernel<CAP, LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const long long n_items = static_cast<long long>(B) * H * ((S + kBQ - 1) / kBQ);
  if (n_items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);  // one block an SM
  const float scale_log2 = CAP ? softcap * kLog2e : scale * kLog2e;
  const float cap_arg = CAP ? scale / softcap : 0.0f;
  flash_attention_hd192_kernel<CAP, LSE><<<grid, kThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), B, S, Skv, H, Kv, hd, scale_log2, cap_arg, lse);
  return cudaGetLastError();
}

int launch_any(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv, int H, int Kv,
               int hd, float scale, float softcap, const long long* layouts, float* lse, cudaStream_t stream) {
  const bool cap = softcap > 0.0f;
  if (lse != nullptr) {
    if (cap) return launch<true, true>(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, layouts, lse, stream);
    return launch<false, true>(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, layouts, lse, stream);
  }
  if (cap) return launch<true, false>(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, layouts, lse, stream);
  return launch<false, false>(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, layouts, lse, stream);
}

}  // namespace wide
}  // namespace

extern "C" {

int flash_attention_max_hd() { return kMaxHd; }

int flash_attention_block_q() { return tc::kBQ; }

int flash_attention_block_k(int hd_inst) { return hd_inst > 128 ? wide::kBK : tc::Tiles<128>::kBK; }

// the bf16 kernel's dynamic shared memory at width hd_inst
int flash_attention_smem_bytes(int hd_inst) {
  return hd_inst > 128 ? wide::kSmem : hd_inst > 64 ? tc::Tiles<128>::kSmem : tc::Tiles<64>::kSmem;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o: [B, S, H, hd] (o contiguous); k, v: [B, Skv, Kv, hd], Skv >= S (q
// row i at absolute position Skv - S + i). Strides are in elements,
// (batch, position, head); the last dimension is contiguous. softcap > 0
// caps the scaled logits. dtype 0 float32 (the CUDA-core kernel; `tma`
// unused), 1 bfloat16 (the tensor-core kernel at width hd_inst, 64, 128 or
// 192; `tma` holds q's, k's and v's tensor-map layouts, 11 values each:
// dims, byte strides, box, the box 128 q rows or block_k(hd_inst) k/v rows).
// lse: null, or float32 [B, H, S] that receives each q row's log-sum-exp of
// its scaled (and capped) logits in natural units, for the backward.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                           int B, int S, int Skv, int H, int Kv, int hd, float scale,
                           float softcap, long long qsb, long long qss, long long qsh,
                           long long ksb, long long kss, long long ksh, long long vsb,
                           long long vss, long long vsh, int hd_inst, const long long* tma,
                           void* lse, void* stream) {
  float* lse_out = static_cast<float*>(lse);
  if (B < 1 || S < 0 || Skv < S || Kv < 1 || H < Kv || H % Kv != 0 || hd < 8 || hd > kMaxHd ||
      hd % 8 != 0 || !(softcap >= 0.0f))
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh}, vs[3] = {vsb, vss, vsh};
    return launch_f32(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, qs, ks, vs, lse_out, st);
  }
  if (dtype != 1 || tma == nullptr || hd > hd_inst || static_cast<long long>(B) * H > 0x7fffffffLL ||
      (S + tc::kBQ - 1) / tc::kBQ > 65535)
    return cudaErrorInvalidValue;
  if (hd_inst == 64) return tc::launch_hd<64>(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, tma, lse_out, st);
  if (hd_inst == 128) return tc::launch_hd<128>(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, tma, lse_out, st);
  if (hd_inst == 192) return wide::launch_any(q, k, v, o, B, S, Skv, H, Kv, hd, scale, softcap, tma, lse_out, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
