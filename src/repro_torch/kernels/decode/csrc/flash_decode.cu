// Flash decode for Hopper (sm_90a): one query token per sequence against a
// KV cache, bound through a plain C interface (loaded with ctypes by
// kernels/decode/kernel.py).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode/kernel.py:62 flash_decode (_decode_kernel).
//   out[b, h] = softmax_{j < length}(cap(q[b, h] . k[b, j, h // g] * scale)) v[b, j, h // g]
//   with the softmax stats m (max logit) and l (sum of exp(logit - m))
//   returned beside it, both of the capped logits (cap(x) = softcap *
//   tanh(x / softcap) when softcap > 0, grok-1's attention-logit cap; the
//   identity otherwise), so that partials over slices of the cache combine
//   exactly (dist/collectives.py: flash_decode_combine). length == 0 gives
//   out = 0, m = -1e30, l = 0, as the Pallas kernel does.
//
// What bounds it on this card: bytes. Every cache row up to `length` is
// read once and used for g FLOP a byte (g q heads per kv head): 3 at
// llama3.2-3b's g = 3, 12 at nemotron-4's, far under the tensor cores'
// 295. At the serving path's shape (B=8, Kv=8, hd=128, length 2,176, bf16)
// that is 71.4 MB, 0.0213 ms at 3.35 TB/s; at nemotron-4's (B=8, 96/8
// heads, hd=192, length 2,080) 102 MB, 0.0307 ms.
// So each design keeps enough bytes in flight on every SM and keeps the
// per-position work off the issue path.
//
// Two designs, picked by dtype and width; neither is a fallback for the
// other.
//
// bfloat16 heads wider than 128 (nemotron-4's 192; 136 runs padded): the
// tensor-core instance (namespace tc). Its CUDA-core predecessor read each
// kv head's cache twice at g = 12 (two groups of 6 q heads), filled an SM
// with one block holding one tile in flight, and did 12 FLOP a byte on CUDA
// cores in f32, so instruction issue set its pace (0.99 TB/s on an H100
// SXM at nemotron-4's shape). Instead:
// - One block per (b, kv head, length split) for all g q heads of the kv
//   head (up to 32; more take ceil(g / 32) blocks): the q heads are the rows
//   of 16-row tensor-core tiles, zero rows past g. Each cached position is
//   read once.
// - K and V tiles (32 positions x 192 columns, three 64-column boxes of the
//   128-byte swizzle) arrive by TMA into a 3-stage ring under mbarriers,
//   from one producer thread. The tensor maps are encoded per call with the
//   position extent set to `length`: rows past it, and columns past hd, are
//   zero-filled, so a stale NaN or inf in the cache's tail never reaches
//   shared memory. 72 KB a block, two blocks an SM: up to 144 KB in flight
//   on every SM.
// - Two consumer warps a 16-row tile, each owning 16 positions of every
//   tile: S = Q K^T and O += P V by mma.sync.m16n8k16 (bf16 in, f32
//   accumulated), K by ldmatrix and V by ldmatrix.trans from the swizzled
//   tiles. Q's A fragments stay in registers across the loop; each warp
//   keeps its own m, l and O [16 x 192] (96 floats a thread). The softmax
//   runs on the score fragments in log2 units (scale, cap, positions at or
//   past the split's end masked, ex2.approx); P is rounded to bf16 for the
//   product, as SDPA and flash_attention do.
// - At the block's end the warps' (m, l, O) merge once through the freed
//   ring, and the partial is written in the layout the combine reads, m
//   back in natural-log units.
// - The wrapper sizes the splits to this instance (kernel.py: splits_for):
//   MIN_WAVES full waves of the blocks that fit an SM, the f32 partials at
//   most a tenth of the cache's bytes.
//
// Every other instance (bf16 up to 128 wide, which llama3.2-3b's serving
// path runs; float32 at either width): the CUDA-core layout.
// - The cache is read in place from [B, S_max, Kv, hd] by strides, once per
//   kv head: a block owns a (b, kv head) pair, a group of NG of its q heads
//   (NG divides g and is at most 8, so no head slot is dead) and a
//   contiguous slice of positions, a multiple of the 64-position tile.
// - K and V tiles (64 positions x hd) stream into shared memory through
//   16-byte cp.async in a ring of 3 stages, one tile ahead (35 KB in flight
//   per block in bf16, two blocks an SM); the third stage lets the loop run
//   with three barriers a tile instead of four. Rows are padded
//   by 16 bytes so that neighbouring rows' 16-byte reads hit distinct banks.
// - One pass per tile for all NG heads: thread (position p, quarter of hd)
//   computes NG partial dots from its k row and q (f32, in shared memory,
//   read as broadcasts); warp h sums the quarters of head h, takes the
//   tile's max and runs one online-softmax step per tile; then thread
//   (8 columns, 4 positions) accumulates P V for all NG heads. No
//   per-position shuffle butterfly.
// - Two instances of the layout, by the widest head it takes (MAXHD): 128
//   and, for float32 only, 192, whose PV pass uses 24 column groups of 8 by
//   8 position groups (192 of the 256 threads) and whose ring keeps 2
//   stages and loads no tile ahead (3 would not fit shared memory).
// - A block's position groups are summed once, at its end, and written
//   as a partial (out normalised by its own l, m, l).
// - Blocks are launched kv head fastest: blocks that run together read the
//   same positions of all of a batch row's kv heads, whole cache rows.
// - The wrapper picks the split count (kernel.py: splits_for) so that the
//   partial kernel launches at least two full waves at the serving shape.
//
// Both designs end in one combine kernel, launched as a programmatic
// dependent launch, with the arithmetic of flash_decode_combine: m* = max
// m_i, w_i = l_i exp(m_i - m*), out = sum w_i out_i / max(sum w_i, 1e-30);
// it returns m* and sum w_i as m and l.
//
// Neither kernel allocates (the wrapper passes the partials' scratch); both
// launch on the caller's stream. The C entry returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernels do not take, or a tensor
// map that cuTensorMapEncodeTiled refuses).

// TMA, mbarriers and the tensor-map encoder, shared with the attention kernels
#include "../../attention/csrc/hopper.cuh"

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHd = 192;        // the widest instance
constexpr int kTile = 64;          // positions per stage
constexpr int kQuarters = kThreads / kTile;  // hd quarters in the score pass
constexpr int kCombineThreads = 128;
constexpr int kMaxGroup = 8;       // q heads per block
constexpr int kMaxSplits = 1024;   // the combine's weights, in static shared memory
constexpr int kCombineBatch = 16;  // partials whose loads the combine issues at once
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes as floats: 8 bf16 or 4 f32
template <typename T>
struct Chunk {
  static constexpr int kElems = 16 / sizeof(T);
};
__device__ __forceinline__ void unpack(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: write zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the shared-memory layout of the instance for heads up to MAXHD wide
template <typename T, int MAXHD>
struct Layout {
  // cp.async ring: 3 stages, or 2 for f32 rows 192 wide (3 would not fit;
  // bf16 rows wider than 128 take the tensor-core instance)
  static constexpr int kStages = (sizeof(T) == 4 && MAXHD > 128) ? 2 : 3;
  // tiles loaded ahead of the one in use: a stage is refilled kStages - 1
  // tiles after it was read, so the barriers inside an iteration already
  // order the reads before the refill and the loop needs no barrier at its end
  static constexpr int kAhead = kStages - 2;
  static constexpr int kLd = MAXHD + Chunk<T>::kElems;  // padded row, elements
  static constexpr int kTileElems = kTile * kLd;
  static constexpr size_t kRing = static_cast<size_t>(kStages) * 2 * kTileElems * sizeof(T);
  static constexpr int kColGroups = MAXHD / 8;                   // PV: 8 columns each
  static constexpr int kPosGroups = MAXHD > 128 ? 8 : 16;        // PV: kTile / kPosGroups positions each
  static constexpr int kPvThreads = kColGroups * kPosGroups;     // 256, or 192 of them
  static_assert(kPvThreads <= kThreads && kTile % kPosGroups == 0, "PV pass layout");
};

template <typename T, int NG, int MAXHD>
constexpr size_t smem_bytes() {
  // ring; q [NG][MAXHD]; quarter scores [4][NG][64]; probabilities [NG][64];
  // corr, m, l [NG]
  return Layout<T, MAXHD>::kRing +
         sizeof(float) * (NG * MAXHD + kQuarters * NG * kTile + NG * kTile + 3 * NG);
}
static_assert(smem_bytes<float, 8, 192>() <= 232448 && smem_bytes<__nv_bfloat16, 8, 128>() <= 232448 &&
                  smem_bytes<float, 8, 128>() <= 232448,
              "every instance fits a block's shared memory");

// positions [pos0, pos0 + 64) of k and v into one ring stage; positions at
// or past `end` and columns at or past hd are zero-filled
template <typename T, int MAXHD>
__device__ __forceinline__ void load_tile(T* dk, T* dv, const T* kb, const T* vb, long long kss,
                                          long long vss, int pos0, int end, int hd) {
  constexpr int kE = Chunk<T>::kElems;
  constexpr int kPerRow = MAXHD / kE;
  constexpr int kLd = Layout<T, MAXHD>::kLd;
  for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * kE;
    const bool valid = pos0 + r < end && col < hd;
    const long long pos = valid ? pos0 + r : 0;
    cp_async16(dk + r * kLd + col, kb + pos * kss + (valid ? col : 0), valid);
    cp_async16(dv + r * kLd + col, vb + pos * vss + (valid ? col : 0), valid);
  }
}

// grid (B*Kv, splits, g/NG): the kv heads of one batch row are neighbours
// in launch order, so blocks that run together read whole cache rows.
// Split i covers positions [i * chunk, min((i + 1) * chunk, length)),
// chunk a multiple of kTile.
// two blocks an SM up to four heads a group (the serving path's three
// included) in the 128-wide instance; wider groups keep their accumulators
// in registers instead. softcap > 0 caps the scaled logits.
template <typename T, int NG, int MAXHD>
__global__ void __launch_bounds__(kThreads, (NG <= 4 && MAXHD <= 128) ? 2 : 1)
    flash_decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, float* __restrict__ part_o,
                                float* __restrict__ part_m, float* __restrict__ part_l, int H,
                                int Kv, int hd, int length, int chunk, float scale, float softcap,
                                long long ksb, long long kss, long long ksh, long long vsb,
                                long long vss, long long vsh) {
  using L = Layout<T, MAXHD>;
  constexpr int kAhead = L::kAhead;
  constexpr int kE = Chunk<T>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + L::kRing);  // [NG][MAXHD]
  float* sc = q_s + NG * MAXHD;                           // [kQuarters][NG][kTile]
  float* p_s = sc + kQuarters * NG * kTile;                // [NG][kTile]
  float* corr_s = p_s + NG * kTile;                        // [NG]
  float* m_s = corr_s + NG;
  float* l_s = m_s + NG;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.y;
  const int b = blockIdx.x / Kv;
  const int kvh = blockIdx.x - b * Kv;
  const int g = H / Kv;
  const int head0 = b * H + kvh * g + blockIdx.z * NG;  // first q head of the group, b*H + h
  const int start = split * chunk;
  const int end = min(start + chunk, length);
  const int n_tiles = end > start ? (end - start + kTile - 1) / kTile : 0;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_tiles) {
      T* stage = ring + s * 2 * L::kTileElems;
      load_tile<T, MAXHD>(stage, stage + L::kTileElems, kb, vb, kss, vss, start + s * kTile, end, hd);
    }
    cp_async_commit();
  }
  for (int i = tid; i < NG * MAXHD; i += kThreads) {
    const int d = i % MAXHD;
    q_s[i] = d < hd ? to_f32(q[static_cast<long long>(head0 + i / MAXHD) * hd + d]) : 0.0f;
  }

  float m = kNegInf, l = 0.0f;  // warp h < NG keeps head h's stats
  float acc[NG][8];
#pragma unroll
  for (int h = 0; h < NG; ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[h][e] = 0.0f;
  const int sp = tid % kTile, quarter = tid / kTile;                 // score pass
  const int cg = tid % L::kColGroups, pg = tid / L::kColGroups;      // PV pass
  // every thread takes part in the PV pass of the 128-wide instance
  const bool pv = L::kPvThreads == kThreads || tid < L::kPvThreads;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + kAhead < n_tiles) {
      T* stage = ring + ((t + kAhead) % L::kStages) * 2 * L::kTileElems;
      load_tile<T, MAXHD>(stage, stage + L::kTileElems, kb, vb, kss, vss,
                          start + (t + kAhead) * kTile, end, hd);
    }
    cp_async_commit();
    cp_async_wait_ring<kAhead>();
    __syncthreads();
    const T* ks = ring + (t % L::kStages) * 2 * L::kTileElems;
    const T* vs = ks + L::kTileElems;
    const int pos0 = start + t * kTile;

    // scores: a quarter of hd for every head of the group
    {
      float dot[NG];
#pragma unroll
      for (int h = 0; h < NG; ++h) dot[h] = 0.0f;
      const T* krow = ks + sp * L::kLd + quarter * (MAXHD / kQuarters);
#pragma unroll
      for (int c = 0; c < MAXHD / kQuarters; c += kE) {
        float kf[kE];
        unpack(krow + c, kf);
#pragma unroll
        for (int h = 0; h < NG; ++h) {
          const float* qh = q_s + h * MAXHD + quarter * (MAXHD / kQuarters) + c;
#pragma unroll
          for (int e = 0; e < kE; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qh + e);
            dot[h] = fmaf(qv.x, kf[e], dot[h]);
            dot[h] = fmaf(qv.y, kf[e + 1], dot[h]);
            dot[h] = fmaf(qv.z, kf[e + 2], dot[h]);
            dot[h] = fmaf(qv.w, kf[e + 3], dot[h]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < NG; ++h) sc[(quarter * NG + h) * kTile + sp] = dot[h];
    }
    __syncthreads();

    // one online-softmax step per tile: warp h owns head h
    if (warp < NG) {
      float s[kTile / 32], mx = m;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const int p = lane + 32 * i;
        float x = 0.0f;
#pragma unroll
        for (int qq = 0; qq < kQuarters; ++qq) x += sc[(qq * NG + warp) * kTile + p];
        float y = x * scale;
        if (softcap > 0.0f) y = softcap * tanhf(y / softcap);
        s[i] = pos0 + p < end ? y : kNegInf;
        mx = fmaxf(mx, s[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m - mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const float p = expf(s[i] - mx);
        p_s[warp * kTile + lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l = l * corr + sum;
      m = mx;
      if (lane == 0) corr_s[warp] = corr;
    }
    __syncthreads();

    // P V: 8 columns x kTile/kPosGroups positions for every head of the group
    if (pv) {
#pragma unroll
      for (int h = 0; h < NG; ++h) {
        const float c = corr_s[h];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[h][e] *= c;
      }
#pragma unroll
      for (int i = 0; i < kTile / L::kPosGroups; ++i) {
        const int p = pg * (kTile / L::kPosGroups) + i;
        float vf[8];
#pragma unroll
        for (int c = 0; c < 8; c += kE) unpack(vs + p * L::kLd + cg * 8 + c, vf + c);
#pragma unroll
        for (int h = 0; h < NG; ++h) {
          const float pr = p_s[h * kTile + p];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[h][e] = fmaf(pr, vf[e], acc[h][e]);
        }
      }
    }
  }

  // the combine may be placed now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // sum the position groups (the ring is free now) and write the partial
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();  // every thread is done with the ring
  float* red = reinterpret_cast<float*>(smem);  // [kPosGroups][NG][MAXHD]
  static_assert(L::kPosGroups * NG * MAXHD * sizeof(float) <= L::kRing, "the sums fit the ring");
  if (pv) {
#pragma unroll
    for (int h = 0; h < NG; ++h)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(pg * NG + h) * MAXHD + cg * 8 + e] = acc[h][e];
  }
  if (warp < NG && lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  const int n_part = gridDim.y;
  for (int i = tid; i < NG * hd; i += kThreads) {
    const int h = i / hd, d = i - h * hd;
    float o = 0.0f;
#pragma unroll
    for (int r = 0; r < L::kPosGroups; ++r) o += red[(r * NG + h) * MAXHD + d];
    const long long idx = static_cast<long long>(head0 + h) * n_part + split;
    part_o[idx * hd + d] = o / fmaxf(l_s[h], 1e-30f);
    if (d == 0) {
      part_m[idx] = m_s[h];
      part_l[idx] = l_s[h];
    }
  }
}

// one block per (b, h): combine its n_part partials with the arithmetic of
// flash_decode_combine. The stats are read in parallel and the weights kept
// in shared memory, so each output column's sum has its loads in flight
// together rather than one L2 round trip per partial.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    flash_decode_combine_kernel(const float* __restrict__ part_o,
                                const float* __restrict__ part_m,
                                const float* __restrict__ part_l, T* __restrict__ out,
                                float* __restrict__ m_out, float* __restrict__ l_out, int hd,
                                int n_part) {
  __shared__ float w[kMaxSplits];
  __shared__ float red[2][kCombineThreads / 32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the partial kernel has finished
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = blockIdx.x;
  const float* pm = part_m + bh * n_part;
  const float* pl = part_l + bh * n_part;
  float ms = kNegInf, den = 0.0f;
  for (int i = tid; i < n_part; i += kCombineThreads) ms = fmaxf(ms, pm[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ms = fmaxf(ms, __shfl_xor_sync(0xffffffffu, ms, off));
  if (lane == 0) red[0][warp] = ms;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCombineThreads / 32; ++i) ms = fmaxf(ms, red[0][i]);
  for (int i = tid; i < n_part; i += kCombineThreads) {
    const float wi = pl[i] * expf(pm[i] - ms);
    w[i] = wi;
    den += wi;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
  if (lane == 0) red[1][warp] = den;
  __syncthreads();
  den = 0.0f;
#pragma unroll
  for (int i = 0; i < kCombineThreads / 32; ++i) den += red[1][i];
  for (int d = tid; d < hd; d += kCombineThreads) {
    const float* po = part_o + bh * n_part * hd + d;
    float num = 0.0f;
    for (int j0 = 0; j0 < n_part; j0 += kCombineBatch) {
      float x[kCombineBatch];  // the batch's loads, all in flight together
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u) x[u] = j0 + u < n_part ? po[(j0 + u) * hd] : 0.0f;
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u)
        if (j0 + u < n_part) num = fmaf(w[j0 + u], x[u], num);
    }
    store(out + bh * hd + d, num / fmaxf(den, 1e-30f));
  }
  if (tid == 0) {
    m_out[bh] = ms;
    l_out[bh] = den;
  }
}

template <typename T, int NG, int MAXHD>
cudaError_t launch_partial(const void* q, const void* k, const void* v, float* part_o,
                           float* part_m, float* part_l, int B, int H, int Kv, int hd, int length,
                           int splits, int chunk, float scale, float softcap, const long long* ks,
                           const long long* vs, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, NG, MAXHD>();
  cudaError_t err = cudaFuncSetAttribute(flash_decode_partial_kernel<T, NG, MAXHD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Kv, splits, H / Kv / NG);
  flash_decode_partial_kernel<T, NG, MAXHD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part_o,
      part_m, part_l, H, Kv, hd, length, chunk, scale, softcap, ks[0], ks[1], ks[2], vs[0], vs[1],
      vs[2]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core instance, heads wider than 128
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kTile = 32;                      // positions a stage: the tensor maps' box rows
constexpr int kHd = 192;                       // the instance's width: three 64-column boxes
constexpr int kBoxes = kHd / kBoxCols;
constexpr int kStages = 3;                     // the k/v ring
constexpr int kRows = 16;                      // q heads a row tile: the mma's m
constexpr int kSlices = kTile / 16;            // consumer warps a row tile, 16 positions each
constexpr int kMaxRowTiles = 2;                // row tiles a block: g <= 32 reads the cache once
constexpr int kBoxBytes = kTile * kRowBytes;   // 4 KB
constexpr int kTileBytes = kBoxes * kBoxBytes;  // one k (or v) tile, 12 KB
constexpr int kFrag = kHd / 2;                 // O accumulators a thread: 24 n8 tiles x 4
constexpr float kLn2 = 0.6931471805599453f;

template <int RT>
struct Shape {
  static constexpr int kConsumers = RT * kSlices;           // warps
  static constexpr int kThreads = 32 * (1 + kConsumers);    // and one producer warp
  // blocks an SM: two of one row tile, one of two. Shared memory would take
  // three of either, but three warps on one of the SM's four sub-partitions
  // cap a thread at 168 registers, and the kernel then spills; at two blocks
  // (or one of five warps) it has up to 255 and spills nothing
  static constexpr int kBlocks = RT == 1 ? 2 : 1;
  static constexpr int kBars = 3 * kStages;                 // k full, v full, k/v empty
  // the swizzled boxes need 1024-byte alignment, which the base is rounded up to
  static constexpr int kSmem = 1024 + kStages * 2 * kTileBytes + 8 * kBars;
  // the merge's scratch in the ring: each slice past the first of every row
  // tile, its O fragments and m, l, as [value][lane]
  static_assert(RT * (kSlices - 1) * (kFrag + 4) * 32 * 4 <= kStages * 2 * kTileBytes, "the merge fits the ring");
};
static_assert(Shape<1>::kBlocks * (Shape<1>::kSmem + 1024) <= 233472 &&
                  Shape<2>::kBlocks * (Shape<2>::kSmem + 1024) <= 233472,
              "the planned blocks fit an SM's shared memory (1 KB of it reserved a block)");

// byte offset, in a tile of kBoxes boxes laid out by TMA with the 128-byte
// swizzle, of row r's 16-byte chunk c (columns 8c .. 8c + 7)
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c / 8) * kBoxBytes + r * kRowBytes + (((c % 8) ^ (r % 8)) << 4);
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// d[4] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulated
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (B*Kv, splits, ceil(g / (16 RT))): kv heads fastest, as the CUDA-core
// layout. Split i covers positions [i * chunk, min((i + 1) * chunk, length)),
// chunk a multiple of kTile. Warp 0 produces (one thread issues every TMA
// load); consumer warp w takes row tile w / kSlices (q heads 16 (w /
// kSlices) .. + 15 of the block's) and positions 16 (w % kSlices) .. + 15 of
// every tile. CAP: logits capped as softcap * tanh(x * scale / softcap)
// (`scale_log2` is then softcap * log2 e and `cap_arg` scale / softcap);
// otherwise x * scale_log2 (scale * log2 e).
template <int RT, bool CAP>
__global__ void __launch_bounds__(Shape<RT>::kThreads, Shape<RT>::kBlocks)
    flash_decode_tc_kernel(const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __nv_bfloat16* __restrict__ q, float* __restrict__ part_o,
                           float* __restrict__ part_m, float* __restrict__ part_l, int H, int Kv,
                           int hd, int length, int chunk, float scale_log2, float cap_arg) {
  using Sh = Shape<RT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // stage st: k tile, then v tile
  const uint32_t bars = ring + kStages * 2 * kTileBytes;
  auto k_full = [&](int st) { return bars + 8u * st; };
  auto v_full = [&](int st) { return bars + 8u * (kStages + st); };
  auto kv_empty = [&](int st) { return bars + 8u * (2 * kStages + st); };

  const int split = blockIdx.y;
  const int b = blockIdx.x / Kv;
  const int kvh = blockIdx.x - b * Kv;
  const int g = H / Kv;
  const int start = split * chunk;
  const int end = min(start + chunk, length);
  const int n_tiles = end > start ? (end - start + kTile - 1) / kTile : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(kv_empty(st), Sh::kConsumers * 32);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // ---- producer ------------------------------------------------------
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const uint32_t kt = ring + st * 2 * kTileBytes;
        mbar_wait(kv_empty(st), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(st), kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load(kt + c * kBoxBytes, &kmap, k_full(st), c * kBoxCols, kvh, start + t * kTile, b);
        mbar_expect_tx(v_full(st), kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load(kt + kTileBytes + c * kBoxBytes, &vmap, v_full(st), c * kBoxCols, kvh, start + t * kTile, b);
      }
    }
    return;
  }

  // ---- consumers ---------------------------------------------------------
  const int cw = warp - 1;
  const int rt = cw / kSlices, slice = cw % kSlices;
  const int head0 = blockIdx.z * (RT * kRows) + rt * kRows + lane / 4;  // this thread's rows: head0, head0 + 8
  const long long qrow = static_cast<long long>(b) * H + kvh * g;      // b*H + the kv head's first q head

  // Q's A fragments (rows past g and columns past hd are zero), kept in
  // registers across the loop
  uint32_t qa[kHd / 4];
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = head0 + 8 * (e % 2), c = 16 * kk + 2 * (lane % 4) + 8 * (e / 2);
      qa[4 * kk + e] = r < g && c < hd ? *reinterpret_cast<const uint32_t*>(q + (qrow + r) * hd + c) : 0u;
    }
  }
  float o[kFrag];
#pragma unroll
  for (int i = 0; i < kFrag; ++i) o[i] = 0.0f;
  // m in log2 units (the thread's rows); l the thread's share of the row sum,
  // summed over its quad at the end
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  // ldmatrix row addresses: thread t names row t % 8 of matrix t / 8. K:
  // matrices (positions 0-7, columns +0), (0-7, +8), (8-15, +0), (8-15, +8)
  // of a 16-column step give the B fragments of both n8 halves; V
  // (transposed): (0-7, +0), (8-15, +0), (0-7, +8), (8-15, +8) of a
  // 16-column pair of n8 tiles
  const int mi = lane / 8, mr = lane % 8;
  const int k_row = slice * 16 + (mi / 2) * 8 + mr, k_col = mi % 2;
  const int v_row = slice * 16 + (mi % 2) * 8 + mr, v_col = mi / 2;
  const int pos_lane = slice * 16 + 2 * (lane % 4);  // the thread's score columns: + 8j + {0, 1}

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int phase = (t / kStages) & 1;
    const uint32_t kt = ring + st * 2 * kTileBytes, vt = kt + kTileBytes;

    // S = Q K^T for the warp's 16 positions: two n8 tiles
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.0f;
    mbar_wait(k_full(st), phase);
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + swizzled(k_row, 2 * kk + k_col));
      mma(s, qa + 4 * kk, kb[0], kb[1]);
      mma(s + 4, qa + 4 * kk, kb[2], kb[3]);
    }

    // online softmax on the fragments, in log2 units: s[4j + e] is row
    // head0 + 8 (e / 2), position pos_lane + 8j + e % 2 of the tile
    const int p0 = start + t * kTile + pos_lane;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = CAP ? scale_log2 * tanhf(s[i] * cap_arg) : s[i] * scale_log2;
      s[i] = p0 + 8 * (i / 4) + i % 2 < end ? y : -INFINITY;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] = ex2(s[i] - m[(i % 4) / 2]);
      l[(i % 4) / 2] += s[i];
    }
#pragma unroll
    for (int i = 0; i < kFrag; ++i) o[i] *= corr[(i % 4) / 2];
    // P in bf16: the A fragment of one 16-position k-step
    const uint32_t pa[4] = {pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]), pack_bf16(s[4], s[5]),
                            pack_bf16(s[6], s[7])};

    // O += P V: 24 n8 tiles, two a transposed ldmatrix
    mbar_wait(v_full(st), phase);
#pragma unroll
    for (int jj = 0; jj < kHd / 16; ++jj) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt + swizzled(v_row, 2 * jj + v_col));
      mma(o + 8 * jj, pa, vb[0], vb[1]);
      mma(o + 8 * jj + 4, pa, vb[2], vb[3]);
    }
    mbar_arrive(kv_empty(st));
  }

  // the combine may be placed now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // merge a row tile's slices through the ring: every load has landed and
  // been read once all consumers pass the first barrier
  float* red = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
  asm volatile("bar.sync 1, %0;\n" ::"n"(Sh::kConsumers * 32) : "memory");
  if (slice > 0) {
    float* dst = red + (rt * (kSlices - 1) + slice - 1) * (kFrag + 4) * 32 + lane;
#pragma unroll
    for (int i = 0; i < kFrag; ++i) dst[i * 32] = o[i];
    dst[kFrag * 32] = m[0];
    dst[(kFrag + 1) * 32] = m[1];
    dst[(kFrag + 2) * 32] = l[0];
    dst[(kFrag + 3) * 32] = l[1];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(Sh::kConsumers * 32) : "memory");
  if (slice > 0) return;
  float mm[2] = {m[0], m[1]};
#pragma unroll
  for (int sl = 1; sl < kSlices; ++sl) {
    const float* src = red + (rt * (kSlices - 1) + sl - 1) * (kFrag + 4) * 32 + lane;
    mm[0] = fmaxf(mm[0], src[kFrag * 32]);
    mm[1] = fmaxf(mm[1], src[(kFrag + 1) * 32]);
  }
  float a[2] = {ex2(m[0] - mm[0]), ex2(m[1] - mm[1])};
  float den[2] = {l[0] * a[0], l[1] * a[1]};
#pragma unroll
  for (int i = 0; i < kFrag; ++i) o[i] *= a[(i % 4) / 2];
#pragma unroll
  for (int sl = 1; sl < kSlices; ++sl) {
    const float* src = red + (rt * (kSlices - 1) + sl - 1) * (kFrag + 4) * 32 + lane;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      a[r] = ex2(src[(kFrag + r) * 32] - mm[r]);
      den[r] += src[(kFrag + 2 + r) * 32] * a[r];
    }
#pragma unroll
    for (int i = 0; i < kFrag; ++i) o[i] += src[i * 32] * a[(i % 4) / 2];
  }

  // the partial: out normalised by its own l, m in natural-log units (-1e30
  // for a split with no position), l
  const int n_part = gridDim.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int head = head0 + 8 * r;
    if (head >= g) continue;
    const long long idx = (qrow + head) * n_part + split;
    const float inv = 1.0f / fmaxf(den[r], 1e-30f);
    float* dst = part_o + idx * hd;
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < hd) *reinterpret_cast<float2*>(dst + col) = make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    if (lane % 4 == 0) {
      part_m[idx] = den[r] > 0.0f ? mm[r] * kLn2 : kNegInf;
      part_l[idx] = den[r];
    }
  }
}

template <int RT, bool CAP>
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(flash_decode_tc_kernel<RT, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<RT>::kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_decode_tc_kernel<RT, CAP>, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int RT, bool CAP>
cudaError_t launch_instance(const CUtensorMap& kmap, const CUtensorMap& vmap, const void* q, float* part_o,
                            float* part_m, float* part_l, int B, int H, int Kv, int hd, int length,
                            int splits, int chunk, float scale, float softcap, cudaStream_t stream) {
  cudaError_t err = prepare<RT, CAP>();
  if (err != cudaSuccess) return err;
  const int heads = RT * kRows;
  const dim3 grid(B * Kv, splits, (H / Kv + heads - 1) / heads);
  const float scale_log2 = CAP ? softcap * kLog2e : scale * kLog2e;
  const float cap_arg = CAP ? scale / softcap : 0.0f;
  flash_decode_tc_kernel<RT, CAP><<<grid, Shape<RT>::kThreads, Shape<RT>::kSmem, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), part_o, part_m, part_l, H, Kv, hd, length, chunk,
      scale_log2, cap_arg);
  return cudaGetLastError();
}

// heads: q heads a block (16 or 32); layouts: k's and v's tensor-map
// layouts, 11 values each (dims with the position extent `length`, byte
// strides, a box of 64 columns x kTile positions)
cudaError_t launch(const void* q, const void* k, const void* v, float* part_o, float* part_m,
                   float* part_l, int B, int H, int Kv, int hd, int length, int splits, int chunk,
                   int heads, float scale, float softcap, const long long* layouts, cudaStream_t stream) {
  CUtensorMap maps[2];
  if (!encode(&maps[0], k, layouts, kTile) || !encode(&maps[1], v, layouts + 11, kTile))
    return cudaErrorInvalidValue;
  const bool cap = softcap > 0.0f;
#define ARGS maps[0], maps[1], q, part_o, part_m, part_l, B, H, Kv, hd, length, splits, chunk, scale, softcap, stream
  if (heads == kRows) return cap ? launch_instance<1, true>(ARGS) : launch_instance<1, false>(ARGS);
  if (heads == 2 * kRows) return cap ? launch_instance<2, true>(ARGS) : launch_instance<2, false>(ARGS);
#undef ARGS
  return cudaErrorInvalidValue;
}

// blocks of the RT-row-tile instance that fit one SM (the lesser of the
// capped and uncapped kernels'), or -1 on an error
template <int RT>
int blocks_per_sm() {
  int n[2] = {0, 0};
  if (prepare<RT, false>() != cudaSuccess || prepare<RT, true>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n[0], flash_decode_tc_kernel<RT, false>, Shape<RT>::kThreads,
                                                    Shape<RT>::kSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n[1], flash_decode_tc_kernel<RT, true>, Shape<RT>::kThreads,
                                                    Shape<RT>::kSmem) != cudaSuccess)
    return -1;
  return n[0] < n[1] ? n[0] : n[1];
}

}  // namespace tc

template <typename T, int MAXHD>
cudaError_t launch_groups(const void* q, const void* k, const void* v, float* part_o, float* part_m,
                          float* part_l, int B, int H, int Kv, int hd, int length, int splits, int chunk,
                          int ng, float scale, float softcap, const long long* ks, const long long* vs,
                          cudaStream_t stream) {
  switch (ng) {
#define CASE(N)                                                                                     \
  case N:                                                                                           \
    return launch_partial<T, N, MAXHD>(q, k, v, part_o, part_m, part_l, B, H, Kv, hd, length, splits, \
                                       chunk, scale, softcap, ks, vs, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* m, float* l,
           float* part_o, float* part_m, float* part_l, int B, int H, int Kv, int hd, int length,
           int splits, int chunk, int ng, float scale, float softcap, const long long* ks,
           const long long* vs, const long long* tma, cudaStream_t stream) {
  cudaError_t err;
  if (hd <= 128) {
    err = launch_groups<T, 128>(q, k, v, part_o, part_m, part_l, B, H, Kv, hd, length, splits, chunk, ng,
                                scale, softcap, ks, vs, stream);
  } else if constexpr (std::is_same<T, float>::value) {
    err = launch_groups<float, 192>(q, k, v, part_o, part_m, part_l, B, H, Kv, hd, length, splits, chunk,
                                    ng, scale, softcap, ks, vs, stream);
  } else {
    err = tc::launch(q, k, v, part_o, part_m, part_l, B, H, Kv, hd, length, splits, chunk, ng, scale, softcap,
                     tma, stream);
  }
  if (err != cudaSuccess) return err;
  // a programmatic dependent launch: the combine's blocks are placed while
  // the partial kernel's last wave runs, and wait for its results in the
  // kernel (griddepcontrol.wait), not behind a launch at its end
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * H);
  config.blockDim = dim3(kCombineThreads);
  config.stream = stream;
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = overlap;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, flash_decode_combine_kernel<T>, static_cast<const float*>(part_o),
                            static_cast<const float*>(part_m), static_cast<const float*>(part_l),
                            static_cast<T*>(out), m, l, hd, splits);
}

}  // namespace

extern "C" {

int flash_decode_max_hd() { return kMaxHd; }

int flash_decode_tile() { return kTile; }

int flash_decode_max_group() { return kMaxGroup; }

int flash_decode_max_splits() { return kMaxSplits; }

int flash_decode_tc_tile() { return tc::kTile; }

int flash_decode_tc_rows() { return tc::kRows; }

int flash_decode_tc_max_row_tiles() { return tc::kMaxRowTiles; }

// blocks of the tensor-core instance that fit one SM, for `heads` (16 or
// 32) q heads a block; -1 on an error
int flash_decode_tc_blocks_per_sm(int heads) {
  return heads == tc::kRows ? tc::blocks_per_sm<1>() : heads == 2 * tc::kRows ? tc::blocks_per_sm<2>() : -1;
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: [B, H, hd] contiguous; k, v: [B, S, Kv, hd] with strides in elements
// (batch, position, head), a contiguous last dimension and rows on 16-byte
// boundaries; out [B, H, hd] in q's type, m and l [B, H] float32. Split i
// covers positions [i * chunk, min((i + 1) * chunk, length)). Scratch:
// part_o float32 [B*H, splits, hd], part_m and part_l float32 [B*H, splits].
// dtype: 0 float32, 1 bfloat16. softcap > 0 caps the scaled logits.
// bfloat16 with hd > 128 runs the tensor-core instance: ng q heads a block
// (16 or 32, ceil(H/Kv / ng) blocks a kv head), chunk a multiple of
// flash_decode_tc_tile(), `tma` k's and v's tensor-map layouts (11 values
// each: dims (hd, Kv, length, B), byte strides, box (64, 1, tile, 1)).
// Otherwise the CUDA-core layout (128 wide up to hd 128, else 192): ng q
// heads (a divisor of H/Kv, at most 8) share a block, chunk a multiple of
// flash_decode_tile(), `tma` unused.
int flash_decode_launch(const void* q, const void* k, const void* v, void* out, float* m,
                        float* l, float* part_o, float* part_m, float* part_l, int dtype, int B,
                        int S, int H, int Kv, int hd, int length, int splits, int chunk, int ng,
                        float scale, float softcap, long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh, const long long* tma,
                        void* stream) {
  if (B < 1 || Kv < 1 || H < Kv || H % Kv != 0 || hd < 8 || hd > kMaxHd || hd % 8 != 0 ||
      !(softcap >= 0.0f) || length < 0 || length > S || splits < 1 || splits > kMaxSplits ||
      static_cast<long long>(splits) * chunk < length || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const bool tensor_cores = dtype == 1 && hd > 128;
  const int g = H / Kv;
  if (tensor_cores ? (tma == nullptr || (ng != tc::kRows && ng != 2 * tc::kRows) || chunk < tc::kTile ||
                      chunk % tc::kTile != 0 || (g + ng - 1) / ng > 65535)
                   : (chunk < kTile || chunk % kTile != 0 || ng < 1 || ng > kMaxGroup || g % ng != 0 ||
                      g / ng > 65535))
    return cudaErrorInvalidValue;
  const long long ks[3] = {ksb, kss, ksh}, vs[3] = {vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, m, l, part_o, part_m, part_l, B, H, Kv, hd, length,
                         splits, chunk, ng, scale, softcap, ks, vs, tma, st);
  return launch<__nv_bfloat16>(q, k, v, out, m, l, part_o, part_m, part_l, B, H, Kv, hd,
                               length, splits, chunk, ng, scale, softcap, ks, vs, tma, st);
}

}  // extern "C"
