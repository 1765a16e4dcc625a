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
// read once and used for about 3 FLOP a byte (g = 3 q heads per kv head);
// at the serving path's shape (B=8, Kv=8, hd=128, length 2,176, bf16) that
// is 71.4 MB, 0.0213 ms at 3.35 TB/s. So the design keeps enough bytes in
// flight on every SM and keeps the per-position work off the issue path.
//
// Design:
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
// - Two instances of the layout, by the widest head it takes (MAXHD): 128,
//   which llama3.2-3b's serving path runs (as before the 192 instance was
//   added), and 192 (nemotron-4), whose PV pass uses 24 column groups of 8
//   by 8 position groups (192 of the 256 threads). A f32 192-wide ring keeps
//   2 stages and loads no tile ahead (3 would not fit shared memory).
// - A block's position groups are summed once, at its end, and written
//   as a partial (out normalised by its own l, m, l); a second small kernel
//   combines a head's partials with the arithmetic of flash_decode_combine:
//   m* = max m_i, w_i = l_i exp(m_i - m*), out = sum w_i out_i / max(sum w_i,
//   1e-30), and returns m* and sum w_i as m and l.
// - Blocks are launched kv head fastest: blocks that run together read the
//   same positions of all of a batch row's kv heads, whole cache rows.
// - The wrapper picks the split count (kernel.py: splits_for) so that the
//   partial kernel launches at least two full waves at the serving shape.
//
// Neither kernel allocates (the wrapper passes the partials' scratch); both
// launch on the caller's stream. The C entry returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernels do not take).

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
  // cp.async ring: 3 stages, or 2 for f32 rows 192 wide (3 would not fit)
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
static_assert(smem_bytes<float, 8, 192>() <= 232448 && smem_bytes<__nv_bfloat16, 8, 192>() <= 232448 &&
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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* m, float* l,
           float* part_o, float* part_m, float* part_l, int B, int H, int Kv, int hd, int length,
           int splits, int chunk, int ng, float scale, float softcap, const long long* ks,
           const long long* vs, cudaStream_t stream) {
  cudaError_t err;
  switch (ng) {
#define CASE(N)                                                                                 \
  case N:                                                                                       \
    err = hd <= 128 ? launch_partial<T, N, 128>(q, k, v, part_o, part_m, part_l, B, H, Kv, hd,  \
                                                length, splits, chunk, scale, softcap, ks, vs,  \
                                                stream)                                         \
                    : launch_partial<T, N, 192>(q, k, v, part_o, part_m, part_l, B, H, Kv, hd,  \
                                                length, splits, chunk, scale, softcap, ks, vs,  \
                                                stream);                                        \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return cudaErrorInvalidValue;
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

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: [B, H, hd] contiguous; k, v: [B, S, Kv, hd] with strides in elements
// (batch, position, head), a contiguous last dimension and rows on 16-byte
// boundaries; out [B, H, hd] in q's type, m and l [B, H] float32. Split i
// covers positions [i * chunk, min((i + 1) * chunk, length)); ng q heads
// (a divisor of H/Kv, at most 8) share a block. Scratch: part_o float32
// [B*H, splits, hd], part_m and part_l float32 [B*H, splits].
// dtype: 0 float32, 1 bfloat16. hd <= 128 runs the 128-wide instance, up
// to 192 the 192-wide one. softcap > 0 caps the scaled logits.
int flash_decode_launch(const void* q, const void* k, const void* v, void* out, float* m,
                        float* l, float* part_o, float* part_m, float* part_l, int dtype, int B,
                        int S, int H, int Kv, int hd, int length, int splits, int chunk, int ng,
                        float scale, float softcap, long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh, void* stream) {
  if (B < 1 || Kv < 1 || H < Kv || H % Kv != 0 || hd < 8 || hd > kMaxHd || hd % 8 != 0 ||
      !(softcap >= 0.0f) ||
      length < 0 || length > S || splits < 1 || splits > kMaxSplits || chunk < kTile ||
      chunk % kTile != 0 || static_cast<long long>(splits) * chunk < length || ng < 1 ||
      ng > kMaxGroup || (H / Kv) % ng != 0 || H / Kv / ng > 65535)
    return cudaErrorInvalidValue;
  const long long ks[3] = {ksb, kss, ksh}, vs[3] = {vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, m, l, part_o, part_m, part_l, B, H, Kv, hd, length,
                         splits, chunk, ng, scale, softcap, ks, vs, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, m, l, part_o, part_m, part_l, B, H, Kv, hd,
                                 length, splits, chunk, ng, scale, softcap, ks, vs, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
