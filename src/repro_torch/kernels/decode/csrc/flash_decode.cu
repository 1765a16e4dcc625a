// Flash decode for Hopper (sm_90a): one query token per sequence against a
// KV cache, bound through a plain C interface (loaded with ctypes by
// kernels/decode/kernel.py).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode/kernel.py: flash_decode (_decode_kernel).
//   out[b, h] = softmax_{j < length}(q[b, h] . k[b, j, h // g] * scale) v[b, j, h // g]
//   with the softmax stats m (max logit) and l (sum of exp(logit - m))
//   returned beside it, so that partials over slices of the cache combine
//   exactly (dist/collectives.py: flash_decode_combine). length == 0 gives
//   out = 0, m = -1e30, l = 0, as the Pallas kernel does.
//
// What bounds it on this card: bytes. Every cache row up to `length` is
// read once and used for a handful of FMAs per q head; at the serving
// path's shape (B=8, Kv=8, hd=128, length ~2,048..2,176, bf16) that is
// 67 MB, 0.020 ms at 3.35 TB/s.
//
// Design: the cache is read in place from [B, S_max, Kv, hd] by strides (a
// transposed copy would cost a full cache read and write every layer of
// every step) and read once per kv head, not once per q head: one warp
// owns a (b, kv head) pair, up to four of its q heads, and a contiguous
// slice of positions. Each lane holds hd/32 columns of q, of the k and v
// rows, and of the running output; four positions are loaded together
// (independent loads in flight), their dots meet in a shuffle butterfly,
// and one online-softmax step takes all four. B*Kv = 64 pairs would fill
// only half of the 132 SMs, so the length is split: each warp writes a
// partial (out normalised by its own l, m, l), and a second small kernel
// combines a head's partials with the arithmetic of flash_decode_combine:
// m* = max m_i, w_i = l_i exp(m_i - m*), out = sum w_i out_i / max(sum w_i,
// 1e-30), and returns m* and sum w_i as m and l. More than four q heads
// per kv head take more head groups (grid z), which re-read the cache
// slice from L2.
//
// Neither kernel allocates (the wrapper passes the partials' scratch); both
// launch on the caller's stream. The C entry returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;           // warps (partials) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHd = 128;
constexpr int kEpl = kMaxHd / 32;   // columns per lane: lane + 32e
constexpr int kHeads = 4;           // q heads per warp (one head group)
constexpr int kBatch = 4;           // positions per online-softmax step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// grid (splits, B*Kv, head groups); partial p = blockIdx.x * kWarps + warp
// covers positions [p * chunk, min((p + 1) * chunk, length)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, float* __restrict__ part_o,
                                float* __restrict__ part_m, float* __restrict__ part_l, int H,
                                int Kv, int hd, int length, int chunk, int n_part, float scale,
                                long long ksb, long long kss, long long ksh, long long vsb,
                                long long vss, long long vsh) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int part = blockIdx.x * kWarps + warp;
  const int b = blockIdx.y / Kv;
  const int kvh = blockIdx.y - b * Kv;
  const int g = H / Kv;
  const int g0 = blockIdx.z * kHeads;
  const int ng = min(kHeads, g - g0);
  const int start = part * chunk;
  const int end = min(start + chunk, length);
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  float qr[kHeads][kEpl], acc[kHeads][kEpl], m[kHeads], l[kHeads];
#pragma unroll
  for (int gi = 0; gi < kHeads; ++gi) {
    const T* qh = q + (static_cast<long long>(b) * H + kvh * g + g0 + gi) * hd;
#pragma unroll
    for (int e = 0; e < kEpl; ++e) {
      const int d = lane + 32 * e;
      qr[gi][e] = (gi < ng && d < hd) ? to_f32(qh[d]) : 0.0f;
      acc[gi][e] = 0.0f;
    }
    m[gi] = kNegInf;
    l[gi] = 0.0f;
  }

  for (int base = start; base < end; base += kBatch) {  // position `base` is valid
    float kr[kBatch][kEpl], vr[kBatch][kEpl];
#pragma unroll
    for (int p = 0; p < kBatch; ++p) {
      const bool valid = base + p < end;
      const long long pos = valid ? base + p : base;
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        const int d = lane + 32 * e;
        kr[p][e] = (valid && d < hd) ? to_f32(kb[pos * kss + d]) : 0.0f;
        vr[p][e] = (valid && d < hd) ? to_f32(vb[pos * vss + d]) : 0.0f;
      }
    }
    float s[kHeads][kBatch];
#pragma unroll
    for (int gi = 0; gi < kHeads; ++gi)
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) dot = fmaf(qr[gi][e], kr[p][e], dot);
        s[gi][p] = dot;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int gi = 0; gi < kHeads; ++gi)
#pragma unroll
        for (int p = 0; p < kBatch; ++p) s[gi][p] += __shfl_xor_sync(0xffffffffu, s[gi][p], off);
#pragma unroll
    for (int gi = 0; gi < kHeads; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        s[gi][p] = base + p < end ? s[gi][p] * scale : kNegInf;
        mx = fmaxf(mx, s[gi][p]);
      }
      const float corr = expf(m[gi] - mx);
      float pr[kBatch], sum = 0.0f;
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        pr[p] = expf(s[gi][p] - mx);
        sum += pr[p];
      }
      l[gi] = l[gi] * corr + sum;
      m[gi] = mx;
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        float a = acc[gi][e] * corr;
#pragma unroll
        for (int p = 0; p < kBatch; ++p) a = fmaf(pr[p], vr[p][e], a);
        acc[gi][e] = a;
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < kHeads; ++gi) {
    if (gi >= ng) break;
    const long long idx = (static_cast<long long>(b) * H + kvh * g + g0 + gi) * n_part + part;
    const float denom = fmaxf(l[gi], 1e-30f);
#pragma unroll
    for (int e = 0; e < kEpl; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) part_o[idx * hd + d] = acc[gi][e] / denom;
    }
    if (lane == 0) {
      part_m[idx] = m[gi];
      part_l[idx] = l[gi];
    }
  }
}

// one block per (b, h): combine its n_part partials
template <typename T>
__global__ void __launch_bounds__(kMaxHd)
    flash_decode_combine_kernel(const float* __restrict__ part_o,
                                const float* __restrict__ part_m,
                                const float* __restrict__ part_l, T* __restrict__ out,
                                float* __restrict__ m_out, float* __restrict__ l_out, int hd,
                                int n_part) {
  const long long bh = blockIdx.x;
  const float* pm = part_m + bh * n_part;
  const float* pl = part_l + bh * n_part;
  float ms = kNegInf;
  for (int i = 0; i < n_part; ++i) ms = fmaxf(ms, pm[i]);
  float den = 0.0f;
  for (int i = 0; i < n_part; ++i) den += pl[i] * expf(pm[i] - ms);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float num = 0.0f;
    for (int i = 0; i < n_part; ++i)
      num = fmaf(pl[i] * expf(pm[i] - ms), part_o[(bh * n_part + i) * hd + d], num);
    store(out + bh * hd + d, num / fmaxf(den, 1e-30f));
  }
  if (threadIdx.x == 0) {
    m_out[bh] = ms;
    l_out[bh] = den;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* m, float* l,
           float* part_o, float* part_m, float* part_l, int B, int H, int Kv, int hd, int length,
           int splits, float scale, const long long* ks, const long long* vs,
           cudaStream_t stream) {
  const int n_part = splits * kWarps;
  const int chunk = (length + n_part - 1) / n_part;
  const int g = H / Kv;
  const dim3 grid(splits, B * Kv, (g + kHeads - 1) / kHeads);
  flash_decode_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part_o,
      part_m, part_l, H, Kv, hd, length, chunk, n_part, scale, ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<T><<<B * H, kMaxHd, 0, stream>>>(
      part_o, part_m, part_l, static_cast<T*>(out), m, l, hd, n_part);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_decode_max_hd() { return kMaxHd; }

int flash_decode_warps_per_split() { return kWarps; }

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: [B, H, hd] contiguous; k, v: [B, S, Kv, hd] with strides in elements
// (batch, position, head) and a contiguous last dimension; out [B, H, hd]
// in q's type, m and l [B, H] float32. Scratch: part_o float32
// [B*H, splits*4, hd], part_m and part_l float32 [B*H, splits*4].
// dtype: 0 float32, 1 bfloat16.
int flash_decode_launch(const void* q, const void* k, const void* v, void* out, float* m,
                        float* l, float* part_o, float* part_m, float* part_l, int dtype, int B,
                        int S, int H, int Kv, int hd, int length, int splits, float scale,
                        long long ksb, long long kss, long long ksh, long long vsb,
                        long long vss, long long vsh, void* stream) {
  if (B < 1 || Kv < 1 || H < Kv || H % Kv != 0 || hd < 8 || hd > kMaxHd || hd % 8 != 0 ||
      length < 0 || length > S || splits < 1 || splits > 65535 ||
      static_cast<long long>(B) * Kv > 65535)
    return cudaErrorInvalidValue;
  const long long ks[3] = {ksb, kss, ksh}, vs[3] = {vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, m, l, part_o, part_m, part_l, B, H, Kv, hd, length,
                         splits, scale, ks, vs, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, m, l, part_o, part_m, part_l, B, H, Kv, hd,
                                 length, splits, scale, ks, vs, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
