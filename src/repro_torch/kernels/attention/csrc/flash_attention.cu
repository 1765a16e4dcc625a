// Causal GQA flash attention for Hopper (sm_90a), bound through a plain C
// interface (loaded with ctypes by kernels/attention/kernel.py).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/attention/kernel.py: flash_attention (_attn_kernel).
//   out[b, i, h] = softmax_j<=i(q[b, i, h] . k[b, j, h // g] * scale) v[b, j, h // g]
//   with the online softmax (m, l, acc) in float32, the reference's -1e30
//   sentinel for masked logits and max(l, 1e-30) as the denominator.
//
// What bounds it on this card: operations. At the serving path's shape
// (B=8, S=2048, H=24, Kv=8, hd=128, bf16) the causal half of QK^T and PV is
// 4*B*H*hd*S(S+1)/2 = 2.06e11 FLOP, 0.21 ms at the tensor cores' 989
// TFLOP/s, against 0.08 ms for the 268 MB of q, k, v and o. This first
// kernel runs on the CUDA cores (67 TFLOP/s of float32 FMA at best), so it
// sits well above that bound; wgmma, TMA and warp specialisation are later
// work.
//
// Design: one block of 256 threads per (64-row q tile, b*h). The q tile is
// staged in shared memory once; 64-row k/v tiles stream in through cp.async
// double buffering (the next tile loads while this one is used). k/v tiles
// past the q tile's last row are never loaded (the causal skip), and tiles
// are taken longest first (the last q tile of a head is block 0). Each
// thread owns 4 q rows: it computes a 4x4 block of the 64x64 score tile and
// 4 x hd/16 outputs; a row's 16 threads are one half-warp, so the row max
// and row sum are shuffles. q, k and v are read in place by strides from
// [B, S, H, hd] / [B, S, Kv, hd] (no transposed or padded copies); a ragged
// S is handled by zero-filled loads and unwritten rows, and hd is any
// multiple of 8 up to 128. Shared memory rows are padded by 16 bytes so
// that the 16-byte reads of eight neighbouring rows hit distinct banks.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() (or cudaErrorInvalidValue for arguments
// the kernel does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 64;            // k/v rows per tile (== kBQ: the diagonal tile is the last)
constexpr int kThreads = 256;      // 16 row groups x 16 threads
constexpr int kMaxHd = 128;
constexpr int kCols = kMaxHd / 16;  // output columns per thread
constexpr int kPLd = kBK + 4;      // row stride of the probability tile
constexpr float kNegInf = -1e30f;

template <typename T>
struct Pad;  // shared-memory row padding, 16 bytes
template <>
struct Pad<float> { static constexpr int kElems = 4; };
template <>
struct Pad<__nv_bfloat16> { static constexpr int kElems = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// four consecutive elements of a shared-memory row, as floats
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros (rows past S)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// rows [row0, row0 + 64) of one head, row stride `stride` elements, into a
// shared tile of row stride `ld`; rows at or past `rows` are zero-filled
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int row0,
                                          int rows, int hd, int ld) {
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  const int per_row = hd / kPerChunk;
  for (int c = threadIdx.x; c < kBK * per_row; c += kThreads) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * kPerChunk;
    const bool valid = row0 + r < rows;
    const T* g = src + (valid ? static_cast<long long>(row0 + r) * stride : 0) + col;
    cp_async16(dst + r * ld + col, g, valid);
  }
}

// f32 tiles take 186 KB of shared memory at hd 128, so one block per SM:
// it may use every register a thread can have. bf16 tiles fit two blocks.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S, int H, int Kv,
                           int hd, float scale, long long qsb, long long qss, long long qsh,
                           long long ksb, long long kss, long long ksh, long long vsb,
                           long long vss, long long vsh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = hd + Pad<T>::kElems;
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kBQ * ld;      // two stages
  T* sv = sk + 2 * kBK * ld;  // two stages
  float* sp = reinterpret_cast<float*>(sv + 2 * kBK * ld);

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x);  // longest tiles first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / Kv);
  const int q0 = qi * kBQ;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % 16;  // score columns tx + 16j, output columns tx + 16c

  load_tile(sq, qb, qss, q0, S, hd, ld);
  load_tile(sk, kb, kss, 0, S, hd, ld);
  load_tile(sv, vb, vss, 0, S, hd, ld);
  cp_async_commit();

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int n_k = (min(q0 + kBQ, S) - 1) / kBK + 1;  // causal skip
  for (int t = 0; t < n_k; ++t) {
    const int st = t & 1;
    if (t + 1 < n_k) {
      load_tile(sk + (st ^ 1) * kBK * ld, kb, kss, (t + 1) * kBK, S, hd, ld);
      load_tile(sv + (st ^ 1) * kBK * ld, vb, vss, (t + 1) * kBK, S, hd, ld);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const T* ks = sk + st * kBK * ld;
    const T* vs = sv + st * kBK * ld;

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
      const int row = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j <= row) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m[i] - mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        sum += p;
        sp[(ty * 4 + i) * kPLd + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
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
          const float vv = to_f32(vs[kk * ld + col]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage and sp
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * S + row) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) store(orow + col, acc[i][c] / denom);
    }
  }
}

size_t smem_bytes(int hd, size_t elem, int pad) {
  return (kBQ + 4 * kBK) * static_cast<size_t>(hd + pad) * elem + kBQ * kPLd * sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int Kv,
           int hd, float scale, const long long* qs, const long long* ks, const long long* vs,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, sizeof(T), Pad<T>::kElems);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Kv, hd, scale, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_max_hd() { return kMaxHd; }

int flash_attention_block_q() { return kBQ; }

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o: [B, S, H, hd] (o contiguous); k, v: [B, S, Kv, hd]. Strides are in
// elements, (batch, position, head); the last dimension is contiguous.
// dtype: 0 float32, 1 bfloat16.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                           int B, int S, int H, int Kv, int hd, float scale, long long qsb,
                           long long qss, long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss, long long vsh,
                           void* stream) {
  if (B < 1 || S < 0 || Kv < 1 || H < Kv || H % Kv != 0 || hd < 8 || hd > kMaxHd ||
      hd % 8 != 0 || static_cast<long long>(B) * H > 65535)
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh}, vs[3] = {vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, B, S, H, Kv, hd, scale, qs, ks, vs, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, H, Kv, hd, scale, qs, ks, vs, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
