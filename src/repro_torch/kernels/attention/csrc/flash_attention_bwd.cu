// The gradient of causal GQA flash attention for Hopper (sm_90a), bound
// through a plain C interface (loaded with ctypes by
// kernels/attention/kernel.py).
//
// What it replaces: no Pallas kernel. The JAX package trains through XLA's
// autodiff of its einsum attention (src/repro/models/layers.py:86
// _attn_core, inside the checkpointed chunk scan of :103-160); its Pallas
// flash_attention (src/repro/kernels/attention/kernel.py:63) has no
// custom_vjp. The port's forward is the hand-written flash_attention.cu,
// so its gradient is a kernel too: this file.
//
// What it computes, for q, o, dO [B, S, H, hd] and k, v [B, S, Kv, hd]
// (Skv = S: an offset prefill is never trained), q head h reading kv head
// h / (H / Kv), scale = 1/sqrt(hd), cap(x) = c tanh(x / c) when c > 0:
//   s_ij  = cap(scale q_i . k_j)            (j <= i, else masked)
//   P_ij  = exp(s_ij - lse_i)                (lse from the forward, natural units)
//   D_i   = dO_i . O_i
//   dS_ij = P_ij (dO_i . v_j - D_i) (1 - tanh^2(scale q_i . k_j / c))   (the last factor with a cap)
//   dq_i  = scale sum_j dS_ij k_j,  dk_j = scale sum_{i, heads of the group} dS_ij q_i,
//   dv_j  = sum_{i, heads of the group} P_ij dO_i
// Accumulation is float32; outputs are in the inputs' dtype.
//
// What bounds it on this card: operations. At llama3.2-3b's training shape
// (B=1, S=4,096, 24/8 heads, hd 128, bf16) the five products over the
// causal half are 2.5x the forward's 4*B*H*hd*S(S+1)/2 FLOP: 2.58e11, 0.26 ms
// at the tensor cores' 989 TFLOP/s, against 0.03 ms for the bytes.
//
// Design: a simple kernel that is right, in three launches and no atomics,
// so every gradient is deterministic (bitwise reruns, the resume check):
// - rowdot: D_i, one warp a row.
// - dkdv: one block per (key tile of 64, b, kv head). It keeps its k and v
//   tile in shared memory and loops over the group's q heads and the q
//   tiles at or after the key tile, accumulating dk and dv in registers.
// - dq: one block per (q tile of 64, b, q head), looping over the key tiles
//   up to the diagonal, dq in registers.
// The dq kernel recomputes S and dP, which the dkdv kernel also forms: the
// price of no atomics. Tiles are taken longest first.
//
// Two instances, picked by dtype, as in the forward:
// - float32 on CUDA cores (TF32 would break the reference's tolerance):
//   256 threads, a 4 x 4 register block of each 64 x 64 score tile a
//   thread, tiles staged by cp.async, rows padded by 16 bytes.
// - bfloat16 on the tensor cores through mma.sync m16n8k16 (f32
//   accumulators), a warp 16 rows. Tiles stream in by cp.async through
//   two stages (the next step's copies fly while this one computes), row
//   major with 16 bytes of padding. A operands and the score products' B
//   operands are read from shared memory as pairs along the contraction;
//   P and dS go from the score accumulators straight into A fragments (the
//   C fragment of two neighbouring n-tiles is the A fragment of one
//   k-step); the B operands needed along the other axis (Q and dO for dk
//   and dv, K for dq) come through ldmatrix .trans from the same tiles.
//   Columns past hd, up to the instantiated width HD (64, 128 or 192), and
//   rows past S are zero-filled. At HD 192 the dkdv kernel runs 8 warps,
//   two a 16-key row group, each accumulating half of dk's and dv's
//   columns (96 + 96 accumulators a thread would spill).
//   wgmma and TMA are work for a later PR.
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry returns cudaGetLastError() (or cudaErrorInvalidValue for arguments
// the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHd = 192;
constexpr int kT = 64;  // q and key rows a tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// D_i = dO_i . O_i, one warp a row; rows are (b, i, h) in the [B, S, H, hd]
// layout, D is [B, H, S]
// ---------------------------------------------------------------------------
template <typename T>
__global__ void rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                              float* __restrict__ delta, long long rows, int S, int H, int hd) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* op = o + row * hd;
  const T* dp = dout + row * hd;
  float sum = 0.0f;
  for (int d = lane; d < hd; d += 32) sum = fmaf(to_f(op[d]), to_f(dp[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const long long b = row / (static_cast<long long>(S) * H);
    const long long rem = row - b * S * H;
    const int i = static_cast<int>(rem / H), h = static_cast<int>(rem - static_cast<long long>(i) * H);
    delta[(b * H + h) * S + i] = sum;
  }
}

// the capped, scaled logit and the cap's derivative (1 without a cap)
__device__ __forceinline__ float capped(float x, float softcap, float& dcap) {
  if (softcap > 0.0f) {
    const float t = tanhf(x / softcap);
    dcap = 1.0f - t * t;
    return softcap * t;
  }
  dcap = 1.0f;
  return x;
}

// ---------------------------------------------------------------------------
// float32 on CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;       // 16 row groups x 16 threads
constexpr int kCols = kMaxHd / 16;  // output columns a thread
constexpr int kPad = 4;             // shared-memory row padding (16 bytes)
constexpr int kPLd = kT + 4;        // row stride of the P / dS tile

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// rows [row0, row0 + 64) of one head (row stride `stride` elements) into a
// shared tile of row stride `ld`; rows at or past `rows` are zero-filled
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride, int row0, int rows,
                                          int hd, int ld) {
  const int per_row = hd / 4;
  for (int c = threadIdx.x; c < kT * per_row; c += kThreads) {
    const int r = c / per_row, col = (c - r * per_row) * 4;
    const bool valid = row0 + r < rows;
    cp_async16(dst + r * ld + col, src + (valid ? static_cast<long long>(row0 + r) * stride : 0) + col, valid);
  }
}

// acc[i][c] += sum_kk p[(ty*4 + i) * kPLd + kk] * m[kk * ld + tx + 16c]
__device__ __forceinline__ void accumulate(float (&acc)[4][kCols], const float* p, const float* m, int ld,
                                           int hd, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kT; ++kk) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty * 4 + i) * kPLd + kk];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) {
        const float mv = m[kk * ld + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], mv, acc[i][c]);
      }
    }
  }
}

// s[i][j] = a_{ty*4+i} . b_{tx+16j} over hd, both tiles row-major in shared memory
__device__ __forceinline__ void dots(float (&s)[4][4], const float* a, const float* b, int ld, int hd, int ty,
                                     int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < hd; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = load4(a + (ty * 4 + i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = load4(b + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// grid (key tiles, B*Kv): block x = key tile (the first has the most q tiles).
// Rows of the score tile are keys, columns q rows.
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int S, int H, int Kv, int hd, float scale,
                float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = hd + kPad;
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + kT * ld;
  float* sq = sv + kT * ld;
  float* sdo = sq + kT * ld;
  float* sp = sdo + kT * ld;  // P, then dS: [key][q]
  float* slse = sp + kT * kPLd;
  float* sdel = slse + kT;

  const int kt = blockIdx.x, k0 = kt * kT;
  const int b = blockIdx.y / Kv, kvh = blockIdx.y - b * Kv, g = H / Kv;
  const long long qstride = static_cast<long long>(H) * hd, kstride = static_cast<long long>(Kv) * hd;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile(sk, k + (static_cast<long long>(b) * S * Kv + kvh) * hd, kstride, k0, S, hd, ld);
  load_tile(sv, v + (static_cast<long long>(b) * S * Kv + kvh) * hd, kstride, k0, S, hd, ld);

  float ak[4][kCols], av[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) ak[i][c] = av[i][c] = 0.0f;

  const int n_q = (S + kT - 1) / kT;
  for (int j = 0; j < g; ++j) {
    const int h = kvh * g + j;
    const long long head = static_cast<long long>(b) * S * H + h;
    const float* lb = lse + (static_cast<long long>(b) * H + h) * S;
    const float* db = delta + (static_cast<long long>(b) * H + h) * S;
    for (int qt = kt; qt < n_q; ++qt) {
      const int q0 = qt * kT;
      load_tile(sq, q + head * hd, qstride, q0, S, hd, ld);
      load_tile(sdo, dout + head * hd, qstride, q0, S, hd, ld);
      if (threadIdx.x < kT) {
        const int i = q0 + threadIdx.x;
        slse[threadIdx.x] = i < S ? lb[i] : 0.0f;
        sdel[threadIdx.x] = i < S ? db[i] : 0.0f;
      }
      cp_async_wait_all();
      __syncthreads();

      float s[4][4], dp[4][4];
      dots(s, sk, sq, ld, hd, ty, tx);
      dots(dp, sv, sdo, ld, hd, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = tx + 16 * jj, qi = q0 + c;
          float dcap;
          const float x = capped(s[i][jj] * scale, softcap, dcap);
          const float p = (key <= qi && qi < S) ? expf(x - slse[c]) : 0.0f;
          s[i][jj] = p;
          dp[i][jj] = p * (dp[i][jj] - sdel[c]) * dcap * scale;
          sp[(ty * 4 + i) * kPLd + c] = p;
        }
      }
      __syncthreads();
      accumulate(av, sp, sdo, ld, hd, ty, tx);  // dv += P dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sp[(ty * 4 + i) * kPLd + tx + 16 * jj] = dp[i][jj];
      __syncthreads();
      accumulate(ak, sp, sq, ld, hd, ty, tx);  // dk += dS q (scale folded into dS)
      __syncthreads();                         // the next loads overwrite sq, sdo, sp
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= S) continue;
    const long long at = ((static_cast<long long>(b) * S + key) * Kv + kvh) * hd;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) {
        dk[at + col] = ak[i][c];
        dv[at + col] = av[i][c];
      }
    }
  }
}

// grid (q tiles, B*H): block x counts q tiles from the last (longest first).
// Rows of the score tile are q rows, columns keys.
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int S, int H, int Kv, int hd, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = hd + kPad;
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + kT * ld;
  float* sk = sdo + kT * ld;
  float* sv = sk + kT * ld;
  float* sp = sv + kT * ld;  // dS: [q][key]
  float* slse = sp + kT * kPLd;
  float* sdel = slse + kT;

  const int n_q = (S + kT - 1) / kT;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x), q0 = qt * kT;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H, kvh = h / (H / Kv);
  const long long qstride = static_cast<long long>(H) * hd, kstride = static_cast<long long>(Kv) * hd;
  const long long head = static_cast<long long>(b) * S * H + h;
  const float* kb = k + (static_cast<long long>(b) * S * Kv + kvh) * hd;
  const float* vb = v + (static_cast<long long>(b) * S * Kv + kvh) * hd;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile(sq, q + head * hd, qstride, q0, S, hd, ld);
  load_tile(sdo, dout + head * hd, qstride, q0, S, hd, ld);
  if (threadIdx.x < kT) {
    const int i = q0 + threadIdx.x;
    const long long at = (static_cast<long long>(b) * H + h) * S + i;
    slse[threadIdx.x] = i < S ? lse[at] : 0.0f;
    sdel[threadIdx.x] = i < S ? delta[at] : 0.0f;
  }

  float aq[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) aq[i][c] = 0.0f;

  for (int t = 0; t <= qt; ++t) {  // key tiles up to the diagonal
    const int k0 = t * kT;
    load_tile(sk, kb, kstride, k0, S, hd, ld);
    load_tile(sv, vb, kstride, k0, S, hd, ld);
    cp_async_wait_all();
    __syncthreads();
    float s[4][4], dp[4][4];
    dots(s, sq, sk, ld, hd, ty, tx);
    dots(dp, sdo, sv, ld, hd, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qi = q0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = k0 + tx + 16 * jj;
        float dcap;
        const float x = capped(s[i][jj] * scale, softcap, dcap);
        const float p = (key <= qi && qi < S) ? expf(x - slse[r]) : 0.0f;
        sp[r * kPLd + tx + 16 * jj] = p * (dp[i][jj] - sdel[r]) * dcap * scale;
      }
    }
    __syncthreads();
    accumulate(aq, sp, sk, ld, hd, ty, tx);  // dq += dS k
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    float* row = dq + (head + static_cast<long long>(qi) * H) * hd;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) row[col] = aq[i][c];
    }
  }
}

size_t smem_bytes(int hd) {
  return (4 * kT * static_cast<size_t>(hd + kPad) + kT * kPLd + 2 * kT) * sizeof(float);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: mma.sync m16n8k16
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kPad = 8;  // bf16 row padding (16 bytes): fragment loads hit distinct banks

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the A fragment of rows [row0, row0 + 16), contraction columns [k0, k0 + 16)
// of a row-major shared tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* t, int ld, int row0, int k0,
                                       int lane) {
  const int g = lane / 4, c = k0 + 2 * (lane % 4);
  a[0] = ld32(t + (row0 + g) * ld + c);
  a[1] = ld32(t + (row0 + g + 8) * ld + c);
  a[2] = ld32(t + (row0 + g) * ld + c + 8);
  a[3] = ld32(t + (row0 + g + 8) * ld + c + 8);
}

// the B fragment of output columns [n0, n0 + 8), contraction [k0, k0 + 16),
// from a shared tile laid [n][k]
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* t, int ld, int n0, int k0,
                                       int lane) {
  const __nv_bfloat16* p = t + (n0 + lane / 4) * ld + k0 + 2 * (lane % 4);
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// the same B fragment from a shared tile laid [k][n] (row-major along the
// output columns): two 8 x 8 matrices, rows k0.. and k0 + 8.., transposed
// by ldmatrix as they load (lanes 0-15 give the row addresses)
__device__ __forceinline__ void load_bt(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* t, int ld, int n0, int k0,
                                        int lane) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_u32(t + (k0 + lane % 16) * ld + n0)));
}

// asynchronous copies into shared memory; a copy that is not valid writes zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + rows_n) of one head (row stride `stride` elements) into
// a row-major shared tile [rows_n][HD + kPad]; rows at or past `rows` and
// columns at or past hd are zeros
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, long long stride, int row0,
                                          int rows_n, int rows, int hd, int nthreads) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < rows_n * kChunks; c += nthreads) {
    const int r = c / kChunks, col = (c - r * kChunks) * 8;
    const bool valid = row0 + r < rows && col < hd;
    cp16(dst + r * (HD + kPad) + col, src + (valid ? static_cast<long long>(row0 + r) * stride + col : 0), valid);
  }
}

// src[i0 .. i0 + n) into dst, zeros at or past `rows`
__device__ __forceinline__ void load_vec(float* dst, const float* src, int i0, int n, int rows, int nthreads) {
  for (int i = threadIdx.x; i < n; i += nthreads) {
    const bool valid = i0 + i < rows;
    cp4(dst + i, src + (valid ? i0 + i : 0), valid);
  }
}

template <int HD>
struct Dkdv {
  static constexpr int kSplit = HD > 128 ? 2 : 1;  // warps sharing a 16-key row group's columns
  static constexpr int kWarps = 4 * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 32;                  // q rows a step
  static constexpr int kNC = HD / 8 / kSplit;     // accumulator n-tiles a warp
  static constexpr int kLd = HD + kPad;
  static constexpr int kStage = 2 * kBQ * kLd * 2 + 2 * kBQ * 4;  // bytes: the q and dO tiles, lse and D
  static constexpr int kSmem = 2 * kT * kLd * 2 + 2 * kStage;     // k and v resident, two stages
};

template <int HD>
struct Dq {
  static constexpr int kThreads = 128;  // 4 warps x 16 q rows
  static constexpr int kLd = HD + kPad;
  static constexpr int kStage = 2 * kT * kLd * 2;  // bytes: the k and v tiles
  static constexpr int kSmem = 2 * kT * kLd * 2 + 2 * kStage;  // q and dO resident, two stages
};

static_assert(Dkdv<192>::kSmem <= 232448 && Dq<192>::kSmem <= 232448, "tiles must fit a block's shared memory");
static_assert(Dkdv<64>::kStage % 16 == 0 && Dkdv<128>::kStage % 16 == 0 && Dkdv<192>::kStage % 16 == 0,
              "stages must keep 16-byte alignment");

// grid (key tiles, B*Kv); block x = key tile (the first has the most q rows).
// The steps (q head of the group, q tile of kBQ rows from the key tile on)
// stream through two stages: the next step's copies are in flight while
// this one computes.
template <int HD>
__global__ void __launch_bounds__(Dkdv<HD>::kThreads)
    dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int S, int H, int Kv, int hd, float scale, float softcap) {
  using L = Dkdv<HD>;
  constexpr int kBQ = L::kBQ, kLd = L::kLd, kNC = L::kNC;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sv = sk + kT * kLd;
  unsigned char* stages = smem + 2 * kT * kLd * 2;
  auto sq = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(stages + st * L::kStage); };
  auto sdo = [&](int st) { return sq(st) + kBQ * kLd; };
  auto slse = [&](int st) { return reinterpret_cast<float*>(stages + st * L::kStage + 2 * kBQ * kLd * 2); };
  auto sdel = [&](int st) { return slse(st) + kBQ; };

  const int kt = blockIdx.x, k0 = kt * kT;
  const int b = blockIdx.y / Kv, kvh = blockIdx.y - b * Kv, g = H / Kv;
  const long long qstride = static_cast<long long>(H) * hd, kstride = static_cast<long long>(Kv) * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 16 * (warp % 4);           // the warp's 16 keys in the tile
  const int nc0 = (warp / 4) * kNC;           // its first accumulator n-tile
  const int gr = lane / 4, tq = 2 * (lane % 4);
  const int n_qs = (S - k0 + kBQ - 1) / kBQ;  // q steps a head
  const int n_steps = g * n_qs;

  auto issue = [&](int idx, int st) {
    const int j = idx / n_qs, q0 = k0 + (idx - j * n_qs) * kBQ, h = kvh * g + j;
    const long long head = static_cast<long long>(b) * S * H + h;
    const long long row = (static_cast<long long>(b) * H + h) * S;
    load_rows<HD>(sq(st), q + head * hd, qstride, q0, kBQ, S, hd, L::kThreads);
    load_rows<HD>(sdo(st), dout + head * hd, qstride, q0, kBQ, S, hd, L::kThreads);
    load_vec(slse(st), lse + row, q0, kBQ, S, L::kThreads);
    load_vec(sdel(st), delta + row, q0, kBQ, S, L::kThreads);
  };
  load_rows<HD>(sk, k + (static_cast<long long>(b) * S * Kv + kvh) * hd, kstride, k0, kT, S, hd, L::kThreads);
  load_rows<HD>(sv, v + (static_cast<long long>(b) * S * Kv + kvh) * hd, kstride, k0, kT, S, hd, L::kThreads);
  issue(0, 0);
  cp_commit();

  float ak[kNC][4], av[kNC][4];
#pragma unroll
  for (int n = 0; n < kNC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.0f;

  for (int idx = 0; idx < n_steps; ++idx) {
    const int st = idx & 1;
    if (idx + 1 < n_steps) {
      issue(idx + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int q0 = k0 + (idx % n_qs) * kBQ;
    const __nv_bfloat16 *tq_ = sq(st), *tdo = sdo(st);
    const float *tl = slse(st), *td = sdel(st);

    // S^T = K Q^T and dP^T = V dO^T over HD: [16 keys x kBQ q]
    float s_[kBQ / 8][4], dpt[kBQ / 8][4];
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4], a2[4];
      load_a(a, sk, kLd, row0, kk, lane);
      load_a(a2, sv, kLd, row0, kk, lane);
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, tq_, kLd, 8 * n, kk, lane);
        mma(s_[n], a, b0, b1);
        load_b(b0, b1, tdo, kLd, 8 * n, kk, lane);
        mma(dpt[n], a2, b0, b1);
      }
    }
    // P and dS (scale folded in) in the accumulators' layout, then as A fragments
    uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + row0 + gr + 8 * (e / 2);
        const int c = 8 * n + tq + (e % 2), qi = q0 + c;
        float dcap;
        const float x = capped(s_[n][e] * scale, softcap, dcap);
        const float p = (key <= qi && qi < S) ? expf(x - tl[c]) : 0.0f;
        s_[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - td[c]) * dcap * scale;
      }
      pa[n / 2][2 * (n % 2)] = pack(s_[n][0], s_[n][1]);
      pa[n / 2][2 * (n % 2) + 1] = pack(s_[n][2], s_[n][3]);
      sa[n / 2][2 * (n % 2)] = pack(dpt[n][0], dpt[n][1]);
      sa[n / 2][2 * (n % 2) + 1] = pack(dpt[n][2], dpt[n][3]);
    }
    // dV += P^T dO and dK += dS^T Q over the kBQ q rows (B from the row-major tiles)
#pragma unroll
    for (int ks = 0; ks < kBQ / 16; ++ks) {
#pragma unroll
      for (int n = 0; n < kNC; ++n) {
        uint32_t b0, b1;
        load_bt(b0, b1, tdo, kLd, 8 * (nc0 + n), 16 * ks, lane);
        mma(av[n], pa[ks], b0, b1);
        load_bt(b0, b1, tq_, kLd, 8 * (nc0 + n), 16 * ks, lane);
        mma(ak[n], sa[ks], b0, b1);
      }
    }
    __syncthreads();  // the next step's copies refill this stage
  }
  // rows below S, the true hd columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + gr + 8 * r;
    if (key >= S) continue;
    const long long at = ((static_cast<long long>(b) * S + key) * Kv + kvh) * hd;
#pragma unroll
    for (int n = 0; n < kNC; ++n) {
      const int col = 8 * (nc0 + n) + tq;
      if (col < hd) {
        *reinterpret_cast<uint32_t*>(dk + at + col) = pack(ak[n][2 * r], ak[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + col) = pack(av[n][2 * r], av[n][2 * r + 1]);
      }
    }
  }
}

// grid (q tiles, B*H); block x counts q tiles from the last (longest first).
// The key tiles up to the diagonal stream through two stages.
template <int HD>
__global__ void __launch_bounds__(Dq<HD>::kThreads)
    dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S,
              int H, int Kv, int hd, float scale, float softcap) {
  using L = Dq<HD>;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdo = sq + kT * kLd;
  auto sk = [&](int st) { return sdo + kT * kLd + st * 2 * kT * kLd; };
  auto sv = [&](int st) { return sk(st) + kT * kLd; };

  const int n_q = (S + kT - 1) / kT;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x), q0 = qt * kT;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H, kvh = h / (H / Kv);
  const long long qstride = static_cast<long long>(H) * hd, kstride = static_cast<long long>(Kv) * hd;
  const long long head = static_cast<long long>(b) * S * H + h;
  const __nv_bfloat16* kb = k + (static_cast<long long>(b) * S * Kv + kvh) * hd;
  const __nv_bfloat16* vb = v + (static_cast<long long>(b) * S * Kv + kvh) * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 16 * warp, gr = lane / 4, tq = 2 * (lane % 4);
  auto issue = [&](int t, int st) {
    load_rows<HD>(sk(st), kb, kstride, t * kT, kT, S, hd, L::kThreads);
    load_rows<HD>(sv(st), vb, kstride, t * kT, kT, S, hd, L::kThreads);
  };
  load_rows<HD>(sq, q + head * hd, qstride, q0, kT, S, hd, L::kThreads);
  load_rows<HD>(sdo, dout + head * hd, qstride, q0, kT, S, hd, L::kThreads);
  issue(0, 0);
  cp_commit();
  float rl[2], rd[2];  // lse and D of the thread's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + gr + 8 * r;
    const long long at = (static_cast<long long>(b) * H + h) * S + qi;
    rl[r] = qi < S ? lse[at] : 0.0f;
    rd[r] = qi < S ? delta[at] : 0.0f;
  }

  float aq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) aq[n][e] = 0.0f;

  for (int t = 0; t <= qt; ++t) {  // key tiles up to the diagonal
    const int st = t & 1, k0 = t * kT;
    if (t < qt) {
      issue(t + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16 *tk = sk(st), *tv = sv(st);

    // S = Q K^T and dP = dO V^T over HD: [16 q x 64 keys]
    float s[kT / 8][4], dp[kT / 8][4];
#pragma unroll
    for (int n = 0; n < kT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4], a2[4];
      load_a(a, sq, kLd, row0, kk, lane);
      load_a(a2, sdo, kLd, row0, kk, lane);
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, tk, kLd, 8 * n, kk, lane);
        mma(s[n], a, b0, b1);
        load_b(b0, b1, tv, kLd, 8 * n, kk, lane);
        mma(dp[n], a2, b0, b1);
      }
    }
    uint32_t sa[kT / 16][4];
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, qi = q0 + row0 + gr + 8 * r;
        const int key = k0 + 8 * n + tq + (e % 2);
        float dcap;
        const float x = capped(s[n][e] * scale, softcap, dcap);
        const float p = (key <= qi && qi < S) ? expf(x - rl[r]) : 0.0f;
        dp[n][e] = p * (dp[n][e] - rd[r]) * dcap * scale;
      }
      sa[n / 2][2 * (n % 2)] = pack(dp[n][0], dp[n][1]);
      sa[n / 2][2 * (n % 2) + 1] = pack(dp[n][2], dp[n][3]);
    }
    // dQ += dS K over the tile's 64 keys (B from the row-major k tile)
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t b0, b1;
        load_bt(b0, b1, tk, kLd, 8 * n, 16 * ks, lane);
        mma(aq[n], sa[ks], b0, b1);
      }
    }
    __syncthreads();  // the next tile's copies refill this stage
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + gr + 8 * r;
    if (qi >= S) continue;
    __nv_bfloat16* row = dq + (head + static_cast<long long>(qi) * H) * hd;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = 8 * n + tq;
      if (col < hd) *reinterpret_cast<uint32_t*>(row + col) = pack(aq[n][2 * r], aq[n][2 * r + 1]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
           void* dq, void* dk, void* dv, int B, int S, int H, int Kv, int hd, float scale, float softcap,
           cudaStream_t stream) {
  using T = __nv_bfloat16;
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Dkdv<HD>::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Dq<HD>::kSmem);
  if (err != cudaSuccess) return err;
  const int n_t = (S + kT - 1) / kT;
  dkdv_kernel<HD><<<dim3(n_t, B * Kv), Dkdv<HD>::kThreads, Dkdv<HD>::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, Kv, hd, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<HD><<<dim3(n_t, B * H), Dq<HD>::kThreads, Dq<HD>::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      lse, delta, static_cast<T*>(dq), S, H, Kv, hd, scale, softcap);
  return cudaGetLastError();
}

}  // namespace tc

int launch_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dq, void* dk, void* dv, int B, int S, int H, int Kv, int hd, float scale,
               float softcap, cudaStream_t stream) {
  const int smem = static_cast<int>(f32::smem_bytes(hd));
  cudaError_t err = cudaFuncSetAttribute(f32::dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(f32::dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_t = (S + kT - 1) / kT;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
  f32::dkdv_kernel<<<dim3(n_t, B * Kv), f32::kThreads, smem, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), S, H, Kv, hd, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  f32::dq_kernel<<<dim3(n_t, B * H), f32::kThreads, smem, stream>>>(qf, kf, vf, df, lse, delta,
                                                                     static_cast<float*>(dq), S, H, Kv, hd,
                                                                     scale, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_bwd_max_hd() { return kMaxHd; }

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Three launches: D = rowsum(dO o O) into `delta` [B, H, S] (float32
// scratch the caller allocates), then dk, dv, then dq. q, o, dout, dq:
// [B, S, H, hd]; k, v, dk, dv: [B, S, Kv, hd]; all contiguous, one dtype
// (0 float32, 1 bfloat16); lse [B, H, S] float32 from the forward.
// hd_inst: the bf16 instance's width (64, 128 or 192; unused for float32).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                               const void* lse, void* delta, void* dq, void* dk, void* dv, int dtype, int B, int S,
                               int H, int Kv, int hd, float scale, float softcap, int hd_inst, void* stream) {
  if (B < 1 || S < 0 || Kv < 1 || H < Kv || H % Kv != 0 || hd < 8 || hd > kMaxHd || hd % 8 != 0 ||
      !(softcap >= 0.0f) || static_cast<long long>(B) * H > 65535)
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * S * H;
  const unsigned blocks = static_cast<unsigned>((rows * 32 + 255) / 256);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == 0) {
    rowdot_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(o), static_cast<const float*>(dout), d,
                                                 rows, S, H, hd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_f32(q, k, v, dout, l, d, dq, dk, dv, B, S, H, Kv, hd, scale, softcap, st);
  }
  if (dtype != 1 || hd > hd_inst) return cudaErrorInvalidValue;
  rowdot_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(o),
                                                       static_cast<const __nv_bfloat16*>(dout), d, rows, S, H, hd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (hd_inst == 64) return tc::launch<64>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, Kv, hd, scale, softcap, st);
  if (hd_inst == 128) return tc::launch<128>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, Kv, hd, scale, softcap, st);
  if (hd_inst == 192) return tc::launch<192>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, Kv, hd, scale, softcap, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
