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
// at the tensor cores' 989 TFLOP/s, against 0.03 ms for the bytes. The
// kernels do seven hd-products a (q, key) pair, not five: see below.
//
// Three launches and no atomics, so every gradient is the same bits on
// every run (the resume check relies on it):
// - rowdot: D_i, a half-warp a row. On the wgmma path it also writes lse in
//   log2 units, and both into [B, H, S_pad] rows padded to 64 (D 0 and lse
//   +inf past S, so a padded row's P is exactly 0), which the dk/dv
//   kernel's bulk copies read whole.
// - dk/dv: one block per (key block, b, kv head), summing the group's q
//   heads and the q tiles from the diagonal on; in bf16 at HD 64 and 128
//   a cluster of CTAs per (key block, b, kv head) where the grid would
//   leave the card unbalanced (below).
// - dq: one block per (q block, b, q head), over the key tiles up to the
//   diagonal.
// The dq kernel recomputes S and dP, which the dk/dv kernel also forms: the
// price of no atomics. Blocks are taken longest first.
//
// Two designs, a fixed dispatch by dtype; none is a fallback for the other:
// - float32 on CUDA cores (TF32 would break the reference's tolerance):
//   256 threads, a 4 x 4 register block of each 64 x 64 score tile a
//   thread, tiles staged by cp.async, rows padded by 16 bytes.
// - bfloat16 at HD 64, 128 and 192 (zamba2's 80 runs padded into 128, 136
//   into 192): wgmma fed by TMA, in the manner of
//   FlashAttention-3's backward without its atomics, and of the forward
//   (flash_attention.cu, whose TMA, mbarrier, descriptor and wgmma helpers
//   hopper.cuh shares). 384 threads: warpgroup 0 is the producer (one
//   thread issues every TMA load and bulk copy; setmaxnreg gives its
//   registers away), warpgroups 1 and 2 are consumers of 64 keys (dk/dv)
//   or 64 q rows (dq) each. Every tile arrives as 64-row boxes of a 4-D
//   tensor map (hd, heads, positions, batch) with the 128-byte swizzle;
//   rows past S and columns past hd are zero-filled.
//   dk/dv: k and v (128 keys) load once and stay resident; each step (q
//   head j of the group, 64-row q tile from the diagonal on) streams the q
//   and dO tiles with their lse and D slices (1-D bulk copies) through a
//   ring of kStages stages, each with full barriers (q, dO apart) and an
//   empty barrier both consumers arrive on. Per consumer and step: S^T =
//   K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands K-major from
//   shared memory); P^T in registers while dP^T is still on the tensor
//   cores (exp2 in log2 units; the causal mask only on the diagonal tile,
//   as a compile-time body; a tile wholly before the warpgroup's keys is
//   skipped), rounded to bf16 in the accumulators' layout, which is the
//   register-A layout; dV += P^T dO issued at once; then dS^T and dK +=
//   dS^T Q (wgmma m64nHDk16, A from registers, dO and Q MN-major through the
//   descriptor's transpose bit: each q and dO tile is read K-major and
//   MN-major from the one swizzled copy).
//   The cluster split. A block's steps are its group's g q heads times
//   the q tiles from its diagonal on, so the first key block runs g n_q
//   steps and the grid B Kv ceil(S/128) blocks. Where that grid is small
//   beside the SM count and g large (qwen3-moe's 64/4 heads at S 4,096:
//   128 blocks, block 0 1,024 steps of 64 q rows against 512 an SM
//   balanced), the first blocks alone hold the launch to twice its
//   balanced length. kernel.py's dkdv_splits picks the smallest c
//   dividing g (at most 8, the portable cluster) whose longest CTA, g/c
//   n_q steps, is within 1.1x of the balanced share (else the largest
//   divisor up to 8), and 1 wherever the grid is balanced already. With c > 1 the
//   grid is (B Kv c, key blocks) in clusters of c CTAs along x; rank r
//   streams and sums q heads r g/c .. (r + 1) g/c - 1 with the same
//   resident k/v, ring and ping-pong. After its last step each consumer
//   writes its float dK and dV partials over the ring and the k/v tiles
//   (72 KB at HD 64, 136 KB at 128: rows padded by 32 bytes against bank
//   conflicts), then a cluster barrier; rank r sums keys r 128/c ..
//   (r + 1) 128/c - 1 over ranks 0, 1, ..., c - 1, in that order, through
//   distributed shared memory (mapa, ld.shared::cluster), scales dK and
//   writes bf16; a last cluster barrier keeps every CTA alive until its
//   peers have read it. The order is fixed, so every run gives the same
//   bits; c = 1 is the plain launch, with the unsplit code.
//   dq: the forward's shape. q and dO (128 rows) resident, k and v
//   streaming as 64-key tiles through the ring; each consumer keeps its 64
//   q and dO rows in registers as A fragments, so S = Q K^T and dP = dO V^T
//   (wgmma m64n64k16) read only k and v from shared memory; P while dP is
//   on the tensor cores, then dS, and dQ += dS K (K MN-major).
//   The two consumers take turns to issue each step's first products (two
//   named barriers, as FlashAttention-3's ping-pong): one warpgroup's score
//   math then runs beside the other's products instead of both idling the
//   tensor cores at once (-17% dk/dv, -15% dq at llama's training shape).
//   The soft cap is a template flag. Its instances run the score math in
//   two passes once dP is in (tanh and the cap's derivative with D, then P
//   with lse), read the lse and D slices in order, and read q and dO from
//   shared memory in dq: the 128-wide ones have no registers to spare.
//   Registers at HD 128 (240 a consumer thread, no spills): dk/dv 64 + 64
//   accumulators, S^T and dP^T 32 + 32, then 16 + 16 bf16 fragments in
//   their place; dq 64 + 32 + 32 and the q and dO fragments 32 + 32.
//   At HD 192 (nemotron-4's heads) a consumer cannot hold 64 keys' dk and
//   dv (96 + 96 accumulators a thread) beside the score tiles, nor three
//   stages fit shared memory beside two resident 128-row tiles, so:
//   dk/dv (dkdv_split_kernel) takes a block a 64-key tile and splits the
//   products between the two consumers instead of the keys: one forms S^T,
//   P^T and dV += P^T dO, the other dP^T, dS^T and dK += dS^T Q, with P^T
//   (times the cap's derivative) handed over in float through two slots of
//   shared memory under named barriers; each holds 96 accumulators and one
//   score tile. dq is the same kernel as at 128 with two stages and q and
//   dO read from shared memory (96 accumulators and two score tiles).
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry returns cudaGetLastError() (or cudaErrorInvalidValue for arguments
// the kernels do not take, or a tensor map the driver refuses).

#include "hopper.cuh"  // TMA, mbarriers, wgmma, the tensor-map encoder (shared with the forward)

#include <type_traits>

namespace {

constexpr int kMaxHd = 192;
constexpr int kT = 64;  // q and key rows a tile

// ---------------------------------------------------------------------------
// D_i = dO_i . O_i, a half-warp a row, 16 bytes a load; rows are (b, i, h)
// over i < S_pad, read from the [B, S, H, hd] layout; D is [B, H, S_pad], 0
// past S. With lse2, also lse2 [B, H, S_pad] = lse [B, H, S] in log2 units,
// +inf past S.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a), y = *reinterpret_cast<const float4*>(b);
  return fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a), y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
  float sum = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(xp[e]), w = __bfloat1622float2(yp[e]);
    sum = fmaf(u.x, w.x, fmaf(u.y, w.y, sum));
  }
  return sum;
}

template <typename T>
__global__ void rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                              float* __restrict__ delta, float* __restrict__ lse2, long long rows, int S, int S_pad,
                              int H, int hd) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte load
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 16;
  const int lane = threadIdx.x % 16;
  const bool live = row < rows;
  const long long b = live ? row / (static_cast<long long>(S_pad) * H) : 0;
  const long long rem = row - b * S_pad * H;
  const int i = live ? static_cast<int>(rem / H) : S, h = static_cast<int>(rem - static_cast<long long>(i) * H);
  float sum = 0.0f;
  if (i < S) {
    const long long at = ((b * S + i) * H + h) * hd;
    for (int d = lane * kPer; d < hd; d += 16 * kPer) sum += dot16(o + at + d, dout + at + d);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (live && lane == 0) {
    const long long out = (b * H + h) * S_pad + i;
    delta[out] = sum;
    if (lse2 != nullptr) lse2[out] = i < S ? lse[(b * H + h) * S + i] * kLog2e : __int_as_float(0x7f800000);
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
// bfloat16 at HD 64, 128 and 192: wgmma fed by TMA, a producer warpgroup
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kBox = 64;            // rows of every tensor-map box: a consumer warpgroup's keys or q rows
constexpr int kBlock = 2 * kBox;    // keys of a dk/dv block, q rows of a dq block
constexpr int kStages = 3;          // the streamed ring
constexpr int kHandSlots = 2;       // the 192-wide dk/dv kernel's P^T handover ring
constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr int kMaxSplits = 8;       // CTAs of a dk/dv cluster: the portable cluster size

// two floats of shared memory at a 32-bit shared address, as a volatile
// load: the loads keep their order, so the compiler cannot gather a step's
// worth of them ahead of their use (the capped dk/dv instance has no
// registers for that)
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}


template <int HD>
struct Tiles {
  static constexpr int kTile = kBox * HD * 2;     // bytes of a 64-row tile: HD/64 boxes of 64 x 64
  static constexpr int kBlockTile = 2 * kTile;    // a 128-row tile: each 64-column chunk two boxes
  static constexpr int kVec = kBox * 4;           // a 64-row slice of lse2 or D
  static constexpr int kHand = kBox * kBox * 4;   // a float 64 x 64 score tile
  // the dq ring: three stages of 192-wide k and v beside the resident q and
  // dO would not fit, two do
  static constexpr int kDqStages = HD > 128 ? 2 : kStages;
  // barriers: the resident tiles' full; per stage two full and one empty
  static constexpr int kBars = 1 + 3 * kStages, kDqBars = 1 + 3 * kDqStages;
  // the swizzled tiles need 1024-byte alignment, which the base is rounded up to
  static constexpr int kDkdvSmem = 1024 + 2 * kBlockTile + kStages * (2 * kTile + 2 * kVec) + 8 * kBars;
  static constexpr int kDqSmem = 1024 + 2 * kBlockTile + kDqStages * 2 * kTile + 8 * kDqBars;
  // the 192-wide dk/dv kernel: a 64-key k and v, the ring, the handover slots
  static constexpr int kSplitSmem =
      1024 + 2 * kTile + kStages * (2 * kTile + 2 * kVec) + kHandSlots * kHand + 8 * kBars;
  static_assert((HD > 128 ? kSplitSmem : kDkdvSmem) <= 232448 && kDqSmem <= 232448,
                "each instance must fit a block's shared memory");
  // a dk/dv cluster's partial sums: float dK and dV of the block's 128 keys,
  // rows padded by 8 floats (32 bytes) so that the accumulators' float2
  // stores fall in distinct banks; written over the k/v tiles and the ring
  // once the CTA's steps are done, short of the barriers
  static constexpr int kPartLd = HD + 8;
  static constexpr int kPartBytes = 2 * kBlock * kPartLd * 4;
  static_assert(kPartBytes <= 2 * kBlockTile + kStages * (2 * kTile + 2 * kVec),
                "the partials must fit below the dk/dv kernel's barriers");
};

// the cluster's barrier, every thread of every CTA (release, then acquire:
// shared-memory writes before it are seen by the peers' reads after it)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// four floats at a shared address of CTA `rank` of the cluster (`addr` the
// same offset in this CTA's shared memory)
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// rows [row0, row0 + 128) of one head: HD/64 column chunks of two 64-row boxes
template <int HD>
__device__ __forceinline__ void load_block(uint32_t dst, const CUtensorMap* map, uint32_t bar, int head, int row0,
                                           int b) {
#pragma unroll
  for (int c = 0; c < HD / kBoxCols; ++c)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      tma_load(dst + (c * kBlock + half * kBox) * kRowBytes, map, bar, c * kBoxCols, head, row0 + half * kBox, b);
}

// rows [row0, row0 + 64) of one head: HD/64 boxes
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int head, int row0,
                                          int b) {
#pragma unroll
  for (int c = 0; c < HD / kBoxCols; ++c) tma_load(dst + c * kBox * kRowBytes, map, bar, c * kBoxCols, head, row0, b);
}

// the dk/dv producers' stream, one thread: for each q head of the group and
// each 64-row q tile from qt0 on, the q and dO tiles with their lse2 and D
// slices into the ring's next stage once both consumers have released it
// (barriers at `bars`: the resident tiles' full, then per stage q full, dO
// full and empty)
template <int HD>
__device__ __forceinline__ void stream_q_do(const CUtensorMap* qmap, const CUtensorMap* domap, const float* lse2,
                                            const float* delta, uint32_t sq, uint32_t sdo, uint32_t svec,
                                            uint32_t bars, int b, int kvh, int g, int H, int S_pad, int qt0, int n_q) {
  using T = Tiles<HD>;
  int step = 0;
  for (int j = 0; j < g; ++j) {
    const int h = kvh * g + j;
    const long long row = (static_cast<long long>(b) * H + h) * S_pad;
    for (int qt = qt0; qt < n_q; ++qt, ++step) {
      const int st = step % kStages;
      const uint32_t q_full = bars + 8u * (1 + st), do_full = bars + 8u * (1 + kStages + st);
      mbar_wait(bars + 8u * (1 + 2 * kStages + st), ((step / kStages) & 1) ^ 1);  // empty
      mbar_expect_tx(q_full, T::kTile + T::kVec);
      load_tile<HD>(sq + st * T::kTile, qmap, q_full, h, qt * kBox, b);
      bulk_load(svec + st * T::kVec, lse2 + row + qt * kBox, T::kVec, q_full);
      mbar_expect_tx(do_full, T::kTile + T::kVec);
      load_tile<HD>(sdo + st * T::kTile, domap, do_full, h, qt * kBox, b);
      bulk_load(svec + (kStages + st) * T::kVec, delta + row + qt * kBox, T::kVec, do_full);
    }
  }
}

// S (+)= A B^T over HD for a warpgroup's 64 rows and a 64-row tile, both
// K-major; a_chunk and b_chunk are the bytes between their 64-column chunks
template <int HD>
__device__ __forceinline__ void scores(float (&d)[kBox / 2], uint32_t a, uint32_t a_chunk, uint32_t b,
                                       uint32_t b_chunk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t box = kk / 4, within = (kk % 4) * 32;  // 64-column chunk, 16-column step
    wgmma_ss<kBox>(d, sw128_desc(a + box * a_chunk + within, 16, 1024), sw128_desc(b + box * b_chunk + within, 16, 1024),
                   kk > 0);
  }
}

// S = A B^T over HD for a warpgroup's 64 rows and a 64-row tile: A the
// rows' bf16 fragments (4 registers a k-step), B K-major in shared memory
template <int HD>
__device__ __forceinline__ void scores_rs(float (&d)[kBox / 2], const uint32_t* a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t box = kk / 4, within = (kk % 4) * 32;
    wgmma_rs_k<kBox>(d, a + 4 * kk, sw128_desc(b + box * kBox * kRowBytes + within, 16, 1024), kk > 0);
  }
}

// d += A B over a 64-row tile: A the bf16 fragments of 4 k-steps, B the
// tile read MN-major (its HD columns are the output's)
template <int HD>
__device__ __forceinline__ void accumulate(float (&d)[HD / 2], const uint32_t* a, uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < kBox / 16; ++kk)
    wgmma_rs<HD>(d, a + 4 * kk, sw128_desc(tile + kk * 16 * kRowBytes, kBox * kRowBytes, 1024));
}

// The capped instances' first pass over a score, once dP is in: with t =
// tanh(scale s / softcap), dp becomes (dP - D)(1 - t^2), the cap's
// derivative folded in, and s the capped logit in log2 units, softcap t
// log2 e (scale_log2 = softcap * log2 e, cap_arg = scale / softcap). The
// second pass takes P = exp2(s - lse2) and dS = P dp. Each pass reads one of
// D and lse, which keeps the capped instances within their registers.
__device__ __forceinline__ void cap_pass(float& s, float& dp, float d, float scale_log2, float cap_arg) {
  const float t = tanh_fast(s * cap_arg);
  dp = (dp - d) * (1.0f - t * t);
  s = scale_log2 * t;
}

// grid (B*Kv*splits, key blocks): block y is the key block (the first has
// the most q rows). Steps run over (q head j of the CTA's share of the group,
// 64-row q tile qt from the diagonal on); consumer warpgroup w owns keys
// k0 + 64w .. + 63. Without SPLIT (splits 1) a block takes the whole group
// and writes dk and dv. With SPLIT, the `splits` CTAs of a cluster (x
// consecutive) share one (b, kv head, key block): rank r takes q heads
// r g/splits .. (r + 1) g/splits - 1, leaves its float partials in its
// shared memory, and after the cluster's barrier sums keys r 128/splits ..
// (r + 1) 128/splits - 1 over ranks 0, 1, ..., splits - 1 in that order
// (distributed shared memory; no atomics, the same bits every run) and
// writes them.
template <int HD, bool CAP, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                const float* __restrict__ lse2, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int S, int S_pad, int H, int Kv, int hd, float scale,
                float scale_log2, float cap_arg, int n_splits) {
  using T = Tiles<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sk = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + T::kBlockTile;
  const uint32_t sq = sv + T::kBlockTile;           // kStages q tiles
  const uint32_t sdo = sq + kStages * T::kTile;     // kStages dO tiles
  const uint32_t svec = sdo + kStages * T::kTile;   // kStages lse2 slices, then kStages D slices
  const uint32_t bars = svec + 2 * kStages * T::kVec;
  const uint32_t kv_full = bars;
  auto q_full = [&](int st) { return bars + 8u * (1 + st); };
  auto do_full = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };

  const int splits = SPLIT ? n_splits : 1;
  const int item = blockIdx.x / splits, rank = blockIdx.x - item * splits;  // rank: the CTA's in its cluster
  const int b = item / Kv, kvh = item - b * Kv, gs = H / Kv / splits;      // gs: the CTA's q heads
  const int k0 = blockIdx.y * kBlock;
  const int n_q = (S + kBox - 1) / kBox;
  const int qt0 = k0 / kBox;  // the first q tile: the diagonal
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(q_full(st), 1);
      mbar_init(do_full(st), 1);
      mbar_init(empty(st), 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer ------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * T::kBlockTile);
      load_block<HD>(sk, &kmap, kv_full, kvh, k0, b);
      load_block<HD>(sv, &vmap, kv_full, kvh, k0, b);
      // the CTA's share of the group: q heads kvh g + rank gs .. + gs - 1, as
      // "group" kvh splits + rank of gs heads
      stream_q_do<HD>(&qmap, &domap, lse2, delta, sq, sdo, svec, bars, b, kvh * splits + rank, gs, H, S_pad, qt0,
                      n_q);
    }
    if constexpr (SPLIT) {  // the consumers' two cluster barriers (below), in step
      cluster_sync();
      cluster_sync();
    }
  } else {
    // ---- consumers: 64 keys each -----------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid / 32, lane = tid % 32;
    const int w = wgi - 1;
    const int kw0 = k0 + w * kBox;  // the warpgroup's first key
    const int key_r = warp * 16 + lane / 4;  // this thread's keys: kw0 + key_r, kw0 + key_r + 8
    const uint32_t k_slice = sk + w * kBox * kRowBytes;
    const uint32_t v_slice = sv + w * kBox * kRowBytes;

    float adk[HD / 2], adv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) adk[i] = adv[i] = 0.0f;
    mbar_wait(kv_full, 0);
    if (w == 1) turn_pass(w);  // warpgroup 0 takes the first turn

    // one step; MASKED (a compile-time flag) on the diagonal tile
    auto step_body = [&](const int st, const int phase, auto masked_tag) {
      constexpr bool kMasked = decltype(masked_tag)::value;
      // S^T = K Q^T and dP^T = V dO^T: rows the warpgroup's keys, columns the tile's q rows
      float s[kBox / 2], dp[kBox / 2];
      mbar_wait(q_full(st), phase);
      mbar_wait(do_full(st), phase);
      turn_wait(w);
      fence_regs(s);
      fence_regs(dp);
      wg_fence();
      scores<HD>(s, k_slice, kBlock * kRowBytes, sq + st * T::kTile, kBox * kRowBytes);
      wg_commit();
      scores<HD>(dp, v_slice, kBlock * kRowBytes, sdo + st * T::kTile, kBox * kRowBytes);
      wg_commit();
      turn_pass(w);

      const uint32_t l2 = svec + st * T::kVec;               // the tile's lse2 slice
      const uint32_t dd = svec + (kStages + st) * T::kVec;  // and its D slice
      auto slice_f2 = [&](uint32_t addr) -> float2 {
        if constexpr (CAP) return lds_f2(addr);
        else return *reinterpret_cast<const float2*>(smem_raw + (addr - smem_u32(smem_raw)));
      };
      uint32_t pa[kBox / 4], sa[kBox / 4];
      if constexpr (CAP) {
        // once dP^T is in: cap_pass, then P from lse, dS, and both in bf16
        wg_wait<0>();
        fence_regs(s);
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < kBox / 8; ++j) {
          const float2 dv2 = slice_f2(dd + 4 * (8 * j + 2 * (lane % 4)));
#pragma unroll
          for (int e = 0; e < 4; ++e) cap_pass(s[4 * j + e], dp[4 * j + e], e % 2 ? dv2.y : dv2.x, scale_log2, cap_arg);
        }
#pragma unroll
        for (int j = 0; j < kBox / 8; ++j) {
          const int c = 8 * j + 2 * (lane % 4);
          const float2 lv = slice_f2(l2 + 4 * c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const bool keep = !kMasked || key_r + 8 * (e / 2) <= c + (e % 2);
            s[i] = keep ? ex2(s[i] - (e % 2 ? lv.y : lv.x)) : 0.0f;
            dp[i] *= s[i];
          }
          pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
          pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
          sa[2 * j] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
          sa[2 * j + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
        }
        fence_regs(adv);
        fence_regs(adk);
        wg_fence();
        accumulate<HD>(adv, pa, sdo + st * T::kTile);
        accumulate<HD>(adk, sa, sq + st * T::kTile);
        wg_commit();
      } else {
        // P^T while dP^T is still on the tensor cores, then dV += P^T dO on
        // them while dS^T is formed, then dK += dS^T Q. Both in the
        // accumulators' layout, rounded to bf16 as the A fragments of 4
        // k-steps (element i: key key_r + 8 ((i / 2) % 2), q row 8 (i / 4) +
        // 2 (lane % 4) + i % 2 of the tile)
        wg_wait<1>();
        fence_regs(s);
#pragma unroll
        for (int j = 0; j < kBox / 8; ++j) {
          const int c = 8 * j + 2 * (lane % 4);
          const float2 lv = slice_f2(l2 + 4 * c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const bool keep = !kMasked || key_r + 8 * (e / 2) <= c + (e % 2);
            s[i] = keep ? ex2(s[i] * scale_log2 - (e % 2 ? lv.y : lv.x)) : 0.0f;
          }
          pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
          pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
        }
        fence_regs(adv);
        wg_fence();
        accumulate<HD>(adv, pa, sdo + st * T::kTile);
        wg_commit();
        wg_wait<1>();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < kBox / 8; ++j) {
          const float2 dv2 = slice_f2(dd + 4 * (8 * j + 2 * (lane % 4)));
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e % 2 ? dv2.y : dv2.x));
          sa[2 * j] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
          sa[2 * j + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
        }
        fence_regs(adk);
        wg_fence();
        accumulate<HD>(adk, sa, sq + st * T::kTile);
        wg_commit();
      }
      wg_wait<0>();
      fence_regs(adv);
      fence_regs(adk);
      mbar_arrive(empty(st));
    };

    int step = 0;
    for (int j = 0; j < gs; ++j) {
      for (int qt = qt0; qt < n_q; ++qt, ++step) {
        const int st = step % kStages, phase = (step / kStages) & 1, q0 = qt * kBox;
        if (q0 < kw0) {  // every q row precedes every key: nothing to add, but the ring and the turns move on
          mbar_wait(q_full(st), phase);
          mbar_wait(do_full(st), phase);
          turn_wait(w);
          turn_pass(w);
          mbar_arrive(empty(st));
        } else if (q0 == kw0) {
          step_body(st, phase, std::true_type{});
        } else {
          step_body(st, phase, std::false_type{});
        }
      }
    }

    if constexpr (!SPLIT) {
      // keys below S, the true hd columns; dk takes the scale here
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = kw0 + key_r + 8 * r;
        if (key >= S) continue;
        const long long at = ((static_cast<long long>(b) * S + key) * Kv + kvh) * hd;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          if (col < hd) {
            *reinterpret_cast<uint32_t*>(dk + at + col) =
                pack_bf16(adk[4 * j + 2 * r] * scale, adk[4 * j + 2 * r + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + at + col) = pack_bf16(adv[4 * j + 2 * r], adv[4 * j + 2 * r + 1]);
          }
        }
      }
    } else {
      // the partials, [dK; dV] x 128 keys x HD floats (row stride kPartLd),
      // over the k/v tiles and the ring once both consumers are past their
      // last products (every TMA write has landed: they waited on each)
      bar_sync(3);
      float* const part = reinterpret_cast<float*>(smem_raw + (sk - smem_u32(smem_raw)));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w * kBox + key_r + 8 * r;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          *reinterpret_cast<float2*>(part + row * T::kPartLd + col) =
              make_float2(adk[4 * j + 2 * r], adk[4 * j + 2 * r + 1]);
          *reinterpret_cast<float2*>(part + (kBlock + row) * T::kPartLd + col) =
              make_float2(adv[4 * j + 2 * r], adv[4 * j + 2 * r + 1]);
        }
      }
      cluster_sync();  // every thread of every CTA, the producers too: the partials are written
      // this rank's keys, summed over the ranks in rank order, 4 columns a
      // thread an item; keys below S, the true hd columns; dk takes the scale
      const int me = cluster_rank();  // rank, read again rather than kept live through the steps
      const int row0 = me * kBlock / splits, rows = (me + 1) * kBlock / splits - row0;
      constexpr int kVecs = HD / 4;
      const int items = 2 * rows * kVecs;
      for (int it = tid + 128 * w; it < items; it += 256) {
        const int dvs = it >= rows * kVecs;  // 0: dK, 1: dV
        const int rem = it - dvs * rows * kVecs;
        const int row = row0 + rem / kVecs, col = (rem % kVecs) * 4;
        const uint32_t at_smem = sk + ((dvs * kBlock + row) * T::kPartLd + col) * 4;
        float4 sum = ld_cluster_f4(at_smem, 0);
        for (int p = 1; p < splits; ++p) {
          const float4 x = ld_cluster_f4(at_smem, p);
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        const int key = k0 + row;
        if (key < S && col < hd) {
          const float mul = dvs ? 1.0f : scale;
          __nv_bfloat16* const out = (dvs ? dv : dk) + ((static_cast<long long>(b) * S + key) * Kv + kvh) * hd + col;
          *reinterpret_cast<uint2*>(out) =
              make_uint2(pack_bf16(sum.x * mul, sum.y * mul), pack_bf16(sum.z * mul, sum.w * mul));
        }
      }
      cluster_sync();  // no CTA leaves while a peer still reads its shared memory
    }
  }
}

// The 192-wide dk/dv kernel. grid (B*Kv, 64-key tiles): block y is the key
// tile (the first has the most q rows); steps run over (q head j of the
// group, 64-row q tile qt from the diagonal on), as in dkdv_kernel. A
// consumer warpgroup cannot hold 64 keys' dK and dV at 192 columns (96 + 96
// floats a thread) beside a score tile, so the two consumers share the
// block's 64 keys and split the products instead of the keys:
// - warpgroup 0 forms S^T = K Q^T, then P^T (masked on the diagonal), its
//   bf16 A fragments and P^T times the cap's derivative (P^T without a
//   cap), which it hands to warpgroup 1 through a float slot of shared
//   memory, and accumulates dV += P^T dO;
// - warpgroup 1 forms dP^T = V dO^T, takes the slot, forms dS^T = P^T (dP^T
//   - D) in bf16 and accumulates dK += dS^T Q.
// Each holds one 64 x HD accumulator and one 64 x 64 score tile. A slot
// holds each thread's score elements where the thread itself keeps them
// (both warpgroups share the accumulator layout), as [16][128] float2.
// Handover ring: named barriers 1 + slot (full: warpgroup 0 arrives,
// warpgroup 1 syncs) and 3 + slot (empty: the reverse).
template <int HD, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_split_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                      const float* __restrict__ lse2, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int S_pad, int H,
                      int Kv, int hd, float scale, float scale_log2, float cap_arg) {
  using T = Tiles<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sk = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + T::kTile;
  const uint32_t sq = sv + T::kTile;                   // kStages q tiles
  const uint32_t sdo = sq + kStages * T::kTile;        // kStages dO tiles
  const uint32_t svec = sdo + kStages * T::kTile;      // kStages lse2 slices, then kStages D slices
  const uint32_t hand = svec + 2 * kStages * T::kVec;  // kHandSlots float score tiles
  const uint32_t bars = hand + kHandSlots * T::kHand;
  const uint32_t kv_full = bars;
  auto q_full = [&](int st) { return bars + 8u * (1 + st); };
  auto do_full = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };

  const int b = blockIdx.x / Kv, kvh = blockIdx.x - b * Kv, g = H / Kv;
  const int k0 = blockIdx.y * kBox;
  const int n_q = (S + kBox - 1) / kBox;
  const int qt0 = k0 / kBox;  // the first q tile: the diagonal
  const int steps = g * (n_q - qt0);
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(q_full(st), 1);
      mbar_init(do_full(st), 1);
      mbar_init(empty(st), 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer ------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * T::kTile);
      load_tile<HD>(sk, &kmap, kv_full, kvh, k0, b);
      load_tile<HD>(sv, &vmap, kv_full, kvh, k0, b);
      stream_q_do<HD>(&qmap, &domap, lse2, delta, sq, sdo, svec, bars, b, kvh, g, H, S_pad, qt0, n_q);
    }
  } else {
    // ---- consumers: warpgroup 0 P^T and dV, warpgroup 1 dS^T and dK ------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid / 32, lane = tid % 32;
    const int w = wgi - 1;
    const int key_r = warp * 16 + lane / 4;  // this thread's keys: k0 + key_r, k0 + key_r + 8
    auto sptr = [&](uint32_t addr) { return smem_raw + (addr - smem_u32(smem_raw)); };  // a shared address's pointer

    float acc[HD / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    mbar_wait(kv_full, 0);

    // the warpgroup's 64 keys of k (warpgroup 0) or v (warpgroup 1) stay in
    // registers as the A operand of its score products, which then read only
    // the q or dO tile from shared memory (-9% at nemotron-4's heads); the
    // capped instance, which spills with them, reads them from there too
    constexpr bool kRegA = !CAP;
    const uint32_t kv_tile = w == 0 ? sk : sv;
    uint32_t ka[kRegA ? HD / 4 : 1];
    if constexpr (kRegA) load_a_frags<HD>(ka, sptr(kv_tile), kBox * kRowBytes, warp, lane);

    int step = 0;
    for (int j = 0; j < g; ++j) {
      for (int qt = qt0; qt < n_q; ++qt, ++step) {
        const int st = step % kStages, phase = (step / kStages) & 1, slot = step % kHandSlots;
        const bool diag = qt == qt0;
        const uint32_t mine = hand + slot * T::kHand + 8 * tid;  // this thread's first float2 in the slot
        float s[kBox / 2];  // S^T (warpgroup 0) or dP^T (warpgroup 1): rows keys, columns the tile's q rows
        uint32_t a[kBox / 4];
        mbar_wait(q_full(st), phase);
        mbar_wait(do_full(st), phase);
        fence_regs(s);
        wg_fence();
        if constexpr (kRegA)
          scores_rs<HD>(s, ka, (w == 0 ? sq : sdo) + st * T::kTile);
        else
          scores<HD>(s, kv_tile, kBox * kRowBytes, (w == 0 ? sq : sdo) + st * T::kTile, kBox * kRowBytes);
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        if (w == 0) {
          // P^T in log2 units (element i: key key_r + 8 ((i / 2) % 2), q row
          // 8 (i / 4) + 2 (lane % 4) + i % 2 of the tile), its A fragments,
          // and P^T (1 - t^2) into the slot
          const uint32_t l2 = svec + st * T::kVec;
#pragma unroll
          for (int jj = 0; jj < kBox / 8; ++jj) {
            const int c = 8 * jj + 2 * (lane % 4);
            const float2 lv = lds_f2(l2 + 4 * c);
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * jj + e;
              float x = s[i] * scale_log2, dcap = 1.0f;
              if constexpr (CAP) {
                const float t = tanh_fast(s[i] * cap_arg);
                x = scale_log2 * t;
                dcap = 1.0f - t * t;
              }
              const bool keep = !diag || key_r + 8 * (e / 2) <= c + (e % 2);
              p[e] = keep ? ex2(x - (e % 2 ? lv.y : lv.x)) : 0.0f;
              s[i] = p[e] * dcap;
            }
            a[2 * jj] = pack_bf16(p[0], p[1]);
            a[2 * jj + 1] = pack_bf16(p[2], p[3]);
          }
          if (step >= kHandSlots) bar_sync(3 + slot);  // warpgroup 1 has read the slot's last tile
#pragma unroll
          for (int e2 = 0; e2 < kBox / 4; ++e2)
            *reinterpret_cast<float2*>(sptr(mine + e2 * 128 * 8)) = make_float2(s[2 * e2], s[2 * e2 + 1]);
          bar_arrive(1 + slot);
          fence_regs(acc);
          wg_fence();
          accumulate<HD>(acc, a, sdo + st * T::kTile);  // dV += P^T dO
        } else {
          // dS^T = P^T (1 - t^2) (dP^T - D), in bf16 as the A fragments
          const uint32_t dd = svec + (kStages + st) * T::kVec;
          bar_sync(1 + slot);
#pragma unroll
          for (int jj = 0; jj < kBox / 8; ++jj) {
            const float2 dv2 = lds_f2(dd + 4 * (8 * jj + 2 * (lane % 4)));
            const float2 p01 = *reinterpret_cast<const float2*>(sptr(mine + (2 * jj) * 128 * 8));
            const float2 p23 = *reinterpret_cast<const float2*>(sptr(mine + (2 * jj + 1) * 128 * 8));
            a[2 * jj] = pack_bf16(p01.x * (s[4 * jj] - dv2.x), p01.y * (s[4 * jj + 1] - dv2.y));
            a[2 * jj + 1] = pack_bf16(p23.x * (s[4 * jj + 2] - dv2.x), p23.y * (s[4 * jj + 3] - dv2.y));
          }
          if (step + kHandSlots < steps) bar_arrive(3 + slot);  // the slot is free for step + kHandSlots
          fence_regs(acc);
          wg_fence();
          accumulate<HD>(acc, a, sq + st * T::kTile);  // dK += dS^T Q
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty(st));
      }
    }

    // keys below S, the true hd columns; dk takes the scale here
    __nv_bfloat16* const out = w == 0 ? dv : dk;
    const float mul = w == 0 ? 1.0f : scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + key_r + 8 * r;
      if (key >= S) continue;
      const long long at = ((static_cast<long long>(b) * S + key) * Kv + kvh) * hd;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        const int col = 8 * jj + 2 * (lane % 4);
        if (col < hd)
          *reinterpret_cast<uint32_t*>(out + at + col) =
              pack_bf16(acc[4 * jj + 2 * r] * mul, acc[4 * jj + 2 * r + 1] * mul);
      }
    }
  }
}

// grid (B*H, q blocks); block y counts q blocks from the last (longest
// first). 64-key tiles up to the block's last row stream through the ring;
// consumer warpgroup w owns q rows q0 + 64w .. + 63.
template <int HD, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
              const float* __restrict__ lse2, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S,
              int S_pad, int H, int Kv, int hd, float scale, float scale_log2, float cap_arg) {
  using T = Tiles<HD>;
  constexpr int kRing = T::kDqStages;
  // q and dO as register A fragments of S and dP, where the registers allow
  constexpr bool kRegA = !CAP && HD <= 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + T::kBlockTile;
  const uint32_t sk = sdo + T::kBlockTile;    // kRing k tiles
  const uint32_t sv = sk + kRing * T::kTile;  // kRing v tiles
  const uint32_t bars = sv + kRing * T::kTile;
  const uint32_t qd_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kRing + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kRing + st); };

  const int n_blocks = (S + kBlock - 1) / kBlock;
  const int q0 = (n_blocks - 1 - static_cast<int>(blockIdx.y)) * kBlock;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H, kvh = h / (H / Kv);
  const int n_k = (min(q0 + kBlock, S) - 1) / kBox + 1;  // causal: no tile past the block's last row
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int st = 0; st < kRing; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer ------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qd_full, 2 * T::kBlockTile);
      load_block<HD>(sq, &qmap, qd_full, h, q0, b);
      load_block<HD>(sdo, &domap, qd_full, h, q0, b);
      for (int t = 0; t < n_k; ++t) {
        const int st = t % kRing;
        mbar_wait(empty(st), ((t / kRing) & 1) ^ 1);
        mbar_expect_tx(k_full(st), T::kTile);
        load_tile<HD>(sk + st * T::kTile, &kmap, k_full(st), kvh, t * kBox, b);
        mbar_expect_tx(v_full(st), T::kTile);
        load_tile<HD>(sv + st * T::kTile, &vmap, v_full(st), kvh, t * kBox, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid / 32, lane = tid % 32;
    const int w = wgi - 1;
    const int qw0 = q0 + w * kBox;           // the warpgroup's first q row
    const int row_r = warp * 16 + lane / 4;  // this thread's rows: qw0 + row_r, qw0 + row_r + 8
    const int td = qw0 / kBox;               // the key tile on the diagonal
    const uint32_t q_slice = sq + w * kBox * kRowBytes;
    const uint32_t do_slice = sdo + w * kBox * kRowBytes;
    float l2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qw0 + row_r + 8 * r;
      const long long at = (static_cast<long long>(b) * H + h) * S_pad + row;
      l2[r] = row < S ? lse2[at] : __int_as_float(0x7f800000);
      dd[r] = row < S ? delta[at] : 0.0f;
    }

    float adq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) adq[i] = 0.0f;
    mbar_wait(qd_full, 0);
    if (w == 1) turn_pass(w);  // warpgroup 0 takes the first turn
    // the warpgroup's q and dO rows stay in registers as the A operands of S
    // and dP, so that the products read only k and v from shared memory; the
    // capped and 192-wide instances, short of those registers, read them
    // from there too
    uint32_t qa[kRegA ? HD / 4 : 1], da[kRegA ? HD / 4 : 1];
    if constexpr (kRegA) {
      load_a_frags<HD>(qa, smem_raw + (q_slice - smem_u32(smem_raw)), kBlock * kRowBytes, warp, lane);
      load_a_frags<HD>(da, smem_raw + (do_slice - smem_u32(smem_raw)), kBlock * kRowBytes, warp, lane);
    }

    // one key tile; MASKED (a compile-time flag) on the diagonal
    auto tile = [&](const int st, const int phase, auto masked_tag) {
      constexpr bool kMasked = decltype(masked_tag)::value;
      float s[kBox / 2], dp[kBox / 2];
      mbar_wait(k_full(st), phase);
      mbar_wait(v_full(st), phase);
      turn_wait(w);
      fence_regs(s);
      fence_regs(dp);
      wg_fence();
      if constexpr (kRegA)
        scores_rs<HD>(s, qa, sk + st * T::kTile);
      else
        scores<HD>(s, q_slice, kBlock * kRowBytes, sk + st * T::kTile, kBox * kRowBytes);
      wg_commit();
      if constexpr (kRegA)
        scores_rs<HD>(dp, da, sv + st * T::kTile);
      else
        scores<HD>(dp, do_slice, kBlock * kRowBytes, sv + st * T::kTile, kBox * kRowBytes);
      wg_commit();
      turn_pass(w);

      // dS in the accumulators' layout (element i: q row row_r + 8 ((i / 2) %
      // 2), key 8 (i / 4) + 2 (lane % 4) + i % 2 of the tile), in bf16
      uint32_t sa[kBox / 4];
      if constexpr (CAP) {  // once dP is in: cap_pass, then P and dS
        wg_wait<0>();
        fence_regs(s);
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < kBox / 2; ++i) cap_pass(s[i], dp[i], dd[(i / 2) % 2], scale_log2, cap_arg);
#pragma unroll
        for (int i = 0; i < kBox / 2; ++i) {
          const int r = (i / 2) % 2;
          const bool keep = !kMasked || 8 * (i / 4) + 2 * (lane % 4) + (i % 2) <= row_r + 8 * r;
          dp[i] *= keep ? ex2(s[i] - l2[r]) : 0.0f;
        }
      } else {  // P while dP is still on the tensor cores, then dS
        wg_wait<1>();
        fence_regs(s);
#pragma unroll
        for (int i = 0; i < kBox / 2; ++i) {
          const int r = (i / 2) % 2;
          const bool keep = !kMasked || 8 * (i / 4) + 2 * (lane % 4) + (i % 2) <= row_r + 8 * r;
          s[i] = keep ? ex2(s[i] * scale_log2 - l2[r]) : 0.0f;
        }
        wg_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < kBox / 2; ++i) dp[i] = s[i] * (dp[i] - dd[(i / 2) % 2]);
      }
#pragma unroll
      for (int j = 0; j < kBox / 8; ++j) {
        sa[2 * j] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
        sa[2 * j + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
      }

      // dQ += dS K over the tile's 64 keys
      fence_regs(adq);
      wg_fence();
      accumulate<HD>(adq, sa, sk + st * T::kTile);
      wg_commit();
      wg_wait<0>();
      fence_regs(adq);
      mbar_arrive(empty(st));
    };

    for (int t = 0; t < n_k; ++t) {
      const int st = t % kRing, phase = (t / kRing) & 1;
      if (t > td) {  // every key follows every row: nothing to add, but the ring and the turns move on
        mbar_wait(k_full(st), phase);
        mbar_wait(v_full(st), phase);
        turn_wait(w);
        turn_pass(w);
        mbar_arrive(empty(st));
      } else if (t == td) {
        tile(st, phase, std::true_type{});
      } else {
        tile(st, phase, std::false_type{});
      }
    }

    // rows below S, the true hd columns; dq takes the scale here
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qw0 + row_r + 8 * r;
      if (row >= S) continue;
      __nv_bfloat16* out = dq + ((static_cast<long long>(b) * S + row) * H + h) * hd;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        if (col < hd)
          *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(adq[4 * j + 2 * r] * scale, adq[4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

template <int HD, bool CAP>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse2, const float* delta,
           void* dq, void* dk, void* dv, int B, int S, int S_pad, int H, int Kv, int hd, float scale, float softcap,
           int splits, const long long* layouts, cudaStream_t stream) {
  using T = Tiles<HD>;
  using bf16 = __nv_bfloat16;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (!encode(&maps[i], ptrs[i], layouts + 11 * i, kBox)) return cudaErrorInvalidValue;
  const float scale_log2 = CAP ? softcap * kLog2e : scale * kLog2e;
  const float cap_arg = CAP ? scale / softcap : 0.0f;
  cudaError_t err;
  if constexpr (HD > 128) {  // a block a 64-key tile, its products split between the consumers
    err = cudaFuncSetAttribute(dkdv_split_kernel<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSplitSmem);
    if (err != cudaSuccess) return err;
    dkdv_split_kernel<HD, CAP><<<dim3(B * Kv, (S + kBox - 1) / kBox), kThreads, T::kSplitSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse2, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, S_pad,
        H, Kv, hd, scale, scale_log2, cap_arg);
  } else if (splits == 1) {  // a block a 128-key block, 64 keys a consumer
    err = cudaFuncSetAttribute(dkdv_kernel<HD, CAP, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kDkdvSmem);
    if (err != cudaSuccess) return err;
    dkdv_kernel<HD, CAP, false><<<dim3(B * Kv, (S + kBlock - 1) / kBlock), kThreads, T::kDkdvSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse2, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, S_pad,
        H, Kv, hd, scale, scale_log2, cap_arg, 1);
  } else {  // the same, each key block's group split over a cluster of `splits` CTAs
    auto kernel = dkdv_kernel<HD, CAP, true>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kDkdvSmem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * Kv * splits, (S + kBlock - 1) / kBlock, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = T::kDkdvSmem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3], lse2, delta, static_cast<bf16*>(dk),
                             static_cast<bf16*>(dv), S, S_pad, H, Kv, hd, scale, scale_log2, cap_arg, splits);
    if (err != cudaSuccess) return err;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kDqSmem);
  if (err != cudaSuccess) return err;
  dq_kernel<HD, CAP><<<dim3(B * H, (S + kBlock - 1) / kBlock), kThreads, T::kDqSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse2, delta, static_cast<bf16*>(dq), S, S_pad, H, Kv, hd, scale, scale_log2,
      cap_arg);
  return cudaGetLastError();
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* dout, const float* lse2, const float* delta,
              void* dq, void* dk, void* dv, int B, int S, int S_pad, int H, int Kv, int hd, float scale, float softcap,
              int splits, const long long* layouts, cudaStream_t stream) {
  if (softcap > 0.0f)
    return launch<HD, true>(q, k, v, dout, lse2, delta, dq, dk, dv, B, S, S_pad, H, Kv, hd, scale, softcap, splits,
                            layouts, stream);
  return launch<HD, false>(q, k, v, dout, lse2, delta, dq, dk, dv, B, S, S_pad, H, Kv, hd, scale, softcap, splits,
                           layouts, stream);
}

}  // namespace wg

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

// rows of the wgmma instances' tensor-map boxes (kernel.py's BWD_BOX_ROWS);
// their D and lse2 rows are padded to a multiple of it
int flash_attention_bwd_box_rows() { return wg::kBox; }

// the most CTAs a dk/dv cluster takes (kernel.py's DKDV_MAX_SPLITS)
int flash_attention_bwd_max_splits() { return wg::kMaxSplits; }

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Three launches: D = rowsum(dO o O) into `delta` (float32 scratch the
// caller allocates, [B, H, S_pad]), then dk, dv, then dq. q, o, dout, dq:
// [B, S, H, hd]; k, v, dk, dv: [B, S, Kv, hd]; all contiguous, one dtype
// (0 float32, 1 bfloat16); lse [B, H, S] float32 from the forward.
// hd_inst: the bf16 instance's width (64, 128 or 192; unused for float32).
// splits: the CTAs of a dk/dv cluster, each a share of the group's q heads
// (1 to max_splits, dividing H / Kv; more than 1 only at hd_inst 64 and
// 128). bf16 takes S_pad = S rounded up to box_rows, `lse2` ([B, H, S_pad]
// float32 scratch for lse in log2 units) and `tma`: q's, k's, v's and
// dout's tensor-map layouts, 11 values each (dims, byte strides, box;
// box_rows rows). float32 takes S_pad = S and ignores lse2 and tma.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                               const void* lse, void* delta, void* lse2, void* dq, void* dk, void* dv, int dtype, int B,
                               int S, int S_pad, int H, int Kv, int hd, float scale, float softcap, int hd_inst,
                               int splits, const long long* tma, void* stream) {
  if (B < 1 || S < 0 || S_pad < S || Kv < 1 || H < Kv || H % Kv != 0 || hd < 8 || hd > kMaxHd || hd % 8 != 0 ||
      !(softcap >= 0.0f) || static_cast<long long>(B) * H > 65535 || splits < 1 || splits > wg::kMaxSplits ||
      (H / Kv) % splits != 0 || (splits > 1 && (dtype != 1 || (hd_inst != 64 && hd_inst != 128))))
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  const long long rows = static_cast<long long>(B) * S_pad * H;
  const unsigned blocks = static_cast<unsigned>((rows * 16 + 255) / 256);  // a half-warp a row
  if (dtype == 0) {
    if (S_pad != S) return cudaErrorInvalidValue;
    rowdot_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(o), static_cast<const float*>(dout), l, d,
                                                 nullptr, rows, S, S_pad, H, hd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_f32(q, k, v, dout, l, d, dq, dk, dv, B, S, H, Kv, hd, scale, softcap, st);
  }
  if (dtype != 1 || (hd_inst != 64 && hd_inst != 128 && hd_inst != 192) || hd > hd_inst || tma == nullptr ||
      lse2 == nullptr || S_pad != (S + wg::kBox - 1) / wg::kBox * wg::kBox)
    return cudaErrorInvalidValue;
  float* l2 = static_cast<float*>(lse2);
  rowdot_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(o),
                                                       static_cast<const __nv_bfloat16*>(dout), l, d, l2, rows, S,
                                                       S_pad, H, hd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (hd_inst == 64)
    return wg::launch_hd<64>(q, k, v, dout, l2, d, dq, dk, dv, B, S, S_pad, H, Kv, hd, scale, softcap, splits, tma,
                             st);
  if (hd_inst == 128)
    return wg::launch_hd<128>(q, k, v, dout, l2, d, dq, dk, dv, B, S, S_pad, H, Kv, hd, scale, softcap, splits, tma,
                              st);
  return wg::launch_hd<192>(q, k, v, dout, l2, d, dq, dk, dv, B, S, S_pad, H, Kv, hd, scale, softcap, 1, tma, st);
}

}  // extern "C"
