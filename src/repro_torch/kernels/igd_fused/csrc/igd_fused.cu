// Fused IGD transition kernels for Hopper (sm_90a), bound through a plain
// C interface (loaded with ctypes by kernels/igd_fused/kernel.py).
//
// igd_fold — replaces the Pallas TPU kernel
//   src/repro/kernels/igd_fused/kernel.py: igd_fold (_igd_kernel).
//   Per row i: wx = w.x_i; margin = y_i*wx (lr, svm) or wx (lsq);
//   c = grad_scale(margin, y_i) * alpha_i; w -= c * x_i.
//   What bounds it: the serial dependency chain. Row i+1 reads the w that
//   row i wrote, so the rows cannot run in parallel; one epoch over N rows
//   is N trips through dot -> warp reduction -> loss scale -> axpy. The
//   bytes (N*(D+2)*4) would take microseconds at 3.35 TB/s; the chain
//   takes N * (a few hundred cycles).
//   Design: one warp owns the whole fold and keeps w in registers
//   (VPL = ceil(D/32) floats per lane), so the chain touches no memory
//   but the row it reads. The dot ends in a __shfl_xor_sync butterfly,
//   which leaves the bit-identical sum in every lane, so every lane
//   computes c itself and no barrier sits on the chain. Rows, y and
//   alpha stream into shared memory ahead of use with cp.async double
//   buffering, so the chain never waits on device memory. The kernel
//   loops over exactly N rows and masks the lanes past D: no padding.
//   Past one warp's reach (D > 1024) the block has 8 or 16 warps and the
//   warps' partial dots meet in shared memory, one block barrier per row
//   (two alternating slots, so one barrier suffices); D <= 4096.
//   One block means 131 of 132 SMs idle; filling the card needs many
//   independent folds (fused serving lanes, sharded segments), which
//   later slices bring.
//
// igd_fold_minibatch — replaces the Pallas TPU kernel
//   src/repro/kernels/igd_fused/kernel.py: igd_fold_minibatch
//   (_minibatch_kernel). One mean-gradient step per 256-row tile:
//   wx = X_t w; c = grad_scale * alpha; w -= (c X_t) / 256.
//   What bounds it: tiles are serial (tile t+1 reads the w tile t wrote),
//   and inside a tile two dependent phases each end in a block barrier.
//   Design: one block of 256 threads, w in shared memory. Phase 1: one
//   thread per row walks its row (independent loads the compiler keeps
//   in flight, where a warp taking its 32 rows in turn would wait on
//   device memory once per row). Phase 2: one thread per column sums
//   c_r * x_rj over the tile's rows (coalesced across threads; the tile
//   was just read, so it comes from L1). The ragged last tile sums only
//   its real rows and still divides by 256, which is the reference's
//   padded semantics.
//
// Neither kernel allocates; both launch on the caller's stream. Each C
// entry returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernels do not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLossLr = 0;
constexpr int kLossSvm = 1;
constexpr int kLossLsq = 2;

constexpr int kWarp = 32;
constexpr int kFoldMaxVpl = 32;          // one warp: D <= 32 * 32 = 1024
constexpr int kWideVpl = 8;              // several warps: 8 floats a thread
constexpr int kFoldMaxDim = 16 * kWarp * kWideVpl;  // 16 warps: D <= 4096
constexpr int kStageFloatBudget = 6000;  // per stage; two stages + partials < 48 KB
constexpr int kTile = 256;               // minibatch rows per step
constexpr int kMinibatchMaxDim = 12288 - kTile;  // w + c in 48 KB

// d loss / d (w.x), given wx = w.x (the kernel forms the margin itself).
template <int LOSS>
__device__ __forceinline__ float grad_scale(float wx, float y) {
  if (LOSS == kLossLsq) return wx - y;
  const float m = y * wx;
  if (LOSS == kLossLr) return -y * (1.0f / (1.0f + expf(m)));  // -y*sigmoid(-m)
  return m < 1.0f ? -y : 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// The block's threads copy rows [row0, row0 + rows) of x, y and alpha into a
// shared-memory stage laid out as x[tile_rows * d] | y[tile_rows] |
// alpha[tile_rows]. With vec set, x and the stage are 16-byte aligned
// and tile_rows * d is a multiple of 4, so every tile's x chunk starts on
// a 16-byte boundary.
__device__ __forceinline__ void load_stage(float* stage, const float* x,
                                           const float* y, const float* alpha,
                                           long long row0, int rows, int d,
                                           int tile_rows, bool vec, int tid, int nt) {
  const float* src = x + row0 * d;
  const long long count = static_cast<long long>(rows) * d;
  long long done = 0;
  if (vec) {
    const long long nvec = count / 4;
    for (long long i = tid; i < nvec; i += nt) cp_async16(stage + 4 * i, src + 4 * i);
    done = nvec * 4;
  }
  for (long long i = done + tid; i < count; i += nt) cp_async4(stage + i, src + i);
  float* ys = stage + static_cast<long long>(tile_rows) * d;
  float* as = ys + tile_rows;
  for (int i = tid; i < rows; i += nt) {
    cp_async4(ys + i, y + row0 + i);
    cp_async4(as + i, alpha + row0 + i);
  }
}

template <int WARPS>
__device__ __forceinline__ void block_sync() {
  if (WARPS == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Smem: two stages of stage_floats, then (several warps only) two slots
// of WARPS partial dots.
template <int LOSS, int VPL, int WARPS>
__global__ void __launch_bounds__(kWarp * WARPS)
    igd_fold_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ alpha, const float* __restrict__ w0,
                    float* __restrict__ wout, long long n, int d, int tile_rows,
                    int stage_floats, int vec) {
  constexpr int kThreads = kWarp * WARPS;
  extern __shared__ __align__(16) float smem[];
  float* partial = smem + 2 * stage_floats;  // [2][WARPS]
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;

  float w[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int j = tid + kThreads * k;
    w[k] = j < d ? w0[j] : 0.0f;
  }

  const long long n_tiles = (n + tile_rows - 1) / tile_rows;
  if (n_tiles > 0) {
    load_stage(smem, x, y, alpha, 0, static_cast<int>(n < tile_rows ? n : tile_rows), d,
               tile_rows, vec != 0, tid, kThreads);
  }
  cp_async_commit();

  for (long long t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const long long next0 = (t + 1) * tile_rows;
      const long long left = n - next0;
      load_stage(smem + ((t + 1) & 1) * stage_floats, x, y, alpha, next0,
                 static_cast<int>(left < tile_rows ? left : tile_rows), d, tile_rows,
                 vec != 0, tid, kThreads);
    }
    cp_async_commit();  // possibly empty: keeps "wait for all but one" exact
    cp_async_wait_one();
    block_sync<WARPS>();

    const float* xs = smem + (t & 1) * stage_floats;
    const float* ys = xs + static_cast<long long>(tile_rows) * d;
    const float* as = ys + tile_rows;
    const long long left = n - t * tile_rows;
    const int rows = static_cast<int>(left < tile_rows ? left : tile_rows);
    for (int r = 0; r < rows; ++r) {
      const float* xr = xs + r * d;
      float xv[VPL];
      float dot = 0.0f;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int j = tid + kThreads * k;
        xv[k] = j < d ? xr[j] : 0.0f;
        dot = fmaf(w[k], xv[k], dot);
      }
      dot = warp_sum(dot);
      if (WARPS > 1) {
        float* slot = partial + (r & 1) * WARPS;
        if (lane == 0) slot[tid / kWarp] = dot;
        __syncthreads();
        dot = 0.0f;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) dot += slot[i];  // same order in every thread
      }
      const float c = grad_scale<LOSS>(dot, ys[r]) * as[r];
#pragma unroll
      for (int k = 0; k < VPL; ++k) w[k] -= c * xv[k];
    }
    block_sync<WARPS>();  // every thread is done with this stage before it is refilled
  }

#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int j = tid + kThreads * k;
    if (j < d) wout[j] = w[k];
  }
}

template <int LOSS>
__global__ void __launch_bounds__(kTile)
    igd_minibatch_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         const float* __restrict__ alpha, const float* __restrict__ w0,
                         float* __restrict__ wout, long long n, int d) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;      // [d]
  float* cs = smem + d;  // [kTile]
  const int tid = threadIdx.x;

  for (int j = tid; j < d; j += kTile) ws[j] = w0[j];
  __syncthreads();

  const long long n_tiles = (n + kTile - 1) / kTile;
  for (long long t = 0; t < n_tiles; ++t) {
    const long long row0 = t * kTile;
    const long long left = n - row0;
    const int rows = static_cast<int>(left < kTile ? left : kTile);

    // phase 1: c_r = grad_scale(w.x_r) * alpha_r, one thread per row
    float c = 0.0f;
    if (tid < rows) {
      const float* xr = x + (row0 + tid) * d;
      float dot = 0.0f;
#pragma unroll 8
      for (int j = 0; j < d; ++j) dot = fmaf(ws[j], xr[j], dot);
      c = grad_scale<LOSS>(dot, y[row0 + tid]) * alpha[row0 + tid];
    }
    cs[tid] = c;
    __syncthreads();

    // phase 2: w_j -= (sum_r c_r x_rj) / TILE — rows past N add nothing,
    // the divisor stays TILE
    for (int j = tid; j < d; j += kTile) {
      const float* xc = x + row0 * d + j;
      float s = 0.0f;
#pragma unroll 8
      for (int r = 0; r < rows; ++r) s = fmaf(cs[r], xc[static_cast<long long>(r) * d], s);
      ws[j] = ws[j] - s / static_cast<float>(kTile);
    }
    __syncthreads();
  }

  for (int j = tid; j < d; j += kTile) wout[j] = ws[j];
}

template <int LOSS>
cudaError_t launch_fold(int vpl, int warps, const float* x, const float* y,
                        const float* alpha, const float* w0, float* wout, long long n,
                        int d, int tile_rows, int stage_floats, int vec, size_t smem,
                        cudaStream_t stream) {
#define REPRO_FOLD_CASE(V, W)                                                    \
  if (vpl == V && warps == W) {                                                  \
    igd_fold_kernel<LOSS, V, W><<<1, kWarp * W, smem, stream>>>(                 \
        x, y, alpha, w0, wout, n, d, tile_rows, stage_floats, vec);             \
    return cudaGetLastError();                                                   \
  }
  REPRO_FOLD_CASE(1, 1)
  REPRO_FOLD_CASE(2, 1)
  REPRO_FOLD_CASE(4, 1)
  REPRO_FOLD_CASE(8, 1)
  REPRO_FOLD_CASE(16, 1)
  REPRO_FOLD_CASE(32, 1)
  REPRO_FOLD_CASE(kWideVpl, 8)
  REPRO_FOLD_CASE(kWideVpl, 16)
#undef REPRO_FOLD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int igd_fused_fold_max_dim() { return kFoldMaxDim; }

int igd_fused_minibatch_max_dim() { return kMinibatchMaxDim; }

int igd_fused_tile() { return kTile; }

const char* igd_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int igd_fold_launch(const float* x, const float* y, const float* alpha, const float* w0,
                    float* wout, long long n, int d, int loss, void* stream) {
  if (n < 0 || d < 1 || d > kFoldMaxDim) return cudaErrorInvalidValue;
  int vpl = 1, warps = 1;
  if (d <= kWarp * kFoldMaxVpl) {
    while (vpl * kWarp < d) vpl *= 2;
  } else {
    vpl = kWideVpl;
    warps = d <= 8 * kWarp * kWideVpl ? 8 : 16;
  }
  int tile_rows = kStageFloatBudget / (d + 2);
  if (tile_rows > 256) tile_rows = 256;
  if (tile_rows >= 4) tile_rows -= tile_rows % 4;
  if (tile_rows < 1) tile_rows = 1;
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  ((static_cast<long long>(tile_rows) * d) % 4 == 0);
  const int stage_floats = (tile_rows * (d + 2) + 3) / 4 * 4;
  const size_t smem = (2 * static_cast<size_t>(stage_floats) + 2 * warps) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kLossLr:
      return launch_fold<kLossLr>(vpl, warps, x, y, alpha, w0, wout, n, d, tile_rows,
                                  stage_floats, vec, smem, s);
    case kLossSvm:
      return launch_fold<kLossSvm>(vpl, warps, x, y, alpha, w0, wout, n, d, tile_rows,
                                   stage_floats, vec, smem, s);
    case kLossLsq:
      return launch_fold<kLossLsq>(vpl, warps, x, y, alpha, w0, wout, n, d, tile_rows,
                                   stage_floats, vec, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int igd_fold_minibatch_launch(const float* x, const float* y, const float* alpha,
                              const float* w0, float* wout, long long n, int d, int loss,
                              void* stream) {
  if (n < 0 || d < 1 || d > kMinibatchMaxDim) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(d + kTile) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kLossLr:
      igd_minibatch_kernel<kLossLr><<<1, kTile, smem, s>>>(x, y, alpha, w0, wout, n, d);
      break;
    case kLossSvm:
      igd_minibatch_kernel<kLossSvm><<<1, kTile, smem, s>>>(x, y, alpha, w0, wout, n, d);
      break;
    case kLossLsq:
      igd_minibatch_kernel<kLossLsq><<<1, kTile, smem, s>>>(x, y, alpha, w0, wout, n, d);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
