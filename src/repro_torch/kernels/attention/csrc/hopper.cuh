// Hopper (sm_90a) building blocks of the attention kernels, included by
// flash_attention.cu, flash_attention_bwd.cu and flash_decode.cu:
// mbarriers, TMA loads of one box of a 4-D tensor map and 1-D bulk copies,
// the 128-byte-swizzle wgmma descriptor, wgmma with A from shared memory or
// from registers, the score math's 2^x and tanh, and the host-side
// tensor-map encoder (kernel.py's tma_layout computes the layouts it
// takes). Everything here has internal linkage.
//
// Layout conventions. A tensor map's box is 64 columns (128 bytes of bf16,
// the 128-byte swizzle's span) by some rows; a tile of HD columns is HD/64
// such boxes one after the other. A K-major operand (the contraction dim
// contiguous) takes sw128_desc(tile + box * box_bytes + (k % 4) * 32, 16,
// 1024) for its k-th 16-column step; an MN-major B operand (the output dim
// contiguous, the instruction's transpose bit) takes sw128_desc(tile + k *
// 16 * 128, box_bytes, 1024): the leading offset steps between 64-column
// boxes, the stride offset between 8-row groups.

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums; the entry point comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBoxCols = 64;    // 128 bytes of bf16, the 128-byte swizzle's span
constexpr int kRowBytes = 128;  // one swizzled box row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a 4-D tensor map (hd, heads, positions, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(pos), "r"(batch)
      : "memory");
}
// `bytes` (a multiple of 16) from 16-byte aligned global memory into shared
// memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for A fragments in registers, which an asynchronous wgmma reads
// until its group is waited for: fencing them after the wait keeps their
// registers from being reused before it
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// named barrier `id` across the two consumer warpgroups (256 threads): one
// warpgroup syncs, the other arrives
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

// the consumers take turns to issue their products (named barriers 1 and
// 2; warpgroup 1 passes once first, so warpgroup 0 takes the first turn),
// so that one warpgroup's score math runs beside the other's products
__device__ __forceinline__ void turn_wait(int w) { bar_sync(1 + w); }
__device__ __forceinline__ void turn_pass(int w) { bar_arrive(2 - w); }

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define ACC32 ACC16(0), ACC16(16)
#define ACC48 ACC16(0), ACC16(16), ACC16(32)
#define ACC56 ACC16(0), ACC16(16), ACC16(32), ACC4(48), ACC4(52)
#define ACC64 ACC16(0), ACC16(16), ACC16(32), ACC16(48)
#define ACC96 ACC16(0), ACC16(16), ACC16(32), ACC16(48), ACC16(64), ACC16(80)

// d[N/2] (+)= A[64 x 16] B[16 x N]: A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float (&d)[48], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : ACC48
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<112>(float (&d)[56], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55"
      "}, "
      "%56, %57, p, 1, 1, 0, 0;\n}\n"
      : ACC56
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[N/2] += A[64 x 16] B[16 x N]: A from registers (the m16k16 fragment of
// each warp's 16 rows), B MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95"
      "}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : ACC96
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[N/2] (+)= A[64 x 16] B[16 x N]: A from registers, B K-major in shared
// memory; scale_d = 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 2], const uint32_t* a, uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs_k<64>(float (&d)[32], const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#undef ACC4
#undef ACC16
#undef ACC32
#undef ACC48
#undef ACC56
#undef ACC64
#undef ACC96

// the A fragments (4 registers a 16-column k-step, the m16k16 fragment of
// each warp's 16 rows) of a warpgroup's 64 rows over HD columns, read from
// a tile as TMA lays it with the 128-byte swizzle: `tile` the slice's first
// row, `chunk` the bytes between its 64-column boxes
template <int HD>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[HD / 4], const unsigned char* tile, int chunk, int warp,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + lane / 4 + 8 * (e % 2), c = 16 * kk + 2 * (lane % 4) + 8 * (e / 2);
      const int byte = (c % kBoxCols) * 2;  // within the row of its box
      const int off = (c / kBoxCols) * chunk + r * kRowBytes + (((byte / 16) ^ (r % 8)) * 16) + byte % 16;
      a[4 * kk + e] = *reinterpret_cast<const uint32_t*>(tile + off);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the MUFU instruction alone: within 2 ulp, a result below 2^-126
// flushed to 0 (a probability that small adds nothing in bf16). exp2f's
// care for subnormal results cost the 192-wide dk/dv kernel a quarter of
// its time, whose score math is on its critical path (2.75 -> 2.11 ms at
// nemotron-4's heads; dq 0.247 -> 0.229 ms at llama3.2-3b's; H100 SXM,
// 700 W).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) as 1 - 2 / (e^{2y} + 1) with |y| clamped to 15 (tanh is then +-1
// in float32): two MUFU operations and a few FMAs, within ~1e-7 of tanhf,
// in fewer registers
__device__ __forceinline__ float tanh_fast(float y) {
  const float e = exp2f(fminf(fmaxf(y, -15.0f), 15.0f) * (2.0f * kLog2e));
  return 1.0f - __fdividef(2.0f, e + 1.0f);
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// layout: dims[4] (hd, heads, positions, batch), byte strides[3] of dims
// 1..3, box[4], as kernel.py's tma_layout computes them
bool encode(CUtensorMap* map, const void* ptr, const long long* layout, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(layout[0]), static_cast<cuuint64_t>(layout[1]),
                              static_cast<cuuint64_t>(layout[2]), static_cast<cuuint64_t>(layout[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(layout[4]),
                                 static_cast<cuuint64_t>(layout[5]),
                                 static_cast<cuuint64_t>(layout[6])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(layout[7]), static_cast<cuuint32_t>(layout[8]),
                             static_cast<cuuint32_t>(layout[9]), static_cast<cuuint32_t>(layout[10])};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (box[0] != kBoxCols || box[1] != 1 || static_cast<int>(box[2]) != box_rows || box[3] != 1)
    return false;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
