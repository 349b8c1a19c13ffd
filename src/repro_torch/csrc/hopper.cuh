// Hopper helpers shared by the tensor-core flash kernels: the forward
// (flash_attention.cu, flash_wgmma) and the backward (flash_attention_bwd.cu,
// bwd_dkdv_wgmma and bwd_dq_wgmma). mbarriers, TMA tile loads through a 3-D
// tensor map with 128- or 64-byte swizzle, wgmma shared-memory descriptors
// and the m64nNk16 bf16 -> f32 products the kernels issue.
//
// A tile of R rows x D bf16 lives in shared memory as NB = D / W column
// blocks of [R][W] (Cols<D>: W = 64 at D = 64 and 128, rows of 128 bytes
// under 128-byte swizzle; W = 32 at D = 96, rows of 64 bytes under 64-byte
// swizzle, so 96 columns are three whole blocks and no column is padded),
// each written by one TMA box; every block starts on 1024 bytes, a multiple
// of both swizzle periods (8 rows: GROUP bytes). For such a tile, as wgmma
// operand (kdesc, mndesc):
//   K-major (the reduction over D): desc(block + (kk % KSTEPS) * 32, 16,
//     GROUP) at k-step kk, block = base + (kk / KSTEPS) * R * ROW (a k-step's
//     32 bytes lie inside one swizzled row, so it moves the start address
//     only; LBO is unused in a swizzled K-major layout);
//   MN-major (the reduction over the R rows, N = D): desc(base + kk * 16 *
//     ROW, R * ROW, GROUP) at k-step kk (16 rows): LBO steps from one column
//     block to the next, SBO from one group of 8 rows to the next.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

// The shared-memory layout of a tile with D columns (see the note above).
template <int D>
struct Cols {
  static_assert(D == 64 || D == 96 || D == 128,
                "no tensor-core tile layout for this head dim");
  static constexpr int W = D % 64 == 0 ? 64 : 32;   // columns of a block
  static constexpr int ROW = 2 * W;                 // bytes of a block's row
  static constexpr int NB = D / W;                  // blocks of a tile
  static constexpr int KSTEPS = W / 16;             // k-steps in a block
  static constexpr int GROUP = 8 * ROW;             // 8 rows: a swizzle period
  static constexpr uint64_t SWIZZLE = W == 64 ? 1 : 2;  // SWIZZLE_128B / _64B
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Returns once the phase of parity `parity` has completed. A phase that
// never completes (a fault in the pipeline) traps after 4 s, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = now_ns();
  while (!mbar_try(bar, parity))
    if (now_ns() - t0 > 4000000000ull) __trap();
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(x), "r"(y), "r"(z) : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets in 16-byte units, layout type (1: SWIZZLE_128B, 2: SWIZZLE_64B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
// The tile of `rows` rows x D at `tile` as a K-major operand at k-step kk.
template <int D>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int rows, int kk) {
  using C = Cols<D>;
  return desc(tile + (kk / C::KSTEPS) * rows * C::ROW + (kk % C::KSTEPS) * 32,
              16, C::GROUP, C::SWIZZLE);
}
// The same tile as the MN-major B operand (N = D) of k-step kk: its rows
// 16 kk + [0, 16).
template <int D>
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int rows, int kk) {
  using C = Cols<D>;
  return desc(tile + kk * 16 * C::ROW, rows * C::ROW, C::GROUP, C::SWIZZLE);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous instructions that use them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define PIPIT_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define PIPIT_F16(i) PIPIT_F4(i), PIPIT_F4(i + 4), PIPIT_F4(i + 8), \
    PIPIT_F4(i + 12)

// d[64] (+)= A[64x16] B[16x128]: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : PIPIT_F16(0), PIPIT_F16(16), PIPIT_F16(32), PIPIT_F16(48)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d[32] (+)= A[64x16] B[16x64], as wgmma_ss_n128.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : PIPIT_F16(0), PIPIT_F16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d[16] (+)= A[64x16] B[16x32], as wgmma_ss_n128.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : PIPIT_F16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d[64] += A[64x16] B[16x128]: A (bf16 pairs) from registers, B from shared
// memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : PIPIT_F16(0), PIPIT_F16(16), PIPIT_F16(32), PIPIT_F16(48)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
// d[48] += A[64x16] B[16x96], as wgmma_rs_n128.
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : PIPIT_F16(0), PIPIT_F16(16), PIPIT_F16(32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
// d[32] += A[64x16] B[16x64], as wgmma_rs_n128.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PIPIT_F16(0), PIPIT_F16(16)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}
#undef PIPIT_F16
#undef PIPIT_F4

// d[N / 2] (+)= A B with both from shared memory, K-major, N in {32, 64,
// 128}; any other N does not compile.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 128 || N == 64 || N == 32,
                "wgmma_ss: no instruction issued for this N");
  if constexpr (N == 128) wgmma_ss_n128(d, a, b, accumulate);
  else if constexpr (N == 64) wgmma_ss_n64(d, a, b, accumulate);
  else wgmma_ss_n32(d, a, b, accumulate);
}

// d[D / 2] += A B with A from registers and B MN-major, D in {64, 96,
// 128}; any other D does not compile.
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  static_assert(D == 128 || D == 96 || D == 64,
                "wgmma_rs: no instruction issued for this N");
  if constexpr (D == 128) wgmma_rs_n128(d, a0, a1, a2, a3, b);
  else if constexpr (D == 96) wgmma_rs_n96(d, a0, a1, a2, a3, b);
  else wgmma_rs_n64(d, a0, a1, a2, a3, b);
}

// two f32 -> one register of two bf16, round to nearest even; lo in the
// low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda at link time.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map over x [batch, rows, heads * D] bf16 seen as 3-D, a box of
// [1, box_rows, box_cols] (one swizzled row wide: 64 columns under 128-byte
// swizzle or 32 under 64-byte swizzle, Cols<D>::W), zero fill outside.
inline bool tensor_map(CUtensorMap* map, const void* x, int batch, int rows,
                       int width, int box_rows, int box_cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)width * 2 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc
}  // namespace
