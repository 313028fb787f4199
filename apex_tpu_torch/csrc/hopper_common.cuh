// Hopper primitives shared by the tensor-core kernels (lm_head_xent.cu,
// flash_attention_tc.cu), written in PTX: shared-memory addresses, mbarriers,
// TMA tile loads, the 128-byte-swizzled wgmma descriptor, wgmma m64n64k16
// with both operands in shared memory or A in registers, in bf16 or fp16
// (the template argument T picks the instruction's .bf16 / .f16), and the
// tensor-map encoder reached through the runtime's driver entry point (no
// -lcuda).  Each source compiles into a library of its own, so these live in
// an anonymous namespace, one copy per library.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace {
namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of a 2-D tensor map at coordinates (c0, c1) into shared memory,
// completing on the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same for a 3-D tensor map at (c0, c1, c2)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The wgmma descriptor of a 128-byte-swizzled tile at a 1024-byte-aligned
// shared address: 8-row groups 1024 bytes apart.  As a K-major operand the
// leading offset is unused; as an MN-major operand 64 wide (one swizzle
// atom) the stride between 8-row groups of K is 1024 bytes, which both
// offset fields hold.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across an
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// the instruction's operand type: .bf16 for __nv_bfloat16, .f16 for __half
template <typename T> struct WgType;
template <> struct WgType<__nv_bfloat16> { static constexpr bool f16 = false; };
template <> struct WgType<__half> { static constexpr bool f16 = true; };

#define APEX_WG_D32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
#define APEX_WG_OUT32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define APEX_WG_SS(TY)                                                                        \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " APEX_WG_D32                     \
  "%32, %33, p, 1, 1, 0, 0;\n}\n"
#define APEX_WG_RS(TY)                                                                        \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " APEX_WG_D32                     \
  "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"

// d (64 x 64 fp32) (+)= A (64 x 16, shared, K-major) . B (64 x 16, shared,
// K-major)^T; the sum restarts when acc is 0
template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  if constexpr (WgType<T>::f16)
    asm volatile(APEX_WG_SS("f16") : APEX_WG_OUT32(d) : "l"(da), "l"(db), "r"(acc));
  else
    asm volatile(APEX_WG_SS("bf16") : APEX_WG_OUT32(d) : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64 fp32) += A (64 x 16 in registers, the accumulator fragment
// layout) . B (16 x 64, shared, MN-major: trans-b)
template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (WgType<T>::f16)
    asm volatile(APEX_WG_RS("f16")
                 : APEX_WG_OUT32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(APEX_WG_RS("bf16")
                 : APEX_WG_OUT32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef APEX_WG_RS
#undef APEX_WG_SS
#undef APEX_WG_OUT32
#undef APEX_WG_D32

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to T and packed into one register, lo in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The accumulator layout of wgmma m64nNk16 (fp32): in warp w of the
// warpgroup, lane l holds d[j] at row 16 w + l / 4 + 8 ((j / 2) % 2) and
// column 8 (j / 4) + 2 (l % 4) + j % 2.  A 64 x 64 accumulator is the A
// operand of the next product (64 rows x K = 64) as four k-steps of 16
// columns: a[k][i] packs d[8 k + 2 i] and d[8 k + 2 i + 1] (FlashAttention-3's
// register reuse).
template <typename T>
__device__ __forceinline__ void to_a_frags(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[k][i] = pack2<T>(d[8 * k + 2 * i], d[8 * k + 2 * i + 1]);
}

// cuTensorMapEncodeTiled is a driver-API call: reached through the runtime's
// driver entry point, so the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace hop
}  // namespace
