// Warp-level building blocks shared by the port's Hopper (sm_90a) kernels:
// ldmatrix loads, the bf16 mma.sync m16n8k16 with f32 accumulation,
// cp.async copies, and the exact split of an f32 into three bf16 pieces.
// Included by routed_gemm.cuh (the FloatSD matmuls), flash_attention.cu and
// rwkv_wkv.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c[16 x 8] += a[16 x 16] @ b[16 x 8], bf16 inputs, f32 accumulation. Not
// volatile: a register-only operation, so the compiler may interleave
// independent accumulators (each accumulator's chain keeps its order).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a @ b, from a zero accumulator
__device__ __forceinline__ void mma_bf16_first(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// 16 bytes from global to shared without the registers; src_ok false: zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool src_ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_ok ? 16 : 0));
}
// 4 bytes, the same way (through L1)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool src_ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending)); }

// x = hi + mid + lo, each a bf16 (returned as its 16 bits), by truncation:
// hi = x & 0xFFFF0000, r = x - hi, mid = r & 0xFFFF0000, lo = r - mid (both
// differences exact, so hi + mid + lo == x wherever lo stays a normal f32,
// above about 2^-100). A non-finite x goes whole into hi (NaN as the
// canonical NaN).
__device__ __forceinline__ void split3(float v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const uint32_t b = __float_as_uint(v);
  if (!isfinite(v)) {
    hi = isnan(v) ? 0x7FC0u : b >> 16;
    mid = lo = 0;
    return;
  }
  const uint32_t h = b & 0xFFFF0000u;
  const float r = v - __uint_as_float(h);  // exact: v and h share sign and exponent
  const uint32_t mb = __float_as_uint(r) & 0xFFFF0000u;
  const float l = r - __uint_as_float(mb);  // exact
  hi = h >> 16;
  mid = mb >> 16;
  lo = __float_as_uint(l) >> 16;
}

}  // namespace warp_mma
