// Weight gradient of the FloatSD8 matmul for Hopper (sm_90a):
//     dw[K, N] = e5m2(clip(x[M, K]^T @ g[M, N]))     (quant != 0)
//     dw[K, N] = x^T @ g                              (quant == 0, the parity oracle)
//
// Replaces the TPU kernel src/repro/kernels/floatsd_matmul/bwd.py:74
// (matmul_dw_kernel). Its plain version is matmul_dw_ref in
// src/repro_torch/kernels/floatsd_matmul/ref.py.
//
// Each output is summed over m = 0, 1, ..., M-1 in order with fmaf in an f32
// register, from +0; the plain version (ordered_matmul(x^T, g), one addcmul_
// per m) repeats the order. The order is what the training path needs: its
// fp16 masters move by less than an ulp a step, so any other order flips
// their bits. At the flush the sum snaps to the FP8 e5m2 grid as
// core/fp8.quantize_fp8 does: finite values clip to +-57344 and round to
// nearest even; +-inf and NaN pass through unchanged. The hardware's
// saturating conversion alone would map inf to 57344 and hide an overflow
// from the train step's skip-on-nonfinite check, so nonfinite values are
// kept before it is applied.
//
// Bound: operations. On the training path (M = S*B = 3072, K = 1024,
// N = 4096) the 2MKN = 25.8 GFLOP dwarf the 79 MB moved, so the kernel is a
// register-blocked FP32 GEMM on the CUDA cores (no tensor cores: their sum
// order is their own, and TF32 would break the 1e-5 contract). Each block
// of 256 threads owns a 128 x 128 tile of dw, each thread an 8 x 8 patch in
// registers (rows k and k + 64 for 4 k, columns n and n + 64 for 4 n): four
// shared float4 loads per 64 FMAs. A warp spans 4 k x 8 n threads, so its
// loads of one x row touch 4 float4 and of one g row 8 neighbouring float4:
// one shared wavefront each. x[m, k0:k0+128] and g[m, n0:n0+128] are rows
// of both operands (no transposed copy) and stream by cp.async through a
// ring of three stages of 16 m, so two stages' loads are in flight while a
// third is multiplied. The last stage's rows past M are zeros, which leave
// every sum's value unchanged. Every edge is bounds-checked: any M, K and N
// run without padding (rows of a multiple of 4 floats move 16 bytes a copy,
// others 4).
//
// Plain C interface; the wrapper is src/repro_torch/kernels/floatsd_matmul/ops.py.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTK = 128;       // rows of dw (columns of x) per block
constexpr int kTN = 128;       // columns of dw (columns of g) per block
constexpr int kTM = 16;        // rows of x and g per stage of the contraction
constexpr int kStages = 3;     // the cp.async ring
constexpr int kThreads = 256;  // 16 x 16 threads, each owns an 8 x 8 patch
constexpr int kStage = kTM * (kTK + kTN);  // floats of one stage: the x tile, then the g tile
constexpr size_t kSmem = kStages * kStage * sizeof(float);  // 48 KiB

__device__ __forceinline__ float snap_e5m2(float v) {
  if (!isfinite(v)) return v;  // inf and NaN stay nonfinite
  v = fminf(fmaxf(v, -57344.0f), 57344.0f);
  const __nv_fp8_storage_t q = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E5M2);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, __NV_E5M2)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// `kBytes` (4 or 16) from global to shared without the registers; ok false: zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(smem_u32(dst)), "l"(src), "n"(kBytes), "r"(ok ? kBytes : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending)); }

// kVec: K and N multiples of 4 and x, g, dw 16-byte aligned
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
matmul_dw_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ dw, int M, int K,
                 int N, int quant) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tk = (warp >> 1) * 4 + (lane >> 3);  // 16 x 16 threads; a warp is 4 (k) x 8 (n)
  const int tn = (warp & 1) * 8 + (lane & 7);
  const int k0 = blockIdx.y * kTK, n0 = blockIdx.x * kTN;
  const int nst = (M + kTM - 1) / kTM;

  // stage s into its ring slot: rows m0.. of x[:, k0:k0+128] and g[:, n0:n0+128],
  // 512 runs of 4 floats each, two of each tile a thread
  auto issue = [&](int s) {
    float* xs = smem + (s % kStages) * kStage;
    float* gs = xs + kTM * kTK;
    const int m0 = s * kTM;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = t + j * kThreads, r = c >> 5, q = (c & 31) * 4;
      const int m = m0 + r, k = k0 + q, n = n0 + q;
      const size_t xa = (size_t)m * K + k, ga = (size_t)m * N + n;
      if constexpr (kVec) {
        cp_async<16>(xs + r * kTK + q, m < M && k < K ? x + xa : x, m < M && k < K);
        cp_async<16>(gs + r * kTN + q, m < M && n < N ? g + ga : g, m < M && n < N);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool xo = m < M && k + i < K, go = m < M && n + i < N;
          cp_async<4>(xs + r * kTK + q + i, xo ? x + xa + i : x, xo);
          cp_async<4>(gs + r * kTN + q + i, go ? g + ga + i : g, go);
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s have landed
    __syncthreads();               // everyone's; stage s - 1's products are done, its slot is free
    if (s + kStages - 1 < nst) issue(s + kStages - 1);
    cp_async_commit();
    const float* xs = smem + (s % kStages) * kStage;
    const float* gs = xs + kTM * kTK;
#pragma unroll
    for (int mm = 0; mm < kTM; ++mm) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + mm * kTK + tk * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + mm * kTK + 64 + tk * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(gs + mm * kTN + tn * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(gs + mm * kTN + 64 + tn * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i >> 2) * 64 + tk * 4 + (i & 3);
    if (k >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tn * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = quant ? snap_e5m2(acc[i][4 * h + j]) : acc[i][4 * h + j];
      float* out = dw + (size_t)k * N + n;
      if (kVec && n < N) {
        *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) out[j] = v[j];
      }
    }
  }
}

template <bool kVec>
cudaError_t launch(const float* x, const float* g, float* dw, int M, int K, int N, int quant, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_dw_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kTN - 1) / kTN, (K + kTK - 1) / kTK);
  matmul_dw_kernel<kVec><<<grid, kThreads, kSmem, s>>>(x, g, dw, M, K, N, quant);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] f32, g [M, N] f32, dw [K, N] f32; all contiguous. Launches on
// `stream`; returns the launch's cudaError_t as an int.
extern "C" int matmul_dw_launch(const float* x, const float* g, float* dw, int M, int K, int N, int quant,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(dw)) & 15) == 0;
  return static_cast<int>(vec ? launch<true>(x, g, dw, M, K, N, quant, s) : launch<false>(x, g, dw, M, K, N, quant, s));
}
