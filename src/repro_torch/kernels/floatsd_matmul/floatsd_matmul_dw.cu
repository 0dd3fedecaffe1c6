// Weight gradient of the FloatSD8 matmul for Hopper (sm_90a):
//     dw[K, N] = e5m2(clip(x[M, K]^T @ g[M, N]))     (quant != 0)
//     dw[K, N] = x^T @ g                              (quant == 0, the parity oracle)
//
// Replaces the TPU kernel src/repro/kernels/floatsd_matmul/bwd.py:74
// (matmul_dw_kernel). Its plain version is matmul_dw_ref in
// src/repro_torch/kernels/floatsd_matmul/ref.py.
//
// Each output is summed over m = 0, 1, ..., M-1 in order with fmaf in an f32
// register; the plain version (ordered_matmul(x^T, g), one addcmul_ per m)
// repeats the order. At the flush the sum snaps to the FP8 e5m2 grid as
// core/fp8.quantize_fp8 does: finite values clip to +-57344 and round to
// nearest even; +-inf and NaN pass through unchanged. The hardware's
// saturating conversion alone would map inf to 57344 and hide an overflow
// from the train step's skip-on-nonfinite check, so nonfinite values are
// kept before it is applied.
//
// Bound: operations. On the training path (M = S*B = 3072, K = 1024,
// N = 4096) the 2MKN = 25.8 GFLOP dwarf the 79 MB moved, so the kernel is a
// register-tiled FP32 GEMM on the CUDA cores (no tensor cores: TF32 would
// break the 1e-5 contract). Each block owns a 64 x 64 tile of dw; per step
// of 16 rows of m it stages x[m, k0:k0+64] and g[m, n0:n0+64] in shared
// memory (coalesced row reads of both operands, no transposed copy), and each
// of its 256 threads accumulates a 4 x 4 patch from one float4 of each tile
// per m: two shared loads per 16 FMAs. Tile edges are bounds-checked and
// padded with zeros, which add nothing to a sum.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/floatsd_matmul/ops.py.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTK = 64;  // rows of dw (columns of x) per block
constexpr int kTN = 64;  // columns of dw (columns of g) per block
constexpr int kTM = 16;  // rows of x and g per step of the contraction
constexpr int kThreads = 256;  // 16 x 16 threads, each owns a 4 x 4 patch
constexpr int kPerThread = kTM * kTK / kThreads;  // elements of each tile a thread stages

__device__ __forceinline__ float snap_e5m2(float v) {
  if (!isfinite(v)) return v;  // inf and NaN stay nonfinite
  v = fminf(fmaxf(v, -57344.0f), 57344.0f);
  const __nv_fp8_storage_t q = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E5M2);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, __NV_E5M2)));
}

__global__ void __launch_bounds__(kThreads)
matmul_dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 float* __restrict__ dw, int M, int K, int N, int quant) {
  __shared__ __align__(16) float xs[kTM][kTK];
  __shared__ __align__(16) float gs[kTM][kTN];

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int k0 = blockIdx.y * kTK, n0 = blockIdx.x * kTN;
  float acc[4][4] = {};

  for (int m0 = 0; m0 < M; m0 += kTM) {
    // every global load of the step is issued before the first shared store
    float xv[kPerThread], gv[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = t + j * kThreads;
      const int gm = m0 + i / kTK, gk = k0 + i % kTK, gn = n0 + i % kTN;
      xv[j] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
      gv[j] = (gm < M && gn < N) ? g[(size_t)gm * N + gn] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = t + j * kThreads;
      xs[i / kTK][i % kTK] = xv[j];
      gs[i / kTN][i % kTN] = gv[j];
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kTM; ++mm) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[mm][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&gs[mm][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty * 4 + i;
    if (gk >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) dw[(size_t)gk * N + gn] = quant ? snap_e5m2(acc[i][j]) : acc[i][j];
    }
  }
}

}  // namespace

// x [M, K] f32, g [M, N] f32, dw [K, N] f32; all contiguous. Launches on
// `stream`; returns the launch's cudaError_t as an int.
extern "C" int matmul_dw_launch(const float* x, const float* g, float* dw, int M, int K, int N,
                                int quant, void* stream) {
  const dim3 grid((N + kTN - 1) / kTN, (K + kTK - 1) / kTK);
  matmul_dw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, g, dw, M, K, N,
                                                                            quant);
  return static_cast<int>(cudaGetLastError());
}
