// Two-region FloatSD8 sigmoid for Hopper (sm_90a), paper Eqs. 7-8:
//     y = Q(sigma(x))          for x <= 0
//     y = 1 - Q(sigma(-x))     for x >  0
// Q rounds to the 42-entry FloatSD8 LUT at bias -7 (plus 0) by counting the
// midpoints that sigma(-|x|) exceeds.
//
// Replaces the TPU kernel src/repro/kernels/qsigmoid/kernel.py:28
// (qsigmoid_kernel). The arithmetic is the fused cell's: this source
// includes lstm_cell_common.cuh (sigma as torch's CUDA formula, the
// midpoint count, the mirror) and is built with --fmad=false, so on f32
// inputs it agrees bit for bit with the plain version, core.qsigmoid.qsigmoid_raw
// (src/repro_torch/kernels/qsigmoid/ref.py), as the cell does. Like the TPU
// kernel it widens fp16/bf16 inputs to f32 before the sigmoid and rounds
// the result back to the input dtype; the plain version computes sigma in
// the input dtype, so on those inputs the two may differ where that
// rounding crosses a midpoint.
//
// Bound: bytes. One thread per element reads its input once and writes its
// output once, coalesced, with a grid-stride loop; the 42 compares against
// __constant__ midpoints are a broadcast.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/qsigmoid/ops.py.

#include <cuda_bf16.h>

#include "../lstm_cell/lstm_cell_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __half narrow<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qsigmoid_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  __shared__ float grid[43];
  if (threadIdx.x < 43) grid[threadIdx.x] = kSigGrid[threadIdx.x];
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    y[i] = narrow<T>(qsigmoid(widen(x[i]), grid));
  }
}

template <typename T>
void launch(const void* x, void* y, long long n, cudaStream_t s) {
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 132 * 64 ? want : 132 * 64);
  qsigmoid_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(y), n);
}

}  // namespace

// x, y [n] contiguous, both of one dtype: 0 = f32, 1 = fp16, 2 = bf16.
// Launches on `stream`; returns the launch's cudaError_t as an int.
extern "C" int qsigmoid_launch(const void* x, void* y, long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch<__half>(x, y, n, s);
  } else if (dtype == 2) {
    launch<__nv_bfloat16>(x, y, n, s);
  } else {
    launch<float>(x, y, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}
