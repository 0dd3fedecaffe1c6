// Two-region FloatSD8 sigmoid for Hopper (sm_90a), paper Eqs. 7-8:
//     y = Q(sigma(x))          for x <= 0
//     y = 1 - Q(sigma(-x))     for x >  0
// Q rounds to the 42-entry FloatSD8 LUT at bias -7 (plus 0), read in O(1)
// from the bucket table of lstm_cell_common.cuh.
//
// Replaces the TPU kernel src/repro/kernels/qsigmoid/kernel.py:28
// (qsigmoid_kernel). The arithmetic is the fused cell's: this source
// includes lstm_cell_common.cuh (sigma as torch's CUDA formula, the LUT
// index, the mirror) and is built with --fmad=false, so on f32 inputs it
// agrees bit for bit with the plain version, core.qsigmoid.qsigmoid_raw
// (src/repro_torch/kernels/qsigmoid/ref.py), as the cell does. Like the TPU
// kernel it widens fp16/bf16 inputs to f32 before the sigmoid and rounds
// the result back to the input dtype; the plain version computes sigma in
// the input dtype, so on those inputs the two may differ where that
// rounding crosses a midpoint.
//
// Bound: bytes, once the gate is short. With the 42-compare index the
// kernel was issue-bound (165 SASS instructions an element); with the
// bucket index it is 36-38. Each thread moves 16 B vectors (4 f32 or 8
// fp16/bf16) over a grid of 132 SMs x 8 blocks of 256 threads that strides
// through the tensor, software-pipelined: the next batch of kInFlight
// vectors is loaded before this one is computed, and the first batch is in
// flight while the LUT table is staged, once a block. Two vectors a batch
// were kept by measurement: on the H100 batches of 1, 2 and 4 took 0.0222,
// 0.0216-0.0220 and 0.0227-0.0229 ms at [2,1024,2560] f32 with 33, 53 and
// 80 registers, a copy of the same bytes 0.0204-0.0211 (PERF.md). A start
// that is not 16-byte aligned and a ragged end are handled element by
// element (the head and the tail); the wrapper gives y the same alignment
// as x, so both share one vector split.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/qsigmoid/ops.py.

#include <cuda_bf16.h>
#include <cstdint>
#include <cstring>

#include "../lstm_cell/lstm_cell_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 2;         // 16 B vectors a batch; two batches in flight a thread
constexpr int kGridBlocks = 132 * 8;  // 8 blocks of 256 threads for each of 132 SMs

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
__device__ __forceinline__ T qsig(T v, const float* table) {
  return narrow<T>(qsigmoid(widen(v), table));
}

// One 16 B vector of T, element by element.
template <typename T>
__device__ __forceinline__ uint4 qsig_vec(uint4 v, const float* table) {
  constexpr int kPer = 16 / sizeof(T);
  T e[kPer];
  memcpy(e, &v, 16);
#pragma unroll
  for (int k = 0; k < kPer; ++k) e[k] = qsig(e[k], table);
  memcpy(&v, e, 16);
  return v;
}

// x and y share their alignment: x + head and y + head are 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qsigmoid_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, int head) {
  constexpr int kPer = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long nv = (n - head) / kPer;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
  uint4* __restrict__ yv = reinterpret_cast<uint4*>(y + head);

  // the first batch's loads are in flight while the table is staged
  uint4 v[kInFlight];
#pragma unroll
  for (int k = 0; k < kInFlight; ++k) {
    if (tid + k * stride < nv) v[k] = xv[tid + k * stride];
  }
  __shared__ float table[kSigTable];
  stage_sig_table<kThreads>(table);
  __syncthreads();

  // the head before the first aligned vector and the tail after the last
  if (tid < head) y[tid] = qsig(x[tid], table);
  const long long tail = head + nv * kPer + tid;
  if (tail < n && tid < kPer) y[tail] = qsig(x[tail], table);

  // software-pipelined: the next batch is loaded before this one is computed
  for (long long i = tid; i < nv; i += kInFlight * stride) {
    const long long next = i + kInFlight * stride;
    uint4 w[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (next + k * stride < nv) w[k] = xv[next + k * stride];
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (i + k * stride < nv) yv[i + k * stride] = qsig_vec<T>(v[k], table);
      v[k] = w[k];
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, cudaStream_t s) {
  const unsigned mis = (unsigned)(reinterpret_cast<uintptr_t>(x) & 15);
  if (mis != (unsigned)(reinterpret_cast<uintptr_t>(y) & 15) || mis % sizeof(T) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long head = mis ? (long long)((16 - mis) / sizeof(T)) : 0;
  const int h = (int)(head < n ? head : n);
  const long long nv = (n - h) / (16 / sizeof(T));
  const long long want = (nv + (long long)kThreads * kInFlight - 1) / ((long long)kThreads * kInFlight);
  const unsigned blocks = (unsigned)(want < 1 ? 1 : want < kGridBlocks ? want : kGridBlocks);
  qsigmoid_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(y), n, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y [n] contiguous, both of one dtype (0 = f32, 1 = fp16, 2 = bf16) and
// of one alignment modulo 16 bytes (else cudaErrorInvalidValue, nothing
// launched). Launches on `stream`; returns the launch's cudaError_t as an
// int.
extern "C" int qsigmoid_launch(const void* x, void* y, long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__half>(x, y, n, s);
  if (dtype == 2) return launch<__nv_bfloat16>(x, y, n, s);
  return launch<float>(x, y, n, s);
}
