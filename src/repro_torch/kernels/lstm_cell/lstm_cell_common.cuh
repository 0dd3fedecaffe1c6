// Device functions shared by the LSTM cell's forward (lstm_cell.cu) and
// backward (lstm_cell_bwd.cu) kernels, so that the backward recomputes the
// forward's gate values and cell state exactly, bit for bit:
//   * sigma(-|z|) is torch's own CUDA formula 1 / (1 + expf(|z|)); its LUT
//     index is the count of the 42 midpoints (in __constant__ memory) it
//     exceeds, then z > 0 mirrors to 1 - q;
//   * e5m2 rounding is the hardware's round-to-nearest-even with
//     saturation (the cell only converts values in [-1, 1]);
//   * fp16 storage rounds with __float2half_rn.
// Both sources are built with --fmad=false.

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

// Midpoints between consecutive entries of the non-positive-branch sigmoid
// LUT (FloatSD8 at bias -7, values in [0, 0.5]).
__constant__ float kSigMid[42] = {
    0.0009765625f, 0.0029296875f, 0.0048828125f, 0.0068359375f, 0.0087890625f,
    0.0107421875f, 0.0126953125f, 0.0146484375f, 0.0166015625f, 0.0185546875f,
    0.021484375f, 0.025390625f, 0.0283203125f, 0.0302734375f, 0.0322265625f,
    0.0341796875f, 0.037109375f, 0.04296875f, 0.05078125f, 0.056640625f,
    0.060546875f, 0.064453125f, 0.068359375f, 0.07421875f, 0.0859375f,
    0.1015625f, 0.11328125f, 0.12109375f, 0.12890625f, 0.13671875f,
    0.1484375f, 0.171875f, 0.203125f, 0.2265625f, 0.2421875f,
    0.2578125f, 0.2734375f, 0.296875f, 0.34375f, 0.40625f,
    0.453125f, 0.484375f};

// The LUT itself: 0 and the 42 FloatSD8 values in (0, 0.5].
__constant__ float kSigGrid[43] = {
    0.0f, 0.001953125f, 0.00390625f, 0.005859375f, 0.0078125f, 0.009765625f,
    0.01171875f, 0.013671875f, 0.015625f, 0.017578125f, 0.01953125f, 0.0234375f,
    0.02734375f, 0.029296875f, 0.03125f, 0.033203125f, 0.03515625f, 0.0390625f,
    0.046875f, 0.0546875f, 0.05859375f, 0.0625f, 0.06640625f, 0.0703125f,
    0.078125f, 0.09375f, 0.109375f, 0.1171875f, 0.125f, 0.1328125f,
    0.140625f, 0.15625f, 0.1875f, 0.21875f, 0.234375f, 0.25f,
    0.265625f, 0.28125f, 0.3125f, 0.375f, 0.4375f, 0.46875f, 0.5f};

__device__ __forceinline__ float e5m2(float v) {
  const __nv_fp8_storage_t q = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E5M2);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, __NV_E5M2)));
}

__device__ __forceinline__ float sigmoid(float z) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
}

// two-region FloatSD8 sigmoid; `grid` is kSigGrid staged in shared memory
__device__ __forceinline__ float qsigmoid(float z, const float* grid) {
  const float s = sigmoid(-fabsf(z));
  int idx = 0;
#pragma unroll
  for (int k = 0; k < 42; ++k) idx += s > kSigMid[k];
  const float q = grid[idx];
  return z > 0.f ? __fsub_rn(1.0f, q) : q;
}

struct Gates {
  float i, f, g, o;
};

// The forward's gate values (quantized: the two-region sigmoid and
// e5m2(tanh); else the smooth ones); `grid` is kSigGrid in shared memory.
__device__ __forceinline__ Gates gates(float zi, float zf, float zg, float zo, int quantized,
                                       const float* grid) {
  if (quantized) return {qsigmoid(zi, grid), qsigmoid(zf, grid), e5m2(tanhf(zg)), qsigmoid(zo, grid)};
  return {sigmoid(zi), sigmoid(zf), tanhf(zg), sigmoid(zo)};
}

// Eq. (5) before storage: f * c_prev + i * g, each product and the sum
// rounded on its own, as separate torch ops round them.
__device__ __forceinline__ float cell_update(const Gates& a, float c_prev) {
  return __fadd_rn(__fmul_rn(a.f, c_prev), __fmul_rn(a.i, a.g));
}

// A value rounded to the cell-state dtype C and read back.
template <typename C> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__half>(float v) {
  return __half2float(__float2half_rn(v));
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __half* p) { return __half2float(*p); }
__device__ __forceinline__ float store(float* p, float v) { *p = v; return v; }
__device__ __forceinline__ float store(__half* p, float v) {
  const __half r = __float2half_rn(v);
  *p = r;
  return __half2float(r);
}

}  // namespace
