// Fused LSTM gate/cell stage for Hopper (sm_90a), paper Eqs. 5-8:
//     i, f, o = two-region FloatSD8 sigmoid of z_i, z_f, z_o
//     g       = e5m2(tanh z_g)
//     c       = f * c_prev + i * g          stored in c's dtype (fp16 under Table VI)
//     h       = o * e5m2(tanh c)
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell/kernel.py:45
// (lstm_cell_kernel). Its plain version is
// src/repro_torch/kernels/lstm_cell/ref.py, and every step here rounds where
// that version rounds, so the two agree bit for bit:
//   * sigma(-|z|) is torch's own CUDA formula 1 / (1 + expf(|z|)); its LUT
//     index is the count of the 42 midpoints (in __constant__ memory) it
//     exceeds, then x > 0 mirrors to 1 - q;
//   * e5m2 rounding is round-to-nearest-even with saturation;
//   * products and the sum of the cell update are rounded one at a time
//     (__fmul_rn / __fadd_rn, and the file is built with --fmad=false), as
//     separate torch ops round them, before the store to fp16 (__float2half_rn).
//
// Bound: bytes. Each thread owns one (b, j) and reads z[b, j], z[b, H + j],
// z[b, 2H + j], z[b, 3H + j] and c_prev[b, j] once and writes h and c once;
// neighbouring threads touch neighbouring j, so every access is coalesced.
// The TPU kernel's gate regrouping is a tiling device and has no counterpart.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/lstm_cell/ops.py.

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

constexpr int kThreads = 256;

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

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __half* p) { return __half2float(*p); }
__device__ __forceinline__ float store(float* p, float v) { *p = v; return v; }
__device__ __forceinline__ float store(__half* p, float v) {
  const __half r = __float2half_rn(v);
  *p = r;
  return __half2float(r);
}

template <typename CIn, typename COut>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const float* __restrict__ z, const CIn* __restrict__ c_prev,
                 float* __restrict__ h, COut* __restrict__ c_out, int B, int H, int quantized) {
  __shared__ float grid[43];
  if (threadIdx.x < 43) grid[threadIdx.x] = kSigGrid[threadIdx.x];
  __syncthreads();

  const long long n = (long long)B * H;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int b = (int)(idx / H), j = (int)(idx % H);
  const float* zr = z + (size_t)b * 4 * H;
  const float zi = zr[j], zf = zr[H + j], zg = zr[2 * H + j], zo = zr[3 * H + j];

  float i_t, f_t, o_t, g_t;
  if (quantized) {
    i_t = qsigmoid(zi, grid);
    f_t = qsigmoid(zf, grid);
    o_t = qsigmoid(zo, grid);
    g_t = e5m2(tanhf(zg));
  } else {
    i_t = sigmoid(zi);
    f_t = sigmoid(zf);
    o_t = sigmoid(zo);
    g_t = tanhf(zg);
  }
  const float c = __fadd_rn(__fmul_rn(f_t, load(c_prev + idx)), __fmul_rn(i_t, g_t));
  const float c_stored = store(c_out + idx, c);
  const float tc = quantized ? e5m2(tanhf(c_stored)) : tanhf(c_stored);
  h[idx] = __fmul_rn(o_t, tc);
}

template <typename CIn, typename COut>
void launch(const float* z, const void* c_prev, float* h, void* c_out, int B, int H,
            int quantized, cudaStream_t s) {
  const long long n = (long long)B * H;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  lstm_cell_kernel<CIn, COut><<<blocks, kThreads, 0, s>>>(
      z, static_cast<const CIn*>(c_prev), h, static_cast<COut*>(c_out), B, H, quantized);
}

}  // namespace

// z [B, 4H] f32 (gate order i|f|g|o), c_prev [B, H] f16 or f32, h [B, H]
// f32, c_out [B, H] f16 or f32; all contiguous. Launches on `stream`;
// returns the launch's cudaError_t as an int.
extern "C" int lstm_cell_launch(const float* z, const void* c_prev, int c_prev_half, float* h,
                                void* c_out, int c_out_half, int B, int H, int quantized,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_prev_half && c_out_half) {
    launch<__half, __half>(z, c_prev, h, c_out, B, H, quantized, s);
  } else if (c_prev_half) {
    launch<__half, float>(z, c_prev, h, c_out, B, H, quantized, s);
  } else if (c_out_half) {
    launch<float, __half>(z, c_prev, h, c_out, B, H, quantized, s);
  } else {
    launch<float, float>(z, c_prev, h, c_out, B, H, quantized, s);
  }
  return static_cast<int>(cudaGetLastError());
}
