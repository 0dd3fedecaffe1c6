// FloatSD8 decode-in-tile GEMM for Hopper (sm_90a):
//     y[M, N] = x[M, K] @ decode(codes),  decode(c) = LUT[c & 31] * 2^((c >> 5) + bias)
//
// Replaces the TPU kernel src/repro/kernels/floatsd_matmul/kernel.py:34
// (floatsd_matmul_kernel), and follows the reference decode of
// src/repro/core/floatsd.py (exact power-of-two scale, mantissa index 31
// clipped to 30) rather than the Pallas kernel's exp2.
//
// Bound: at the serving path's shapes (M = lanes or lanes * chunk, K = 1024,
// N = 4096 or 33280) the weight codes dominate the bytes moved, so the
// kernel is memory-bound. Its design answer is to move the weights as
// 1-byte codes and decode them in shared memory: each block first builds a
// 256-entry table of every code's value (mantissa LUT from __constant__
// memory times the exact scale 2^(e + bias) built from exponent bits), then
// per K step stages an x tile (f32) and a code tile (u8, decoded through
// the table) in shared memory and accumulates in f32 registers with FFMA.
// No TF32 and no tensor cores: the precise contract holds the result to
// 1e-5 of the f32 reference. Each output sums k = 0, 1, ..., K-1 in order,
// which the plain version repeats; on the serving path every product is
// exact in f32, so the two agree bit for bit. Every tile edge is bounds-checked, so no
// zero-code padding is needed for any M, N, K.
//
// `transposed` selects the code layout: codes[K, N] (gate weights) or
// codes[N, K] (the tied logits head reads the embedding table in place).
//
// Plain C interface; the wrapper is src/repro_torch/kernels/floatsd_matmul/ops.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The 31 FloatSD8 mantissa values, ascending; entry 31 repeats entry 30
// (decode clips index 31 to 30).
__constant__ float kMantissa[32] = {
    -4.5f, -4.25f, -4.0f, -3.75f, -3.5f, -2.5f, -2.25f, -2.0f, -1.75f, -1.5f,
    -1.25f, -1.0f, -0.75f, -0.5f, -0.25f, 0.0f, 0.25f, 0.5f, 0.75f, 1.0f,
    1.25f, 1.5f, 1.75f, 2.0f, 2.25f, 2.5f, 3.5f, 3.75f, 4.0f, 4.25f,
    4.5f, 4.5f};

constexpr int kBM = 32;   // rows of x / y per block
constexpr int kBN = 32;   // columns of y per block
constexpr int kBK = 128;  // K step (fewer barriers, more loads in flight per step)
constexpr int kThreads = 256;  // 16 x 16 threads, each owns a 2 x 2 micro tile
constexpr int kXPerThread = kBM * kBK / kThreads;  // x elements each thread stages per K step
constexpr int kCPerThread = kBK * kBN / kThreads;  // codes each thread stages per K step

// Exact 2^k for k in f32's normal range, built from the exponent bits.
__device__ __forceinline__ float pow2i(int k) { return __int_as_float((k + 127) << 23); }

template <bool kTransposed>
__global__ void __launch_bounds__(kThreads)
floatsd_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                      int bias, float* __restrict__ y, int M, int N, int K) {
  __shared__ float table[256];            // value of every code byte
  __shared__ float xs[kBK][kBM + 1];      // x tile, k-major
  __shared__ float ws[kBK][kBN + 1];      // decoded weight tile

  const int t = threadIdx.x;
  table[t] = kMantissa[t & 31] * pow2i((t >> 5) + bias);

  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // Stage both tiles through registers: every thread issues all of its
    // global loads before the first store to shared memory, so a tile costs
    // one memory round trip, not one per element.
    float xv[kXPerThread];
    uint8_t cv[kCPerThread];
    bool cok[kCPerThread];
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      // x tile: consecutive threads read consecutive k of one row
      const int i = t + j * kThreads;
      const int gm = m0 + i / kBK, gk = k0 + i % kBK;
      xv[j] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kCPerThread; ++j) {
      // code tile: consecutive threads read consecutive bytes in either layout
      const int i = t + j * kThreads;
      const int kk = kTransposed ? i % kBK : i / kBN;
      const int c = kTransposed ? i / kBK : i % kBN;
      const int gk = k0 + kk, gn = n0 + c;
      cok[j] = gk < K && gn < N;
      cv[j] = cok[j] ? (kTransposed ? codes[(size_t)gn * K + gk] : codes[(size_t)gk * N + gn]) : 0;
    }
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int i = t + j * kThreads;
      xs[i % kBK][i / kBK] = xv[j];
    }
#pragma unroll
    for (int j = 0; j < kCPerThread; ++j) {
      // decoded on the way into shared memory; out-of-range entries are 0
      const int i = t + j * kThreads;
      const int kk = kTransposed ? i % kBK : i / kBN;
      const int c = kTransposed ? i / kBK : i % kBN;
      ws[kk][c] = cok[j] ? table[cv[j]] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float a0 = xs[kk][ty], a1 = xs[kk][ty + 16];
      const float b0 = ws[kk][tx], b1 = ws[kk][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) y[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// x [M, K] f32, codes [K, N] (transposed == 0) or [N, K] (transposed != 0)
// u8, bias already clamped to [-126, 120], y [M, N] f32; all contiguous.
// Launches on `stream`; returns the launch's cudaError_t as an int.
extern "C" int floatsd_matmul_launch(const float* x, const uint8_t* codes, int bias, float* y,
                                     int M, int N, int K, int transposed, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transposed) {
    floatsd_matmul_kernel<true><<<grid, kThreads, 0, s>>>(x, codes, bias, y, M, N, K);
  } else {
    floatsd_matmul_kernel<false><<<grid, kThreads, 0, s>>>(x, codes, bias, y, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
