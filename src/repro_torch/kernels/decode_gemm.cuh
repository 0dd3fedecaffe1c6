// The decode-in-tile GEMM shared by the FloatSD8 and FloatSD4 matmul kernels
// (floatsd_matmul/floatsd_matmul.cu, floatsd4_matmul/floatsd4_matmul.cu):
//     y[M, N] = x[M, K] @ W,   W decoded from codes tile by tile.
//
// One block owns a 32 x 32 tile of y; 256 threads (16 x 16) each own a
// 2 x 2 patch. Per K step of 128, each thread issues all of its global loads
// (x in f32, its share of the weight codes) before its first store to shared
// memory, so a tile costs one memory round trip; the weight tile is decoded to
// f32 on its way into shared memory. Each output sums k = 0, 1, ..., K-1 in
// order with fmaf (no tensor cores, no TF32), which the plain versions
// repeat. Every edge is bounds-checked: entries outside the matrices are 0
// and nothing past them is read, so no padding is needed for any M, N, K.
//
// A kernel supplies only its weight decode, as a `Loader`:
//     typename Loader::Regs;                                    one K step's codes in registers
//     Regs load(int t, int k0, int n0, int N, int K) const;    global loads of thread t
//     void store(const Regs&, WeightTile& ws, int t) const;    decoded into ws[k][n]

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_gemm {

constexpr int kBM = 32;   // rows of x / y per block
constexpr int kBN = 32;   // columns of y per block
constexpr int kBK = 128;  // K step (fewer barriers, more loads in flight per step)
constexpr int kThreads = 256;  // 16 x 16 threads, each owns a 2 x 2 micro tile
constexpr int kXPerThread = kBM * kBK / kThreads;  // x elements each thread stages per K step

using WeightTile = float[kBK][kBN + 1];  // decoded weight tile, k-major

// Exact 2^k for k in f32's normal range, built from the exponent bits.
__device__ __forceinline__ float pow2i(int k) { return __int_as_float((k + 127) << 23); }

inline dim3 grid(int M, int N) { return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM); }

// The block's tile of y = x @ W. Called once per kernel, by all kThreads
// threads, after the loader's shared tables are written (it synchronises
// before reading them).
template <class Loader>
__device__ __forceinline__ void gemm(const float* __restrict__ x, const Loader& w,
                                     float* __restrict__ y, int M, int N, int K) {
  __shared__ float xs[kBK][kBM + 1];  // x tile, k-major
  __shared__ WeightTile ws;

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += kBK) {
    float xv[kXPerThread];
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      // x tile: consecutive threads read consecutive k of one row
      const int i = t + j * kThreads;
      const int gm = m0 + i / kBK, gk = k0 + i % kBK;
      xv[j] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    const typename Loader::Regs r = w.load(t, k0, n0, N, K);
#pragma unroll
    for (int j = 0; j < kXPerThread; ++j) {
      const int i = t + j * kThreads;
      xs[i % kBK][i / kBK] = xv[j];
    }
    w.store(r, ws, t);
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

}  // namespace decode_gemm
