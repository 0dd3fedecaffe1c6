// FloatSD8 decode-in-tile GEMM for Hopper (sm_90a):
//     y[M, N] = x[M, K] @ decode(codes),  decode(c) = LUT[c & 31] * 2^((c >> 5) + bias)
//
// Replaces the TPU kernel src/repro/kernels/floatsd_matmul/kernel.py:34
// (floatsd_matmul_kernel), and follows the reference decode of
// src/repro/core/floatsd.py (exact power-of-two scale, mantissa index 31
// clipped to 30) rather than the Pallas kernel's exp2.
//
// The weights move as 1-byte codes and are decoded in shared memory: each
// block first builds a 256-entry table of every code's value (mantissa LUT
// from __constant__ memory times the exact scale 2^(e + bias) built from
// exponent bits); the tile loop (decode_gemm.cuh, shared with the FloatSD4
// kernel) stages each code tile through that table and sums k = 0, 1, ...,
// K-1 in order with fmaf, which the plain version repeats. No TF32 and no
// tensor cores: the precise contract holds the result to 1e-5 of the f32
// reference, and on the serving path every product is exact in f32, so
// kernel and plain version agree bit for bit.
//
// `transposed` selects the code layout: codes[K, N] (gate weights) or
// codes[N, K] (the tied logits head reads the embedding table in place).
//
// Plain C interface; the wrapper is src/repro_torch/kernels/floatsd_matmul/ops.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../decode_gemm.cuh"

namespace {

using namespace decode_gemm;

// The 31 FloatSD8 mantissa values, ascending; entry 31 repeats entry 30
// (decode clips index 31 to 30).
__constant__ float kMantissa[32] = {
    -4.5f, -4.25f, -4.0f, -3.75f, -3.5f, -2.5f, -2.25f, -2.0f, -1.75f, -1.5f,
    -1.25f, -1.0f, -0.75f, -0.5f, -0.25f, 0.0f, 0.25f, 0.5f, 0.75f, 1.0f,
    1.25f, 1.5f, 1.75f, 2.0f, 2.25f, 2.5f, 3.5f, 3.75f, 4.0f, 4.25f,
    4.5f, 4.5f};

constexpr int kCPerThread = kBK * kBN / kThreads;  // codes each thread stages per K step

// The weight tile: one code byte per weight, decoded through the block's
// 256-entry table of every code's value.
template <bool kTransposed>
struct CodeTile {
  const uint8_t* __restrict__ codes;
  const float* table;  // shared memory

  struct Regs {
    uint8_t c[kCPerThread];
    bool ok[kCPerThread];
  };

  // consecutive threads read consecutive bytes in either layout
  __device__ __forceinline__ static void place(int i, int& kk, int& c) {
    kk = kTransposed ? i % kBK : i / kBN;
    c = kTransposed ? i / kBK : i % kBN;
  }

  __device__ __forceinline__ Regs load(int t, int k0, int n0, int N, int K) const {
    Regs r;
#pragma unroll
    for (int j = 0; j < kCPerThread; ++j) {
      int kk, c;
      place(t + j * kThreads, kk, c);
      const int gk = k0 + kk, gn = n0 + c;
      r.ok[j] = gk < K && gn < N;
      r.c[j] = r.ok[j] ? (kTransposed ? codes[(size_t)gn * K + gk] : codes[(size_t)gk * N + gn]) : 0;
    }
    return r;
  }

  __device__ __forceinline__ void store(const Regs& r, WeightTile& ws, int t) const {
#pragma unroll
    for (int j = 0; j < kCPerThread; ++j) {
      int kk, c;
      place(t + j * kThreads, kk, c);
      ws[kk][c] = r.ok[j] ? table[r.c[j]] : 0.f;
    }
  }
};

template <bool kTransposed>
__global__ void __launch_bounds__(kThreads)
floatsd_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                      int bias, float* __restrict__ y, int M, int N, int K) {
  __shared__ float table[256];  // value of every code byte
  const int t = threadIdx.x;
  table[t] = kMantissa[t & 31] * pow2i((t >> 5) + bias);
  gemm(x, CodeTile<kTransposed>{codes, table}, y, M, N, K);
}

}  // namespace

// x [M, K] f32, codes [K, N] (transposed == 0) or [N, K] (transposed != 0)
// u8, bias already clamped to [-126, 120], y [M, N] f32; all contiguous.
// Launches on `stream`; returns the launch's cudaError_t as an int.
extern "C" int floatsd_matmul_launch(const float* x, const uint8_t* codes, int bias, float* y,
                                     int M, int N, int K, int transposed, void* stream) {
  const dim3 grid = decode_gemm::grid(M, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transposed) {
    floatsd_matmul_kernel<true><<<grid, decode_gemm::kThreads, 0, s>>>(x, codes, bias, y, M, N, K);
  } else {
    floatsd_matmul_kernel<false><<<grid, decode_gemm::kThreads, 0, s>>>(x, codes, bias, y, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
