// FloatSD4 nibble-unpack + decode-in-tile GEMM for Hopper (sm_90a):
//     y[M, N] = x[M, K] @ W,   W[k, n] = LUT16[code(k, n)] * 2^exps[k / 32, n]
//
// Replaces the TPU kernel src/repro/kernels/floatsd4_matmul/kernel.py:29
// (floatsd4_matmul_kernel). The weight travels as two 4-bit codes per byte
// (low nibble = even row of the packed axis) plus one int8 exponent per 32
// rows of that axis and column; the scale 2^e is built from exponent bits
// (exact), not with the Pallas kernel's exp2. Its plain version is
// src/repro_torch/kernels/floatsd4_matmul/ref.py.
//
// `transposed` selects the layout:
//   0: codes [ceil(K/2), N], exps [ceil(K/32), N]: a gate weight, packed
//      along the contraction K;
//   1: codes [ceil(N/2), K], exps [ceil(N/32), K]: the [N, K] embedding
//      table of the tied logits head, read in place: element (n, k) is
//      nibble n & 1 of codes[n >> 1, k], scaled by 2^exps[n >> 5, k].
//      The TPU package decodes the whole table and multiplies densely
//      there, because a Pallas block cannot transpose a nibble stream; a
//      CUDA thread reads any nibble, so the head runs this kernel too.
//
// The tile loop is the FloatSD8 kernel's (decode_gemm.cuh, shared): 32 x 32
// output tiles, K steps of 128, all global loads of a step issued before the
// first shared store, an ordered fmaf sum over k = 0, 1, ..., K-1 that the
// plain version repeats. Only the weight decode differs: per step each
// thread loads 8 code bytes and their exponents and decodes both nibbles of
// each byte through a 16-entry table in shared memory into the f32 weight
// tile. No tensor cores and no TF32. Products of FP8/FP16 activations and
// FloatSD4 weights are exact in f32, so kernel and plain version agree bit
// for bit on the serving path; no --use_fast_math, so the subnormal values
// of exponent -126 (0.25 * 2^-126) stay.
//
// Every edge is bounds-checked: no read past row ceil(K/2) - 1 of the codes
// or ceil(K/32) - 1 of the exponents, an odd K's pad nibble and a partial
// last group are never used, and entries outside the matrix are 0.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/floatsd4_matmul/ops.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../decode_gemm.cuh"

namespace {

using namespace decode_gemm;

// The 15 FloatSD4 mantissas, ascending; code 15 decodes to 0.
__constant__ float kLut16[16] = {
    -2.25f, -2.0f, -1.75f, -1.25f, -1.0f, -0.75f, -0.25f, 0.0f,
    0.25f, 0.75f, 1.0f, 1.25f, 1.75f, 2.0f, 2.25f, 0.0f};

constexpr int kBPerThread = kBK * kBN / 2 / kThreads;  // code bytes each thread stages per K step

// The weight tile: two 4-bit codes per byte along the packed axis, one int8
// exponent per 32 rows of it.
template <bool kTransposed>
struct NibbleTile {
  const uint8_t* __restrict__ codes;
  const int8_t* __restrict__ exps;
  const float* lut;  // shared memory

  struct Regs {
    uint8_t c[kBPerThread];
    int8_t e[kBPerThread];
    bool lo[kBPerThread], hi[kBPerThread];
  };

  __device__ __forceinline__ Regs load(int t, int k0, int n0, int N, int K) const {
    Regs r;
#pragma unroll
    for (int j = 0; j < kBPerThread; ++j) {
      // byte j of this thread holds two neighbouring rows of the packed axis;
      // consecutive threads read consecutive bytes in either layout
      const int i = t + j * kThreads;
      if (kTransposed) {
        const int gn = n0 + 2 * (i / kBK), gk = k0 + i % kBK;  // rows gn, gn + 1 of the table
        r.lo[j] = gn < N && gk < K;
        r.hi[j] = gn + 1 < N && gk < K;
        r.c[j] = r.lo[j] ? codes[(size_t)(gn >> 1) * K + gk] : 0;
        r.e[j] = r.lo[j] ? exps[(size_t)(gn >> 5) * K + gk] : 0;
      } else {
        const int gk = k0 + 2 * (i / kBN), gn = n0 + i % kBN;  // rows gk, gk + 1 of W
        r.lo[j] = gk < K && gn < N;
        r.hi[j] = gk + 1 < K && gn < N;
        r.c[j] = r.lo[j] ? codes[(size_t)(gk >> 1) * N + gn] : 0;
        r.e[j] = r.lo[j] ? exps[(size_t)(gk >> 5) * N + gn] : 0;
      }
    }
    return r;
  }

  __device__ __forceinline__ void store(const Regs& r, WeightTile& ws, int t) const {
#pragma unroll
    for (int j = 0; j < kBPerThread; ++j) {
      const int i = t + j * kThreads;
      // clamped to f32's normal range, as the plain version's exp2i clamps
      const float scale = pow2i(max(static_cast<int>(r.e[j]), -126));
      const float lo = r.lo[j] ? lut[r.c[j] & 0xF] * scale : 0.f;
      const float hi = r.hi[j] ? lut[r.c[j] >> 4] * scale : 0.f;
      if (kTransposed) {
        const int kk = i % kBK, c = 2 * (i / kBK);
        ws[kk][c] = lo;
        ws[kk][c + 1] = hi;
      } else {
        const int kk = 2 * (i / kBN), c = i % kBN;
        ws[kk][c] = lo;
        ws[kk + 1][c] = hi;
      }
    }
  }
};

template <bool kTransposed>
__global__ void __launch_bounds__(kThreads)
floatsd4_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                       const int8_t* __restrict__ exps, float* __restrict__ y,
                       int M, int N, int K) {
  __shared__ float lut[16];
  if (threadIdx.x < 16) lut[threadIdx.x] = kLut16[threadIdx.x];
  gemm(x, NibbleTile<kTransposed>{codes, exps, lut}, y, M, N, K);
}

}  // namespace

// x [M, K] f32; codes/exps as above (uint8 / int8); y [M, N] f32; all
// contiguous. Launches on `stream`; returns the launch's cudaError_t as an int.
extern "C" int floatsd4_matmul_launch(const float* x, const uint8_t* codes, const int8_t* exps,
                                      float* y, int M, int N, int K, int transposed,
                                      void* stream) {
  const dim3 grid = decode_gemm::grid(M, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transposed) {
    floatsd4_matmul_kernel<true><<<grid, decode_gemm::kThreads, 0, s>>>(x, codes, exps, y, M, N, K);
  } else {
    floatsd4_matmul_kernel<false><<<grid, decode_gemm::kThreads, 0, s>>>(x, codes, exps, y, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
