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
// Bound on this card by the bytes of the codes (K x N / 2, plus K x N / 32
// of exponents; at M = 64 the f32 operations come close). The tile loop is
// route A of the FloatSD8 matmul (../routed_gemm.cuh, `ordered_tile`), for
// every M: ordered split-K on the CUDA cores, K cut into `plan`'s chunks
// (ordered=True; floatsd_matmul/ref.py), each summed in k order with fmaf,
// the chunks added in order, which the plain version repeats. Products of
// FP8/FP16 activations and FloatSD4 weights are exact in f32, so kernel and
// plain version agree bit for bit on the serving path. No tensor cores and
// no TF32; no --use_fast_math, so the subnormal values of exponent -126
// (0.25 * 2^-126) stay. Only the weight's decode is this file's, as the
// tile loop's `Loader`: per stage each thread loads 16 code bytes and their
// 16 exponents (two 16-byte loads, neighbouring threads on neighbouring
// addresses in both layouts) and decodes both nibbles of each byte through
// a 16-entry table in shared memory into the f32 tile. A chunk is a multiple
// of 64 k, and a stage starts at a multiple of 64, so neither splits a
// nibble byte or a 32-row exponent group.
//
// Every edge is bounds-checked: no read past row ceil(K/2) - 1 of the codes
// or ceil(K/32) - 1 of the exponents, an odd row count's pad nibble is
// replaced by the zero code, and entries outside the matrix decode to 0.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/floatsd4_matmul/ops.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../routed_gemm.cuh"

namespace {

using namespace routed_gemm;

// The 15 FloatSD4 mantissas, ascending; code 15 decodes to 0.
__constant__ float kLut16[16] = {
    -2.25f, -2.0f, -1.75f, -1.25f, -1.0f, -0.75f, -0.25f, 0.0f,
    0.25f, 0.75f, 1.0f, 1.25f, 1.75f, 2.0f, 2.25f, 0.0f};

constexpr uint32_t kZeroByte = 0x77u;  // two zero codes (mantissa 0.0)

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
}
__device__ __forceinline__ int byte(const uint4& v, int i) { return (word(v, i) >> (8 * (i & 3))) & 0xFF; }

// The FloatSD4 weight as route A's Loader. A stage's [kABK][kABN] tile is
// 4096 code bytes: thread t loads 16 of them and their exponents.
template <bool kTransposed>
struct Fsd4 {
  const uint8_t* __restrict__ codes;
  const int8_t* __restrict__ exps;
  int N, K;
  bool vec;          // packed rows of a multiple of 16 bytes from 16-byte aligned bases
  const float* lut;  // shared: the 16 mantissas

  struct RegsA {
    uint4 c;  // 16 code bytes
    uint4 e;  // their exponents
  };

  // thread t's bytes in the tile: (k, n) is the low nibble of the first
  // byte. [K, N]: 8 threads a code row, 16 n each; the high nibble is k + 1.
  // [N, K]: 4 threads a code row, 16 k each; the high nibble is n + 1.
  __device__ __forceinline__ static void place(int t, int& k, int& n) {
    k = kTransposed ? (t & 3) * 16 : 2 * (t >> 3);
    n = kTransposed ? 2 * (t >> 2) : (t & 7) * 16;
  }

  __device__ __forceinline__ RegsA load_a(int t, int k0, int kend, int n0) const {
    int k, n;
    place(t, k, n);
    k += k0, n += n0;
    const size_t row = kTransposed ? (size_t)(n >> 1) * K + k : (size_t)(k >> 1) * N + n;
    const size_t grp = kTransposed ? (size_t)(n >> 5) * K + k : (size_t)(k >> 5) * N + n;
    const bool full = kTransposed ? (n < N && k + 16 <= kend) : (k < kend && n + 16 <= N);
    RegsA r;
    if (vec && full) {
      r.c = __ldg(reinterpret_cast<const uint4*>(codes + row));
      r.e = __ldg(reinterpret_cast<const uint4*>(exps + grp));
    } else {
      uint32_t c[4], e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c[q] = e[q] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = 4 * q + b;
          const bool ok = kTransposed ? (n < N && k + i < kend) : (k < kend && n + i < N);
          c[q] |= (ok ? uint32_t(codes[row + i]) : kZeroByte) << (8 * b);
          e[q] |= (ok ? uint32_t(static_cast<uint8_t>(exps[grp + i])) : 0u) << (8 * b);
        }
      }
      r.c = make_uint4(c[0], c[1], c[2], c[3]);
      r.e = make_uint4(e[0], e[1], e[2], e[3]);
    }
    // the high nibbles past an odd row count (the pad) decode to 0
    if (kTransposed ? n + 1 >= N : k + 1 >= kend) {
      constexpr uint32_t lo = 0x0F0F0F0Fu, zero_hi = 0x70707070u;
      r.c = make_uint4((r.c.x & lo) | zero_hi, (r.c.y & lo) | zero_hi, (r.c.z & lo) | zero_hi,
                       (r.c.w & lo) | zero_hi);
    }
    return r;
  }

  __device__ __forceinline__ void store_a(const RegsA& r, float* ws, int t) const {
    int k, n;
    place(t, k, n);
    float lo[16], hi[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = byte(r.c, i);
      // clamped to f32's normal range, as the plain version's exp2i clamps
      const float scale = pow2i(max(static_cast<int>(static_cast<int8_t>(byte(r.e, i))), -126));
      lo[i] = lut[c & 0xF] * scale;
      hi[i] = lut[c >> 4] * scale;
    }
    if (kTransposed) {  // byte i: (k + i, n) and (k + i, n + 1), neighbours in the swizzled tile
#pragma unroll
      for (int i = 0; i < 16; ++i) *reinterpret_cast<float2*>(ws + a_slot(k + i, n)) = make_float2(lo[i], hi[i]);
    } else {  // byte i: (k, n + i) and (k + 1, n + i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<float4*>(ws + a_slot(k, n + 4 * q)) =
            make_float4(lo[4 * q], lo[4 * q + 1], lo[4 * q + 2], lo[4 * q + 3]);
        *reinterpret_cast<float4*>(ws + a_slot(k + 1, n + 4 * q)) =
            make_float4(hi[4 * q], hi[4 * q + 1], hi[4 * q + 2], hi[4 * q + 3]);
      }
    }
  }
};

static_assert(kABK * kABN / 2 == 16 * kThreads, "a stage's code bytes: 16 a thread");

template <bool kT, int MT>
__global__ void __launch_bounds__(kThreads)
floatsd4_matmul_ordered_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                               const int8_t* __restrict__ exps, float* __restrict__ out, int M, int N, int K,
                               int splits, int chunk) {
  __shared__ float lut[16];
  extern __shared__ __align__(16) unsigned char smem[];
  if (threadIdx.x < 16) lut[threadIdx.x] = kLut16[threadIdx.x];
  const int row = kT ? K : N;
  const bool vec = row % 16 == 0 && ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(exps)) & 15) == 0;
  ordered_tile<MT>(x, Fsd4<kT>{codes, exps, N, K, vec, lut}, out, M, N, K, splits, chunk,
                   reinterpret_cast<float*>(smem));
}

// `blocks_z`: splits (a block a chunk, into partials) or 1 (a block adds its chunks itself)
template <bool kT>
cudaError_t launch_ordered(const float* x, const uint8_t* codes, const int8_t* exps, float* out, int M, int N,
                           int K, int splits, int chunk, int blocks_z, cudaStream_t s) {
  return with_row_tile(M, [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    const size_t smem = a_smem<MT>();
    if (cudaError_t e = allow_smem<floatsd4_matmul_ordered_kernel<kT, MT>>(smem)) return e;
    const dim3 grid((N + kABN - 1) / kABN, (M + MT - 1) / MT, blocks_z);
    floatsd4_matmul_ordered_kernel<kT, MT><<<grid, kThreads, smem, s>>>(x, codes, exps, out, M, N, K, splits,
                                                                         chunk);
    return cudaGetLastError();
  });
}

}  // namespace

// x [M, K] f32; codes/exps as above (uint8 / int8); y [M, N] f32; all
// contiguous. K is cut into `splits` chunks of `chunk` consecutive k (a
// multiple of 64 when splits > 1). With splits > 1 and `part` [splits, M,
// N] f32 given, a block sums each chunk into it and a second kernel adds
// them in order into y; with `part` null, a block sums all the chunks of its
// tile and adds them in the same order itself. Launches on `stream`; returns
// the launches' cudaError_t as an int.
extern "C" int floatsd4_matmul_launch(const float* x, const uint8_t* codes, const int8_t* exps, float* y,
                                      float* part, int M, int N, int K, int transposed, int splits, int chunk,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1 && chunk % kABK) return static_cast<int>(cudaErrorInvalidValue);
  const bool partials = splits > 1 && part != nullptr;
  float* out = partials ? part : y;
  const int blocks_z = partials ? splits : 1;
  const cudaError_t e = transposed ? launch_ordered<true>(x, codes, exps, out, M, N, K, splits, chunk, blocks_z, s)
                                   : launch_ordered<false>(x, codes, exps, out, M, N, K, splits, chunk, blocks_z, s);
  if (e != cudaSuccess || !partials) return static_cast<int>(e);
  return static_cast<int>(launch_add_partials(part, y, (size_t)M * N, splits, s));
}
