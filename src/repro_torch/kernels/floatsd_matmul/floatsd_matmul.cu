// FloatSD8 decode-in-tile GEMM for Hopper (sm_90a):
//     y[M, N] = x[M, K] @ decode(codes),  decode(c) = LUT[c & 31] * 2^((c >> 5) + bias)
//
// Replaces the TPU kernel src/repro/kernels/floatsd_matmul/kernel.py:34
// (floatsd_matmul_kernel), which decodes code tiles in VMEM and feeds the
// MXU with f32 accumulation; this computes the same function with the
// precise contract (within 1e-5 of the sum of term magnitudes on any f32 x,
// no TF32), and follows the reference decode of src/repro/core/floatsd.py
// (exact power-of-two scale, mantissa index 31 clipped to 30) rather than
// the Pallas kernel's exp2.
//
// Two routes (tile loops in ../routed_gemm.cuh), chosen with the K split by
// `plan` (ref.py; the wrapper, ops.py, applies it) from the shapes:
//
//  * Route A, ordered split-K on CUDA cores, for M <= 64 (every decode step,
//    the LSTM's prompt chunks, its per-step training products and
//    matmul_dx at B 64), and at any M where the caller asks for the plain
//    version's order (the fused BPTT's batched recompute of zs and its
//    dXs, at M = S x B; a block then adds its tile's chunks in order
//    itself instead of writing partials). Bound on this card by the bytes
//    of the codes (K x N, 1 byte each; at M = 64 the f32 operations come
//    close). The codes stream as 16-byte loads, neighbouring threads on
//    neighbouring addresses in both layouts, are decoded through a
//    256-entry f32 table in shared memory into a bank-conflict-free tile,
//    and the grid is split over K so that some 264 blocks keep enough
//    bytes in flight.
//    Each chunk sums in k order with fmaf and the chunks are added in
//    order, which the plain version repeats: bit for bit on the serving
//    path, where every product is exact.
//  * Route B, bf16 tensor cores (mma.sync m16n8k16, f32 accumulation), for
//    M > 64 (the zoo's and the dense model's prefills). Bound by
//    operations: the decoded weight without its bias, LUT[c & 31] *
//    2^(c >> 5), lies in +-[0.25, 576] or is 0 and is exact in bf16, and x
//    is split once, by a pre-pass, into up to three bf16 pieces whose
//    products with it are exact, so the card's 16-bit rate applies to FP8
//    activations (1 piece), FP16 ones (2) and f32 (3: a piece that is zero
//    in a block's tile is neither loaded nor multiplied). Pieces and codes
//    stream by cp.async three stages deep; the epilogue scales by 2^bias.
//    Tensor cores sum in their own order, so this route is held within the
//    precise bound, not bit for bit.
//
// `transposed` selects the code layout: codes[K, N] (gate weights) or
// codes[N, K] (the tied logits head and matmul_dx read it in place).
//
// Plain C interface; the wrapper is src/repro_torch/kernels/floatsd_matmul/ops.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../routed_gemm.cuh"

namespace {

using namespace routed_gemm;

// The 31 FloatSD8 mantissa values, ascending; entry 31 repeats entry 30
// (decode clips index 31 to 30).
__constant__ float kMantissa[32] = {
    -4.5f, -4.25f, -4.0f, -3.75f, -3.5f, -2.5f, -2.25f, -2.0f, -1.75f, -1.5f,
    -1.25f, -1.0f, -0.75f, -0.5f, -0.25f, 0.0f, 0.25f, 0.5f, 0.75f, 1.0f,
    1.25f, 1.5f, 1.75f, 2.0f, 2.25f, 2.5f, 3.5f, 3.75f, 4.0f, 4.25f,
    4.5f, 4.5f};

constexpr uint8_t kZeroCode = 15;  // mantissa 0.0: decodes to +0 at any exponent

// The FloatSD8 weight as the routes' Loader: one code byte per weight,
// 16 codes per load (along n in codes[K, N], along k in codes[N, K]).
template <bool kTransposed>
struct Fsd8 {
  static constexpr bool kNMajor = kTransposed;
  const uint8_t* __restrict__ codes;
  int N, K;
  bool vec;                // rows of a multiple of 16 bytes from a 16-byte aligned base
  const float* tab_a;      // shared: every code's value (route A)
  const uint16_t* tab_b;   // shared: every code's value without the bias, bf16 bits (route B)
  float scale;             // 2^bias (route B)

  // 16 codes from (k, n) on: along n, or along k when transposed; the zero
  // code outside [.., kend) x [.., N)
  __device__ __forceinline__ uint4 load16(int k, int kend, int n) const {
    const size_t at = kTransposed ? (size_t)n * K + k : (size_t)k * N + n;
    const bool full = kTransposed ? (n < N && k + 16 <= kend) : (k < kend && n + 16 <= N);
    if (vec && full && (at & 15) == 0) return __ldg(reinterpret_cast<const uint4*>(codes + at));
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * q + b;
        const bool ok = kTransposed ? (n < N && k + i < kend) : (k < kend && n + i < N);
        v[q] |= uint32_t(ok ? codes[at + i] : kZeroCode) << (8 * b);
      }
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
  }

  __device__ __forceinline__ static int byte(const uint4& v, int i) {
    const uint32_t w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
    return (w >> (8 * (i & 3))) & 0xFF;
  }

  // route A: [kABK][kABN] codes, 512 loads of 16; thread t takes t and t + 256
  struct RegsA {
    uint4 v[2];
  };
  __device__ __forceinline__ static void place_a(int i, int& k, int& n) {
    k = kTransposed ? (i & 3) * 16 : i >> 3;   // [N, K]: 4 threads a row of 64 k
    n = kTransposed ? i >> 2 : (i & 7) * 16;   // [K, N]: 8 threads a row of 128 n
  }
  __device__ __forceinline__ RegsA load_a(int t, int k0, int kend, int n0) const {
    RegsA r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int k, n;
      place_a(t + j * kThreads, k, n);
      r.v[j] = load16(k0 + k, kend, n0 + n);
    }
    return r;
  }
  __device__ __forceinline__ void store_a(const RegsA& r, float* ws, int t) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int k, n;
      place_a(t + j * kThreads, k, n);
      if (kTransposed) {
#pragma unroll
        for (int i = 0; i < 16; ++i) ws[a_slot(k + i, n)] = tab_a[byte(r.v[j], i)];
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float4*>(ws + a_slot(k, n + 4 * q)) =
              make_float4(tab_a[byte(r.v[j], 4 * q)], tab_a[byte(r.v[j], 4 * q + 1)],
                          tab_a[byte(r.v[j], 4 * q + 2)], tab_a[byte(r.v[j], 4 * q + 3)]);
      }
    }
  }

  // route B: [kBBK][kBBN] codes, 512 runs of 16 placed as route A's
  // (kBBK == kABK); thread t takes runs t and t + 256, at raw + 16 * run
  static_assert(kBBK == kABK && kBBN == kABN, "route B places its runs as route A");
  __device__ __forceinline__ bool in_b(int k, int kend, int n, int i) const {  // code i of the run
    return kTransposed ? (n < N && k + i < kend) : (k < kend && n + i < N);
  }
  // the zero code wherever a run leaves the matrix, so the decode needs no
  // bounds: with 16-byte rows a run is all inside or all outside
  __device__ __forceinline__ void issue_b(int t, int k0, int kend, int n0, uint8_t* raw) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = t + j * kThreads;
      int k, n;
      place_a(r, k, n);
      k += k0, n += n0;
      uint4* dst = reinterpret_cast<uint4*>(raw + 16 * r);
      if (!vec) {  // rows not 16-byte aligned: byte loads
        *dst = load16(k, kend, n);
      } else if (in_b(k, kend, n, 0) && in_b(k, kend, n, 15)) {
        cp_async16(dst, codes + (kTransposed ? (size_t)n * K + k : (size_t)k * N + n), true);
      } else {
        constexpr uint32_t z = 0x01010101u * kZeroCode;
        *dst = make_uint4(z, z, z, z);
      }
    }
  }
  __device__ __forceinline__ void decode_b(const uint8_t* raw, uint16_t* ws, int t) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = t + j * kThreads;
      int k, n;
      place_a(r, k, n);
      const uint4 v = *reinterpret_cast<const uint4*>(raw + 16 * r);
      uint32_t h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = tab_b[byte(v, 2 * i)] | (uint32_t(tab_b[byte(v, 2 * i + 1)]) << 16);
      uint4* dst = reinterpret_cast<uint4*>(ws + b_slot<kNMajor>(k, n));  // 16 consecutive k or n
      dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
      dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
  }
};

template <bool kT>
__device__ __forceinline__ Fsd8<kT> fsd8(const uint8_t* codes, int N, int K, const float* tab_a,
                                          const uint16_t* tab_b, float scale) {
  const int row = kT ? K : N;
  const bool vec = row % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  return Fsd8<kT>{codes, N, K, vec, tab_a, tab_b, scale};
}

template <bool kT, int MT>
__global__ void __launch_bounds__(kThreads)
floatsd_matmul_ordered_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes, int bias,
                              float* __restrict__ out, int M, int N, int K, int splits, int chunk) {
  __shared__ float tab[256];  // value of every code byte
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  tab[t] = kMantissa[t & 31] * pow2i((t >> 5) + bias);
  ordered_tile<MT>(x, fsd8<kT>(codes, N, K, tab, nullptr, 1.f), out, M, N, K, splits, chunk,
                   reinterpret_cast<float*>(smem));
}

template <bool kT>
__global__ void __launch_bounds__(kThreads, 1)
floatsd_matmul_mma_kernel(const uint16_t* __restrict__ pieces, const int* __restrict__ flags,
                          const uint8_t* __restrict__ codes, int bias, float* __restrict__ out, int M, int N,
                          int K, int Kp, int chunk) {
  __shared__ uint16_t tab[256];  // bf16 bits of every code byte's value without the bias
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  tab[t] = static_cast<uint16_t>(__float_as_uint(kMantissa[t & 31] * pow2i(t >> 5)) >> 16);
  mma_tile(pieces, flags, fsd8<kT>(codes, N, K, nullptr, tab, pow2i(bias)), out, M, N, K, Kp, chunk,
           reinterpret_cast<uint16_t*>(smem));
}

template <bool kT>
cudaError_t launch_route(const float* x, const uint8_t* codes, int bias, float* out, uint16_t* pieces, int* flags,
                         int M, int N, int K, int route, int splits, int chunk, int blocks_z, cudaStream_t s) {
  if (route == 0) {
    return with_row_tile(M, [&](auto mt) {
      constexpr int MT = decltype(mt)::value;
      const size_t smem = a_smem<MT>();
      if (cudaError_t e = allow_smem<floatsd_matmul_ordered_kernel<kT, MT>>(smem)) return e;
      // `blocks_z`: splits (a block a chunk, into partials) or 1 (a block adds its chunks itself)
      const dim3 grid((N + kABN - 1) / kABN, (M + MT - 1) / MT, blocks_z);
      floatsd_matmul_ordered_kernel<kT, MT><<<grid, kThreads, smem, s>>>(x, codes, bias, out, M, N, K, splits,
                                                                          chunk);
      return cudaGetLastError();
    });
  }
  const int kp = (K + 7) & ~7, mblocks = (M + kBBM - 1) / kBBM;
  if (K > 0) {
    split_pieces<<<dim3((K + kBBK - 1) / kBBK, mblocks), kThreads, 0, s>>>(x, pieces, flags, M, K, kp);
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  if (cudaError_t e = allow_smem<floatsd_matmul_mma_kernel<kT>>(kBSmem)) return e;
  const dim3 grid((N + kBBN - 1) / kBBN, mblocks, splits);
  floatsd_matmul_mma_kernel<kT><<<grid, kThreads, kBSmem, s>>>(pieces, flags, codes, bias, out, M, N, K, kp, chunk);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] f32, codes [K, N] (transposed == 0) or [N, K] (transposed != 0)
// u8, bias already clamped to [-126, 120], y [M, N] f32; all contiguous.
// route 0 (ordered split-K) or 1 (tensor cores); K is cut into `splits`
// chunks of `chunk` consecutive k. With splits > 1 and `part` [splits, M, N]
// f32 given, a block sums each chunk into it and a second kernel adds them
// in order into y; with `part` null (route 0 only), a block sums all the
// chunks of its tile and adds them in the same order itself. Route 1 also
// takes the scratch of its pre-pass: `pieces` [3, M, K rounded up to 8]
// bf16 and `flags` [ceil(M / 128), ceil(K / 64)] int32; its chunk, when
// K is split, is a multiple of 64.
// Launches on `stream`; returns the launches' cudaError_t as an int.
extern "C" int floatsd_matmul_launch(const float* x, const uint8_t* codes, int bias, float* y, float* part,
                                     uint16_t* pieces, int* flags, int M, int N, int K, int transposed, int route,
                                     int splits, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route != 0 && ((K > 0 && (pieces == nullptr || flags == nullptr)) ||
                     (splits > 1 && (part == nullptr || chunk % kBBK))))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool partials = splits > 1 && part != nullptr;
  float* out = partials ? part : y;
  const int blocks_z = partials ? splits : 1;
  const cudaError_t e =
      transposed ? launch_route<true>(x, codes, bias, out, pieces, flags, M, N, K, route, splits, chunk, blocks_z, s)
                 : launch_route<false>(x, codes, bias, out, pieces, flags, M, N, K, route, splits, chunk, blocks_z, s);
  if (e != cudaSuccess || !partials) return static_cast<int>(e);
  return static_cast<int>(launch_add_partials(part, y, (size_t)M * N, splits, s));
}
