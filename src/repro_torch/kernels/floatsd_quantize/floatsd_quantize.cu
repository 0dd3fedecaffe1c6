// FloatSD8 quantization for Hopper (sm_90a): f32 or fp16 values -> uint8 codes
//     n     = min(|x| * 2^-bias, 576)          (576 = 4.5 * 2^7, the grid's top)
//     g     = #(grid midpoints < n)            (64 midpoints of the 65 grid values >= 0)
//     code  = (e[g] << 5) | midx[g]            for x >= 0 (+0 and -0 alike)
//           = (e[g] << 5) | (30 - midx[g])     for x < 0  (the mantissa set is symmetric)
//
// Replaces the TPU kernel src/repro/kernels/floatsd_quantize/kernel.py:32
// (quantize_kernel). Its plain version is core.floatsd.encode of the port
// (src/repro_torch/kernels/floatsd_quantize/ref.py), which it matches byte
// for byte on finite inputs: 2^-bias is built from exponent bits (the
// Pallas kernel's exp2 is not), and |x| * 2^-bias rounds exactly as the
// plain version's |x| / 2^bias (both are the one correctly rounded value
// of the same real number). A value exactly on a midpoint is not counted
// (ties go to the lower grid value), as in the plain version. NaN and inf
// have no code (the precondition of encode).
//
// The bias is read from a device int32 (fit_bias's output), so the caller
// never synchronises the host, and clamped to [-126, 120] as encode clamps
// it: every exponent e + bias, e in [0, 7], stays normal.
//
// The O(1) index. Every midpoint is a float with at most 5 mantissa bits
// and an exponent in [-3, 9], so each one is the lower edge of a bucket of
// the float line cut by exponent and top 5 mantissa bits: 13 x 32 = 416
// buckets, bucket k starting at the float whose bits are (k + kQuantBase)
// << kQuantShift, and no two midpoints share a bucket. For n > 0 the count
// of midpoints below n equals the count at or below the float just under n
// (bits(n) - 1), and that is the count at or below its bucket's lower edge,
// a function of the bucket alone. kQuantBucket holds, for every bucket, the
// code at that count, and in its second half the same codes with the sign
// folded in; the sign bit of x picks the half (-0 folds to the same code
// as +0, grid value 0's mantissa index being the middle one, 15). n <=
// 2^-3 (subnormal n included) wraps below bucket 0 and n = 0 (bits - 1 is
// all ones) lands above bucket 415; both clamp to the last entry, grid
// value 0's code. n = 576 falls in bucket 387, whose count is 64. The
// table is built at compile time from kMid and kCode (make_quant_buckets);
// tests/test_torch_quant_index.py reads them and the bucket constants from
// this file, builds the table as make_quant_buckets() does, and proves the
// index equals the 64-midpoint count on every f32 in [0, 576]. With the
// 64-compare count the kernel was issue-bound (187-190 SASS instructions an
// element); with the bucket index it takes 11-12 and runs within 5% of a
// copy of its bytes (PERF.md).
//
// Bound: bytes, 5 (f32) or 3 (fp16) an element. Each thread converts groups
// of 16 elements: 4 (f32) or 2 (fp16) 16-byte loads and one 16-byte store
// of codes, over a grid of 132 SMs x 8 blocks of 256 threads that strides
// through the tensor, software-pipelined: the next group is loaded before
// this one is converted, and the first group and the bias are in flight
// while the table is staged in shared memory, once a block. A start that is
// not on a 16-element boundary of the codes and a ragged end are handled
// element by element (the head and the tail); the wrapper places the codes
// so that x and codes agree in their element index modulo 16, and x + head
// is then 16-byte aligned too.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/floatsd_quantize/ops.py.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstring>

namespace {

// Midpoints between consecutive non-negative FloatSD8 grid values at bias
// 0; host constants from which kQuantBucket is built.
constexpr float kMid[64] = {
    0.125f, 0.375f, 0.625f, 0.875f, 1.125f, 1.375f, 1.625f, 1.875f,
    2.125f, 2.375f, 2.75f, 3.25f, 3.625f, 3.875f, 4.125f, 4.375f,
    4.75f, 5.5f, 6.5f, 7.25f, 7.75f, 8.25f, 8.75f, 9.5f,
    11.0f, 13.0f, 14.5f, 15.5f, 16.5f, 17.5f, 19.0f, 22.0f,
    26.0f, 29.0f, 31.0f, 33.0f, 35.0f, 38.0f, 44.0f, 52.0f,
    58.0f, 62.0f, 66.0f, 70.0f, 76.0f, 88.0f, 104.0f, 116.0f,
    124.0f, 132.0f, 140.0f, 152.0f, 176.0f, 208.0f, 232.0f, 248.0f,
    264.0f, 280.0f, 304.0f, 384.0f, 464.0f, 496.0f, 528.0f, 560.0f};

// Code of each non-negative grid value: its smallest exponent e and the
// index of its mantissa, (e << 5) | midx.
constexpr uint8_t kCode[65] = {
    15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 53, 26, 27, 28, 29,
    30, 57, 85, 58, 59, 60, 61, 62, 89, 117, 90, 91, 92, 93, 94, 121,
    149, 122, 123, 124, 125, 126, 153, 181, 154, 155, 156, 157, 158, 185, 213, 186,
    187, 188, 189, 190, 217, 245, 218, 219, 220, 221, 222, 249, 250, 251, 252, 253,
    254};

constexpr float kTop = 576.0f;

// The bucket table: bits >> kQuantShift keeps sign, exponent and the top 5
// mantissa bits; kQuantBase is that key of 2^-3 (biased exponent 124).
constexpr unsigned kQuantShift = 18;
constexpr unsigned kQuantBase = 124u << 5;
constexpr unsigned kQuantBuckets = 416;
constexpr unsigned kQuantTable = kQuantBuckets + 1;  // + the clamp entry, grid value 0's code
constexpr unsigned kQuantWords = (2 * kQuantTable + 3) / 4;  // both halves, in 32-bit words

// A code with the sign folded into its mantissa index.
constexpr uint8_t negated(uint8_t c) { return static_cast<uint8_t>((c & 0xE0) | (30 - (c & 31))); }

// For every bucket, kCode at the count of kMid at or below its lower edge,
// then the clamp entry; the second half the same codes negated. Bucket k's
// lower edge is the float with unbiased exponent (kQuantBase >> 5) - 127 +
// k / 32 and top mantissa bits k % 32, that is 2^(k / 32 - 3) (1 + (k % 32)
// / 32), exact in float. Built at compile time; read once a block,
// coalesced, into shared memory.
struct QuantBucketTable {
  alignas(16) uint8_t v[4 * kQuantWords];
};
constexpr QuantBucketTable make_quant_buckets() {
  QuantBucketTable t{};
  for (unsigned k = 0; k < kQuantTable; ++k) {
    int count = 0;
    if (k < kQuantBuckets) {
      float edge = 1.0f + static_cast<float>(k % 32) / 32.0f;
      int e = static_cast<int>(kQuantBase >> 5) - 127 + static_cast<int>(k / 32);
      for (; e < 0; ++e) edge *= 0.5f;
      for (; e > 0; --e) edge *= 2.0f;
      for (int m = 0; m < 64; ++m) count += kMid[m] <= edge;
    }
    t.v[k] = kCode[count];
    t.v[kQuantTable + k] = negated(kCode[count]);
  }
  return t;
}
__device__ const QuantBucketTable kQuantBucket = make_quant_buckets();

constexpr int kThreads = 256;
constexpr int kGroup = 16;            // elements a thread converts at once: one 16-byte store of codes
constexpr int kGridBlocks = 132 * 8;  // 8 blocks of 256 threads for each of 132 SMs

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// The code of v at 2^-bias = inv_scale: its bucket's entry, in the half of
// the staged table that v's sign bit picks.
__device__ __forceinline__ unsigned code_of(float v, float inv_scale, const uint8_t* table) {
  const float a = fminf(__fmul_rn(fabsf(v), inv_scale), kTop);
  const unsigned key = min(((__float_as_uint(a) - 1u) >> kQuantShift) - kQuantBase, kQuantBuckets);
  return table[key + (__float_as_uint(v) >> 31) * kQuantTable];
}

// The 16 codes of one group, its 16 elements held as kGroup * sizeof(T) / 16
// vectors of 16 bytes.
template <typename T>
__device__ __forceinline__ uint4 group_codes(const uint4* v, float inv_scale, const uint8_t* table) {
  T e[kGroup];
  memcpy(e, v, sizeof(e));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kGroup; ++k) w[k / 4] |= code_of(widen(e[k]), inv_scale, table) << (8 * (k % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// codes + head and x + head are 16-byte aligned (x and codes agree in their
// element index modulo 16).
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const int* __restrict__ bias, uint8_t* __restrict__ codes,
                long long n, int head) {
  constexpr int kVecs = kGroup * sizeof(T) / 16;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long groups = (n - head) / kGroup;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
  uint4* __restrict__ cv = reinterpret_cast<uint4*>(codes + head);

  // the bias and the first group's loads are in flight while the table is staged
  const int b = *bias;
  uint4 v[kVecs];
  if (tid < groups) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) v[k] = xv[tid * kVecs + k];
  }
  __shared__ unsigned words[kQuantWords];
  for (int i = threadIdx.x; i < (int)kQuantWords; i += kThreads) {
    words[i] = reinterpret_cast<const unsigned*>(kQuantBucket.v)[i];
  }
  __syncthreads();
  const uint8_t* table = reinterpret_cast<const uint8_t*>(words);
  const float inv_scale = __int_as_float((127 - min(max(b, -126), 120)) << 23);  // 2^-bias, exact

  // the head before the first aligned group and the tail after the last
  if (tid < head) codes[tid] = (uint8_t)code_of(widen(x[tid]), inv_scale, table);
  const long long tail = head + groups * kGroup + tid;
  if (tid < kGroup && tail < n) codes[tail] = (uint8_t)code_of(widen(x[tail]), inv_scale, table);

  // software-pipelined: the next group is loaded before this one is converted
  for (long long i = tid; i < groups; i += stride) {
    const long long next = i + stride;
    uint4 w[kVecs];
    if (next < groups) {
#pragma unroll
      for (int k = 0; k < kVecs; ++k) w[k] = xv[next * kVecs + k];
    }
    cv[i] = group_codes<T>(v, inv_scale, table);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) v[k] = w[k];
  }
}

template <typename T>
int launch(const void* x, const int* bias, uint8_t* codes, long long n, cudaStream_t s) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), ca = reinterpret_cast<uintptr_t>(codes);
  if (xa % sizeof(T) != 0 || (xa / sizeof(T) - ca) % kGroup != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long lead = (long long)((kGroup - ca % kGroup) % kGroup);
  const int head = (int)(lead < n ? lead : n);
  const long long groups = (n - head) / kGroup;
  const long long want = (groups + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 1 ? 1 : want < kGridBlocks ? want : kGridBlocks);
  quantize_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), bias, codes, n, head);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n] f32 (x_half == 0) or fp16 (x_half != 0), bias one device int32,
// codes [n] uint8; both contiguous, x and codes agreeing in their element
// index modulo 16 (x's address over its element size against codes'
// address; else cudaErrorInvalidValue, nothing launched). Launches on
// `stream`; returns the launch's cudaError_t as an int.
extern "C" int floatsd_quantize_launch(const void* x, int x_half, const int* bias, uint8_t* codes,
                                       long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_half) return launch<__half>(x, bias, codes, n, s);
  return launch<float>(x, bias, codes, n, s);
}
