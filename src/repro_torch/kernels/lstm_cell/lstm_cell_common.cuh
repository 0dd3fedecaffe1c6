// Device functions shared by the LSTM cell's forward (lstm_cell.cu) and
// backward (lstm_cell_bwd.cu) kernels and by qsigmoid.cu, so that the
// backward recomputes the forward's gate values and cell state exactly, bit
// for bit:
//   * sigma(-|z|) is torch's own CUDA formula 1 / (1 + expf(|z|)) with an
//     IEEE divide; its LUT index is the count of the 42 midpoints it
//     exceeds, read in O(1) from a bucket table (below), then z > 0 mirrors
//     to 1 - q;
//   * e5m2 rounding is the hardware's round-to-nearest-even with
//     saturation (the cell only converts values in [-1, 1]);
//   * fp16 storage rounds with __float2half_rn.
// Every source that includes this is built with --fmad=false.
//
// The O(1) index. Every midpoint is a float with at most 5 mantissa bits
// and an exponent in [-10, -2], so each one is the lower edge of a bucket
// of the float line cut by exponent and top 5 mantissa bits: 9 x 32 = 288
// buckets, bucket b starting at the float whose bits are (b + kSigBase) <<
// kSigShift. For s > 0 the count of midpoints below s equals the count at
// or below the float just under s (bits(s) - 1), and that is the count at
// or below its bucket's lower edge, a function of the bucket alone.
// kSigBucket holds, for every bucket, the LUT value at that count (built
// at compile time from kSigMid and kSigGrid); a block stages it in shared
// memory, and sig_lut() reads it after one integer
// subtract, shift, subtract and min (the 42-compare count it replaces was
// about 85 dependent instructions). s <= 2^-10 (subnormal s included)
// wraps below bucket 0, s = 0 (bits - 1 is all ones) and NaN land above
// bucket 287, and all of them clamp to the last entry, the LUT's 0; s = 0.5
// falls in bucket 287, whose count is 42. kSigMid and kSigGrid define the
// LUT; tests/test_torch_qsig_index.py reads them and the bucket constants
// from this file, builds the table as make_sig_buckets() does, and proves
// the index equals the 42-midpoint count on every f32 in (0, 0.5].

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

// Midpoints between consecutive entries of the non-positive-branch sigmoid
// LUT (FloatSD8 at bias -7, values in [0, 0.5]); host constants from which
// kSigBucket is built.
constexpr float kSigMid[42] = {
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
constexpr float kSigGrid[43] = {
    0.0f, 0.001953125f, 0.00390625f, 0.005859375f, 0.0078125f, 0.009765625f,
    0.01171875f, 0.013671875f, 0.015625f, 0.017578125f, 0.01953125f, 0.0234375f,
    0.02734375f, 0.029296875f, 0.03125f, 0.033203125f, 0.03515625f, 0.0390625f,
    0.046875f, 0.0546875f, 0.05859375f, 0.0625f, 0.06640625f, 0.0703125f,
    0.078125f, 0.09375f, 0.109375f, 0.1171875f, 0.125f, 0.1328125f,
    0.140625f, 0.15625f, 0.1875f, 0.21875f, 0.234375f, 0.25f,
    0.265625f, 0.28125f, 0.3125f, 0.375f, 0.4375f, 0.46875f, 0.5f};

// The bucket table: bits >> kSigShift keeps sign, exponent and the top 5
// mantissa bits; kSigBase is that key of 2^-10 (biased exponent 117).
constexpr unsigned kSigShift = 18;
constexpr unsigned kSigBase = 117u << 5;
constexpr unsigned kSigBuckets = 288;
constexpr int kSigTable = kSigBuckets + 1;  // + the clamp entry, 0

// For every bucket, kSigGrid at the count of kSigMid at or below its lower
// edge; the last entry is the clamp's 0. Bucket b's lower edge is the float
// with unbiased exponent (kSigBase >> 5) - 127 + b / 32 and top mantissa
// bits b % 32, that is 2^(b / 32 - 10) (1 + (b % 32) / 32), exact in float.
// Built at compile time; read once a block, coalesced, into shared memory
// (stage_sig_table).
struct SigBucketTable {
  float v[kSigTable];
};
constexpr SigBucketTable make_sig_buckets() {
  SigBucketTable t{};
  for (unsigned b = 0; b < kSigBuckets; ++b) {
    float edge = 1.0f + static_cast<float>(b % 32) / 32.0f;
    for (int e = static_cast<int>(kSigBase >> 5) - 127 + static_cast<int>(b / 32); e < 0; ++e) edge *= 0.5f;
    int count = 0;
    for (int k = 0; k < 42; ++k) count += kSigMid[k] <= edge;
    t.v[b] = kSigGrid[count];
  }
  t.v[kSigBuckets] = 0.0f;
  return t;
}
__device__ const SigBucketTable kSigBucket = make_sig_buckets();

// Copies kSigBucket into table[0 .. kSigTable) in shared memory, a block
// of kBlock threads striding over it. The stride is a compile-time constant,
// so every load is issued before the first store and the copy costs one
// load's latency, not one a stride. The caller synchronises the block before
// the first sig_lut().
template <int kBlock>
__device__ __forceinline__ void stage_sig_table(float* table) {
  constexpr int kPer = (kSigTable + kBlock - 1) / kBlock;
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b = threadIdx.x + k * kBlock;
    if (b < kSigTable) v[k] = kSigBucket.v[b];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b = threadIdx.x + k * kBlock;
    if (b < kSigTable) table[b] = v[k];
  }
}

// Q(s) for s = sigma(-|z|) in [0, 0.5] or NaN: the LUT value whose index
// is the count of midpoints below s.
__device__ __forceinline__ float sig_lut(float s, const float* table) {
  const unsigned b = ((__float_as_uint(s) - 1u) >> kSigShift) - kSigBase;
  return table[min(b, kSigBuckets)];
}

__device__ __forceinline__ float e5m2(float v) {
  const __nv_fp8_storage_t q = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E5M2);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, __NV_E5M2)));
}

__device__ __forceinline__ float sigmoid(float z) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
}

// two-region FloatSD8 sigmoid; `table` is stage_sig_table's, in shared memory
__device__ __forceinline__ float qsigmoid(float z, const float* table) {
  const float q = sig_lut(sigmoid(-fabsf(z)), table);
  return z > 0.f ? __fsub_rn(1.0f, q) : q;
}

// A quantized gate and its smooth sigma(z), the straight-through factor. For
// z <= 0, sigma(z) is sigma(-|z|) itself, bit for bit (the same expf
// argument), so only z > 0 forms a second expf.
struct GatePair {
  float q, s;
};
__device__ __forceinline__ GatePair qsigmoid_pair(float z, const float* table) {
  const float s_neg = sigmoid(-fabsf(z));
  const float q = sig_lut(s_neg, table);
  if (z > 0.f) return {__fsub_rn(1.0f, q), sigmoid(z)};
  return {q, s_neg};
}

struct Gates {
  float i, f, g, o;
};

// The forward's gate values (quantized: the two-region sigmoid and
// e5m2(tanh); else the smooth ones); `table` is stage_sig_table's.
__device__ __forceinline__ Gates gates(float zi, float zf, float zg, float zo, int quantized,
                                       const float* table) {
  if (quantized) {
    return {qsigmoid(zi, table), qsigmoid(zf, table), e5m2(tanhf(zg)), qsigmoid(zo, table)};
  }
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
