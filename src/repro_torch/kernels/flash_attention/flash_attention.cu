// Flash-attention forward for Hopper (sm_90a): causal or full, with an
// optional sliding window, GQA read in place, online softmax.
//
//     o_i = sum_j softmax_j(q_i . k_j * D^-1/2 | mask) v_j,
//     mask: j <= i (causal), i - j < window (sliding window)
//
// over contiguous positions from 0 (query i is position i, key j is
// position j).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:27
// (flash_fwd_kernel, launched by flash_attention_pallas at :97), whose grid
// (batch * head, q tile, KV tile) keeps the running max m, sum l and
// numerator acc of a q tile in VMEM across its sequential KV axis. Hopper's
// blocks run in no order, so the KV axis is a loop inside the block: one
// block owns 64 query rows of one (batch, query head) and walks the KV
// tiles of 64 keys in order; m and l live in registers (each row's 16
// threads hold copies), acc in registers. A tile's q (scaled), k, v (rounded
// to bf16) and p (rounded to bf16) are staged in shared memory (115,456 B,
// dynamic). Each of the 256 threads computes a 4 x 4 block of the score
// tile (4 rows, keys strided by 16), reduces each row's max and sum across
// its 16 lanes with shuffles, and then a 4 x 8 block of the output (4 rows,
// head columns strided by 16).
//
// Numerics, as the TPU kernel: scores are f32 fmaf sums of (q * scale) and
// k; masked scores are -1e30 (not -inf: a row whose first tiles are wholly
// masked adds exp(0) = 1 terms that the first valid tile's alpha =
// exp(-1e30 - m) = 0 wipes out); p and v are rounded to bf16 (round to
// nearest even) before their product, which is exact in f32, summed in
// f32; the output is acc / max(l, 1e-30). Keys past the end of the
// sequence are not keys: their scores are -inf, so they add nothing (the
// tile always holds a real key, so m is finite). expf, no fast math. Tiles
// wholly outside every row's causal band and window are skipped, which
// gives the same result, except in a block that holds a row with no
// admitted key at all (only when Sq > Skv under a window): there every
// tile runs, so that row averages every v as the reference does.
//
// Layout and GQA: q [B, Sq, H, D], k, v [B, Skv, Kh, D], each read in place
// through its batch, position and head strides (the last axis contiguous);
// query head h reads KV head h / (H / Kh), so K and V are never expanded.
// o is contiguous [B, Sq, H, D], in q's type. f32 or bf16 in and out; D <=
// 128; every tile is bounds-checked (any Sq, Skv and D).
//
// Bound: at the dense model's prefill (B 2, S 1024, 32 heads over 8, D 120,
// causal) the 16.1 GFLOP of f32 products over the FP32 peak (0.24 ms) far
// exceed the bytes (78.6 MB, 0.023 ms): the kernel is bound by its FMAs,
// which this design issues from shared memory at one load per two FMAs.
// Tensor-core tiles (wgmma) are later work.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/flash_attention/ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kDMax = 128;        // largest head size
constexpr int kQS = kDMax + 1;    // row strides: odd, so a column read is conflict-free
constexpr int kKS = kDMax + 1;
constexpr int kVS = kDMax;
constexpr int kPS = kBK + 1;
constexpr int kThreads = 256;     // 16 row groups x 16 lanes
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemBytes = sizeof(float) * (kBQ * kQS + kBK * kKS + kBK * kVS + kBQ * kPS);

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// reduce over the 16 lanes of a row group (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float group_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Sq, int Skv, int H, int G, int D, long long q_sb,
                 long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
                 long long window) {
  extern __shared__ float smem[];
  float* sq = smem;              // [kBQ][kQS] q * scale
  float* sk = sq + kBQ * kQS;    // [kBK][kKS] k
  float* sv = sk + kBK * kKS;    // [kBK][kVS] bf16(v)
  float* sp = sv + kBK * kVS;    // [kBQ][kPS] bf16(p)

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // the longest rows start first
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const bool has_window = window > 0;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sq[r * kQS + d] = (q0 + r < Sq) ? load(qb + (q0 + r) * q_ss + d) * scale : 0.f;
  }

  // the keys any row of the block admits, unless a row admits none
  int k_begin = 0, k_end = Skv;
  if (!(has_window && q_last >= Skv - 1 + window)) {
    if (causal) k_end = min(Skv, q_last + 1);
    if (has_window && q0 - window + 1 > 0) k_begin = (int)((q0 - window + 1) / kBK * kBK);
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Skv;
      sk[r * kKS + d] = in ? load(kb + (k0 + r) * k_ss + d) : 0.f;
      sv[r * kVS + d] = in ? bf16_round(load(vb + (k0 + r) * v_ss + d)) : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4 + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty * 4 + i) * kQS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sk[(tx + 16 * j) * kKS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // mask, then the online softmax step of each row
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kj = k0 + tx + 16 * j;
        if (kj >= Skv)
          s[i][j] = -INFINITY;
        else if ((causal && kj > qi) || (has_window && qi - kj >= window))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rowsum += p;
        sp[(ty * 4 + i) * kPS + tx + 16 * j] = bf16_round(p);
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + group_sum(rowsum);
      m[i] = m_new;
    }
    __syncthreads();

    // acc <- acc * alpha + p v over the tile (keys past Skv have p = v = 0)
    float pv[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) pv[i][c] = 0.f;
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty * 4 + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float vv = sv[kk * kVS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i][c] = fmaf(p[i], vv, pv[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = acc[i][c] * alpha[i] + pv[i][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* ob = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(ob + d, acc[i][c] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
           int Kh, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           float scale, int causal, long long window, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, H / Kh, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, H, D], k, v [B, Skv, Kh, D] with the given batch, position and
// head strides (elements; the last axis contiguous), o contiguous [B, Sq, H,
// D]; dtype 0: all f32, 1: all bf16. 1 <= D <= 128, Kh divides H, B * H <=
// 65535, Skv >= 1; window <= 0: none. Launches on `stream`; returns the
// launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                                      int Sq, int Skv, int H, int Kh, int D, long long q_sb,
                                      long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                                      long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                      float scale, int causal, long long window, int dtype,
                                      void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Kh, D, q_sb, q_ss, q_sh, k_sb, k_ss,
                                 k_sh, v_sb, v_ss, v_sh, scale, causal, window, st);
  return launch<float>(q, k, v, o, B, Sq, Skv, H, Kh, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                       v_ss, v_sh, scale, causal, window, st);
}
