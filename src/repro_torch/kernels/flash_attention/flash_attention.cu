// Flash-attention forward for Hopper (sm_90a): causal or full, with an
// optional sliding window, GQA read in place, online softmax, both products
// on the tensor cores by warpgroup matrix products (wgmma).
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
// blocks run in no order, so the KV axis is a loop inside the block.
//
// Two kernels a call. flash_split_kv, a pre-pass, writes K and V once into
// a bf16 scratch [B * Kh][P + 1][Skv8][DP] that the wrapper allocates: K as
// its P pieces (f32 inputs: P = 3, hi + mid + lo == k exactly, by the
// truncation split of warp_mma.cuh; bf16 inputs: P = 1, k itself), V
// rounded to bf16 (round to nearest even); D is padded with zeros to DP (64
// or 128, a multiple of the products' k16), Skv with zero rows to Skv8, a
// multiple of 8, and each [Skv8][DP] matrix is stored in 8 x 8 core
// matrices (8 rows of 16 bytes, 128 contiguous bytes), the layout the
// tensor cores read from shared memory, so a tile is one contiguous run.
// flash_fwd_kernel then gives one block 128 query rows of one (batch, query
// head): 2 warpgroups of 64 rows, each warp 16 of them. The block splits q
// * scale (f32) or takes q (bf16) into pieces once, into shared memory, and
// walks the KV tiles of 64 keys in order; the tiles stream from the scratch
// through a two-stage cp.async ring, so tile j + 1's load overlaps tile j's
// products. A warpgroup forms its [64 x 64] score tile with wgmma (q's and
// K's pieces read from shared memory by descriptor, f32 accumulators), each
// warp masks its 16 rows, takes its online softmax step (a row's max and
// sum across the 4 lanes that hold it), rounds p to bf16 and feeds the
// score accumulators straight back as the register A operand of the PV
// wgmma (V read from shared memory, transposed): p never goes through
// shared memory. m, l and the [16 x DP] numerator of each warp stay in
// registers. A warpgroup skips a tile its causal band and window admit no
// key of.
//
// Numerics, as the TPU kernel. Scores: on f32 inputs the six products of
// the pieces whose weight reaches 2^-16 (hi.hi, hi.mid, mid.hi, hi.lo,
// lo.hi, mid.mid; each product exact; every dropped product is below 2^-23
// of its term), summed in f32, the five smaller ones first, so the scores
// keep f32 accuracy up to sum order; on bf16 inputs one exact product, times the scale in f32. Masked
// scores are -1e30 (not -inf: a row whose first tiles are wholly masked
// adds exp(0) = 1 terms that the first valid tile's alpha = exp(-1e30 - m)
// = 0 wipes out); keys past the end of the sequence are not keys: their
// scores are -inf, so they add nothing (a tile always holds a real key, so
// m is finite). p and v are rounded to bf16 before their product, as the
// reference rounds them, so the tensor cores form the reference's products
// exactly and sum them in f32; l sums the unrounded p; the output is acc /
// max(l, 1e-30). expf, no fast math. Tiles wholly outside the block's causal
// band and window are skipped, which gives the same result, except in a
// block that holds a row with no admitted key at all (only when Sq > Skv
// under a window): there every tile runs, so that row averages every v as
// the reference does. Fixed order everywhere: two launches give the same
// bits.
//
// Layout and GQA: q [B, Sq, H, D], k, v [B, Skv, Kh, D], each read in place
// through its batch, position and head strides (the last axis contiguous);
// query head h reads KV head h / (H / Kh), so K and V are never expanded.
// o is contiguous [B, Sq, H, D], in q's type. f32 or bf16 in and out; D <=
// 128; every tile is bounds-checked (any Sq, Skv and D).
//
// Bound: at the dense model's prefill (B 2, S 1024, 32 heads over 8, D 120,
// causal, f32) the products are 8.06 GFLOP each for QK^T and PV; on the
// 16-bit tensor cores, at six pieces for QK^T, 7 x 8.06 GFLOP over 989
// TFLOP/s (0.057 ms) exceed the bytes (78.6 MB, 0.023 ms): the kernel is
// bound by its tensor-core products.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/flash_attention/ops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../warp_mma.cuh"

namespace {

using namespace warp_mma;

constexpr int kWarps = 8;          // 2 warpgroups
constexpr int kBM = 16 * kWarps;   // query rows a block
constexpr int kBN = 64;            // keys a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;         // the K/V ring
constexpr int kSplitThreads = 256;
constexpr float kNegInf = -1e30f;

// head size padded to the products' k16: 64 or 128
inline int padded_d(int D) { return D <= 64 ? 64 : 128; }

// pieces of q and K
template <typename T>
__host__ __device__ constexpr int pieces() { return sizeof(T) == 4 ? 3 : 1; }

// shared memory (bf16 values): q's P pieces [kBM][DP] and kStages tiles of
// K's P pieces and V [kBN][DP], each in core matrices
template <typename T, int DP>
constexpr size_t smem_bytes() { return sizeof(uint16_t) * (pieces<T>() * kBM + kStages * (pieces<T>() + 1) * kBN) * DP; }

// element (r, c) of a matrix of DP columns in 8 x 8 core matrices
template <int DP>
__device__ __forceinline__ int cm(int r, int c) { return ((r >> 3) * (DP / 8) + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// two floats rounded to bf16 (one instruction), lo in the low half (the
// lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// warpgroup matrix products (wgmma, sm_90a): a warpgroup of 4 warps, 64 rows
// ---------------------------------------------------------------------------

// The shared-memory matrix descriptor of a tile in the no-swizzle layout of
// 8 x 8 core matrices (each 8 rows of 16 bytes, 128 contiguous bytes):
// `lbo` bytes between core matrices along the product's k, `sbo` along m or n.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory"); }
// After a wait: the accumulators are read no earlier, and a register A
// operand is kept (not reused) until the products that read it are done.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]), "+r"(a[i][3]) :: "memory");
}
// shared-memory writes of this thread (st.shared, cp.async) made visible to
// the tensor cores' reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// d[64 x 64] (+)= a[64 x 16] @ b[16 x 64]: a and b in shared memory, both
// K-major; f32 accumulators, this thread's 32 in the m16n8 C layout of its
// warp's 16 rows, n8 block after n8 block; scale_d 0: d = a @ b.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x N] += a[64 x 16] @ b[16 x N], N = 64 or 128: a from registers (the
// m16n8k16 A fragment of each warp's 16 rows), b in shared memory MN-major
// (rows of k, each N contiguous values: the transposed read); accumulators
// as above.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, "
      "%68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// The pre-pass: K's P pieces and bf16 V into kv [B * Kh][P + 1][Skv8][DP]
// in core matrices, zero past D and past Skv. A thread writes one row (8
// columns, 16 bytes) of one core matrix of each.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
flash_split_kv(const T* __restrict__ k, const T* __restrict__ v, uint16_t* __restrict__ kv, int Skv, int Skv8, int Kh,
               int D, int DP, long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
               long long v_sh) {
  constexpr int P = pieces<T>();
  const int cpr = DP / 8;  // core matrices across a row
  const int i = blockIdx.x * kSplitThreads + threadIdx.x;
  const int rr = i & 7, c = (i >> 3) % cpr, r = (i / (8 * cpr)) * 8 + rr;  // the row within its core matrix fastest
  const int bk = blockIdx.y, b = bk / Kh, hk = bk % Kh;
  if (r >= Skv8) return;
  const T* kr = k + b * k_sb + r * k_ss + hk * k_sh;
  const T* vr = v + b * v_sb + r * v_ss + hk * v_sh;
  uint32_t pk[P][8], pv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int d = c * 8 + e;
    const bool in = r < Skv && d < D;
    if constexpr (P == 3) {
      split3(in ? kr[d] : 0.f, pk[0][e], pk[1][e], pk[2][e]);
    } else {
      pk[0][e] = in ? bf16_bits(kr[d]) : 0u;
    }
    pv[e] = in ? bf16_bits(vr[d]) : 0u;
  }
  uint16_t* out = kv + (size_t)bk * (P + 1) * Skv8 * DP + (size_t)(r >> 3) * 8 * DP + c * 64 + rr * 8;
#pragma unroll
  for (int p = 0; p < P; ++p)
    *reinterpret_cast<uint4*>(out + (size_t)p * Skv8 * DP) =
        make_uint4(pk[p][0] | (pk[p][1] << 16), pk[p][2] | (pk[p][3] << 16), pk[p][4] | (pk[p][5] << 16),
                   pk[p][6] | (pk[p][7] << 16));
  *reinterpret_cast<uint4*>(out + (size_t)P * Skv8 * DP) =
      make_uint4(pv[0] | (pv[1] << 16), pv[2] | (pv[3] << 16), pv[4] | (pv[5] << 16), pv[6] | (pv[7] << 16));
}

// KV tile k0 (K's P pieces, then V: P + 1 contiguous runs of the scratch,
// rows past Skv8 zero) into a ring stage
template <typename T, int DP>
__device__ __forceinline__ void issue_tile(uint16_t* dst, const uint16_t* kvb, int k0, int Skv8, int tid) {
  constexpr int kRuns = kBN * DP / 8;  // 16-byte runs of one matrix's tile
#pragma unroll
  for (int j = 0; j < (pieces<T>() + 1) * kRuns / kThreads; ++j) {
    const int i = tid + j * kThreads, mat = i / kRuns, run = i % kRuns;
    const bool ok = k0 + (run / DP) * 8 < Skv8;  // its core matrix's first row
    cp_async16(dst + mat * kBN * DP + run * 8, kvb + (size_t)mat * Skv8 * DP + (ok ? (size_t)k0 * DP + run * 8 : 0), ok);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const uint16_t* __restrict__ kv, T* __restrict__ o, int Sq, int Skv,
                 int Skv8, int H, int G, int Kh, int D, long long q_sb, long long q_ss, long long q_sh, float scale,
                 int causal, long long window) {
  constexpr int P = pieces<T>();
  constexpr int KS = DP / 16;   // k16 steps of QK^T
  constexpr int NS = kBN / 8;   // n8 blocks of a score tile
  constexpr int NT = DP / 8;    // n8 blocks of the output
  constexpr uint32_t kRowBlock = DP * 16;  // bytes between core matrices 8 rows apart
  extern __shared__ __align__(128) uint16_t smem[];
  uint16_t* sq = smem;                   // [P][kBM][DP]
  uint16_t* ring = smem + P * kBM * DP;  // [kStages][P + 1][kBN][DP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // the longest rows start first
  const int q_last = min(q0 + kBM, Sq) - 1;
  const bool has_window = window > 0;
  const int win = has_window ? (int)min(window, (long long)INT_MAX) : 0;  // no window reaches past 2^31 keys
  const uint16_t* kvb = kv + (size_t)(b * Kh + hk) * (P + 1) * Skv8 * DP;

  // the keys any row of the block admits, unless a row admits none
  int k_begin = 0, k_end = Skv;
  if (!(has_window && q_last >= Skv - 1 + window)) {
    if (causal) k_end = min(Skv, q_last + 1);
    if (has_window && q0 - window + 1 > 0) k_begin = (int)((q0 - window + 1) / kBN * kBN);
  }
  const int n_tiles = (k_end - k_begin + kBN - 1) / kBN;
  if (n_tiles > 0) issue_tile<T, DP>(ring, kvb, k_begin, Skv8, tid);
  cp_async_commit();

  // q's pieces, once per block, while the first tile is in flight: every
  // load of the thread issued before the first is used
  constexpr int QPT = kBM * DP / kThreads;
  const T* qb = q + b * q_sb + h * q_sh;
  T qv[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int i = tid + j * kThreads, r = i / DP, d = i % DP;
    qv[j] = q0 + r < Sq && d < D ? qb[(q0 + r) * q_ss + d] : T(0.f);
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int i = tid + j * kThreads, r = i / DP, d = i % DP;
    if constexpr (P == 3) {
      uint32_t hi, mid, lo;
      split3(qv[j] * scale, hi, mid, lo);
      sq[cm<DP>(r, d)] = hi;
      sq[kBM * DP + cm<DP>(r, d)] = mid;
      sq[2 * kBM * DP + cm<DP>(r, d)] = lo;
    } else {
      sq[cm<DP>(r, d)] = bf16_bits(qv[j]);
    }
  }
  fence_async_smem();

  // the warpgroup's rows; does one of them admit no key at all
  const int gr0 = q0 + 64 * wg, gr1 = min(gr0 + 63, Sq - 1);
  const bool has_rows = gr0 < Sq;
  const bool group_all = has_window && gr1 >= Skv - 1 + window;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;  // this thread's two rows

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's share
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  auto& acc_flat = reinterpret_cast<float(&)[DP / 2]>(acc);
  uint32_t pa[NS / 2][4];  // p, rounded to bf16: the A fragments of the PV product

  auto stage = [&](int it) { return ring + (it % kStages) * (P + 1) * kBN * DP; };
  // does the warpgroup skip the tile of keys k0..: its causal band and
  // window admit none of them (unless a row of it admits no key at all)
  auto skip = [&](int k0) {
    const int k_hi = min(k0 + kBN, Skv) - 1;  // the tile's last key
    return !has_rows || (!group_all && ((causal && k0 > gr1) || (has_window && (long long)gr0 - k_hi >= window)));
  };
  // the score tile [64 x 64] of the warpgroup from a stage, this thread's
  // part as NS n8 blocks (issued; committed, not waited for). f32: the five
  // smaller products over all of d first, then hi.hi, so that the tensor
  // cores' rounding of the running sum acts on the small terms at their own
  // scale
  auto qk = [&](float (&s)[NS][4], const uint16_t* sk) {
    auto& s_flat = reinterpret_cast<float(&)[NS * 4]>(s);
    // q's and K's pieces at k16 step ks: K-major, 2 core matrices (256 bytes) a step
    auto qd = [&](int p, int ks) { return smem_desc(sq + p * kBM * DP + 64 * wg * DP + ks * 128, 128, kRowBlock); };
    auto kd = [&](int p, int ks) { return smem_desc(sk + p * kBN * DP + ks * 128, 128, kRowBlock); };
    wgmma_fence();
    if constexpr (P == 3) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {  // lo.hi, hi.lo, mid.mid, mid.hi, hi.mid
        wgmma_ss(s_flat, qd(2, ks), kd(0, ks), ks > 0);
        wgmma_ss(s_flat, qd(0, ks), kd(2, ks), 1);
        wgmma_ss(s_flat, qd(1, ks), kd(1, ks), 1);
        wgmma_ss(s_flat, qd(1, ks), kd(0, ks), 1);
        wgmma_ss(s_flat, qd(0, ks), kd(1, ks), 1);
      }
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) wgmma_ss(s_flat, qd(0, ks), kd(0, ks), P == 3 || ks > 0);  // hi.hi
    wgmma_commit();
  };
  // On a finished score tile: the scale (bf16 inputs) and the masks, each
  // row's new max, and acc rescaled to it.
  float al0, al1;  // exp(old max - new max) of the thread's two rows
  auto softmax_max = [&](float (&s)[NS][4], int k0) {
    // element e of n8 block nt: row (e < 2 ? row0 : row1), key k0 + 8 nt + 2 tq + (e & 1)
    const bool masked = k0 + kBN > Skv || (causal && k0 + kBN - 1 > gr0) ||
                        (has_window && (long long)gr1 - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (P == 1) s[nt][e] *= scale;
        if (masked) {
          const int row = e < 2 ? row0 : row1, key = k0 + 8 * nt + 2 * tq + (e & 1);
          if (key >= Skv)
            s[nt][e] = -INFINITY;
          else if ((causal && key > row) || (has_window && row - key >= win))
            s[nt][e] = kNegInf;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0, m1 = mn1;
    if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {  // a row's max moved
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        acc[i][0] *= al0, acc[i][1] *= al0;
        acc[i][2] *= al1, acc[i][3] *= al1;
      }
    }
  };
  // Then p = exp(s - max), rounded to bf16 into pa (k16 step kk of the PV
  // product holds score blocks 2 kk and 2 kk + 1), the row sums, and acc +=
  // p v over the tile from a stage (issued; committed, not waited for).
  // Keys past Skv: p = 0, v = 0. V is read transposed: k16 step kk is 2
  // core matrices 8 keys apart (2 DP 16 bytes), the n8 blocks of d 128
  // bytes apart.
  auto softmax_pv = [&](float (&s)[NS][4], const uint16_t* sv) {
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      const float p0 = expf(s[nt][0] - m0), p1 = expf(s[nt][1] - m0);
      const float p2 = expf(s[nt][2] - m1), p3 = expf(s[nt][3] - m1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[nt >> 1][2 * (nt & 1)] = pack_bf16(p0, p1);
      pa[nt >> 1][2 * (nt & 1) + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) wgmma_rs(acc_flat, pa[kk], smem_desc(sv + kk * 16 * DP, kRowBlock, 128));
    wgmma_commit();
  };
  // after a wait: the results are read no earlier, and pa (read by the PV
  // product) is not reused before
  auto settle = [&](float (&s)[NS][4]) {
    fence_regs(reinterpret_cast<float(&)[NS * 4]>(s));
    fence_regs(acc_flat);
    fence_regs(pa);
  };

  float s[NS][4];
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBN;
    if (it + 1 < n_tiles) issue_tile<T, DP>(stage(it + 1), kvb, k0 + kBN, Skv8, tid);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile `it` have landed
    fence_async_smem();
    __syncthreads();     // everyone's, and q's pieces
    if (!skip(k0)) {
      qk(s, stage(it));
      wgmma_wait<0>();
      settle(s);
      softmax_max(s, k0);
      softmax_pv(s, stage(it) + P * kBN * DP);
      wgmma_wait<0>();
      settle(s);
    }
    __syncthreads();  // every warpgroup is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // each row's sum over its 4 lanes, then acc / max(l, 1e-30)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  T* o0 = o + (((long long)b * Sq + row0) * H + h) * D;
  T* o1 = o + (((long long)b * Sq + row1) * H + h) * D;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int d = i * 8 + 2 * tq;
    if (row0 < Sq) {
      if (d < D) store(o0 + d, acc[i][0] / den0);
      if (d + 1 < D) store(o0 + d + 1, acc[i][1] / den0);
    }
    if (row1 < Sq) {
      if (d < D) store(o1 + d, acc[i][2] / den1);
      if (d + 1 < D) store(o1 + d + 1, acc[i][3] / den1);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* scratch, int B, int Sq, int Skv,
                   int H, int Kh, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh, float scale,
                   int causal, long long window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, DP>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  auto* kv = static_cast<uint16_t*>(scratch);
  const int skv8 = (Skv + 7) / 8 * 8;
  const long long threads = (long long)skv8 * (DP / 8);  // one a core-matrix row of one (batch, KV head)
  flash_split_kv<T><<<dim3((unsigned)((threads + kSplitThreads - 1) / kSplitThreads), B * Kh), kSplitThreads, 0,
                      stream>>>(static_cast<const T*>(k), static_cast<const T*>(v), kv, Skv, skv8, Kh, D, DP, k_sb,
                                k_ss, k_sh, v_sb, v_ss, v_sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<T, DP><<<dim3((Sq + kBM - 1) / kBM, B * H), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), kv, static_cast<T*>(o), Sq, Skv, skv8, H, H / Kh, Kh, D, q_sb, q_ss, q_sh, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the K/V scratch that flash_attention_launch needs (dtype 0: f32,
// 1: bf16): [B * Kh][P + 1][Skv8][DP] bf16.
extern "C" long long flash_attention_scratch_bytes(int B, int Skv, int Kh, int D, int dtype) {
  const int P = dtype == 1 ? 1 : 3;
  return 2LL * B * Kh * (P + 1) * ((Skv + 7) / 8 * 8) * padded_d(D);
}

// q [B, Sq, H, D], k, v [B, Skv, Kh, D] with the given batch, position and
// head strides (elements; the last axis contiguous), o contiguous [B, Sq, H,
// D], scratch of flash_attention_scratch_bytes (16-byte aligned); dtype 0:
// all f32, 1: all bf16. 1 <= D <= 128, Kh divides H, B * H <= 65535, Skv >=
// 1; window <= 0: none. Launches the pre-pass and the forward kernel on
// `stream`; returns the first launch error (cudaError_t).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, void* scratch, int B,
                                      int Sq, int Skv, int H, int Kh, int D, long long q_sb, long long q_ss,
                                      long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
                                      long long window, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const bool wide = padded_d(D) == 128;
  cudaError_t e;
  if (dtype == 1)
    e = (wide ? launch<__nv_bfloat16, 128> : launch<__nv_bfloat16, 64>)(
        q, k, v, o, scratch, B, Sq, Skv, H, Kh, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
        causal, window, st);
  else
    e = (wide ? launch<float, 128> : launch<float, 64>)(q, k, v, o, scratch, B, Sq, Skv, H, Kh, D, q_sb, q_ss,
                                                        q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
                                                        window, st);
  return static_cast<int>(e);
}
