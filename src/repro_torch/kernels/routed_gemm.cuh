// The two tile loops of the FloatSD matmuls on Hopper (sm_90a), one per
// route; the caller picks the route and the K split from the shapes
// (floatsd_matmul/ref.py's `plan`, which the wrappers in ops.py apply) and
// passes them as launch arguments. FloatSD8 (floatsd_matmul.cu) runs both
// routes, FloatSD4 (floatsd4_matmul.cu) route A only:
//     y[M, N] = x[M, K] @ W,   W decoded from a weight format tile by tile.
//
// Both routes cut K into `splits` chunks of `chunk` consecutive k. With a
// grid of `splits` blocks over blockIdx.z, each block writes its chunk's sum
// to part[z][M][N] and add_partials adds the chunks in order, p = 0, 1, ...,
// P-1 (no float atomics); route A also runs with one block over z, which
// adds its chunks' sums in the same order itself, where the partials would
// outgrow the codes (large M). Every edge is bounds-checked: entries outside
// the matrices are 0 and nothing past them is read, so no padding is needed
// for any M, N, K.
//
// Route A, ordered (small M: decode steps, prompt chunks, the LSTM's
// per-step products and matmul_dx; and any M whose caller needs the plain
// version's bits): CUDA cores. A block owns up to MT = 64 rows and kABN
// columns of one chunk, or of all; each output sums a chunk as
// acc = fmaf(x[m, k], w[k, n], acc) for k in order, which the plain version
// repeats, so on exact products (FP8/FP16 activations times FloatSD weights)
// the two agree bit for bit. The order depends on N and K only, so a row's
// result does not depend on how many rows share the launch.
//
// Route B, mma (large M: prefills): bf16 tensor cores, mma.sync m16n8k16
// with f32 accumulation. A pre-pass (split_pieces) splits x once into three
// bf16 pieces by truncation, hi = x & 0xFFFF0000, r = x - hi,
// mid = r & 0xFFFF0000, lo = r - mid (both differences exact, hi + mid + lo
// == x above about 2^-100), and marks which pieces each block tile of x
// holds nonzero; the loader decodes w' = w / scale (scale a power of two)
// to bf16, which must be exact, so every product of a piece and w' is exact.
// A piece that is zero in the block's tile is neither loaded nor multiplied
// (FP8 activations need 1 piece, FP16 2, f32 3). The pieces and the raw
// codes stream by cp.async through a ring of stages. Each stage (kBBK of k)
// accumulates in fresh registers and is added to the block's sum with one
// f32 add, so the tensor cores' own rounding acts on a stage's partial sum,
// not on the running total. The epilogue multiplies by scale, which is
// exact wherever y is normal.
//
// A weight format supplies its decode as a `Loader`:
//     typename Loader::RegsA;                                   route A: one stage's codes in registers
//     RegsA load_a(int t, int k0, int kend, int n0) const;      thread t's global loads of [kABK][kABN]
//     void store_a(const RegsA&, float* ws, int t) const;       decoded w into ws[a_slot(k, n)]
//     void issue_b(int t, int k0, int kend, int n0, uint8_t* raw) const;
//         route B: thread t's 16 bytes of the stage's codes [kBBK][kBBN] to raw + 16 t (cp.async)
//         (outside the matrix: codes that decode to 0)
//     void decode_b(const uint8_t* raw, uint16_t* ws, int t) const;
//         its bf16 bits of w' into ws[b_slot<kNMajor>(k, n)]
//     static constexpr bool kNMajor;                            route B's w' tile is [n][k] (else [k][n])
//     float scale;                                              w = w' * scale
// and its tables, which it writes before the tile loop starts (the loop
// synchronises before its first store).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "warp_mma.cuh"

namespace routed_gemm {

using namespace warp_mma;  // ldmatrix, mma.sync, cp.async, split3

// Exact 2^k for k in f32's normal range, built from the exponent bits.
__device__ __forceinline__ float pow2i(int k) { return __int_as_float((k + 127) << 23); }

constexpr int kThreads = 256;  // both routes: 8 warps

// route A: kABN columns, up to 64 rows, stages of kABK k
constexpr int kABN = 128;
constexpr int kABK = 64;

// route B: kBBM x kBBN block tile, 8 warps of 64 x 32, stages of kBBK k
constexpr int kBBM = 128;
constexpr int kBBN = 128;
constexpr int kBBK = 64;
constexpr int kBLdK = kBBK + 8;  // row of a [.][k] bf16 tile: 144 B, so ldmatrix rows hit distinct banks
constexpr int kBLdN = kBBN + 8;  // row of a [k][n] bf16 tile: 272 B
constexpr int kBPiece = kBBM * kBLdK;  // bf16 elements of one x piece's tile
constexpr int kBW = kBBN * kBLdK > kBBK * kBLdN ? kBBN * kBLdK : kBBK * kBLdN;  // the w' tile
constexpr int kBStages = 3;  // the ring's stages
constexpr int kBSlot = 3 * kBPiece + kBBK * kBBN / 2;  // a stage: 3 pieces + the raw codes (bf16 units)
constexpr size_t kBSmem = (kBStages * kBSlot + 2 * kBW) * sizeof(uint16_t);  // + two w' tiles

// route A's dynamic shared memory: the w tile and the x tile ([kABK][MT + 4])
template <int MT>
constexpr size_t a_smem() { return (kABK * kABN + kABK * (MT + 4)) * sizeof(float); }

// Route A's w tile [kABK][kABN] f32, XOR-swizzled in units of 4 columns so
// that a loader's 16 columns of one k, its 16 k of one n (from four threads
// on four k blocks), and the compute's float4 reads of one k all fall on
// distinct banks. Keeps every aligned group of 4 columns together.
__device__ __forceinline__ int a_slot(int k, int n) {
  return k * kABN + (n ^ ((((n >> 5) & 3) ^ (((k >> 4) & 3) << 1)) << 2));
}

// Route B's w' tile: [n][k] rows of kBLdK, or [k][n] rows of kBLdN.
template <bool kNMajor>
__device__ __forceinline__ int b_slot(int k, int n) { return kNMajor ? n * kBLdK + k : k * kBLdN + n; }

// ---------------------------------------------------------------------------
// route A: ordered split-K on CUDA cores
// ---------------------------------------------------------------------------

// One block's tile: rows blockIdx.y * MT.., columns blockIdx.x * kABN.., the
// chunk blockIdx.z, or with gridDim.z == 1 all `splits` chunks, whose sums
// the block adds in order. Up to 16 rows, a thread owns MT / 2 rows of one
// column (2 row groups), so the w tile is read twice a stage; above, 8 warps
// own 8 row groups of MT / 8 rows, a lane 4 columns. Each stage's global
// loads are issued before the previous stage's products, so they are in
// flight while it computes.
template <int MT, class Loader>
__device__ __forceinline__ void ordered_tile(const float* __restrict__ x, const Loader& w, float* __restrict__ out,
                                             int M, int N, int K, int splits, int chunk, float* smem) {
  constexpr bool kNarrow = MT <= 16;
  constexpr int TM = kNarrow ? MT / 2 : MT / 8;  // rows a thread
  constexpr int TN = kNarrow ? 1 : 4;            // columns a thread
  constexpr int LDX = MT + 4;
  constexpr int XPT = MT * kABK / kThreads;  // x elements each thread stages
  static_assert(MT % 8 == 0 && XPT >= 1 && (TM % 4 == 0 || TM < 4) && (!kNarrow || kThreads == 2 * kABN), "MT");
  float* ws = smem;               // [kABK][kABN] at a_slot
  float* xs = smem + kABK * kABN;  // [kABK][LDX], k-major
  const int t = threadIdx.x;
  const int r0 = kNarrow ? (t / kABN) * TM : (t >> 5) * TM;  // the thread's first row and column
  const int col = kNarrow ? t % kABN : (t & 31) * 4;
  const int n0 = blockIdx.x * kABN, m0 = blockIdx.y * MT;
  const int c0 = blockIdx.z, c1 = gridDim.z == 1 ? splits : c0 + 1;  // the block's chunks
  out += (size_t)blockIdx.z * M * N;  // chunk z's sums (one block over z: y itself)

  float acc[TM][TN], tot[TM][TN];  // the chunk's sum; the sum of the chunks before it
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = tot[i][j] = 0.f;
  }

  float xv[XPT];
  typename Loader::RegsA wr;
  auto load = [&](int k0, int ke) {
#pragma unroll
    for (int j = 0; j < XPT; ++j) {  // consecutive threads read consecutive k of one row
      const int i = t + j * kThreads, m = m0 + i / kABK, k = k0 + i % kABK;
      xv[j] = (m < M && k < ke) ? x[(size_t)m * K + k] : 0.f;
    }
    wr = w.load_a(t, k0, ke, n0);
  };
  auto end_of = [&](int c) { return min(K, (c + 1) * chunk); };

  // the stages: chunk c's k from c * chunk to end_of(c), kABK at a time
  int c = c0, k0 = c0 * chunk;
  bool have = c < c1 && k0 < end_of(c);
  if (have) load(k0, end_of(c));
  while (have) {
    int nc = c, nk = k0 + kABK;  // the next stage
    if (nk >= end_of(c)) nc = c + 1, nk = nc * chunk;
    const bool more = nc < c1 && nk < end_of(nc);
    __syncthreads();  // the loader's tables are written; the previous stage's reads are done
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int i = t + j * kThreads;
      xs[(i % kABK) * LDX + i / kABK] = xv[j];
    }
    w.store_a(wr, ws, t);
    __syncthreads();
    if (more) load(nk, end_of(nc));
#pragma unroll
    for (int kk = 0; kk < kABK; ++kk) {
      float b[TN];
      if constexpr (TN == 4) {
        const float4 v = *reinterpret_cast<const float4*>(ws + a_slot(kk, col));
        b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
      } else {
        b[0] = ws[a_slot(kk, col)];
      }
      const float* xr = xs + kk * LDX + r0;
      float a[TM];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xr + i);
          a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xr[i];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (nc != c || !more) {  // chunk c is summed: ((p0 + p1) + p2) + ...
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          tot[i][j] = c == c0 ? acc[i][j] : __fadd_rn(tot[i][j], acc[i][j]);
          acc[i][j] = 0.f;
        }
      }
    }
    c = nc, k0 = nk, have = more;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + r0 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + col + j;
      if (n < N) out[(size_t)m * N + n] = tot[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// route B: bf16 tensor cores on truncation-split x
// ---------------------------------------------------------------------------

// The pre-pass: x [M, K] f32 -> its hi, mid and lo pieces [3][M][Kp] bf16
// (Kp = K rounded up to 8, the tail 0, so every row is 16-byte aligned), and
// for each kBBM x kBBK tile of x a mask of its nonzero pieces,
// flags[(m / kBBM) * ceil(K / kBBK) + k / kBBK]. Once per launch, so the
// tile loop's blocks, which each read a row block N / kBBN times, neither
// split x nor load the pieces that are zero. A block a tile.
__global__ void __launch_bounds__(kThreads) split_pieces(const float* __restrict__ x, uint16_t* __restrict__ pieces,
                                                         int* __restrict__ flags, int M, int K, int Kp) {
  const int t = threadIdx.x, kt = blockIdx.x, mb = blockIdx.y;
  const bool xvec = (K & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  int nz = 0;
#pragma unroll
  for (int j = 0; j < kBBM * kBBK / 8 / kThreads; ++j) {
    const int c = t + j * kThreads;  // 128 rows x 8 runs of 8 k
    const int m = mb * kBBM + (c >> 3), k = kt * kBBK + (c & 7) * 8;
    if (m >= M || k >= Kp) continue;
    float v[8];
    if (xvec && k + 8 <= K) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(x + (size_t)m * K + k));
      const float4 b = __ldg(reinterpret_cast<const float4*>(x + (size_t)m * K + k + 4));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = k + e < K ? x[(size_t)m * K + k + e] : 0.f;
    }
    uint32_t p[3][8];
#pragma unroll
    for (int e = 0; e < 8; ++e) split3(v[e], p[0][e], p[1][e], p[2][e]);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      uint32_t any = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) any |= p[q][e] & 0x7FFFu;
      nz |= any ? 1 << q : 0;
      *reinterpret_cast<uint4*>(pieces + ((size_t)q * M + m) * Kp + k) =
          make_uint4(p[q][0] | (p[q][1] << 16), p[q][2] | (p[q][3] << 16), p[q][4] | (p[q][5] << 16),
                     p[q][6] | (p[q][7] << 16));
    }
  }
  int any = __syncthreads_or(nz & 1) ? 1 : 0;
  any |= __syncthreads_or(nz & 2) ? 2 : 0;
  any |= __syncthreads_or(nz & 4) ? 4 : 0;
  if (t == 0) flags[mb * gridDim.x + kt] = any;
}

// One block's kBBM x kBBN tile of the chunk blockIdx.z, on the pre-split
// pieces. Warp (wm, wn) owns rows wm * 64.. and columns wn * 32..: 4 x 4
// tiles of m16n8. A ring of kBStages stages in shared memory, each the
// nonzero pieces' tiles and the raw code tile, is filled by cp.async two
// stages ahead; between two barriers a stage's products run on the tensor
// cores and the next stage's codes are decoded into the other w' tile.
template <class Loader>
__device__ __forceinline__ void mma_tile(const uint16_t* __restrict__ pieces, const int* __restrict__ flags,
                                         const Loader& w, float* __restrict__ out, int M, int N, int K, int Kp,
                                         int chunk, uint16_t* smem) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBBM, n0 = blockIdx.x * kBBN;
  const int kb = blockIdx.z * chunk, ke = min(K, kb + chunk);
  const int nst = ke > kb ? (ke - kb + kBBK - 1) / kBBK : 0;
  const int* tile_flags = flags + (m0 / kBBM) * ((K + kBBK - 1) / kBBK);
  uint16_t* wt = smem + kBStages * kBSlot;  // the decoded w' tiles, two
  out += (size_t)blockIdx.z * M * N;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // stage s into its ring slot: the pieces that are nonzero somewhere in the
  // tile (`use`), 128 rows x 64 k each (4 copies of 16 bytes a thread), and
  // the codes
  auto issue = [&](int s, int use) {
    const int k0 = kb + s * kBBK;
    uint16_t* slot = smem + (s % kBStages) * kBSlot;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (!(use & (1 << q))) continue;
#pragma unroll
      for (int j = 0; j < kBBM * kBBK / 8 / kThreads; ++j) {
        const int c = t + j * kThreads, row = c >> 3, kq = (c & 7) * 8;
        const int m = m0 + row, k = k0 + kq;
        const bool ok = m < M && k < ke;
        cp_async16(slot + q * kBPiece + row * kBLdK + kq, ok ? pieces + ((size_t)q * M + m) * Kp + k : pieces, ok);
      }
    }
    w.issue_b(t, k0, ke, n0, reinterpret_cast<uint8_t*>(slot + 3 * kBPiece));
  };

  // the stages' piece masks, read kBStages stages ahead of their products
  static_assert(kBStages == 3, "the masks' shift register");
  const int* stage_flags = tile_flags + kb / kBBK;
  auto flag = [&](int s) { return s < nst ? stage_flags[s] : 0; };
  int f0 = flag(0), f1 = flag(1), f2 = flag(2);

  auto raw = [&](int s) { return reinterpret_cast<const uint8_t*>(smem + (s % kBStages) * kBSlot + 3 * kBPiece); };
  __syncthreads();  // the loader's tables are written
  if (nst > 0) issue(0, f0);
  cp_async_commit();
  if (nst > 1) issue(1, f1);
  cp_async_commit();
  cp_async_wait<1>();  // stage 0
  __syncthreads();
  if (nst > 0) w.decode_b(raw(0), wt, t);
  for (int s = 0; s < nst; ++s) {
    const int f3 = flag(s + 3);
    const uint16_t* xs = smem + (s % kBStages) * kBSlot;
    const uint16_t* ws = wt + (s & 1) * kBW;
    cp_async_wait<0>();  // this thread's copies of stage s + 1 have landed
    __syncthreads();      // everyone's; w' of stage s is decoded; stage s - 1's products are done
    if (s + 1 < nst) w.decode_b(raw(s + 1), wt + ((s + 1) & 1) * kBW, t);
    if (s + 2 < nst) issue(s + 2, f2);  // into stage s - 1's slot
    cp_async_commit();
    const int use = f0;  // uniform across the block
    f0 = f1, f1 = f2, f2 = f3;
    const int first = use & 1 ? 0 : use & 2 ? 1 : 2;  // the first piece multiplied
    constexpr int KS = kBBK / 16;
    uint32_t bf[KS][4][2];  // w' fragments of the stage's k16 steps, 4 n8 tiles
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        if constexpr (Loader::kNMajor) {
          const int n = wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(r, ws + b_slot<true>(ks * 16 + (((lane >> 3) & 1) << 3), n));
        } else {
          const int k = ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          ldsm_x4_t(r, ws + b_slot<false>(k, wn * 32 + np * 16 + ((lane >> 4) << 3)));
        }
        bf[ks][2 * np][0] = r[0];
        bf[ks][2 * np][1] = r[1];
        bf[ks][2 * np + 1][0] = r[2];
        bf[ks][2 * np + 1][1] = r[3];
      }
    }
    float c[4][4][4];  // the stage's sums, from zero: 16 independent chains
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (!(use & (1 << q))) continue;
        uint32_t a[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(a[mi], xs + q * kBPiece + (wm * 64 + mi * 16 + (lane & 15)) * kBLdK + ks * 16 + ((lane >> 4) << 3));
        if (ks == 0 && q == first) {
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_bf16_first(c[mi][ni], a[mi], bf[ks][ni]);
        } else {
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_bf16(c[mi][ni], a[mi], bf[ks][ni]);
        }
      }
    }
    if (use) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += c[mi][ni][e];
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + wn * 32 + ni * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
        if (m >= M) continue;
        if (n < N) out[(size_t)m * N + n] = acc[mi][ni][2 * h] * w.scale;
        if (n + 1 < N) out[(size_t)m * N + n + 1] = acc[mi][ni][2 * h + 1] * w.scale;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the chunks' sums, added in order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) add_partials(const float* __restrict__ part, float* __restrict__ y,
                                                         size_t mn, int splits) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < mn; i += (size_t)gridDim.x * kThreads) {
    float s = part[i];
    for (int p = 1; p < splits; ++p) s = __fadd_rn(s, part[p * mn + i]);
    y[i] = s;
  }
}

// y = ((part[0] + part[1]) + ...) + part[splits - 1], on `s`
inline cudaError_t launch_add_partials(const float* part, float* y, size_t mn, int splits, cudaStream_t s) {
  const size_t b = (mn + kThreads - 1) / kThreads;
  add_partials<<<static_cast<unsigned>(b < 132 * 16 ? b : 132 * 16), kThreads, 0, s>>>(part, y, mn, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared memory limit, once per kernel.
template <auto kKernel>
cudaError_t allow_smem(size_t bytes) {
  static const cudaError_t err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                      static_cast<int>(bytes));
  return err;
}

// Route A's row tile MT, the smallest of 8, 16, 32 and 64 that holds M (the
// sum order does not depend on it): returns launch(integral_constant<MT>).
template <class Launch>
cudaError_t with_row_tile(int M, Launch&& launch) {
  if (M <= 8) return launch(std::integral_constant<int, 8>());
  if (M <= 16) return launch(std::integral_constant<int, 16>());
  if (M <= 32) return launch(std::integral_constant<int, 32>());
  return launch(std::integral_constant<int, 64>());
}

}  // namespace routed_gemm
