// Chunked RWKV-6 wkv forward for Hopper (sm_90a), from a zero state:
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
// evaluated a chunk of L = 16 tokens at a time (b = inclusive cumsum of
// log max(w, 1e-38) inside the chunk, bprev = b - log w):
//     y_t = (r_t . e^{bprev_t}) S
//         + sum_{i<t} (sum_k r_tk k_ik e^{min(bprev_tk - b_ik, 0)}) v_i
//         + (r_t . u . k_t) v_t
//     S  <- diag(e^{b_last}) S + sum_i diag(e^{b_last - b_i}) k_i v_i^T
//
// Replaces the TPU kernel src/repro/kernels/rwkv_wkv/kernel.py:27
// (wkv_chunk_kernel, launched by wkv_pallas at :76), whose sequential grid
// axis carries the [K, V] state in VMEM from chunk to chunk. Only the state
// is sequential; everything else in a chunk depends on the chunk alone. So
// a call is two kernels:
//
//   wkv_chunk_prep, one block of 256 threads a (batch, head, chunk), all in
//   parallel: forms the chunk's decays and its tile once, into a record of
//   the scratch the wrapper allocates (Rec: q = r e^{bprev} and kd = k
//   e^{b_last - b} [L][K], the tile A [L][L], e^{b_last} [K]).
//     phase A (a thread per (t, k), the cumsum over t a 16-lane shuffle
//       scan): b, bprev, the decays;
//     phase B (8 lanes per (t, i) pair, K split across them and summed with
//       shuffles): the tile, decay-masked r_t . k_i below the diagonal with
//       the pairwise decay e^{min(bprev_t - b_i, 0)} (never e^{bprev_t} *
//       e^{-b_i}, which overflows at fast decay), the bonus r_t . u . k_t on
//       it, zero above.
//   rwkv_wkv_kernel, the walk: one block of 64 threads a (batch, head, 16
//   columns of V) walks the chunks in order, each chunk's record and v
//   slice streaming through a cp.async ring of 4 (issued three chunks ahead,
//   so the chain never waits on device memory). Its [K, 16] slice of the
//   state lives in registers, 2 columns x K / 8 rows a thread; a chunk's y =
//   q S + A v is each thread's share over its rows (and 2 of the tile's
//   columns), summed over 8 lanes by a reduce-scatter of shuffles, and S <-
//   e^{b_last} S + kd^T v. One barrier a chunk; the reduce-scatter and the
//   store of a chunk's y run during the next chunk's products. Narrow
//   slices make many small blocks (320 at the zoo's prefill), which the
//   latency of the chain needs more than it needs the records read once.
//
// The exps are formed once per (batch, head, chunk): the walk forms none.
// The records cost (2 L + 1) K + L L floats a chunk, written once and read
// by each of the V / 16 walks (at the zoo's prefill: 48.5 MB written, 194 MB
// read, mostly from L2). Fixed order everywhere (two launches give the same bits); f32 with
// expf/logf, built without --use_fast_math.
//
// Bound: at the full-width prefill (B 2, S 1024, 40 heads, K = V = 64) the
// bytes (one read of r, k, v, w, one write of y and the state: 0.0317 ms)
// and the chunked form's operations over the FP32 peak (0.027 ms) are
// about equal; the pre-pass is bound by its exps (issue), the walk by the
// latency of its 64-step chain.
//
// Layouts: r, k, w [B, S, H, K] and v, y [B, S, H, V], each contiguous (the
// model's [B, S, d] projections viewed per head, read in place); u [B, H, K]
// with batch stride u_sb (0: one [H, K] row set for every batch entry);
// s_fin [B, H, K, V], the state after the last token. A short last chunk is
// bounds-checked: the positions past S read as r = k = v = 0, w = 1; so are
// K and V (K is padded to 64 or 128 with zero rows, columns past V are
// neither read nor written).
//
// Plain C interface; the wrapper is src/repro_torch/kernels/rwkv_wkv/ops.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../warp_mma.cuh"

namespace {

using namespace warp_mma;

constexpr int kL = 16;                       // chunk length
constexpr int kPrepThreads = 256;            // the pre-pass: 8 warps a (batch, head, chunk)
constexpr int kPairs = kL * (kL + 1) / 2;    // (t, i) with i <= t
constexpr int kGroups = kPrepThreads / 8;    // phase B: pair groups of 8 lanes
constexpr int kRounds = (kPairs + kGroups - 1) / kGroups;
constexpr int kVS = 16;                      // the walk: V columns a block
constexpr int kLanes = 8;                    // the walk: lanes a pair of columns
constexpr int kWalkThreads = kLanes * kVS / 2;
constexpr int kTL = kL / kLanes;             // positions of y each lane stores
constexpr int kRing = 4;                     // the walk's chunks in shared memory
constexpr unsigned kAll = 0xffffffffu;

// K padded to KT (64 or 128). A chunk's record, written once by the
// pre-pass and read by each V slice's walk: q = r e^{bprev} [kL][KT], kd =
// k e^{b_last - b} [kL][KT], the tile A [kL][kL] (zero above the diagonal),
// e^{b_last} [KT]; floats, 16-byte aligned.
template <int KT>
struct Rec {
  static constexpr int q = 0, kd = kL * KT, a = 2 * kL * KT, eb = a + kL * kL;
  static constexpr int size = eb + KT;
};

// ---------------------------------------------------------------------------
// the pre-pass: one block a (batch * head, chunk)
// ---------------------------------------------------------------------------

template <int KT>
__global__ void __launch_bounds__(kPrepThreads)
wkv_chunk_prep(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ w,
               const float* __restrict__ u, float* __restrict__ rec, int H, int S, int K, long long u_sb, int vec) {
  constexpr int RS = KT + 4;  // a [kL][KT] row in shared memory
  extern __shared__ __align__(16) float psm[];  // prep_smem<KT>() bytes
  using Rows = float[kL][RS];
  Rows& sr = *reinterpret_cast<Rows*>(psm);
  Rows& sk = *reinterpret_cast<Rows*>(psm + kL * RS);
  Rows& sw = *reinterpret_cast<Rows*>(psm + 2 * kL * RS);  // w, then e^{b_last - b}
  Rows& sb = *reinterpret_cast<Rows*>(psm + 3 * kL * RS);
  Rows& sbp = *reinterpret_cast<Rows*>(psm + 4 * kL * RS);
  Rows& sq = *reinterpret_cast<Rows*>(psm + 5 * kL * RS);  // e^{bprev}
  float* su = psm + 6 * kL * RS;
  float* seb = su + KT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_chunks = gridDim.x, c0 = c * kL, lc = min(kL, S - c0);
  const long long rowK = (long long)H * K, base = (long long)b * S * rowK + (long long)h * K;
  float* out = rec + ((size_t)bh * n_chunks + c) * Rec<KT>::size;

  // r, k and w of the chunk, every copy in flight at once (past S or K: 0)
  if (vec) {  // K a multiple of 4, r, k, w 16-byte aligned
    for (int i = tid; i < 3 * kL * (KT / 4); i += kPrepThreads) {
      const int a = i / (kL * (KT / 4)), t = (i / (KT / 4)) % kL, kk = (i % (KT / 4)) * 4;
      const float* src = a == 0 ? r : a == 1 ? k : w;
      const bool ok = t < lc && kk < K;
      cp_async16(psm + (a * kL + t) * RS + kk, ok ? src + base + (long long)(c0 + t) * rowK + kk : src, ok);
    }
  } else {
    for (int i = tid; i < 3 * kL * KT; i += kPrepThreads) {
      const int a = i / (kL * KT), t = (i / KT) % kL, kk = i % KT;
      const float* src = a == 0 ? r : a == 1 ? k : w;
      const bool ok = t < lc && kk < K;
      cp_async4(psm + (a * kL + t) * RS + kk, ok ? src + base + (long long)(c0 + t) * rowK + kk : src, ok);
    }
  }
  cp_async_commit();
  for (int i = tid; i < KT; i += kPrepThreads) su[i] = i < K ? u[(long long)b * u_sb + (long long)h * K + i] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // phase A, the decays: thread (t = lane % 16, k = 2 warp + lane / 16 + 16
  // m); b, the cumsum of log w over t, is a 16-lane shuffle scan (past S or
  // K: log w = 0)
  const int t = lane & 15;
#pragma unroll
  for (int m = 0; m < KT / 16; ++m) {
    const int kk = 2 * warp + (lane >> 4) + 16 * m;
    const float lw = (t < lc && kk < K) ? logf(fmaxf(sw[t][kk], 1e-38f)) : 0.f;
    float bs = lw;
#pragma unroll
    for (int off = 1; off < kL; off <<= 1) {
      const float n = __shfl_up_sync(kAll, bs, off, kL);
      if (t >= off) bs += n;
    }
    const float bl = __shfl_sync(kAll, bs, kL - 1, kL);
    const float bpv = bs - lw;
    sb[t][kk] = bs;
    sbp[t][kk] = bpv;
    sq[t][kk] = expf(bpv);       // times r below
    sw[t][kk] = expf(bl - bs);   // times k (this thread alone read w[t][kk])
    if (t == kL - 1) seb[kk] = expf(bl);
  }
  __syncthreads();

  // the record's q, kd and e^{b_last}, coalesced
  for (int i = tid; i < kL * KT; i += kPrepThreads) {
    const int tt = i / KT, kk = i % KT;
    out[Rec<KT>::q + i] = sr[tt][kk] * sq[tt][kk];
    out[Rec<KT>::kd + i] = sk[tt][kk] * sw[tt][kk];
  }
  for (int i = tid; i < KT; i += kPrepThreads) out[Rec<KT>::eb + i] = seb[i];
  for (int i = tid; i < kL * kL; i += kPrepThreads)
    if (i % kL > i / kL) out[Rec<KT>::a + i] = 0.f;

  // phase B, the tile: pair group tid / 8 takes pairs tid / 8 + kGroups rd
  // (t-major order of i <= t; a slot past the last pair repeats pair 0 and
  // stores nothing, so the rounds have no branch and their exps interleave),
  // lane tid % 8 the k set 4 (tid % 8) + 32 mm + e, summed over the 8 lanes
  // with shuffles. Below the diagonal the pairwise decay e^{min(bprev_t -
  // b_i, 0)}, on it the bonus u.
  const int kl = lane & 7, pg = tid >> 3;
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {
    const int p = pg + kGroups * rd;
    int tp = (int)((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
    if ((tp + 1) * (tp + 2) / 2 <= p) ++tp;
    if (tp * (tp + 1) / 2 > p) --tp;
    const bool real = p < kPairs;
    const int ip = real ? p - tp * (tp + 1) / 2 : 0;
    tp = real ? tp : 0;
    float a = 0.f;
#pragma unroll
    for (int mm = 0; mm < KT / 32; ++mm) {
      const int kk = 4 * kl + 32 * mm;
      const float4 rv = *reinterpret_cast<const float4*>(&sr[tp][kk]);
      const float4 kv = *reinterpret_cast<const float4*>(&sk[ip][kk]);
      const float4 bpv = *reinterpret_cast<const float4*>(&sbp[tp][kk]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[ip][kk]);
      const float4 uv = *reinterpret_cast<const float4*>(su + kk);
      const float re[4] = {rv.x, rv.y, rv.z, rv.w}, ke[4] = {kv.x, kv.y, kv.z, kv.w};
      const float de[4] = {bpv.x - bv.x, bpv.y - bv.y, bpv.z - bv.z, bpv.w - bv.w};
      const float ue[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) a = fmaf(re[e] * ke[e], ip == tp ? ue[e] : expf(fminf(de[e], 0.f)), a);
    }
    a += __shfl_xor_sync(kAll, a, 1);
    a += __shfl_xor_sync(kAll, a, 2);
    a += __shfl_xor_sync(kAll, a, 4);
    if (real && kl == 0) out[Rec<KT>::a + tp * kL + ip] = a;
  }
}

// ---------------------------------------------------------------------------
// the walk: one block a (batch * head, kVS columns of V), the chunks in order
// ---------------------------------------------------------------------------

// One round of the reduce-scatter of y over the kLanes lanes of a column
// pair: positions [0, 2 HALF) of yp -> [0, HALF), the lane whose bit
// `HALF / kTL` is set keeping the upper half, the other the lower, each
// adding its partner's share. Values are selected, not elements, so yp
// stays in registers.
template <int HALF>
__device__ __forceinline__ void fold(float (&yp)[kL][2], int kg) {
  constexpr int kBit = HALF / kTL;
  const bool up = kg & kBit;
#pragma unroll
  for (int i = 0; i < HALF; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float lo = yp[i][jj], hi = yp[i + HALF][jj];
      yp[i][jj] = (up ? hi : lo) + __shfl_xor_sync(kAll, up ? lo : hi, kBit);
    }
}

template <int KT>
__global__ void __launch_bounds__(kWalkThreads)
rwkv_wkv_kernel(const float* __restrict__ rec, const float* __restrict__ v, float* __restrict__ y,
                float* __restrict__ s_fin, int H, int S, int K, int V, int vec) {
  using R = Rec<KT>;
  constexpr int kSlot = R::size + kL * kVS;  // a chunk's record and its [kL][kVS] slice of v
  constexpr int MM = KT / (4 * kLanes);      // a thread's k set: 4 kg + 4 kLanes mm + e
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, v0 = blockIdx.x * kVS;
  const int kg = lane % kLanes, j = 2 * (warp * (32 / kLanes) + lane / kLanes);  // k set; columns j, j + 1
  const int n_chunks = (S + kL - 1) / kL;
  const long long rowV = (long long)H * V, baseV = (long long)b * S * rowV + (long long)h * V + v0;
  const float* recs = rec + (size_t)bh * n_chunks * R::size;

  // chunk c's record and v slice into ring slot c % kRing (v past S or V: 0)
  auto issue = [&](int c) {
    float* dst = smem + (c % kRing) * kSlot;
    const float* src = recs + (size_t)c * R::size;
    for (int i = tid; i < R::size / 4; i += kWalkThreads) cp_async16(dst + 4 * i, src + 4 * i, true);
    float* dv = dst + R::size;
    if (vec) {  // V a multiple of 4, v 16-byte aligned
      for (int i = tid; i < kL * kVS / 4; i += kWalkThreads) {
        const int t = i / (kVS / 4), jj = (i % (kVS / 4)) * 4;
        const bool ok = c * kL + t < S && v0 + jj < V;
        cp_async16(dv + t * kVS + jj, ok ? v + baseV + (long long)(c * kL + t) * rowV + jj : v, ok);
      }
    } else {
      for (int i = tid; i < kL * kVS; i += kWalkThreads) {
        const int t = i / kVS, jj = i % kVS;
        const bool ok = c * kL + t < S && v0 + jj < V;
        cp_async4(dv + t * kVS + jj, ok ? v + baseV + (long long)(c * kL + t) * rowV + jj : v, ok);
      }
    }
  };

  float st[MM][4][2];  // S[k][j + jj] of the thread's k set
#pragma unroll
  for (int mm = 0; mm < MM; ++mm)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[mm][e][0] = st[mm][e][1] = 0.f;

#pragma unroll
  for (int c = 0; c < kRing - 1; ++c) {
    if (c < n_chunks) issue(c);
    cp_async_commit();
  }
  // the kLanes lanes' shares of chunk c's y summed (lane kg ends with t =
  // kTL kg + tt) and stored; run during the next chunk's products, which do
  // not wait for it
  auto finish = [&](float (&yp)[kL][2], int c) {
    fold<8>(yp, kg);
    fold<4>(yp, kg);
    fold<2>(yp, kg);
    const int lc = min(kL, S - c * kL);
#pragma unroll
    for (int tt = 0; tt < kTL; ++tt)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        if (kTL * kg + tt < lc && v0 + j + jj < V)
          y[baseV + (long long)(c * kL + kTL * kg + tt) * rowV + j + jj] = yp[tt][jj];
  };
  float yprev[kL][2];
  for (int c = 0; c <= n_chunks; ++c) {  // one call site of finish, so it stays inline
    if (c < n_chunks) {
      cp_async_wait<kRing - 2>();  // this thread's copies of chunk c
      __syncthreads();             // everyone's; chunk c - 1's slot is read
      if (c + kRing - 1 < n_chunks) issue(c + kRing - 1);
      cp_async_commit();
    }
    if (c > 0) finish(yprev, c - 1);
    if (c == n_chunks) break;
    const float* sl = smem + (c % kRing) * kSlot;
    const float *cq = sl + R::q, *ckd = sl + R::kd, *ca = sl + R::a, *ceb = sl + R::eb, *cv = sl + R::size;

    // y = q S over the thread's k set, and S <- e^{b_last} S + kd^T v
    float sacc[MM][4][2] = {};
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      const float2 vv = *reinterpret_cast<const float2*>(cv + t * kVS + j);
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int mm = 0; mm < MM; ++mm) {
        const float4 q4 = *reinterpret_cast<const float4*>(cq + t * KT + 4 * kg + 4 * kLanes * mm);
        const float4 d4 = *reinterpret_cast<const float4*>(ckd + t * KT + 4 * kg + 4 * kLanes * mm);
        const float qe[4] = {q4.x, q4.y, q4.z, q4.w}, de[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y0 = fmaf(qe[e], st[mm][e][0], y0);
          y1 = fmaf(qe[e], st[mm][e][1], y1);
          sacc[mm][e][0] = fmaf(de[e], vv.x, sacc[mm][e][0]);
          sacc[mm][e][1] = fmaf(de[e], vv.y, sacc[mm][e][1]);
        }
      }
      yprev[t][0] = y0;
      yprev[t][1] = y1;
    }
#pragma unroll
    for (int mm = 0; mm < MM; ++mm) {
      const float4 e4 = *reinterpret_cast<const float4*>(ceb + 4 * kg + 4 * kLanes * mm);
      const float ee[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[mm][e][0] = fmaf(ee[e], st[mm][e][0], sacc[mm][e][0]);
        st[mm][e][1] = fmaf(ee[e], st[mm][e][1], sacc[mm][e][1]);
      }
    }
    // + A v: lane kg takes i = kg + kLanes h2 (above the diagonal a = 0)
#pragma unroll
    for (int h2 = 0; h2 < kTL; ++h2) {
      const int ii = kg + kLanes * h2;
      const float2 vv = *reinterpret_cast<const float2*>(cv + ii * kVS + j);
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        const float a = t >= ii ? ca[t * kL + ii] : 0.f;
        yprev[t][0] = fmaf(a, vv.x, yprev[t][0]);
        yprev[t][1] = fmaf(a, vv.y, yprev[t][1]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mm = 0; mm < MM; ++mm)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 4 * kg + 4 * kLanes * mm + e;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        if (kk < K && v0 + j + jj < V) s_fin[((long long)bh * K + kk) * V + v0 + j + jj] = st[mm][e][jj];
    }
}

template <int KT>
constexpr size_t prep_smem() { return sizeof(float) * (6 * kL * (KT + 4) + 2 * KT); }
template <int KT>
constexpr size_t walk_smem() { return sizeof(float) * kRing * (Rec<KT>::size + kL * kVS); }

template <int KT>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w, const float* u, float* y,
                   float* s_fin, float* rec, int B, int H, int S, int K, int V, long long u_sb, cudaStream_t stream) {
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(wkv_chunk_prep<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(prep_smem<KT>()));
    return e != cudaSuccess ? e : cudaFuncSetAttribute(rwkv_wkv_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       static_cast<int>(walk_smem<KT>()));
  }();
  if (attr != cudaSuccess) return attr;
  const int n_chunks = (S + kL - 1) / kL;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec_k = K % 4 == 0 && aligned(r) && aligned(k) && aligned(w);
  wkv_chunk_prep<KT><<<dim3(n_chunks, B * H), kPrepThreads, prep_smem<KT>(), stream>>>(r, k, w, u, rec, H, S, K, u_sb,
                                                                                      vec_k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int vec = V % 4 == 0 && aligned(v);
  rwkv_wkv_kernel<KT><<<dim3((V + kVS - 1) / kVS, B * H), kWalkThreads, walk_smem<KT>(), stream>>>(
      rec, v, y, s_fin, H, S, K, V, vec);
  return cudaGetLastError();
}

inline int padded_k(int K) { return K <= 64 ? 64 : 128; }

}  // namespace

// Bytes of the chunk records that rwkv_wkv_launch needs: one (4 (2 kL + 1) KT
// + 4 kL kL bytes) per (batch, head, chunk of kL).
extern "C" long long rwkv_wkv_scratch_bytes(int B, int H, int S, int K) {
  const int kt = padded_k(K);
  return 4LL * B * H * ((S + kL - 1) / kL) * (2 * kL * kt + kL * kL + kt);
}

// r, k, w [B, S, H, K], v [B, S, H, V], u [B, H, K] (batch stride u_sb),
// y [B, S, H, V], s_fin [B, H, K, V], scratch of rwkv_wkv_scratch_bytes
// (16-byte aligned); all f32, r, k, w contiguous. 1 <= K <= 128, V >= 1, B
// * H <= 65535, S >= 1. Launches the pre-pass and the walk on `stream`;
// returns the first launch error (cudaError_t).
extern "C" int rwkv_wkv_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                               void* y, void* s_fin, void* scratch, int B, int H, int S, int K, int V,
                               long long u_sb, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto go = padded_k(K) == 64 ? launch<64> : launch<128>;
  return static_cast<int>(go(f(r), f(k), f(v), f(w), f(u), static_cast<float*>(y), static_cast<float*>(s_fin),
                             static_cast<float*>(scratch), B, H, S, K, V, u_sb, static_cast<cudaStream_t>(stream)));
}
