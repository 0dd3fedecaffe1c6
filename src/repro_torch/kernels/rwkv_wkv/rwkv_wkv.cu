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
// axis carries the [K, V] state in VMEM from chunk to chunk. Here one thread
// block owns one (batch * head, 16-column slice of V): the state's V
// columns evolve independently (S[:, v] and y[:, v] depend on column v
// alone), so the split is exact and multiplies the blocks by V / 16. The
// block loops over the chunks in order and keeps its [K, 16] slice of the
// state in shared memory for the whole sequence; r, k, log w and v of one
// chunk are staged in shared memory, then the [L, L] decay-masked tile A
// (its diagonal holds the bonus r_t . u . k_t), then y, then the state
// update. The pairwise decay keeps its exponent e^{bprev_t - b_i} (never
// e^{bprev_t} * e^{-b_i}, which overflows at fast decay). All arithmetic is
// f32 with expf/logf, built without --use_fast_math.
//
// Bound: at the full-width prefill (B 2, S 1024, 40 heads, K = V = 64) the
// bytes (one read of r, k, v, w, one write of y) and the chunked form's
// MACs and exps over the FP32 peak are about equal; each block re-forms the
// tile A and the decays for its V slice (4 slices at V = 64), so the exps
// are paid four times over, and 120 of the 256 tile threads do the work.
//
// Layouts: r, k, w [B, S, H, K] and v, y [B, S, H, V], each contiguous (the
// model's [B, S, d] projections viewed per head, read in place); u [B, H, K]
// with batch stride u_sb (0: one [H, K] row set for every batch entry);
// s_fin [B, H, K, V], the state after the last token. A short last chunk is
// bounds-checked: the positions past S read as r = k = v = 0, w = 1.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/rwkv_wkv/ops.py.

#include <cuda_runtime.h>

namespace {

constexpr int kL = 16;         // chunk length
constexpr int kVS = 16;        // V columns per block
constexpr int kKMax = 128;     // largest head size K
constexpr int kKP = kKMax + 1; // padded row: the tile reads rows i = 0..15 at one k
constexpr int kThreads = 256;  // = kL * kL = kL * kVS

__global__ void __launch_bounds__(kThreads)
rwkv_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ y, float* __restrict__ s_fin,
                int H, int S, int K, int V, long long u_sb) {
  __shared__ float sr[kL][kKP];   // r, then q = r e^{bprev}
  __shared__ float sk[kL][kKP];   // k, then kd = k e^{b_last - b}
  __shared__ float sb[kL][kKP];   // b
  __shared__ float sbp[kL][kKP];  // log w, then bprev
  __shared__ float sv[kL][kVS];
  __shared__ float sa[kL][kL + 1];
  __shared__ float ss[kKMax][kVS];  // this block's slice of the state
  __shared__ float su[kKMax];
  __shared__ float seb[kKMax];      // e^{b_last}

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.x * kVS;
  const long long rowK = (long long)H * K, rowV = (long long)H * V;  // stride of one token
  const long long baseK = (long long)b * S * rowK + (long long)h * K;
  const long long baseV = (long long)b * S * rowV + (long long)h * V;
  const float* rb = r + baseK;
  const float* kb = k + baseK;
  const float* wb = w + baseK;
  const float* vb = v + baseV;
  float* yb = y + baseV;

  for (int i = tid; i < K; i += kThreads) su[i] = u[(long long)b * u_sb + (long long)h * K + i];
  for (int i = tid; i < K * kVS; i += kThreads) ss[i / kVS][i % kVS] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < S; c0 += kL) {
    const int lc = min(kL, S - c0);
    // 1. stage the chunk
    for (int i = tid; i < kL * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      const bool in = t < lc;
      const long long off = (long long)(c0 + t) * rowK + kk;
      sr[t][kk] = in ? rb[off] : 0.f;
      sk[t][kk] = in ? kb[off] : 0.f;
      sbp[t][kk] = in ? logf(fmaxf(wb[off], 1e-38f)) : 0.f;
    }
    for (int i = tid; i < kL * kVS; i += kThreads) {
      const int t = i / kVS, j = i % kVS;
      sv[t][j] = (t < lc && v0 + j < V) ? vb[(long long)(c0 + t) * rowV + v0 + j] : 0.f;
    }
    __syncthreads();
    // 2. b = cumsum(log w) and bprev = b - log w along the chunk, per k
    for (int kk = tid; kk < K; kk += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < kL; ++t) {
        const float lw = sbp[t][kk];
        acc += lw;
        sb[t][kk] = acc;
        sbp[t][kk] = acc - lw;
      }
      seb[kk] = expf(acc);
    }
    __syncthreads();
    // 3. the [L, L] tile: decay-masked r_t . k_i below the diagonal, the
    //    bonus r_t . u . k_t on it, zero above
    {
      const int t = tid / kL, i = tid % kL;
      float a = 0.f;
      if (i < t) {
        for (int kk = 0; kk < K; ++kk)
          a += sr[t][kk] * sk[i][kk] * expf(fminf(sbp[t][kk] - sb[i][kk], 0.f));
      } else if (i == t) {
        for (int kk = 0; kk < K; ++kk) a += sr[t][kk] * su[kk] * sk[t][kk];
      }
      sa[t][i] = a;
    }
    __syncthreads();
    // 4. decayed receptance q = r e^{bprev}, decayed keys kd = k e^{b_last - b}
    for (int i = tid; i < kL * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      sr[t][kk] *= expf(sbp[t][kk]);
      sk[t][kk] *= expf(sb[kL - 1][kk] - sb[t][kk]);
    }
    __syncthreads();
    // 5. y = q S + A v
    {
      const int t = tid / kVS, j = tid % kVS;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) acc += sr[t][kk] * ss[kk][j];
      for (int i = 0; i <= t; ++i) acc += sa[t][i] * sv[i][j];
      if (t < lc && v0 + j < V) yb[(long long)(c0 + t) * rowV + v0 + j] = acc;
    }
    __syncthreads();
    // 6. S <- diag(e^{b_last}) S + kd^T v
    for (int i = tid; i < K * kVS; i += kThreads) {
      const int kk = i / kVS, j = i % kVS;
      float s = ss[kk][j] * seb[kk];
      for (int t = 0; t < kL; ++t) s += sk[t][kk] * sv[t][j];
      ss[kk][j] = s;
    }
    __syncthreads();
  }
  for (int i = tid; i < K * kVS; i += kThreads) {
    const int kk = i / kVS, j = i % kVS;
    if (v0 + j < V) s_fin[((long long)bh * K + kk) * V + v0 + j] = ss[kk][j];
  }
}

}  // namespace

// r, k, w [B, S, H, K], v [B, S, H, V], u [B, H, K] (batch stride u_sb),
// y [B, S, H, V], s_fin [B, H, K, V]; all f32. 1 <= K <= 128, V >= 1,
// B * H <= 65535. Launches on `stream`; returns the launch's cudaError_t.
extern "C" int rwkv_wkv_launch(const void* r, const void* k, const void* v, const void* w,
                               const void* u, void* y, void* s_fin, int B, int H, int S, int K,
                               int V, long long u_sb, void* stream) {
  dim3 grid((V + kVS - 1) / kVS, B * H);
  rwkv_wkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(s_fin), H, S, K, V, u_sb);
  return static_cast<int>(cudaGetLastError());
}
