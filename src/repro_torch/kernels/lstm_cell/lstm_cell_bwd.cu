// Recompute-gates backward of the fused LSTM cell for Hopper (sm_90a):
//     (z [B, 4H], c_prev, dh, dc [B, H]) -> (dz [B, 4H] f32, dc_prev [B, H] f32)
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell/bwd.py:75
// (lstm_cell_bwd_kernel). Its plain version is lstm_cell_bwd_ref in
// src/repro_torch/kernels/lstm_cell/ref.py, a line-for-line port of
// src/repro/kernels/lstm_cell/bwd.py:41-72.
//
// Only (z, c_prev) survive the forward; everything else is recomputed here.
// The forward values (quantized gates, e5m2 g, the cell state rounded to its
// storage dtype, e5m2 tanh c) come from lstm_cell_common.cuh, the functions
// the forward kernel runs, so the recompute is the forward bit for bit. The
// derivative factors are the smooth ones (sigma' = s (1 - s), tanh' =
// 1 - t^2), as in the straight-through estimators: for z <= 0 the smooth
// sigma(z) is the quantizer's own sigma(-|z|), reused (qsigmoid_pair), and
// tanh(z_g) is formed once for both g and its factor. The products are
// formed in the plain version's operation order, e.g. dzo = ((dh * tc) *
// so) * (1 - so), and the file is built with --fmad=false, so each rounds
// where a separate torch op rounds. c_prev is read in the dtype the forward
// stored the cell state in; the dc chain stays f32 (the reference's
// recorded deviation from autodiff through the fp16 cell), so dc_prev is
// f32.
//
// Bound: bytes, 46 B a (b, j); at the train step's [64, 1024] that is 3 MB,
// about one DRAM round trip of the whole card, so the time is latency: the
// loads' round trip, then the chain of sigmoids, LUT reads, tanhs and
// products before the first store. The design shortens that chain and
// puts every load in flight at once:
//   * the LUT index is the header's O(1) bucket read;
//   * a block of 128 threads covers 128 columns of one row: the row is
//     blockIdx.x and the column block blockIdx.y, so the indices are 32-bit
//     and need no division;
//   * each thread issues all its loads (the four gates of z, c_prev, dh and
//     dc) before the LUT table is staged and before any arithmetic;
//   * scalar loads and stores take any alignment and any H, so a
//     cs_prev[t] view at an odd fp16 offset and a ragged H need no path of
//     their own.
// One column a thread was kept by measurement: on the H100 at [64, 4096],
// with 1, 2 and 4 consecutive columns a thread (float2/float4 loads), a
// launch took 0.0081-0.0084, 0.0084-0.0086 and 0.0096-0.0098 ms (PERF.md):
// at this size 4x the threads hide more of the chain than 4x the
// independent work in one thread does.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/lstm_cell/ops.py.

#include "lstm_cell_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename C, bool Q>
__global__ void __launch_bounds__(kThreads)
lstm_cell_bwd_kernel(const float* __restrict__ z, const C* __restrict__ c_prev,
                     const float* __restrict__ dh, const float* __restrict__ dc,
                     float* __restrict__ dz, float* __restrict__ dc_prev, int H) {
  const int b = blockIdx.x;
  const int j = blockIdx.y * kThreads + threadIdx.x;
  const bool active = j < H;
  const size_t row = (size_t)b * H + j;
  const float* zr = z + (size_t)b * 4 * H + j;

  float zi = 0.f, zf = 0.f, zg = 0.f, zo = 0.f, dhv = 0.f, dcv = 0.f, cp = 0.f;
  if (active) {
    zi = zr[0];
    zf = zr[H];
    zg = zr[2 * H];
    zo = zr[3 * H];
    dhv = dh[row];
    dcv = dc[row];
    cp = load(c_prev + row);
  }
  __shared__ float table[Q ? kSigTable : 1];
  if (Q) {
    stage_sig_table<kThreads>(table);
    __syncthreads();
  }
  if (!active) return;

  // forward values, exactly as the forward kernel computed them, and the
  // smooth derivative factors
  Gates a;
  float si, sf, so;
  const float tg = tanhf(zg);
  if (Q) {
    const GatePair pi = qsigmoid_pair(zi, table), pf = qsigmoid_pair(zf, table),
                   po = qsigmoid_pair(zo, table);
    a = {pi.q, pf.q, e5m2(tg), po.q};
    si = pi.s;
    sf = pf.s;
    so = po.s;
  } else {
    si = sigmoid(zi);
    sf = sigmoid(zf);
    so = sigmoid(zo);
    a = {si, sf, tg, so};
  }
  const float c = round_to<C>(cell_update(a, cp));
  const float tanh_c = tanhf(c);
  const float tc = Q ? e5m2(tanh_c) : tanh_c;

  const float dct = dcv + dhv * a.o * (1.0f - tanh_c * tanh_c);
  float* dzr = dz + (size_t)b * 4 * H + j;
  dzr[0] = (dct * a.g) * si * (1.0f - si);
  dzr[H] = (dct * cp) * sf * (1.0f - sf);
  dzr[2 * H] = (dct * a.i) * (1.0f - tg * tg);
  dzr[3 * H] = (dhv * tc) * so * (1.0f - so);
  dc_prev[row] = dct * a.f;
}

template <typename C>
void launch(const float* z, const void* c_prev, const float* dh, const float* dc, float* dz,
            float* dc_prev, int B, int H, int quantized, cudaStream_t s) {
  const dim3 grid((unsigned)B, (unsigned)((H + kThreads - 1) / kThreads));
  const C* cp = static_cast<const C*>(c_prev);
  if (quantized) {
    lstm_cell_bwd_kernel<C, true><<<grid, kThreads, 0, s>>>(z, cp, dh, dc, dz, dc_prev, H);
  } else {
    lstm_cell_bwd_kernel<C, false><<<grid, kThreads, 0, s>>>(z, cp, dh, dc, dz, dc_prev, H);
  }
}

}  // namespace

// z [B, 4H] f32 (gate order i|f|g|o), c_prev [B, H] in the cell-state
// dtype (f16 when c_half, else f32), dh and dc [B, H] f32, dz [B, 4H] f32,
// dc_prev [B, H] f32; all contiguous, at any element alignment. Launches on
// `stream`; returns the launch's cudaError_t as an int.
extern "C" int lstm_cell_bwd_launch(const float* z, const void* c_prev, const float* dh,
                                    const float* dc, float* dz, float* dc_prev, int c_half,
                                    int B, int H, int quantized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_half) {
    launch<__half>(z, c_prev, dh, dc, dz, dc_prev, B, H, quantized, s);
  } else {
    launch<float>(z, c_prev, dh, dc, dz, dc_prev, B, H, quantized, s);
  }
  return static_cast<int>(cudaGetLastError());
}
