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
// 1 - t^2), as in the straight-through estimators. The products are formed
// in the plain version's operation order, e.g. dzo = ((dh * tc) * so) *
// (1 - so), and the file is built with --fmad=false, so each rounds where a
// separate torch op rounds. c_prev is read in the dtype the forward stored
// the cell state in; the dc chain stays f32 (the reference's recorded
// deviation from autodiff through the fp16 cell), so dc_prev is f32.
//
// Bound: bytes. One thread per (b, j) reads the four gates of z, c_prev, dh
// and dc once and writes the four gates of dz (contiguous i|f|g|o, so no
// regrouping) and dc_prev once; neighbouring threads touch neighbouring j.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/lstm_cell/ops.py.

#include "lstm_cell_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename C>
__global__ void __launch_bounds__(kThreads)
lstm_cell_bwd_kernel(const float* __restrict__ z, const C* __restrict__ c_prev,
                     const float* __restrict__ dh, const float* __restrict__ dc,
                     float* __restrict__ dz, float* __restrict__ dc_prev, int B, int H,
                     int quantized) {
  __shared__ float grid[43];
  if (threadIdx.x < 43) grid[threadIdx.x] = kSigGrid[threadIdx.x];
  __syncthreads();

  const long long n = (long long)B * H;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int b = (int)(idx / H), j = (int)(idx % H);
  const float* zr = z + (size_t)b * 4 * H;
  const float zi = zr[j], zf = zr[H + j], zg = zr[2 * H + j], zo = zr[3 * H + j];

  // forward values, exactly as the forward kernel computed them
  const Gates a = gates(zi, zf, zg, zo, quantized, grid);
  const float cp = load(c_prev + idx);
  const float c = round_to<C>(cell_update(a, cp));
  const float tanh_c = tanhf(c);
  const float tc = quantized ? e5m2(tanh_c) : tanh_c;
  // smooth derivative factors
  const float si = sigmoid(zi), sf = sigmoid(zf), so = sigmoid(zo), tg = tanhf(zg);

  const float dhv = dh[idx], dcv = dc[idx];
  const float dzo = (dhv * tc) * so * (1.0f - so);
  const float dct = dcv + dhv * a.o * (1.0f - tanh_c * tanh_c);
  const float dzf = (dct * cp) * sf * (1.0f - sf);
  const float dzi = (dct * a.g) * si * (1.0f - si);
  const float dzg = (dct * a.i) * (1.0f - tg * tg);
  float* dzr = dz + (size_t)b * 4 * H;
  dzr[j] = dzi;
  dzr[H + j] = dzf;
  dzr[2 * H + j] = dzg;
  dzr[3 * H + j] = dzo;
  dc_prev[idx] = dct * a.f;
}

template <typename C>
void launch(const float* z, const void* c_prev, const float* dh, const float* dc, float* dz,
            float* dc_prev, int B, int H, int quantized, cudaStream_t s) {
  const long long n = (long long)B * H;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  lstm_cell_bwd_kernel<C><<<blocks, kThreads, 0, s>>>(
      z, static_cast<const C*>(c_prev), dh, dc, dz, dc_prev, B, H, quantized);
}

}  // namespace

// z [B, 4H] f32 (gate order i|f|g|o), c_prev [B, H] in the cell-state
// dtype (f16 when c_half, else f32), dh and dc [B, H] f32, dz [B, 4H] f32,
// dc_prev [B, H] f32; all contiguous. Launches on `stream`; returns the
// launch's cudaError_t as an int.
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
