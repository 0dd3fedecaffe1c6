// Fused LSTM gate/cell stage for Hopper (sm_90a), paper Eqs. 5-8:
//     i, f, o = two-region FloatSD8 sigmoid of z_i, z_f, z_o
//     g       = e5m2(tanh z_g)
//     c       = f * c_prev + i * g          stored in c's dtype (fp16 under Table VI)
//     h       = o * e5m2(tanh c)
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell/kernel.py:45
// (lstm_cell_kernel). Its plain version is
// src/repro_torch/kernels/lstm_cell/ref.py, and every step here rounds where
// that version rounds, so the two agree bit for bit: the gate values, the
// cell update and the fp16 rounding come from lstm_cell_common.cuh, which
// the backward (lstm_cell_bwd.cu) shares, and the file is built with
// --fmad=false so no product and sum are contracted into one FMA.
//
// Bound: bytes. Each thread owns one (b, j) and reads z[b, j], z[b, H + j],
// z[b, 2H + j], z[b, 3H + j] and c_prev[b, j] once and writes h and c once;
// neighbouring threads touch neighbouring j, so every access is coalesced.
// The TPU kernel's gate regrouping is a tiling device and has no counterpart.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/lstm_cell/ops.py.

#include "lstm_cell_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename CIn, typename COut>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const float* __restrict__ z, const CIn* __restrict__ c_prev,
                 float* __restrict__ h, COut* __restrict__ c_out, int B, int H, int quantized) {
  __shared__ float table[kSigTable];
  stage_sig_table(table);
  __syncthreads();

  const long long n = (long long)B * H;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int b = (int)(idx / H), j = (int)(idx % H);
  const float* zr = z + (size_t)b * 4 * H;
  const Gates a = gates(zr[j], zr[H + j], zr[2 * H + j], zr[3 * H + j], quantized, table);
  const float c_stored = store(c_out + idx, cell_update(a, load(c_prev + idx)));
  const float tc = quantized ? e5m2(tanhf(c_stored)) : tanhf(c_stored);
  h[idx] = __fmul_rn(a.o, tc);
}

template <typename CIn, typename COut>
void launch(const float* z, const void* c_prev, float* h, void* c_out, int B, int H,
            int quantized, cudaStream_t s) {
  const long long n = (long long)B * H;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  lstm_cell_kernel<CIn, COut><<<blocks, kThreads, 0, s>>>(
      z, static_cast<const CIn*>(c_prev), h, static_cast<COut*>(c_out), B, H, quantized);
}

}  // namespace

// z [B, 4H] f32 (gate order i|f|g|o), c_prev [B, H] f16 or f32, h [B, H]
// f32, c_out [B, H] f16 or f32; all contiguous. Launches on `stream`;
// returns the launch's cudaError_t as an int.
extern "C" int lstm_cell_launch(const float* z, const void* c_prev, int c_prev_half, float* h,
                                void* c_out, int c_out_half, int B, int H, int quantized,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_prev_half && c_out_half) {
    launch<__half, __half>(z, c_prev, h, c_out, B, H, quantized, s);
  } else if (c_prev_half) {
    launch<__half, float>(z, c_prev, h, c_out, B, H, quantized, s);
  } else if (c_out_half) {
    launch<float, __half>(z, c_prev, h, c_out, B, H, quantized, s);
  } else {
    launch<float, float>(z, c_prev, h, c_out, B, H, quantized, s);
  }
  return static_cast<int>(cudaGetLastError());
}
