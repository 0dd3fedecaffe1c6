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
// Bound: bytes, 24 B a (b, j) with an fp16 cell: z[b, j], z[b, H + j],
// z[b, 2H + j], z[b, 3H + j] and c_prev[b, j] read once, h and c written
// once. At the train step's [64, 1024] that is 1.6 MB, well under one DRAM
// round trip of the whole card, so the time is latency: the loads' round
// trip, then the chain of sigmoids, LUT reads, tanhs and products before
// the stores. The design is the backward's (lstm_cell_bwd.cu):
//   * a block of 128 threads covers 128 columns of one row: the row is
//     blockIdx.x and the column block blockIdx.y, so the indices are 32-bit
//     and need no division;
//   * each thread issues its five loads before the LUT table is staged and
//     before any arithmetic;
//   * quantized is a template parameter: the smooth instantiation stages no
//     table;
//   * scalar loads and stores take any alignment and any H, so a
//     cs_prev[t] view at an odd fp16 offset and a ragged H need no path of
//     their own; neighbouring threads touch neighbouring j, so every access
//     is coalesced.
// The TPU kernel's gate regrouping is a tiling device and has no counterpart.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/lstm_cell/ops.py.

#include "lstm_cell_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename CIn, typename COut, bool Q>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const float* __restrict__ z, const CIn* __restrict__ c_prev,
                 float* __restrict__ h, COut* __restrict__ c_out, int H) {
  const int b = blockIdx.x;
  const int j = blockIdx.y * kThreads + threadIdx.x;
  const bool active = j < H;
  const size_t row = (size_t)b * H + j;
  const float* zr = z + (size_t)b * 4 * H + j;

  float zi = 0.f, zf = 0.f, zg = 0.f, zo = 0.f, cp = 0.f;
  if (active) {
    zi = zr[0];
    zf = zr[H];
    zg = zr[2 * H];
    zo = zr[3 * H];
    cp = load(c_prev + row);
  }
  __shared__ float table[Q ? kSigTable : 1];
  if (Q) {
    stage_sig_table<kThreads>(table);
    __syncthreads();
  }
  if (!active) return;

  const Gates a = gates(zi, zf, zg, zo, Q, table);
  const float c_stored = store(c_out + row, cell_update(a, cp));
  const float tc = Q ? e5m2(tanhf(c_stored)) : tanhf(c_stored);
  h[row] = __fmul_rn(a.o, tc);
}

template <typename CIn, typename COut>
void launch(const float* z, const void* c_prev, float* h, void* c_out, int B, int H,
            int quantized, cudaStream_t s) {
  const dim3 grid((unsigned)B, (unsigned)((H + kThreads - 1) / kThreads));
  const CIn* cp = static_cast<const CIn*>(c_prev);
  COut* co = static_cast<COut*>(c_out);
  if (quantized) {
    lstm_cell_kernel<CIn, COut, true><<<grid, kThreads, 0, s>>>(z, cp, h, co, H);
  } else {
    lstm_cell_kernel<CIn, COut, false><<<grid, kThreads, 0, s>>>(z, cp, h, co, H);
  }
}

}  // namespace

// z [B, 4H] f32 (gate order i|f|g|o), c_prev [B, H] f16 or f32, h [B, H]
// f32, c_out [B, H] f16 or f32; all contiguous, at any element alignment.
// Launches on `stream`; returns the launch's cudaError_t as an int.
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
