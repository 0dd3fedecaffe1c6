// FloatSD8 quantization for Hopper (sm_90a): f32 or fp16 values -> uint8 codes
//     n     = min(|x| * 2^-bias, 576)          (576 = 4.5 * 2^7, the grid's top)
//     g     = #(grid midpoints < n)            (64 midpoints of the 65 grid values >= 0)
//     code  = (e[g] << 5) | midx[g]            for x >= 0 (+0 and -0 alike)
//           = (e[g] << 5) | (30 - midx[g])     for x < 0  (the mantissa set is symmetric)
//
// Replaces the TPU kernel src/repro/kernels/floatsd_quantize/kernel.py:32
// (quantize_kernel). Its plain version is core.floatsd.encode of the port
// (src/repro_torch/kernels/floatsd_quantize/ref.py), which it matches byte
// for byte on finite inputs: 2^-bias is built from exponent bits (the
// Pallas kernel's exp2 is not), and |x| * 2^-bias rounds exactly as the
// plain version's |x| / 2^bias (both are the one correctly rounded value
// of the same real number). A value exactly on a midpoint is not counted
// (ties go to the lower grid value), as in the plain version. NaN and inf
// have no code (the precondition of encode).
//
// The bias is read from a device int32 (fit_bias's output), so the caller
// never synchronises the host, and clamped to [-126, 120] as encode clamps
// it: every exponent e + bias, e in [0, 7], stays normal.
//
// Bound: bytes. One thread per element reads 2 or 4 bytes and writes 1;
// the 64 compares against midpoints in __constant__ memory (the same
// address for every thread: a broadcast) stay below the memory time.
// Consecutive threads touch consecutive elements; a grid-stride loop
// covers any length.
//
// Plain C interface; the wrapper is src/repro_torch/kernels/floatsd_quantize/ops.py.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Midpoints between consecutive non-negative FloatSD8 grid values at bias 0.
__constant__ float kMid[64] = {
    0.125f, 0.375f, 0.625f, 0.875f, 1.125f, 1.375f, 1.625f, 1.875f,
    2.125f, 2.375f, 2.75f, 3.25f, 3.625f, 3.875f, 4.125f, 4.375f,
    4.75f, 5.5f, 6.5f, 7.25f, 7.75f, 8.25f, 8.75f, 9.5f,
    11.0f, 13.0f, 14.5f, 15.5f, 16.5f, 17.5f, 19.0f, 22.0f,
    26.0f, 29.0f, 31.0f, 33.0f, 35.0f, 38.0f, 44.0f, 52.0f,
    58.0f, 62.0f, 66.0f, 70.0f, 76.0f, 88.0f, 104.0f, 116.0f,
    124.0f, 132.0f, 140.0f, 152.0f, 176.0f, 208.0f, 232.0f, 248.0f,
    264.0f, 280.0f, 304.0f, 384.0f, 464.0f, 496.0f, 528.0f, 560.0f};

// Code of each non-negative grid value: its smallest exponent e and the
// index of its mantissa, (e << 5) | midx.
__constant__ uint8_t kCode[65] = {
    15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 53, 26, 27, 28, 29,
    30, 57, 85, 58, 59, 60, 61, 62, 89, 117, 90, 91, 92, 93, 94, 121,
    149, 122, 123, 124, 125, 126, 153, 181, 154, 155, 156, 157, 158, 185, 213, 186,
    187, 188, 189, 190, 217, 245, 218, 219, 220, 221, 222, 249, 250, 251, 252, 253,
    254};

constexpr int kThreads = 256;
constexpr float kTop = 576.0f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __half* p) { return __half2float(*p); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const int* __restrict__ bias, uint8_t* __restrict__ codes,
                long long n) {
  const int b = min(max(*bias, -126), 120);
  const float inv_scale = __int_as_float((127 - b) << 23);  // 2^-bias, exact
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float v = load(x + i);
    const float a = fminf(__fmul_rn(fabsf(v), inv_scale), kTop);
    int g = 0;
#pragma unroll
    for (int j = 0; j < 64; ++j) g += a > kMid[j];
    const int c = kCode[g];
    codes[i] = (uint8_t)(v < 0.f ? (c & 0xE0) | (30 - (c & 31)) : c);
  }
}

}  // namespace

// x [n] f32 (x_half == 0) or fp16 (x_half != 0), bias one device int32,
// codes [n] uint8; all contiguous. Launches on `stream`; returns the
// launch's cudaError_t as an int.
extern "C" int floatsd_quantize_launch(const void* x, int x_half, const int* bias, uint8_t* codes,
                                       long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 132 * 64 ? want : 132 * 64);
  if (x_half) {
    quantize_kernel<__half><<<blocks, kThreads, 0, s>>>(static_cast<const __half*>(x), bias, codes, n);
  } else {
    quantize_kernel<float><<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x), bias, codes, n);
  }
  return static_cast<int>(cudaGetLastError());
}
