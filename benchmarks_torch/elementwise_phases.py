#!/usr/bin/env python3
"""Where the time of the port's element-wise kernels goes on one NVIDIA GPU:
the numbers ``chip_smoke.py`` does not print.

Run from the root of a checkout, on a machine with the card and the CUDA
toolkit:

    python3 benchmarks_torch/elementwise_phases.py

For ``qsigmoid`` at a zoo prefill gate ([2,1024,2560] f32),
``lstm_cell_grad`` and ``lstm_cell`` at the train step's [64,4096] (fp16
cell state, quantized) and ``floatsd_quantize`` at the tied embedding's
[33280,1024] (f32 and fp16) and a gate weight's [1024,4096] (f32) it prints:

  * each kernel's median time by CUDA events with L2 flushed before each
    call, and with L2 left warm, beside a copy kernel that moves the same
    bytes with the same thread mapping (the share of the time that is
    memory and occupancy, not arithmetic; for the quantize kernel a copy
    of 16-byte loads and stores that reads the input and writes a byte an
    element), the byte bound and the timing floor (the same timer around a
    one-element torch op);
  * the latency, in SM cycles, of one dependent call of each piece of the
    gate function on a single warp (clock64): sigma(-|z|) as the cell's
    header forms it, expf, the reciprocal, the IEEE divide, the header's
    LUT index, the whole quantized gate, tanhf, the e5m2 rounding, and a
    load that misses L2 (a pointer chase over 64 MiB).

ptxas's registers and spills and the SASS instructions an element are in
``chip_smoke.py``'s kernel rows. The last line is one JSON object with
every number. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER_DIR = ROOT / "src" / "repro_torch" / "kernels" / "lstm_cell"
BUILD_DIR = ROOT / "build" / "phases"
QSIG_SHAPE = (2, 1024, 2560)  # one receptance gate of the zoo's prefill
CELL_B, CELL_H = 64, 1024  # the train step's cell: z [64, 4096]
# the tied embedding in f32 and fp16 (the entry pass's largest master), and a
# gate weight in f32
QUANT_CASES = [("floatsd_quantize float32", (33280, 1024), "float32"),
               ("floatsd_quantize float16", (33280, 1024), "float16"),
               ("floatsd_quantize float32 gate weight", (1024, 4096), "float32")]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
REPS = 50
SPIN_CYCLES = 40_000_000  # device time that covers the host's enqueueing of a timing loop
LAT_ITERS = 4096
CHASE_WORDS = 16 * 2**20  # 64 MiB of int32: beyond the 50 MB L2

MICRO = r"""
#include <cstring>

#include "lstm_cell_common.cuh"

// One warp, every lane the same value: cycles of `iters` dependent calls
// of piece W.
template <int W>
__global__ void lat_kernel(int iters, const int* chase, long long* cycles, float* sink) {
  __shared__ float table[kSigTable];
  stage_sig_table<32>(table);
  __syncthreads();
  float v = 0.3f;
  int j = 0;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (W == 0) v = sigmoid(-fabsf(v));
    if (W == 1) v = expf(-v);
    if (W == 2) v = __frcp_rn(__fadd_rn(1.0f, v));
    if (W == 3) v = __fdiv_rn(1.0f, __fadd_rn(1.0f, v));
    if (W == 4) v = __fmul_rn(sig_lut(v, table), 0.9f);
    if (W == 5) v = qsigmoid(v, table);
    if (W == 6) v = tanhf(v);
    if (W == 7) v = e5m2(v);
    if (W == 8) j = chase[j];
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    sink[0] = v + (float)j;
  }
}

// qsigmoid.cu's mapping with no arithmetic: 16 B a thread, two vectors in
// flight, 132 x 8 blocks of 256 threads striding through the tensor.
__global__ void copy_vec_kernel(const float4* __restrict__ x, float4* __restrict__ y, long long nv) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nv; i += 2 * stride) {
    const float4 a = x[i];
    const bool two = i + stride < nv;
    float4 b;
    if (two) b = x[i + stride];
    y[i] = a;
    if (two) y[i + stride] = b;
  }
}

// lstm_cell_bwd.cu's bytes and mapping with no arithmetic: a block of 128
// threads a (row, column block), one column a thread.
__global__ void copy_cell_bwd_kernel(const float* __restrict__ z, const __half* __restrict__ c,
                                     const float* __restrict__ dh, const float* __restrict__ dc,
                                     float* __restrict__ dz, float* __restrict__ dcp, int H) {
  const int b = blockIdx.x, j = blockIdx.y * 128 + threadIdx.x;
  if (j >= H) return;
  const size_t row = (size_t)b * H + j;
  const float* zr = z + (size_t)b * 4 * H + j;
  float* dzr = dz + (size_t)b * 4 * H + j;
  const float zi = zr[0], zf = zr[H], zg = zr[2 * H], zo = zr[3 * H];
  const float cp = __half2float(c[row]), d = dh[row] + dc[row];
  dzr[0] = zi + cp;
  dzr[H] = zf;
  dzr[2 * H] = zg;
  dzr[3 * H] = zo;
  dcp[row] = d;
}

// lstm_cell.cu's bytes and mapping with no arithmetic: a block of 128
// threads a (row, column block), one column a thread; z's four gates and
// the fp16 c_prev in, h (f32) and c (fp16) out.
__global__ void copy_cell_kernel(const float* __restrict__ z, const __half* __restrict__ c,
                                 float* __restrict__ h, __half* __restrict__ c_out, int H) {
  const int b = blockIdx.x, j = blockIdx.y * 128 + threadIdx.x;
  if (j >= H) return;
  const size_t row = (size_t)b * H + j;
  const float* zr = z + (size_t)b * 4 * H + j;
  const float zi = zr[0], zf = zr[H], zg = zr[2 * H], zo = zr[3 * H];
  const float cp = __half2float(c[row]);
  h[row] = zi + zf + zg + zo;
  c_out[row] = __float2half_rn(cp);
}

// floatsd_quantize.cu's mapping with no arithmetic: groups of 16 elements,
// V 16-byte loads (V = 4 for f32, 2 for fp16) and one 16-byte store of a
// byte an element (xor of the group's words), the next group loaded before
// this one is stored, 132 x 8 blocks of 256 threads striding through it.
template <int V>
__global__ void copy_quant_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, long long groups) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint4 v[V];
  if (tid < groups) {
    for (int k = 0; k < V; ++k) v[k] = x[tid * V + k];
  }
  for (long long i = tid; i < groups; i += stride) {
    const long long next = i + stride;
    uint4 w[V];
    if (next < groups) {
      for (int k = 0; k < V; ++k) w[k] = x[next * V + k];
    }
    unsigned u[4 * V], o[4] = {0u, 0u, 0u, 0u};
    memcpy(u, v, sizeof(u));
    for (int k = 0; k < 4 * V; ++k) o[k / V] ^= u[k];
    y[i] = make_uint4(o[0], o[1], o[2], o[3]);
    for (int k = 0; k < V; ++k) v[k] = w[k];
  }
}

template <int W>
int lat(int iters, const void* chase, void* cycles, void* sink, cudaStream_t s) {
  lat_kernel<W><<<1, 32, 0, s>>>(iters, (const int*)chase, (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}

extern "C" int launch_lat(int what, int iters, const void* chase, void* cycles, void* sink, void* stream) {
  int (*fns[])(int, const void*, void*, void*, cudaStream_t) = {lat<0>, lat<1>, lat<2>, lat<3>, lat<4>,
                                                                 lat<5>, lat<6>, lat<7>, lat<8>};
  return fns[what](iters, chase, cycles, sink, (cudaStream_t)stream);
}
extern "C" int launch_copy_vec(const void* x, void* y, long long nv, void* stream) {
  copy_vec_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>((const float4*)x, (float4*)y, nv);
  return (int)cudaGetLastError();
}
extern "C" int launch_copy_cell(const void* z, const void* c, void* h, void* c_out, int B, int H, void* stream) {
  copy_cell_kernel<<<dim3(B, (H + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const __half*)c, (float*)h, (__half*)c_out, H);
  return (int)cudaGetLastError();
}
extern "C" int launch_copy_quant(const void* x, int x_half, void* y, long long n, void* stream) {
  const long long groups = n / 16, want = (groups + 255) / 256;
  const unsigned blocks = (unsigned)(want < 1 ? 1 : want < 132 * 8 ? want : 132 * 8);
  if (x_half) {
    copy_quant_kernel<2><<<blocks, 256, 0, (cudaStream_t)stream>>>((const uint4*)x, (uint4*)y, groups);
  } else {
    copy_quant_kernel<4><<<blocks, 256, 0, (cudaStream_t)stream>>>((const uint4*)x, (uint4*)y, groups);
  }
  return (int)cudaGetLastError();
}
extern "C" int launch_copy_cell_bwd(const void* z, const void* c, const void* dh, const void* dc, void* dz,
                                    void* dcp, int B, int H, void* stream) {
  copy_cell_bwd_kernel<<<dim3(B, (H + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const __half*)c, (const float*)dh, (const float*)dc, (float*)dz, (float*)dcp, H);
  return (int)cudaGetLastError();
}
"""

LAT_NAMES = ["sigma(-|z|) (expf, add, divide)", "expf", "reciprocal __frcp_rn(1 + v)", "divide __fdiv_rn(1, 1 + v)",
             "the header's LUT index and lookup", "the header's whole gate qsigmoid(z)", "tanhf", "e5m2 rounding",
             "a load that misses L2 (pointer chase)"]


def build_micro() -> ctypes.CDLL:
    """Compile MICRO against the cell's header, as the cell's kernels are
    built (sm_90a, --fmad=false)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else shutil.which("nvcc") or "nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    header = (HEADER_DIR / "lstm_cell_common.cuh").read_bytes()
    digest = hashlib.sha256(MICRO.encode() + header).hexdigest()[:12]
    src, lib = BUILD_DIR / f"micro-{digest}.cu", BUILD_DIR / f"libmicro-{digest}.so"
    if not lib.exists():
        src.write_text(MICRO)
        r = subprocess.run([nvcc, str(src), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                            "-shared", "-Xcompiler", "-fPIC", "--fmad=false", f"-I{HEADER_DIR}", "-o", str(lib)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"elementwise_phases: nvcc failed:\n{r.stdout}{r.stderr}")
    micro = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    micro.launch_lat.argtypes = [i, i, p, p, p, p]
    micro.launch_copy_vec.argtypes = [p, p, ll, p]
    micro.launch_copy_cell_bwd.argtypes = [p, p, p, p, p, p, i, i, p]
    micro.launch_copy_cell.argtypes = [p, p, p, p, i, i, p]
    micro.launch_copy_quant.argtypes = [p, i, p, ll, p]
    return micro


def timed_ms(torch, fn, flush) -> float:
    """Median device time of one call by CUDA events, with ``flush`` zeroed
    before each call (64 MiB empties the 50 MB L2; one element leaves it
    warm). A spin kernel first keeps the device busy while the host
    enqueues the loop, so the host's launch overhead stays out."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in pairs:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("elementwise_phases: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import floatsd
    from repro_torch.kernels.floatsd_quantize.ops import floatsd_quantize
    from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_cell_grad
    from repro_torch.kernels.qsigmoid.ops import qsigmoid

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"elementwise_phases: {smi}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    res = {"device": smi}
    micro = build_micro()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    cold = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    warm = torch.empty(1, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    # the SM clock under a spin: cycles a millisecond
    spin = 20_000_000
    clock_hz = spin / timed_ms(torch, lambda: torch.cuda._sleep(spin), cold) * 1e3
    one = torch.zeros(1, device=dev)
    res["clock_ghz"], res["floor_ms"] = clock_hz / 1e9, timed_ms(torch, lambda: torch.neg(one), cold)
    print(f"  SM clock under a spin {res['clock_ghz']:.3f} GHz; timing floor (one-element torch.neg) "
          f"{res['floor_ms']:.4f} ms")

    perm = torch.randperm(CHASE_WORDS, device=dev, generator=g)
    chase = torch.empty(CHASE_WORDS, dtype=torch.int32, device=dev)
    chase[perm] = torch.roll(perm, 1).to(torch.int32)  # one cycle through every word
    cyc, sink = torch.zeros(1, dtype=torch.int64, device=dev), torch.zeros(1, device=dev)
    res["latency_cycles"] = {}
    for what, name in enumerate(LAT_NAMES):
        iters = 512 if name.startswith("a load") else LAT_ITERS
        best = None
        for _ in range(3):
            cold.zero_()
            assert micro.launch_lat(what, iters, chase.data_ptr(), cyc.data_ptr(), sink.data_ptr(), stream()) == 0
            torch.cuda.synchronize()
            best = min(best or float("inf"), int(cyc.item()) / iters)
        res["latency_cycles"][name] = best
        print(f"  latency of one dependent call, {name}: {best:.1f} cycles")

    x = torch.randn(QSIG_SHAPE, device=dev, generator=g) * 4
    y = torch.empty_like(x)
    nv = x.numel() // 4
    copy = lambda: micro.launch_copy_vec(x.data_ptr(), y.data_ptr(), nv, stream())  # noqa: E731
    rows = {"kernel": timed_ms(torch, lambda: qsigmoid(x), cold), "copy": timed_ms(torch, copy, cold),
            "kernel, L2 warm": timed_ms(torch, lambda: qsigmoid(x), warm), "copy, L2 warm": timed_ms(torch, copy, warm)}
    res["qsigmoid"] = dict(shape=list(QSIG_SHAPE), bound_ms=x.numel() * 8 / HBM_BYTES_PER_S * 1e3, rows=rows)

    b, h = CELL_B, CELL_H
    z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
    c = torch.randn((b, h), device=dev, generator=g).to(torch.float16)
    dh, dc = (torch.randn((b, h), device=dev, generator=g) for _ in range(2))
    dz, dcp = torch.empty_like(z), torch.empty_like(dh)
    c_odd = torch.empty(b * h + 1, dtype=torch.float16, device=dev)[1:].view(b, h)  # an odd fp16 offset
    c_odd.copy_(c)
    copy = lambda: micro.launch_copy_cell_bwd(z.data_ptr(), c.data_ptr(), dh.data_ptr(), dc.data_ptr(),  # noqa: E731
                                              dz.data_ptr(), dcp.data_ptr(), b, h, stream())
    rows = {"kernel": timed_ms(torch, lambda: lstm_cell_grad(z, c, dh, dc), cold),
            "kernel, c_prev at an odd fp16 offset": timed_ms(torch, lambda: lstm_cell_grad(z, c_odd, dh, dc), cold),
            "kernel, not quantized": timed_ms(torch, lambda: lstm_cell_grad(z, c, dh, dc, quantized=False), cold),
            "copy": timed_ms(torch, copy, cold),
            "kernel, L2 warm": timed_ms(torch, lambda: lstm_cell_grad(z, c, dh, dc), warm),
            "copy, L2 warm": timed_ms(torch, copy, warm)}
    res["lstm_cell_bwd"] = dict(shape=[b, 4 * h], bound_ms=46.0 * b * h / HBM_BYTES_PER_S * 1e3, rows=rows)

    h_out, c_out = torch.empty_like(dh), torch.empty_like(c)
    copy = lambda: micro.launch_copy_cell(z.data_ptr(), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),  # noqa: E731
                                          b, h, stream())
    rows = {"kernel": timed_ms(torch, lambda: lstm_cell(z, c), cold),
            "kernel, c_prev at an odd fp16 offset": timed_ms(torch, lambda: lstm_cell(z, c_odd), cold),
            "kernel, not quantized": timed_ms(torch, lambda: lstm_cell(z, c, quantized=False), cold),
            "copy": timed_ms(torch, copy, cold),
            "kernel, L2 warm": timed_ms(torch, lambda: lstm_cell(z, c), warm),
            "copy, L2 warm": timed_ms(torch, copy, warm)}
    res["lstm_cell"] = dict(shape=[b, 4 * h], bound_ms=24.0 * b * h / HBM_BYTES_PER_S * 1e3, rows=rows)

    ops = ["qsigmoid", "lstm_cell_bwd", "lstm_cell"]
    for op, shape, dtype in QUANT_CASES:
        dt = getattr(torch, dtype)
        w = (torch.randn(shape, device=dev, generator=g) * 0.03).to(dt)
        bias = floatsd.fit_bias(w)  # a device int32: the kernel reads it in place
        out = torch.empty(w.numel(), dtype=torch.uint8, device=dev)
        copy = lambda: micro.launch_copy_quant(w.data_ptr(), int(dt == torch.float16),  # noqa: E731
                                               out.data_ptr(), w.numel(), stream())
        rows = {"kernel": timed_ms(torch, lambda: floatsd_quantize(w, bias), cold), "copy": timed_ms(torch, copy, cold),
                "kernel, L2 warm": timed_ms(torch, lambda: floatsd_quantize(w, bias), warm),
                "copy, L2 warm": timed_ms(torch, copy, warm)}
        res[op] = dict(shape=list(shape),
                       bound_ms=w.numel() * (w.element_size() + 1) / HBM_BYTES_PER_S * 1e3, rows=rows)
        ops.append(op)

    for op in ops:
        r = res[op]
        print(f"  {op} {r['shape']} (bound {r['bound_ms']:.5f} ms, bytes): "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in r["rows"].items()) + f"; timing floor {res['floor_ms']:.4f} ms")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
