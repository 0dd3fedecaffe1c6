#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

  1. device     a CUDA device is present; prints nvidia-smi's name and
                power limit.
  2. build      builds both hand-written kernels from the checkout's
                sources (one nvcc per source, started together).
  3. kernels    each kernel against its plain PyTorch version on the card,
                at the serving path's shapes: error, mismatches, median
                time beside the plain version, the library call and the
                bound (bytes or operations over the card's peak rates).
  4. main path  the full-width WikiText-2 FloatSD8 LM (vocab 33278 padded
                to 33280, 1024 wide, 2 layers, tied embeddings, seeded
                random weights) packed to 1-byte codes and served by
                ServeEngine: 8 lanes, chunk 8, 16 requests, 16 new tokens
                each. Launch counters and dispatch records are zeroed just
                before and read just after; every gate matmul, head and
                cell must have run on the kernels, none on the plain path.
  5. cross      the same requests served with backend="ref" (the plain
                versions) on the card; greedy tokens must agree over each
                request's margin-decisive prefix.

The second-to-last line is nvidia-smi's name/power-limit line, the line
before it the kernels' JSON record, and the last line the result JSON.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
LANES, CHUNK, REQUESTS, MAX_NEW = 8, 8, 16, 16
MARGIN_FLOOR = 1e-5  # top-2 logit gap below which a greedy choice is a near-tie
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth, and
# FP32 FMA rate outside the tensor cores (both kernels run on the FP32 units)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations of one (b, j) of the cell: 3 gates x (exp, add, divide, 42
# compares, select) + 2 tanh + 2 e5m2 conversions + 3 multiplies + 1 add
CELL_OPS = 3 * 46 + 8
SPIN_CYCLES = 40_000_000  # ~20 ms of device time: longer than the host needs to enqueue a timing loop


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def bound(nbytes: float, ops: float) -> dict:
    """The least time for the work: bytes moved over the HBM rate, or the
    operations over the FP32 rate, whichever is larger (ms)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return dict(bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def timed_ms(torch, fn, reps: int, flush) -> float:
    """Median device time of one call, by CUDA events, with L2 flushed
    before each call (the serving path meets each weight cold). A spin
    kernel first keeps the device busy while the host enqueues the loop,
    so the host's launch overhead stays out of the events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in pairs:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_phase(torch, dev, flush):
    from repro_torch.core import floatsd
    from repro_torch.core.fp8 import FP16, quantize_fp8
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul
    from repro_torch.kernels.floatsd_matmul.ref import floatsd_matmul_ref, no_tf32
    from repro_torch.kernels.lstm_cell.ops import lstm_cell
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    mm = {}
    # (site, M, K, N, codes stored [N, K], activation quantizer): the gate
    # matmul (M = lanes, every time step; and at 64 rows), the tied head at
    # decode (M = lanes) and prefill (M = lanes * chunk), and a ragged shape
    shapes = [
        ("gate", 8, 1024, 4096, False, "fp8"),
        ("gate", 64, 1024, 4096, False, "fp8"),
        ("head", 8, 1024, 33280, True, "fp16"),
        ("head", 64, 1024, 33280, True, "fp16"),
        ("ragged", 3, 100, 130, False, None),
    ]
    print("kernels: floatsd_matmul vs plain version (tolerance |err| <= 1e-5 * (|x| @ |W|))")
    for site, m, k, n, tr, act in shapes:
        x = torch.randn((m, k), device=dev, generator=g)
        if act == "fp8":
            x = quantize_fp8(x)
        elif act == "fp16":
            x = quantize_fp8(x, FP16)
        w = torch.randn((n, k) if tr else (k, n), device=dev, generator=g) * (0.02 if tr else 0.03)
        codes, bias = floatsd.encode(w)
        bias = int(bias)
        wd = floatsd.decode(codes, bias)
        wk = wd.t() if tr else wd
        y = floatsd_matmul(x, codes, bias, transposed=tr)
        y_ref = floatsd_matmul_ref(x, codes, bias, transposed=tr)
        torch.cuda.synchronize()
        err = (y.double() - y_ref.double()).abs()
        tol = 1e-5 * (x.double().abs() @ wk.double().abs())
        check(bool((err <= tol + 1e-30).all()), f"floatsd_matmul {m}x{k}x{n} exceeds 1e-5")
        mism = int((y != y_ref).sum())
        with no_tf32():
            lib = lambda: torch.matmul(x, wk)  # noqa: E731 — the library yardstick
            t = timed_ms(torch, lambda: floatsd_matmul(x, codes, bias, transposed=tr), 20, flush)
            t_plain = timed_ms(torch, lambda: floatsd_matmul_ref(x, codes, bias, transposed=tr), 3, flush)
            t_lib = timed_ms(torch, lib, 20, flush)
        bd = bound(x.numel() * 4 + codes.numel() + 4 + m * n * 4, 2.0 * m * n * k)
        b_ms, b_by = bd["bound_ms"], bd["bound_by"]
        mm[(site, m)] = dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=float(err.max()), **bd)
        print(f"  {site:6s} [{m},{k}] x {'[N,K]^T' if tr else '[K,N]'} N={n}: max_abs_err {float(err.max()):.3e}, "
              f"{mism} of {m * n} not bit-identical | kernel {t:.4f} ms, plain {t_plain:.3f} ms, "
              f"torch.matmul {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    print("kernels: lstm_cell vs plain version (at most 0.1% flipped, |dh| <= 2^-3)")
    cell = {}
    for b, h in [(8, 1024), (5, 200)]:
        z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
        c = torch.randn((b, h), device=dev, generator=g).to(torch.float16)
        h_k, c_k = lstm_cell(z, c)
        h_r, c_r = lstm_cell_ref(z, c)
        torch.cuda.synchronize()
        flips = int(((h_k != h_r) | (c_k != c_r)).sum())
        err = max(float((h_k - h_r).abs().max()), float((c_k.float() - c_r.float()).abs().max()))
        check(flips <= 1e-3 * b * h and float((h_k - h_r).abs().max()) <= 2.0**-3,
              f"lstm_cell {b}x{h}: {flips} flips, max err {err}")
        t = timed_ms(torch, lambda: lstm_cell(z, c), 50, flush)
        t_plain = timed_ms(torch, lambda: lstm_cell_ref(z, c), 10, flush)
        bd = bound(b * 4 * h * 4 + b * h * 2 + b * h * 4 + b * h * 2, float(b * h * CELL_OPS))
        b_ms, b_by = bd["bound_ms"], bd["bound_by"]
        cell[(b, h)] = dict(ms=t, plain_ms=t_plain, err=err, **bd)
        print(f"  [{b},{4 * h}] -> h,c [{b},{h}]: max_abs_err {err:.3e}, {flips} of {b * h} flipped | "
              f"kernel {t:.4f} ms, plain {t_plain:.3f} ms, bound {b_ms:.5f} ms ({b_by})")
    return mm, cell


def serve(torch, model, params, policy, prompts, backend=None, step_times=None):
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(model, params, policy, lanes=LANES, chunk=CHUNK, backend=backend)
    reqs = eng.submit_all([p.copy() for p in prompts], max_new=MAX_NEW)
    eng.metrics.start()
    while True:
        decode_before = eng.metrics.decode_steps
        t0 = time.perf_counter()
        if not eng.step_once():  # ends in a device->host copy: synchronised
            break
        if step_times is not None and eng.metrics.decode_steps > decode_before:
            step_times.append(time.perf_counter() - t0)
    eng.metrics.stop()
    return eng, sorted(reqs, key=lambda r: r.rid)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repository (src/repro_torch missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import lstm_wikitext2
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import _build
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul
    from repro_torch.kernels.lstm_cell.ops import lstm_cell
    from repro_torch.models import build
    from repro_torch.serving import synthetic_prompts

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} x{torch.cuda.device_count()} | {smi} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s (sm_90a)", flush=True)
    for op in _build.KERNELS:
        for line in _build.build_log(op).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {op}: {line.strip()}")

    # 3. kernels against their plain versions
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)  # > 50 MB L2
    mm, cell = kernel_phase(torch, dev, flush)
    del flush

    # 4. the main path at full width
    cfg = lstm_wikitext2.CONFIG
    model = build(cfg)
    policy = get_policy("floatsd8_table6")
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    prompts = synthetic_prompts(REQUESTS, cfg.vocab, np.random.default_rng(SEED))
    check(model._vp() == 33280 and params["embed"]["table"].shape == (33280, 1024), "model width")
    kd.STATS.reset()
    floatsd_matmul.launches = 0
    lstm_cell.launches = 0
    decode_times: list[float] = []
    eng, reqs = serve(torch, model, params, policy, prompts, step_times=decode_times)
    launches = {"floatsd_matmul": floatsd_matmul.launches, "lstm_cell": lstm_cell.launches}
    stats = kd.STATS.snapshot()
    m = eng.metrics
    s = eng.store
    print(f"main path: weights {s.dense_nbytes / 2**20:.1f} MiB dense -> {s.packed_nbytes / 2**20:.1f} MiB "
          f"packed FloatSD8 ({s.n_packed} tensors); {m.format()}", flush=True)
    check(all(r.status == "done" and len(r.out) == MAX_NEW for r in reqs), "requests not all done")
    check(m.numeric_errors == 0, "nonfinite logits on the main path")
    positions = CHUNK * m.prefill_steps + m.decode_steps  # block width S, summed over steps
    want = {"floatsd_matmul": 2 * cfg.n_layers * positions + m.steps,
            "lstm_cell": cfg.n_layers * positions}
    check(launches == want, f"launches {launches} != expected {want}")
    check(stats.get(("floatsd_matmul", "cuda"), 0) == want["floatsd_matmul"]
          and stats.get(("lstm_cell", "cuda"), 0) == want["lstm_cell"]
          and sum(n for (_, b), n in stats.items() if b == "ref") == 0,
          f"dispatch records {stats}")
    step_ms = statistics.median(decode_times) * 1e3
    print(f"main path: {m.report()['gen_tok_per_s']:.1f} generated tok/s, "
          f"{m.report()['total_tok_per_s']:.1f} total tok/s, median decode step {step_ms:.3f} ms "
          f"over {len(decode_times)} steps ({LANES} lanes; {smi}); launches {launches}; "
          f"dispatch {dict((f'{o}/{b}', n) for (o, b), n in stats.items())}", flush=True)

    # 5. cross-check against the plain versions on the card
    _, refs = serve(torch, model, params, policy, prompts, backend="ref")
    decisive = agree = 0
    for r, ref in zip(reqs, refs):
        n = next((i for i, g in enumerate(ref.margins) if g <= MARGIN_FLOOR), MAX_NEW)
        check(r.out[:n] == ref.out[:n], f"request {r.rid}: {r.out} vs plain {ref.out} (decisive {n})")
        decisive += n
        agree += r.out == ref.out
    check(decisive >= REQUESTS * MAX_NEW // 2, f"only {decisive} decisive tokens")
    margins = np.array([g for ref in refs for g in ref.margins])
    print(f"cross-check: {decisive} of {REQUESTS * MAX_NEW} tokens margin-decisive (floor {MARGIN_FLOOR}) "
          f"and equal; {agree} of {REQUESTS} streams equal in full; top-2 margin median "
          f"{np.median(margins):.3e}, min {margins.min():.3e}", flush=True)

    # result lines
    gate, head = mm[("gate", 8)], mm[("head", 8)]
    c8 = cell[(8, 1024)]
    per_step = lambda key: 2 * cfg.n_layers * gate[key] + head[key]  # noqa: E731
    mm_bound = bound(0, 0)
    mm_bound.update(bytes_ms=per_step("bytes_ms"), ops_ms=per_step("ops_ms"))
    mm_bound.update(bound_ms=max(mm_bound["bytes_ms"], mm_bound["ops_ms"]),
                    bound_by="bytes" if mm_bound["bytes_ms"] >= mm_bound["ops_ms"] else "operations")
    record = {"kernels": [
        {"name": "floatsd_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/floatsd_matmul/floatsd_matmul.cu",
         "replaces": "src/repro/kernels/floatsd_matmul/kernel.py:34",
         "launches": launches["floatsd_matmul"],
         "max_abs_err": max(v["err"] for v in mm.values()),
         "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
         "bound_ms": mm_bound["bound_ms"], "bound_by": mm_bound["bound_by"],
         "library_ms": per_step("library_ms"),
         "per": "decode step at 8 lanes: 4 x [8,1024]@[1024,4096] + [8,1024]@[33280,1024]^T"},
        {"name": "lstm_cell", "route": "cuda",
         "source": "src/repro_torch/kernels/lstm_cell/lstm_cell.cu",
         "replaces": "src/repro/kernels/lstm_cell/kernel.py:45",
         "launches": launches["lstm_cell"],
         "max_abs_err": max(v["err"] for v in cell.values()),
         "ms": cfg.n_layers * c8["ms"], "plain_ms": cfg.n_layers * c8["plain_ms"],
         "bound_ms": cfg.n_layers * c8["bound_ms"], "bound_by": c8["bound_by"], "library_ms": None,
         "per": "decode step at 8 lanes: 2 x z [8,4096], c [8,1024] fp16"},
    ]}
    check(all(k["launches"] > 0 for k in record["kernels"]), "a kernel never launched on the main path")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
