#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

  1. device     a CUDA device is present; prints nvidia-smi's name and
                power limit.
  2. build      builds every hand-written kernel from the checkout's
                sources (one nvcc per source, started together).
  3. kernels    each kernel against its plain PyTorch version on the card,
                at the serving and training paths' shapes: error,
                mismatches, median time beside the plain version, the
                library call and the bound (bytes or operations over the
                card's peak rates).
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
  6. train      the same full-width model trained through the training
                CLI's entry point (`repro_torch.launch.train --full`: B 64,
                S 48, sgd(0.9), lr 0.5, floatsd8_table6, static loss scale
                1024) for a few steps from a seeded init. Counters and
                dispatch records are zeroed before and read after: every
                forward matmul, cell, cell backward, matmul_dx and matmul_dw
                ran on its kernel, as often as the fused BPTT implies, none
                on the plain path; every loss is finite and no step was
                skipped. Then one more step under torch.profiler: device
                time by kernel, and the device's busy share of a step.
  7. train-x    the same init and batches trained with backend="ref" on
                the card: losses within 1e-3 relative at every step, and
                each trained master leaf within 1e-3 of its change (L2)
                from a second kernel-path run, whose losses must be
                bit-identical to the first's.

The second-to-last line is nvidia-smi's name/power-limit line, the line
before it the kernels' JSON record, and the last line the result JSON.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
LANES, CHUNK, REQUESTS, MAX_NEW = 8, 8, 16, 16
MARGIN_FLOOR = 1e-5  # top-2 logit gap below which a greedy choice is a near-tie
TRAIN_STEPS, XCHECK_STEPS = 5, 3  # the first train step is the warm-up
TRAIN_ARGS = ["--task", "wikitext2", "--full", "--log-every", "1", "--seed", str(SEED)]
LOSS_RTOL = 1e-3  # kernel vs plain losses: the JAX package's kernel-vs-reference bound
PARAM_RTOL = 1e-3  # kernel vs plain masters, per leaf, relative to the plain run's change
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth, and
# FP32 FMA rate outside the tensor cores (both kernels run on the FP32 units)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations of one (b, j) of the cell: 3 gates x (exp, add, divide, 42
# compares, select) + 2 tanh + 2 e5m2 conversions + 3 multiplies + 1 add
CELL_OPS = 3 * 46 + 8
# the backward recomputes that (146 ops), adds 3 smooth sigmoids and a tanh
# (10) and 22 multiplies and adds of the derivative products
CELL_BWD_OPS = 146 + 10 + 22
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
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul, matmul_dw, matmul_dx
    from repro_torch.kernels.floatsd_matmul.ref import (
        floatsd_matmul_ref, matmul_dw_ref, matmul_dx_ref, no_tf32,
    )
    from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_cell_grad
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_bwd_ref, lstm_cell_ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    mm = {}
    # (site, M, K, N, codes stored [N, K], activation quantizer): the gate
    # matmul (M = lanes, every time step; and at 64 rows, the training
    # batch), the tied head at decode (M = lanes) and prefill (M = lanes *
    # chunk), the training backward's recompute of all zs (M = S * B), and a
    # ragged shape
    shapes = [
        ("gate", 8, 1024, 4096, False, "fp8"),
        ("gate", 64, 1024, 4096, False, "fp8"),
        ("head", 8, 1024, 33280, True, "fp16"),
        ("head", 64, 1024, 33280, True, "fp16"),
        ("remat", 3072, 1024, 4096, False, "fp8"),
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
    for b, h in [(8, 1024), (64, 1024), (5, 200)]:
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

    print("kernels: matmul_dx (floatsd_matmul.cu on codes [K,N] read as [out, contraction]) vs plain "
          "version (tolerance |err| <= 1e-5 * (|g| @ |W|^T))")
    dx = {}
    for m, k, n in [(64, 1024, 4096), (3072, 1024, 4096)]:  # g [M, N], codes [K, N]
        gr = torch.randn((m, n), device=dev, generator=g) * 1e-2
        codes, bias = floatsd.encode(torch.randn((k, n), device=dev, generator=g) * 0.03)
        bias = int(bias)
        wd = floatsd.decode(codes, bias)
        y, y_ref = matmul_dx(gr, codes, bias), matmul_dx_ref(gr, codes, bias)
        torch.cuda.synchronize()
        err = (y.double() - y_ref.double()).abs()
        check(bool((err <= 1e-5 * (gr.double().abs() @ wd.double().abs().t()) + 1e-30).all()),
              f"matmul_dx {m}x{n} -> {k} exceeds 1e-5")
        mism = int((y != y_ref).sum())
        with no_tf32():
            t = timed_ms(torch, lambda: matmul_dx(gr, codes, bias), 20, flush)
            t_plain = timed_ms(torch, lambda: matmul_dx_ref(gr, codes, bias), 3, flush)
            t_lib = timed_ms(torch, lambda: torch.matmul(gr, wd.t()), 20, flush)
        bd = bound(gr.numel() * 4 + codes.numel() + 4 + m * k * 4, 2.0 * m * n * k)
        dx[m] = dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=float(err.max()), **bd)
        print(f"  [{m},{n}] x codes[{k},{n}]^T: max_abs_err {float(err.max()):.3e}, {mism} of {m * k} "
              f"not bit-identical | kernel {t:.4f} ms, plain {t_plain:.3f} ms, torch.matmul {t_lib:.4f} ms, "
              f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")

    print("kernels: matmul_dw vs plain version (quant=False: |err| <= 1e-5 * (|x|^T @ |g|); quant=True: "
          "at most 0.1% of outputs differ, each by at most one e5m2 step)")
    dw = {}
    m, k, n = 3072, 1024, 4096  # S*B rows; dWx and dWh at the full width
    x = quantize_fp8(torch.randn((m, k), device=dev, generator=g))
    gr = torch.randn((m, n), device=dev, generator=g) * 1e-2
    with no_tf32():
        t_lib = timed_ms(torch, lambda: torch.matmul(x.t(), gr), 10, flush)
    for quant in (True, False):
        y, y_ref = matmul_dw(x, gr, quant=quant), matmul_dw_ref(x, gr, quant)
        torch.cuda.synchronize()
        err = (y.double() - y_ref.double()).abs()
        off = y != y_ref
        if quant:
            step = torch.exp2(torch.floor(torch.log2(torch.maximum(y.abs(), y_ref.abs()).clamp(min=2.0**-14))) - 2)
            check(int(off.sum()) <= 1e-3 * y.numel() and bool((err[off] <= step[off]).all()),
                  f"matmul_dw quant: {int(off.sum())} outputs differ")
        else:
            check(bool((err <= 1e-5 * (x.double().abs().t() @ gr.double().abs()) + 1e-30).all()),
                  "matmul_dw exceeds 1e-5")
        t = timed_ms(torch, lambda: matmul_dw(x, gr, quant=quant), 10, flush)
        t_plain = timed_ms(torch, lambda: matmul_dw_ref(x, gr, quant), 3, flush)
        bd = bound(4.0 * (m * k + m * n + k * n), 2.0 * m * k * n)
        dw[quant] = dict(ms=t, plain_ms=t_plain, library_ms=t_lib, err=float(err.max()), **bd)
        print(f"  quant={quant} [{m},{k}]^T x [{m},{n}]: max_abs_err {float(err.max()):.3e}, {int(off.sum())} of "
              f"{k * n} not bit-identical | kernel {t:.4f} ms, plain {t_plain:.3f} ms, torch.matmul(x.t(), g) "
              f"(no FP8 snap) {t_lib:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")

    print("kernels: lstm_cell_grad vs plain version (bit for bit)")
    cell_bwd = {}
    for b, h in [(64, 1024), (5, 200)]:
        z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
        c = torch.randn((b, h), device=dev, generator=g).to(torch.float16)  # fp16 storage, as trained
        dh, dc = (torch.randn((b, h), device=dev, generator=g) for _ in range(2))
        dz, dcp = lstm_cell_grad(z, c, dh, dc)
        dz_r, dcp_r = lstm_cell_bwd_ref(z, c.float(), dh, dc)
        torch.cuda.synchronize()
        flips = int((dz != dz_r).sum()) + int((dcp != dcp_r).sum())
        err = max(float((dz - dz_r).abs().max()), float((dcp - dcp_r).abs().max()))
        check(flips == 0, f"lstm_cell_grad {b}x{h}: {flips} outputs differ, max err {err}")
        t = timed_ms(torch, lambda: lstm_cell_grad(z, c, dh, dc), 50, flush)
        t_plain = timed_ms(torch, lambda: lstm_cell_bwd_ref(z, c.float(), dh, dc), 10, flush)
        bd = bound(46.0 * b * h, float(b * h * CELL_BWD_OPS))
        cell_bwd[(b, h)] = dict(ms=t, plain_ms=t_plain, err=err, **bd)
        print(f"  [{b},{4 * h}] + 3 x [{b},{h}] -> dz, dc_prev: max_abs_err {err:.3e}, {flips} differ | "
              f"kernel {t:.4f} ms, plain {t_plain:.3f} ms, bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})")
    return mm, cell, dx, dw, cell_bwd


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


def composite(parts) -> dict:
    """Times and bound of a sequence of launches, from (count, row) pairs:
    the sums of count x each row's time, and the larger of the summed byte
    and operation bounds."""
    tot = lambda key: sum(n * r[key] for n, r in parts)  # noqa: E731
    lib = [r.get("library_ms") for _, r in parts]
    b, o = tot("bytes_ms"), tot("ops_ms")
    return {"ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": max(b, o),
            "bound_by": "bytes" if b >= o else "operations",
            "library_ms": None if None in lib else tot("library_ms")}


def train_counts(n_layers: int, seq: int) -> dict:
    """Kernel calls per training step of the fused BPTT, per the code: per
    layer, 2 gate matmuls a step + the backward's recompute pair, a cell
    and a cell backward a step, a matmul_dx a step + the batched dXs, and
    dWx + dWh."""
    L, S = n_layers, seq
    return {"floatsd_matmul": 2 * L * S + 2 * L, "lstm_cell": L * S, "lstm_cell_grad": L * S,
            "floatsd_matmul_dx": L * S + L, "floatsd_matmul_dw": 2 * L}


def profile_step(torch, step_fn, state, batch):
    """One train step under torch.profiler: device time (ms) and launches
    by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = step_fn(state, batch)
        float(m["loss"])
    names = [("floatsd_matmul_kernel<false", "floatsd_matmul"),
             ("floatsd_matmul_kernel<true", "floatsd_matmul_dx"),
             ("matmul_dw_kernel", "floatsd_matmul_dw"), ("lstm_cell_bwd_kernel", "lstm_cell_grad"),
             ("lstm_cell_kernel", "lstm_cell"), ("gemm", "library GEMM (tied head)")]
    groups = {g: [0.0, 0] for _, g in names + [("", "other torch ops")]}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        g = next((g for k, g in names if k in e.key.lower()), "other torch ops")
        groups[g][0] += e.self_device_time_total / 1e3
        groups[g][1] += e.count
    return groups


def train_phase(torch, smi):
    """Phases 6 and 7: the full-width model through the training CLI."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul, matmul_dw, matmul_dx
    from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_cell_grad
    from repro_torch.launch import train
    from repro_torch.models.task_zoo import make_task
    from repro_torch.optim.train_state import batch_to_device, init_state, make_train_step

    wrappers = {"floatsd_matmul": floatsd_matmul, "floatsd_matmul_dx": matmul_dx,
                "floatsd_matmul_dw": matmul_dw, "lstm_cell": lstm_cell, "lstm_cell_grad": lstm_cell_grad}
    kd.STATS.reset()
    for w in wrappers.values():
        w.launches = 0
    out = train.main([*TRAIN_ARGS, "--steps", str(TRAIN_STEPS)])
    launches = {op: w.launches for op, w in wrappers.items()}
    stats = kd.STATS.snapshot()
    model, data, opt, lr, _ = make_task("wikitext2", full=True)
    batch = next(data.batches)
    want = {op: TRAIN_STEPS * n
            for op, n in train_counts(model.n_layers, batch["tokens"].shape[1]).items()}
    check(launches == want, f"train launches {launches} != expected {want}")
    check(all(stats.get((op, "cuda"), 0) == n for op, n in want.items())
          and sum(n for (_, b), n in stats.items() if b == "ref") == 0, f"train dispatch records {stats}")
    check(all(math.isfinite(v) for v in out["losses"]), f"nonfinite train loss {out['losses']}")
    check(all(out["finite"]), f"a train step was skipped: grads_finite {out['finite']}")
    warm = out["step_s"][1:]
    step_ms = statistics.median(warm) * 1e3
    tok_s = out["tokens_per_step"] / statistics.median(warm)
    print(f"train: {TRAIN_STEPS} steps (first excluded as warm-up): median step {step_ms:.2f} ms, "
          f"{tok_s:.0f} tok/s ({smi}); losses {out['losses']}; launches {launches}", flush=True)

    # one more step under the profiler: where the device time goes
    step_fn = make_train_step(model.loss, opt, get_policy("floatsd8_table6"), lr=lr)
    groups = profile_step(torch, step_fn, out["state"], batch_to_device(batch, "cuda"))
    busy = sum(ms for ms, _ in groups.values())
    print(f"train step device time (torch.profiler, one warm step): busy {busy:.2f} ms of the "
          f"{step_ms:.2f} ms median step (idle share {max(0.0, 1 - busy / step_ms):.1%}) in "
          f"{sum(n for _, n in groups.values())} device operations; "
          + ", ".join(f"{k} {ms:.3f} ms ({n})" for k, (ms, n) in groups.items()), flush=True)

    # 7. the same init and batches on the plain versions, then the kernels again
    with kd.use_backend("ref"):
        ref = train.main([*TRAIN_ARGS, "--steps", str(XCHECK_STEPS)])
    rel = [abs(a - b) / abs(b) for a, b in zip(out["losses"], ref["losses"])]
    check(max(rel) <= LOSS_RTOL, f"kernel vs plain losses differ by {rel} relative")
    again = train.main([*TRAIN_ARGS, "--steps", str(XCHECK_STEPS)])
    check(again["losses"] == out["losses"][:XCHECK_STEPS],
          f"two kernel runs differ: {again['losses']} vs {out['losses'][:XCHECK_STEPS]}")
    # the loss barely moves in a few steps, so the trained masters are held
    # too: each leaf's kernel-vs-plain distance against its plain change
    init = init_state(model.init(torch.Generator(device="cuda").manual_seed(SEED)), opt,
                      get_policy("floatsd8_table6")).params
    drift = {}
    for mod, leaves in ref["state"].params.items():
        for name, p_ref in leaves.items():
            p_ref, p_k = p_ref.float(), again["state"].params[mod][name].float()
            moved = float(torch.linalg.vector_norm(p_ref - init[mod][name].float()))
            drift[f"{mod}/{name}"] = float(torch.linalg.vector_norm(p_k - p_ref)) / max(moved, 1e-30)
            check(moved > 0 and drift[f"{mod}/{name}"] <= PARAM_RTOL,
                  f"{mod}/{name}: kernel vs plain masters {drift[f'{mod}/{name}']:.3e} of their change "
                  f"{moved:.3e} (bound {PARAM_RTOL})")
    print(f"train cross-check: {XCHECK_STEPS} steps, kernel vs plain losses within {max(rel):.3e} relative "
          f"(bound {LOSS_RTOL}); plain {ref['losses']}; masters within {max(drift.values()):.3e} of their "
          f"change (bound {PARAM_RTOL}; per leaf {drift}); a second kernel run bit-identical; plain step "
          f"{statistics.median(ref['step_s']):.2f} s", flush=True)
    return dict(launches=launches, step_ms=step_ms, tok_s=tok_s, groups=groups, busy_ms=busy)


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
    mm, cell, dx, dw, cell_bwd = kernel_phase(torch, dev, flush)
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

    # 6-7. training
    tr = train_phase(torch, smi)

    # result lines: each kernel's time per decode step (serving) or per train
    # step, from the kernel phase's per-launch times and the launch counts
    # of each path
    L, S = cfg.n_layers, 48
    serve_mm = [(2 * L, mm[("gate", 8)]), (1, mm[("head", 8)])]
    train_mm = [(2 * L * S, mm[("gate", 64)]), (2 * L, mm[("remat", 3072)])]
    entries = [
        ("floatsd_matmul", "floatsd_matmul/floatsd_matmul.cu", "floatsd_matmul/kernel.py:34",
         mm.values(), serve_mm,
         "decode step at 8 lanes: 4 x [8,1024]@[1024,4096] + [8,1024]@[33280,1024]^T",
         train_mm, "train step: 192 x [64,1024]@[1024,4096] + 4 x [3072,1024]@[1024,4096]"),
        ("lstm_cell", "lstm_cell/lstm_cell.cu", "lstm_cell/kernel.py:45", cell.values(),
         [(L, cell[(8, 1024)])], "decode step at 8 lanes: 2 x z [8,4096], c [8,1024] fp16",
         [(L * S, cell[(64, 1024)])], "train step: 96 x z [64,4096], c [64,1024] fp16"),
        ("floatsd_matmul_dx", "floatsd_matmul/floatsd_matmul.cu", "floatsd_matmul/bwd.py:48",
         dx.values(), None, None, [(L * S, dx[64]), (L, dx[3072])],
         "train step: 96 x [64,4096]@codes[1024,4096]^T + 2 x [3072,4096]@codes[1024,4096]^T"),
        ("floatsd_matmul_dw", "floatsd_matmul/floatsd_matmul_dw.cu", "floatsd_matmul/bwd.py:74",
         dw.values(), None, None, [(2 * L, dw[True])],
         "train step: 4 x e5m2([3072,1024]^T @ [3072,4096]); library: torch.matmul(x.t(), g), no snap"),
        ("lstm_cell_grad", "lstm_cell/lstm_cell_bwd.cu", "lstm_cell/bwd.py:75", cell_bwd.values(),
         None, None, [(L * S, cell_bwd[(64, 1024)])],
         "train step: 96 x z [64,4096], c_prev/dh/dc [64,1024] -> dz, dc_prev"),
    ]
    record = {"kernels": []}
    for name, src, repl, rows, serve_parts, serve_per, train_parts, train_per in entries:
        n_serve, n_train = launches.get(name, 0), tr["launches"][name]
        parts, per = (serve_parts, serve_per) if serve_parts else (train_parts, train_per)
        rec = {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/{src}",
               "replaces": f"src/repro/kernels/{repl}", "launches": n_serve + n_train,
               "launches_by_path": {"serve": n_serve, "train": n_train},
               "max_abs_err": max(v["err"] for v in rows), **composite(parts), "per": per}
        if serve_parts:
            rec["train_step"] = {**composite(train_parts), "per": train_per}
        record["kernels"].append(rec)
    check(all(k["launches"] > 0 for k in record["kernels"]), "a kernel never launched on the main path")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
