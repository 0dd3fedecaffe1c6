#!/usr/bin/env python3
"""What the training CLI's device mesh costs on one NVIDIA GPU: the
full-width WikiText-2 LM's train step (Table III: vocab 33280, 1024 wide, 2
layers, tied, ``floatsd8_table6``, B 64 x S 48, SGD 0.9, telemetry on, as
the CLI runs it) on the CLI's ("data", "model") mesh over an NCCL world of
one rank, against the unsharded step from the same state and batch.

Run from the root of a checkout, on a machine with the card and the CUDA
toolkit:

    python3 benchmarks_torch/mesh_overhead.py [--pairs 8] [--calls 100]

It prints one JSON line: the card's name and power limit; warm steps of
the two in ``--pairs`` alternating pairs (the meshed step first in even
pairs; host clock to a read of the loss), their medians and the median
pair difference; the same pairs with every collective of the mesh path
replaced by its one-rank identity (what the collectives themselves cost);
one step of each under ``torch.profiler``: the host's self time in all
and in the collectives' ops, and the device's busy time; and the host time
of ``--calls`` all-gathers and all-reduces of 4 MB alone. Imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--calls", type=int, default=100)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mesh_overhead: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.policy import get_policy
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.models.task_zoo import make_task
    from repro_torch.optim.train_state import batch_to_device, init_state, make_train_step, state_shardings

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    dev = torch.device("cuda")
    model, data, opt, lr, _ = make_task("wikitext2", full=True)
    policy = get_policy("floatsd8_table6")
    state = init_state(model.init(torch.Generator(device=dev).manual_seed(0)), opt, policy)
    batch = batch_to_device(next(data.batches), dev)
    step = make_train_step(model.loss, opt, policy, lr=lr, telemetry=True)

    def step_ms(fn, st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(fn(st, batch)[1]["loss"])  # a device->host copy: synchronised
        return (time.perf_counter() - t0) * 1e3

    def pairs(mstep, mstate):
        out = []
        for i in range(args.pairs):
            if i % 2 == 0:
                out.append((step_ms(mstep, mstate), step_ms(step, state)))
            else:
                u = step_ms(step, state)
                out.append((step_ms(mstep, mstate), u))
        return {"pairs_ms": out, "mesh_median_ms": statistics.median(p[0] for p in out),
                "unsharded_median_ms": statistics.median(p[1] for p in out),
                "median_difference_ms": statistics.median(a - b for a, b in out),
                "mesh_slower_in": sum(a > b for a, b in out)}

    def profiled(fn, st):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            float(fn(st, batch)[1]["loss"])
        ev = prof.key_averages()
        host = sum(e.self_cpu_time_total for e in ev) / 1e3
        comm = sum(e.self_cpu_time_total for e in ev if e.key.startswith(("c10d::", "record_param_comms"))) / 1e3
        busy = sum(e.self_device_time_total for e in ev
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
        return {"host_self_ms": host, "collective_ops_host_ms": comm, "device_busy_ms": busy}

    out = {"device": smi, "torch": torch.__version__}
    with train.process_group("cuda"):
        mesh = train.make_mesh_for_host()
        sh = state_shardings(model.specs(), state, mesh)
        mstep = make_train_step(model.loss, opt, policy, lr=lr, telemetry=True, shardings=sh)
        mstate = shd.shard_tree(state, sh)
        for _ in range(2):  # warm-up: the communicators, the allocator
            step_ms(mstep, mstate), step_ms(step, state)
        shd.COLLECTIVES.clear()
        step_ms(mstep, mstate)
        out["collectives_a_step"] = dict(shd.COLLECTIVES)
        out["with_collectives"] = pairs(mstep, mstate)
        out["profiled"] = {"mesh": profiled(mstep, mstate), "unsharded": profiled(step, state)}
        real = shd.all_gather, shd.all_reduce
        shd.all_gather = lambda x, dim, axes, mesh=None: x
        shd.all_reduce = lambda x, axes=None, mesh=None, op="sum", group=None: x.clone()
        try:
            out["collectives_as_identities"] = pairs(mstep, mstate)
        finally:
            shd.all_gather, shd.all_reduce = real
        x = torch.randn(1 << 20, device=dev)
        for name, fn in (("all_gather", lambda: shd.all_gather(x, 0, ("data",), mesh)),
                         ("all_reduce", lambda: shd.all_reduce(x, ("data",), mesh))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
            out[f"{name}_4MB_ms_a_call"] = (time.perf_counter() - t0) * 1e3 / args.calls
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
