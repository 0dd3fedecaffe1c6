"""Training CLI of the port: one of the paper's four tasks (the WikiText-2
LM by default; UDPOS, SNLI, Multi30K) under FloatSD8 weights, FP8
activations and gradients and an FP16 master copy, through the fused
quantized BPTT (counterpart of ``repro.launch.train``); ``--policy fp32``
trains the FP32 baseline through autodiff. On the card every LSTM gate
matmul, cell, cell backward, ``matmul_dx`` and ``matmul_dw`` of the fused
path runs a hand-written CUDA kernel.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5               # reduced, CPU
  PYTHONPATH=src python -m repro_torch.launch.train --task snli --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 20                    # paper width, GPU

Prints the reference's ``step N  loss L  scale S  finite F`` lines, a
closing ``trained N steps in ...`` line with the warm steps/s and tokens/s
(the first step is left out of both), and the dispatch record. With
``--ckpt-dir``, writes TrainState checkpoints that
``repro.distributed.checkpointing.restore`` reads.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch

from ..bridge import save_checkpoint
from ..core.policy import get_policy
from ..device import resolve_device
from ..kernels import dispatch as kd
from ..models.task_zoo import TASKS, make_task
from ..optim.train_state import batch_to_device, init_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="wikitext2", choices=TASKS)
    ap.add_argument("--full", action="store_true", help="the paper's width (Table III)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--policy", default="floatsd8_table6")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=None, help="default: the task's")
    ap.add_argument("--seed", type=int, default=0, help="seeds the parameter init")
    ap.add_argument("--ckpt-dir", default=None, help="write checkpoints here (default: none)")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dynamic-scale", action="store_true",
                    help="dynamic loss scaling: a nonfinite step skips the update and halves "
                    "the scale, 2000 finite steps double it (default: the static 1024)")
    return ap.parse_args(argv)


def describe(model) -> str:
    """The model's widths, from its fields."""
    return ", ".join(f"{f.name} {getattr(model, f.name)}" for f in dataclasses.fields(model))


def main(argv=None) -> dict:
    """Train; returns the per-step losses, finite flags and step times (s)
    and the final state."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    policy = get_policy(args.policy)
    model, data, opt, lr, _ = make_task(args.task, full=args.full)
    lr = args.lr or lr
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    state = init_state(params, opt, policy, dynamic_scale=args.dynamic_scale)
    step_fn = make_train_step(model.loss, opt, policy, lr=lr)
    first = next(data.batches)
    keys = data.token_keys
    tokens = sum(first[k].size for k in keys)
    shape = " + ".join(f"{k} {first[k].shape[0]} x {first[k].shape[1]}" for k in keys)
    print(f"model: {args.task} {type(model).__name__} ({describe(model)}) | policy {policy.name} | "
          f"{opt.name} lr {lr} | batch {shape} | {device}", flush=True)

    hist = collections.deque(maxlen=max(args.log_every, 1))
    out = {"losses": [], "finite": [], "step_s": [], "tokens_per_step": tokens}
    batch = first
    t_start = time.perf_counter()
    for step in range(1, args.steps + 1):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch_to_device(batch, device))
        loss = float(m["loss"])  # reads the device: the step has finished
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(loss)
        out["finite"].append(bool(m["grads_finite"]))
        hist.append(loss)
        if step % args.log_every == 0 or step == args.steps:
            print(f"step {step:5d}  loss {np.mean(hist):.4f}  scale {float(m['loss_scale']):.0f}  "
                  f"finite {out['finite'][-1]}", flush=True)
        if args.ckpt_dir and (step % args.save_every == 0 or step == args.steps):
            save_checkpoint(args.ckpt_dir, state, step)
        if step < args.steps:
            batch = next(data.batches)
    dt = time.perf_counter() - t_start
    warm = out["step_s"][1:]
    rate = (f"first step {out['step_s'][0]:.2f}s + {np.mean(warm):.4f}s/step warm "
            f"({len(warm) / sum(warm):.2f} steps/s, {tokens * len(warm) / sum(warm):.0f} tok/s)"
            if warm else f"{dt:.2f}s/step")
    print(f"trained {args.steps} steps in {dt:.1f}s ({rate}); nonfinite steps skipped: "
          f"{out['finite'].count(False)}", flush=True)
    print("dispatch: " + ", ".join(f"{o}/{b}={n}" for (o, b), n in sorted(kd.STATS.snapshot().items())),
          flush=True)
    out["state"] = state
    return out


if __name__ == "__main__":
    main()
