#!/usr/bin/env python3
"""Paper Table IV on the port: the FP32 baseline against FloatSD8 (Table II)
and FloatSD8 with the FP16 master (Table VI) on the four LSTM tasks
(UDPOS, SNLI, Multi30K, WikiText-2).

Counterpart of ``benchmarks/table4_accuracy.py`` and of the ``train_task``
and ``evaluate`` of ``benchmarks/_trainers.py``: each (task, policy, seed)
trains from a seeded init through the port's train step (the fused
quantized BPTT under the FloatSD8 policies, autodiff under FP32), then
evaluates the task's metric (accuracy or perplexity) on held-out batches
with no gradient. The claim it checks is relative: the FloatSD8 rows track
the FP32 row's metric.

  PYTHONPATH=src python benchmarks_torch/table4_accuracy.py --device cpu --steps 20
  PYTHONPATH=src python benchmarks_torch/table4_accuracy.py --full --steps 200 --out chiprun_out/table4.json

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.task_zoo import TASKS, make_task  # noqa: E402
from repro_torch.optim.train_state import batch_to_device, init_state, make_train_step  # noqa: E402

POLICIES = ("fp32", "floatsd8_table2", "floatsd8_table6")


def evaluate(model, params, data, policy, metric: str, device, n_batches: int = 8) -> float:
    """Mean of the task's metric over ``n_batches`` held-out batches."""
    vals = []
    with torch.no_grad():
        for _ in range(n_batches):
            batch = batch_to_device(next(data.eval_batches), device)
            vals.append(float(getattr(model, metric)(params, batch, policy)))
    return float(np.mean(vals))


def train_task(task: str, policy_name: str, steps: int = 200, seed: int = 0, full: bool = False,
               device="cuda", policy_overrides: dict | None = None) -> dict:
    """Train one (task, policy, seed) from its seeded init and evaluate it.
    ``policy_overrides`` replaces fields of the named policy (Table V's
    activation settings); the row's policy name then ends in ``*``."""
    dev = resolve_device(device)
    model, data, opt, lr, metric = make_task(task, full)
    policy = get_policy(policy_name, **(policy_overrides or {}))
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    state = init_state(params, opt, policy)
    step_fn = make_train_step(model.loss, opt, policy, lr=lr)
    t0 = time.time()
    losses = []
    for _ in range(steps):
        state, m = step_fn(state, batch_to_device(next(data.batches), dev))
        losses.append(float(m["loss"]))
    train_s = time.time() - t0
    return {
        "task": task, "policy": policy.name if not policy_overrides else f"{policy.name}*",
        "metric": metric,
        "value": evaluate(model, state.params, data, policy, metric, dev),
        "loss_first10": float(np.mean(losses[:10])), "loss_last10": float(np.mean(losses[-10:])),
        "steps": steps, "train_s": round(train_s, 1),
    }


def run(tasks=TASKS, steps=200, full=False, device="cuda", out=None, seeds=(0,)) -> list[dict]:
    rows = []
    for task in tasks:
        for pol in POLICIES:
            for seed in seeds:
                r = train_task(task, pol, steps=steps, seed=seed, full=full, device=device)
                r["seed"] = seed
                rows.append(r)
                print(f"  {task:10s} {pol:18s} seed{seed} {r['metric']}={r['value']:.4f}  "
                      f"loss {r['loss_first10']:.3f}->{r['loss_last10']:.3f}  ({r['train_s']}s)", flush=True)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", nargs="*", default=list(TASKS), choices=TASKS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true", help="the paper's widths (Table III)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seeds", type=int, nargs="*", default=[0])
    ap.add_argument("--out", default="results/table4_accuracy.json")
    a = ap.parse_args(argv)
    print("Table IV on the port (FP32 vs FloatSD8 Table II vs Table VI):", flush=True)
    return run(a.tasks, a.steps, a.full, a.device, out=a.out, seeds=tuple(a.seeds))


if __name__ == "__main__":
    main()
