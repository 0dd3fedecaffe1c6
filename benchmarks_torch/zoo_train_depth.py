#!/usr/bin/env python3
"""How deep the full-width zoo training step fits on one NVIDIA GPU: the
peak device memory of ``h2o_danube3_4b`` trained at its published width
(d_model 3840, 32 heads of 120 over 8, d_ff 10240, vocab 32000, window
4096) at several depths, the numbers behind ``chip_smoke.py``'s
``TRAIN_LAYERS``.

Run from the root of a checkout, on a machine with the card and the CUDA
toolkit:

    python3 benchmarks_torch/zoo_train_depth.py [--layers 10 11 12] [--steps 3]

For each depth it builds the model from seed 0, starts the train state
(the fp16 masters and Adam's f32 moments) and runs ``--steps`` steps of
``make_train_step`` at B 1 x S 8192 under ``floatsd8_table6`` with
telemetry on (as the training CLI runs), and prints one JSON line: the
parameters, the state's bytes, the peak ``max_memory_allocated`` (the
step's transient trees on top: the gradient, ``grad_quant``, unscale,
clip and update trees and the skip-select copies), the step times and the
flash-attention kernel's launches. A depth that does not fit prints its
out-of-memory peak and the script goes on. Imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[10, 11, 12])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seq", type=int, default=8192)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("zoo_train_depth: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import build
    from repro_torch.optim import adam
    from repro_torch.optim.train_state import init_state, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev, pol = torch.device("cuda"), get_policy("floatsd8_table6")
    for layers in args.layers:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(get_config("h2o_danube3_4b"), n_layers=layers)
        model, opt = build(cfg), adam()
        state = init_state(model.init(torch.Generator(device=dev).manual_seed(0)), opt, pol)
        n_params = sum(t.numel() for t in tree_leaves(state.params))
        torch.cuda.synchronize()
        state_bytes = torch.cuda.memory_allocated()
        step = make_train_step(model.loss, opt, pol, lr=1e-3, telemetry=True)
        g = torch.Generator(device=dev).manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab, (1, args.seq), device=dev, generator=g) for k in ("tokens", "labels")}
        flash_attention.launches = 0
        times, losses = [], []
        try:
            for _ in range(args.steps):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))  # a device->host copy: synchronised
                times.append(time.perf_counter() - t0)
            rec = {"layers": layers, "state_bytes": state_bytes, "peak_bytes": torch.cuda.max_memory_allocated(),
                   "step_s": times, "losses": losses, "flash_attention_launches": flash_attention.launches}
        except torch.OutOfMemoryError:
            rec = {"layers": layers, "state_bytes": state_bytes, "oom_at_peak_bytes": torch.cuda.max_memory_allocated()}
        rec["params"] = n_params
        print(json.dumps(rec), flush=True)
        del state, step, model
    return 0


if __name__ == "__main__":
    sys.exit(main())
