#!/usr/bin/env python3
"""Paper Table V on the port: the WikiText-2 activation-precision ablation.

Counterpart of ``benchmarks/table5_ablation.py``: five (first layer, last
layer, other layers) activation settings of the LM under the Table II
scheme (``floatsd8_table2``, FP32 master), each trained from its seeded
init through the port's train step (the fused quantized BPTT; the hidden
activations at the "other" setting, so the (fp16, fp16, fp16) row runs the
engine with FP16 activations and activation gradients) and evaluated for
perplexity on held-out batches. The paper's finding: the last layer's
activation precision dominates (an FP8 last layer hurts; an FP16 one
recovers the baseline with FP8 everywhere else).

  PYTHONPATH=src python benchmarks_torch/table5_ablation.py --device cpu --steps 2
  python3 benchmarks_torch/table5_ablation.py --full --steps 200 --out results/table5_full.json

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from table4_accuracy import train_task  # noqa: E402

# (first, last, other), in the paper's row order
SETTINGS = [
    ("fp8", "fp8", "fp8"),
    ("fp16", "fp16", "fp16"),
    ("fp8", "fp16", "fp8"),
    ("fp16", "fp8", "fp8"),
    ("fp16", "fp16", "fp8"),
]


def run(steps=200, full=False, device="cuda", out=None, seed=0) -> list[dict]:
    rows = []
    for first, last, other in SETTINGS:
        overrides = {"first_layer_act": first, "last_layer_act": last, "act_fwd": other,
                     "act_bwd": other}
        r = train_task("wikitext2", "floatsd8_table2", steps=steps, seed=seed, full=full, device=device,
                       policy_overrides=overrides)
        r.update(first=first, last=last, other=other)
        rows.append(r)
        print(f"  first={first:5s} last={last:5s} other={other:5s} ppl={r['value']:.3f}  "
              f"loss {r['loss_first10']:.3f}->{r['loss_last10']:.3f}  ({r['train_s']}s)", flush=True)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true", help="the paper's width (Table III)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/table5_ablation.json")
    a = ap.parse_args(argv)
    print("Table V on the port (WikiText-2 activation-precision ablation):", flush=True)
    return run(a.steps, a.full, a.device, out=a.out, seed=a.seed)


if __name__ == "__main__":
    main()
