"""Recompute params_active, model_flops_per_device and useful_flops_ratio
in the dry run's JSONs (parameter shapes on the meta device, no trace).
Needed when ``count_active_params`` changes after a sweep has run.

Counterpart of ``repro.launch.fix_useful``.

  PYTHONPATH=src python -m repro_torch.launch.fix_useful --dir results/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs.base import get_config
from .dryrun import OUT, model_flops


def fix_record(rec: dict) -> bool:
    """Rewrite ``rec``'s parameter counts and useful ratio in place; False
    if it is not ok."""
    if rec.get("status") != "ok":
        return False
    total, active, mflops = model_flops(get_config(rec["arch"]), rec["shape"], rec["n_devices"])
    rec["params_total"] = total
    rec["params_active"] = active
    rec["model_flops_per_device"] = mflops
    rec["useful_flops_ratio"] = round(mflops / rec["hlo_flops"], 4) if rec.get("hlo_flops") else None
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=OUT)
    a = ap.parse_args(argv)
    for path in sorted(glob.glob(os.path.join(a.dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        old = rec.get("useful_flops_ratio")
        if fix_record(rec):
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if old != rec["useful_flops_ratio"]:
                print(f"{path}: useful {old} -> {rec['useful_flops_ratio']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
