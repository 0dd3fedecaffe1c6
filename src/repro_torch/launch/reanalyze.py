"""Recompute the derived terms of the dry run's JSONs from saved traces,
with no new trace. Run after the roofline's constants or the record's
fields change, so the whole table shares one accounting.

Counterpart of ``repro.launch.reanalyze``: the reference re-parses saved
HLO text; the port re-reads the ``StepCost`` a ``--save-trace`` run wrote
(``results/trace_torch/<arch>__<shape>__<mesh>.json.gz``) and rewrites the
FLOP, byte and collective fields, the roofline over ``HW`` and the useful
ratio of every ``"status": "ok"`` record it has a trace for.

  PYTHONPATH=src python -m repro_torch.launch.reanalyze --dir results/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from .dryrun import OUT, TRACE_DIR, analysis_fields, trace_path
from .step_analysis import StepCost


def reanalyze_record(rec: dict, trace_dir: str) -> bool:
    """Rewrite ``rec`` in place from its saved trace; False if it is not
    ok or has none."""
    path = trace_path(trace_dir, rec["arch"], rec["shape"], rec["mesh"])
    if rec.get("status") != "ok" or not os.path.exists(path):
        return False
    with gzip.open(path, "rt") as f:
        saved = json.load(f)
    shape, axes = saved.pop("mesh_shape"), saved.pop("mesh_axes")
    rec.update(analysis_fields(StepCost(**saved), rec["model_flops_per_device"], shape, axes))
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=OUT)
    ap.add_argument("--trace-dir", default=TRACE_DIR)
    a = ap.parse_args(argv)
    for path in sorted(glob.glob(os.path.join(a.dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if reanalyze_record(rec, a.trace_dir):
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            rf = rec["roofline"]
            print(f"{os.path.basename(path):50s} C={rf['compute_s'] * 1e3:9.1f}ms M={rf['memory_s'] * 1e3:9.1f}ms "
                  f"X={rf['collective_s'] * 1e3:9.1f}ms dom={rf['dominant']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
