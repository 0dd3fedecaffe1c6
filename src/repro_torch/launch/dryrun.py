"""Production-mesh dry run: trace one rank's program of every (arch x shape
x mesh) cell on fake tensors, and its roofline.

Counterpart of ``repro.launch.dryrun``. The reference lowers and compiles
each cell for 256 or 512 placeholder devices; the port opens a fake
process group of that many ranks in this process (``launch.mesh.
fake_group``: this process is rank 0, every collective returns at once),
builds the production mesh over it, and runs rank 0's share of the cell
(tensor parallelism over "model", FSDP over "data", the batch over "pod"
and "data") on fake tensors under ``launch.step_analysis``, which counts
its FLOPs, bytes, collectives and live memory. No device is needed.

A record has the reference's keys. ``memory``: the arguments' and
outputs' bytes exact from this rank's pieces, the temporaries as the
peak of live tensors made during the trace. ``roofline``: the compute,
memory and collective terms over ``launch.mesh.HW``'s H100 datasheet
constants (the collective term charges each mesh axis's wire bytes to
the link its groups cross, ``HW.link_bw``). ``useful_flops_ratio``: the
model FLOPs (6 / 2 / 2 x active parameters x tokens for train / prefill
/ decode, over the devices) over the traced FLOPs, as the reference
computes it. A cell of a family without ported tensor parallelism records
``"status": "error"`` with the reason, and the sweep goes on.

Usage (on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o_danube3_4b --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import time
import traceback

import torch

from .._tree import tree_leaves
from ..configs.base import ARCH_IDS, SHAPES, get_config
from ..distributed import sharding as shd
from ..models import build
from ..nn.module import SHAPES_ONLY
from .mesh import HW, fake_group, make_production_mesh, production_shape
from .specs import build_cell, piece_shape
from .step_analysis import NOT_APPLICABLE, analyze

__all__ = ["run_cell", "main", "count_active_params", "roofline", "model_flops", "analysis_fields", "trace_path"]

OUT = "results/dryrun_torch"
TRACE_DIR = "results/trace_torch"
#: what the port runs, the only values ``--remat`` and ``--attn-chunk`` take:
#: each trained stack group recomputed whole in the backward
#: (``torch.utils.checkpoint``), and the plain flash version's query chunk
REMAT = "full"
ATTN_CHUNK = 1024


def count_active_params(cfg, params_shape) -> tuple[int, int]:
    """(total, active) parameter counts; expert leaves scale by top_k/E.

    Expert weights are [E, d, h], or [L, E, d, h] when the stack holds
    them, so the expert dim may sit at axis 0 or 1."""
    total = active = 0
    for leaf in tree_leaves(params_shape):
        n = leaf.numel()
        total += n
        if cfg.n_experts and leaf.dim() >= 3 and cfg.n_experts in tuple(leaf.shape[:2]):
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n
    return int(total), int(active)


def model_flops(cfg, shape: str, n_dev: int) -> tuple[int, int, float]:
    """(total params, active params, the model FLOPs per device) of a cell."""
    total, active = count_active_params(cfg, build(cfg).init(SHAPES_ONLY))
    seq, gbatch, kind = SHAPES[shape]
    tokens = gbatch * (seq if kind != "decode" else 1)
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[kind]
    return total, active, mult * active * tokens / n_dev


def roofline(flops: float, nbytes: float, wire_by_axis: dict, mesh_shape: tuple, mesh_axes: tuple) -> dict:
    """The three terms over ``HW`` and the dominant one; the collective term
    charges each axis's wire bytes to its link (an explicit group's to
    the slowest link)."""
    compute_s = flops / HW.PEAK_FLOPS_BF16
    memory_s = nbytes / HW.HBM_BW
    coll_s = sum(v / (HW.link_bw(mesh_shape, mesh_axes, a) if a in mesh_axes else HW.IB_BW)
                 for a, v in wire_by_axis.items())
    dom = max(("compute", compute_s), ("memory", memory_s), ("collective", coll_s), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s, "dominant": dom}


def _nbytes_pieces(shardings, args) -> int:
    return sum(int(torch.Size(piece_shape(s, x.shape)).numel()) * x.element_size()
               for s, x in zip(tree_leaves(shardings, is_leaf=lambda s: isinstance(s, shd.NamedSharding)),
                               tree_leaves(args)))


def run_cell(arch: str, shape: str, multi_pod: bool = False, policy_name: str = "floatsd8_tpu",
             verbose: bool = True, mesh_shape: tuple | None = None, cfg=None, save_trace: bool = False) -> dict:
    """One cell's record. Opens the fake group of the mesh's size (this
    process must have no default group) unless one of that size is open.
    ``mesh_shape`` replaces the production shape (tests: a (2, 2) mesh);
    ``cfg`` the arch's config."""
    cfg = cfg or get_config(arch)
    shape_, axes = production_shape(multi_pod)
    if mesh_shape is not None:
        shape_ = tuple(mesh_shape)
    name = "x".join(map(str, shape_)) if not multi_pod else "pod" + "x".join(map(str, shape_))
    rec = {"arch": arch, "shape": shape, "mesh": name, "policy": policy_name}
    skip = cfg.skips(shape)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    n_dev = 1
    for d in shape_:
        n_dev *= d
    own = not torch.distributed.is_initialized()
    try:
        with fake_group(n_dev) if own else contextlib.nullcontext():
            mesh = make_production_mesh(multi_pod=multi_pod) if mesh_shape is None else _mesh(shape_, axes)
            t0 = time.time()
            cell = build_cell(arch, shape, mesh, policy_name=policy_name, cfg=cfg)
            t1 = time.time()
            hlo, out = analyze(cell.fn, make_args=lambda: cell.local_args())
            t2 = time.time()
            out_bytes = sum(t.nbytes for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        if save_trace:
            os.makedirs(TRACE_DIR, exist_ok=True)
            with gzip.open(trace_path(TRACE_DIR, arch, shape, name), "wt") as f:
                json.dump({"mesh_shape": list(shape_), "mesh_axes": list(axes), **dataclasses.asdict(hlo)}, f)
        seq, gbatch, kind = SHAPES[shape]
        total_p, active_p, mflops = model_flops(cfg, shape, n_dev)
        rec.update(
            status="ok",
            lower_s=round(t1 - t0, 2),
            compile_s=round(t2 - t1, 2),
            kind=kind,
            n_devices=n_dev,
            mesh_shape=list(shape_),
            mesh_axes=list(axes),
            memory={"argument_size_in_bytes": _nbytes_pieces(cell.in_shardings, cell.args),
                    "output_size_in_bytes": int(out_bytes),
                    "temp_size_in_bytes": int(hlo.peak_bytes)},
            xla_cost_analysis="not applicable: no XLA compile (the port's program is traced eagerly)",
            params_total=total_p,
            params_active=active_p,
            model_flops_per_device=mflops,
            **analysis_fields(hlo, mflops, shape_, axes),
            remat=REMAT,
            attn_chunk=ATTN_CHUNK,
        )
        rf = rec["roofline"]
        if verbose:
            print(f"[{name}] {arch:20s} {shape:12s} OK  trace={rec['compile_s']:7.1f}s  "
                  f"C={rf['compute_s'] * 1e3:8.2f}ms M={rf['memory_s'] * 1e3:8.2f}ms "
                  f"X={rf['collective_s'] * 1e3:8.2f}ms dom={rf['dominant']:10s} "
                  f"useful={rec['useful_flops_ratio']}", flush=True)
    except Exception as e:  # noqa: BLE001: record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[{name}] {arch:20s} {shape:12s} FAIL {rec['error'][:160]}", flush=True)
    return rec


def trace_path(trace_dir: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(trace_dir, f"{arch}__{shape}__{mesh}.json.gz")


def analysis_fields(hlo, mflops: float, mesh_shape: tuple, mesh_axes: tuple) -> dict:
    """The record's fields that follow from a trace's ``StepCost`` (what
    ``reanalyze`` recomputes from a saved trace)."""
    top = sorted(hlo.detail.items(), key=lambda kv: -kv[1])[:20]
    return dict(
        hlo_flops=hlo.flops,
        hlo_dot_flops=hlo.dot_flops,
        hlo_bytes=hlo.bytes_accessed,
        collective_wire_bytes=hlo.collective_bytes,
        collective_raw_bytes=hlo.collective_raw,
        collective_breakdown={k: float(v) for k, v in hlo.collective_breakdown.items()},
        collective_by_axis={k: float(v) for k, v in hlo.collective_by_axis.items()},
        collective_count=hlo.collective_count,
        unknown_while=NOT_APPLICABLE["unknown_while"],
        useful_flops_ratio=round(mflops / hlo.flops, 4) if hlo.flops else None,
        roofline=roofline(hlo.flops, hlo.bytes_accessed, hlo.collective_by_axis, tuple(mesh_shape),
                          tuple(mesh_axes)),
        roofline_flash=NOT_APPLICABLE["roofline_flash"],
        bytes_by_op={k: float(v) for k, v in sorted(hlo.bytes_by_op.items(), key=lambda kv: -kv[1])},
        top_bytes_instrs=[[k, float(v)] for k, v in top],
        kernel_sites=dict(hlo.kernel_sites),
        host_reads=list(hlo.host_reads),
    )


def _mesh(shape, axes):
    from .mesh import make_host_mesh

    return make_host_mesh(shape, axes[-len(shape):], "cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--policy", default="floatsd8_tpu")
    ap.add_argument("--remat", default=REMAT, choices=[REMAT],
                    help="the port recomputes each trained stack group whole (the reference's 'full')")
    ap.add_argument("--attn-chunk", type=int, default=ATTN_CHUNK, choices=[ATTN_CHUNK],
                    help="the plain flash version's query chunk; a kernel site is counted by its cost model")
    ap.add_argument("--save-trace", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"skip existing {tag}", flush=True)
                    continue
                rec = run_cell(arch, shape, multi_pod=mp, policy_name=args.policy, save_trace=args.save_trace)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
