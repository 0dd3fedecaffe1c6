"""Analytical kernel cost model: the op/byte ledger of the dispatch layer.

Counterpart of ``repro.obs.costmodel``, for the port's CUDA kernels. Each
kernel package has a ``cost.py`` with a closed-form model of its FLOPs,
device-memory bytes read and written and shared-memory working set as
functions of the call's shape, and ``kernels/dispatch.py`` holds one
:class:`CostSpec` per op. Every dispatched call records a :class:`Cost`
with its Decision, and :class:`CostLedger` joins the predicted side
(accumulated in ``dispatch.STATS``, one entry a call) with the measured
side (wall time fed by ``chip_smoke.py``'s kernel phase through
``STATS.add_time``, and the bytes of the tensors each call really handed
over) into one row per ``(op, backend)``.

Model conventions:

  * **Device-memory bytes count operands and results only**: packed
    FloatSD8 codes are 1 byte a weight, and intermediates of a plain version
    (its decode of the codes, score matrices) are excluded. On the **ref
    backend the model is exact**: predicted read + write bytes equal the
    ``numel() * element_size()`` of the tensors the dispatch handed to the
    plain version plus its outputs (tested, tolerance 0).
  * **cuda traffic follows the launch that runs**: an operand tile is
    charged once per block that fetches it (the matmuls' x once per column
    block, their codes once per row block), and a kernel's device scratch
    (split-K partials, route B's bf16 pieces of x, the pre-passes' records
    of ``rwkv_wkv`` and ``flash_attention``) once written and once per block
    that reads it back. Every port kernel bounds-checks its tiles, so
    nothing is padded: ``pad_waste_bytes`` is 0, and ``pad_waste_flops``
    is the work a kernel issues outside the function (a tile's rows or
    columns past the matrix, flash's masked pairs in the tiles it visits).
  * **FLOPs are model constants, not measurements**: 2 FLOPs a MAC plus
    documented per-element constants for the LUT and transcendental work.
    ``macs`` is a field of its own because the paper's Table 7 argues in
    MACs (``benchmarks/table7_mac.py`` and this model agree, tested).
  * **Shared memory** (``smem_bytes``) is the peak a block of the call's
    kernels holds, static plus dynamic (the reference's ``vmem_bytes``,
    the per-grid-step VMEM working set, has no counterpart on the card).
    0 on ref.
  * **Per execution**: the port runs eagerly, so a Decision is recorded at
    every call and ``calls`` counts executions (the reference records at
    trace time under ``jax.jit``).

Stdlib only: the serving scrape path reads the ledger host-side.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Optional

__all__ = ["Cost", "CostSpec", "CostLedger", "merge_costs", "ZERO_COST"]


@dataclasses.dataclass(frozen=True)
class Cost:
    """Predicted cost of one op call (or a sum of calls; ``smem_bytes``
    merges as a max: it is a per-block peak, not a flow)."""

    flops: int = 0  # total floating-point ops (2 a MAC + model constants)
    macs: int = 0  # multiply-accumulates (the paper's Table-7 unit)
    hbm_read_bytes: int = 0  # operand traffic, per fetching block on cuda
    hbm_write_bytes: int = 0  # result (and scratch) traffic
    smem_bytes: int = 0  # peak shared memory of a block, static + dynamic (0 on ref)
    pad_waste_flops: int = 0  # flops a kernel issues outside the function
    pad_waste_bytes: int = 0  # padded bytes beyond the exact shape (0: nothing is padded)

    @property
    def hbm_bytes(self) -> int:
        return self.hbm_read_bytes + self.hbm_write_bytes

    @property
    def arithmetic_intensity(self) -> float:
        """FLOPs per device-memory byte: the roofline x-coordinate."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return merge_costs(self, other)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "macs": self.macs, "hbm_read_bytes": self.hbm_read_bytes,
            "hbm_write_bytes": self.hbm_write_bytes, "smem_bytes": self.smem_bytes,
            "pad_waste_flops": self.pad_waste_flops, "pad_waste_bytes": self.pad_waste_bytes,
            "hbm_bytes": self.hbm_bytes, "arithmetic_intensity": self.arithmetic_intensity,
        }


ZERO_COST = Cost()


def merge_costs(a: Cost, b: Cost) -> Cost:
    """Accumulate two costs: flows sum, the shared-memory peak takes the max."""
    return Cost(
        flops=a.flops + b.flops,
        macs=a.macs + b.macs,
        hbm_read_bytes=a.hbm_read_bytes + b.hbm_read_bytes,
        hbm_write_bytes=a.hbm_write_bytes + b.hbm_write_bytes,
        smem_bytes=max(a.smem_bytes, b.smem_bytes),
        pad_waste_flops=a.pad_waste_flops + b.pad_waste_flops,
        pad_waste_bytes=a.pad_waste_bytes + b.pad_waste_bytes,
    )


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """The cost model of one dispatched op.

    ``fn`` is the package's cost function (``kernels/<package>/cost.py``):
    shape dims plus ``backend=`` ("ref" or "cuda") and the op's options,
    returning a :class:`Cost`. ``notes`` states the model's assumptions
    (revisit factors, per-element FLOP constants) for the ledger's reader."""

    op: str
    fn: Callable[..., Cost]
    notes: str = ""


class CostLedger:
    """Joins the predicted (dispatch-time) and measured costs per ``(op,
    backend)``.

    The predicted side accumulates in the stats sink at every call; the
    measured side is optional: per-op wall time is only honest at kernel
    granularity, so ``chip_smoke.py``'s kernel phase feeds it through
    ``STATS.add_time``, while the serving ledgers carry the predicted
    columns and the touched-bytes cross-check only."""

    def __init__(self, stats: Any):
        self._stats = stats  # duck-typed: DispatchStats-shaped

    # -- joined rows ------------------------------------------------------
    def rows(self) -> list[dict]:
        """One dict per (op, backend), sorted, with predicted totals,
        touched-byte cross-check, and measured wall-time when present."""
        snap = self._stats.cost_snapshot()
        out = []
        for (op, backend) in sorted(snap):
            entry = snap[(op, backend)]
            cost: Cost = entry["cost"]
            calls = entry["calls"]
            touched = entry["touched_bytes"]
            timed_calls, wall_s = entry["timed_calls"], entry["wall_s"]
            row = {"op": op, "backend": backend, "calls": calls, **cost.to_dict(),
                   "touched_bytes": touched}
            # predicted-vs-touched delta is only meaningful on ref, where
            # the model counts each operand exactly once (no revisits)
            if backend == "ref" and touched:
                row["bytes_rel_err"] = (cost.hbm_bytes - touched) / touched
            else:
                row["bytes_rel_err"] = None
            row["timed_calls"] = timed_calls
            row["wall_s"] = wall_s
            if timed_calls and wall_s > 0 and calls:
                per_call = cost.flops / calls
                row["measured_flops_per_s"] = per_call * timed_calls / wall_s
                per_call_b = cost.hbm_bytes / calls
                row["measured_bytes_per_s"] = per_call_b * timed_calls / wall_s
            else:
                row["measured_flops_per_s"] = None
                row["measured_bytes_per_s"] = None
            out.append(row)
        return out

    # -- trace counter tracks ---------------------------------------------
    def emit_counters(self, tracer=None) -> int:
        """Emit one ``cost.<op>`` counter sample per op (summed across
        backends) onto the trace: monotone totals, so Perfetto draws
        cumulative FLOP/byte tracks next to the span rows. Returns the
        number of tracks emitted."""
        if tracer is None:
            from .trace import TRACER as tracer
        if not tracer.enabled:
            return 0
        per_op: dict[str, dict] = {}
        for (op, _), entry in self._stats.cost_snapshot().items():
            agg = per_op.setdefault(op, {"flops": 0, "hbm_bytes": 0, "calls": 0})
            agg["flops"] += entry["cost"].flops
            agg["hbm_bytes"] += entry["cost"].hbm_bytes
            agg["calls"] += entry["calls"]
        for op, agg in sorted(per_op.items()):
            tracer.counter(f"cost.{op}", "cost", **agg)
        return len(per_op)

    # -- human / machine output -------------------------------------------
    def table(self) -> str:
        """Aligned text table."""
        rows = self.rows()
        if not rows:
            return "(cost ledger empty: no dispatch decisions recorded)"
        headers = [
            "op", "backend", "calls", "GFLOP", "MB read", "MB write",
            "AI", "waste%", "SMEM KB", "GFLOP/s", "bytes ok",
        ]
        body = []
        for r in rows:
            waste = r["pad_waste_bytes"] / r["hbm_bytes"] * 100 if r["hbm_bytes"] else 0.0
            meas = r["measured_flops_per_s"]
            if r["bytes_rel_err"] is None:
                ok = "-"
            else:
                ok = f"{r['bytes_rel_err']:+.1%}" if r["bytes_rel_err"] else "exact"
            body.append([
                r["op"], r["backend"], str(r["calls"]),
                f"{r['flops'] / 1e9:.3f}",
                f"{r['hbm_read_bytes'] / 1e6:.3f}",
                f"{r['hbm_write_bytes'] / 1e6:.3f}",
                f"{r['arithmetic_intensity']:.2f}",
                f"{waste:.1f}",
                f"{r['smem_bytes'] / 1024:.1f}",
                f"{meas / 1e9:.2f}" if meas else "-",
                ok,
            ])
        widths = [max(len(h), *(len(row[i]) for row in body)) for i, h in enumerate(headers)]
        fmt = "  ".join(f"{{:<{w}}}" for w in widths)
        lines = [fmt.format(*headers), fmt.format(*("-" * w for w in widths))]
        lines += [fmt.format(*row) for row in body]
        return "\n".join(lines)

    def to_json(self, meta: Optional[dict] = None) -> dict:
        return {"meta": meta or {}, "rows": self.rows()}

    def dump(self, path: str, meta: Optional[dict] = None) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(meta), f, indent=1, sort_keys=True)
            f.write("\n")

