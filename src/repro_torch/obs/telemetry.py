"""Quantization-health telemetry for FloatSD8/FP8 training (paper §III).

Counterpart of ``repro.obs.telemetry``, with its names, thresholds and
JSONL record fields. The numerical events a loss curve cannot show:

  * **FP8 grad saturation / underflow**: loss-scaled gradients that clamp
    at the e5m2 max (±57344) or round to zero below the subnormal floor at
    the §III-D ``grad_quant`` sweep. Sustained saturation means the loss
    scale is too high; a growing underflow fraction means it is too low.
  * **FloatSD carry / clamp**: master-weight updates that move a weight to
    another FloatSD8 grid point (a signed-digit group carry in the paper's
    circuit), and weights pinned at the top of the exponent-biased grid.
  * **Loss-scale adjustments** and per-layer grad-norm snapshots.

``make_train_step(..., telemetry=True)`` computes the statistics below
inside the step as device tensors and returns them under
``metrics["tel"]``; ``TelemetryLogger`` reads them to the host once a step,
aggregates them into ``TrainTelemetry`` records and appends those to a
JSONL file. ``KERNEL_STATS`` is the sink of ``kernels.dispatch.matmul_dw``'s
flush hook: while enabled, every snapped dW reports its saturated and zero
counts, which stay device tensors until ``snapshot()``.

One deviation, the same function: ``floatsd_update_stats`` quantizes with
``kernels.dispatch.quantize`` (the ``floatsd_quantize`` kernel on the card,
its plain version on the CPU) and compares the codes, where the reference
compares the quantized values in ``jnp``: two codes at one bias differ
exactly where their values do (``tests/test_torch_telemetry.py``).
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Optional

import numpy as np
import torch

from .._tree import tree_leaves
from ..core import floatsd
from ..core.fp8 import _MAX, FP8_E5M2

__all__ = [
    "FP8_SAT_THRESHOLD", "FP8_UNDERFLOW_THRESHOLD", "fp8_grad_stats", "layer_grad_norms",
    "floatsd_update_stats", "KernelStats", "KERNEL_STATS", "TrainTelemetry", "TelemetryLogger",
]

#: e5m2 saturating clamp value (``core.fp8.quantize_fp8``).
FP8_SAT_THRESHOLD = float(_MAX[FP8_E5M2])
#: Below half the smallest e5m2 subnormal (2^-16), round-to-nearest-even
#: sends a nonzero gradient to exactly zero.
FP8_UNDERFLOW_THRESHOLD = 2.0 ** -17

_f32 = torch.float32


def _per_element(leaves, dev) -> torch.Tensor:
    """1 / the leaves' element count (summed in f32, at least 1), rounded
    to f32, as an f32 scalar on ``dev`` (a fill: a copy from the host would
    wait for the device). A fraction is its count times this: the count is
    a constant of the reference's compiled step, whose division by it XLA
    folds into a multiplication by its f32 reciprocal."""
    n = np.float32(0.0)
    for t in leaves:
        n = np.float32(n + np.float32(t.numel()))
    return torch.full((), float(np.float32(1.0) / max(n, np.float32(1.0))), dtype=_f32, device=dev)


def fp8_grad_stats(tree) -> dict:
    """Saturation/underflow/zero fractions over a (loss-scaled) grad tree,
    at the §III-D ``grad_quant`` sweep point. On leaves the fused backward
    already emitted on the FP8 grid, ``fp8_sat_frac`` counts values at the
    clamp and ``fp8_underflow_frac`` is zero by construction (an underflow
    is already a zero, counted by ``fp8_zero_frac``). f32 device scalars.

    The counts are summed exactly (int64) and turned to f32 once; the
    reference adds per-leaf f32 counts, which is the same while every count
    stays below 2^24. Both thresholds are exact in fp16 and bf16, so a leaf
    is compared in its own dtype."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device if leaves else torch.device("cpu")
    counts = torch.zeros(3, dtype=torch.int64, device=dev)  # >= clamp, < floor (zeros too), zeros
    for g in leaves:
        a = torch.abs(g)
        counts = counts + torch.stack([(a >= FP8_SAT_THRESHOLD).sum(), (a < FP8_UNDERFLOW_THRESHOLD).sum(),
                                       (a == 0).sum()])
    f = torch.stack([counts[0], counts[1] - counts[2], counts[2]]).to(_f32) * _per_element(leaves, dev)
    return {"fp8_sat_frac": f[0], "fp8_underflow_frac": f[1], "fp8_zero_frac": f[2]}


def layer_grad_norms(grads) -> dict:
    """L2 norm (f32 device scalar) of each top-level group of a grad tree
    (the dict ``model.init`` returns), in sorted key order; a tree that is
    not a dict gets a single ``"all"`` entry."""
    def _norm(sub) -> torch.Tensor:
        sq = sum(torch.sum(torch.square(g.to(_f32))) for g in tree_leaves(sub))
        return torch.sqrt(torch.as_tensor(sq, dtype=_f32))

    if isinstance(grads, dict):
        return {str(k): _norm(v) for k, v in sorted(grads.items())}
    return {"all": _norm(grads)}


def floatsd_update_stats(old_params, new_params) -> dict:
    """FloatSD carry/clamp fractions of one master-weight update, over every
    weight leaf (ndim >= 2, the tensors the models quantize at use):

      * ``sd_carry_frac``: the share of weights whose nearest FloatSD8 grid
        point changed from the old master to the new, both quantized at the
        new master's bias (``fit_bias``, a device int32: no host read);
      * ``sd_clamp_frac``: the share of new weights at or beyond the top of
        that bias's grid, where the quantizer saturates.

    Each leaf takes two ``dispatch.quantize`` calls (two kernel launches on
    the card). Counted as ``fp8_grad_stats`` counts; f32 device scalars."""
    from ..kernels import dispatch as kd

    top = float(floatsd._GRID_POS[-1])
    pairs = [(o, w) for o, w in zip(tree_leaves(old_params), tree_leaves(new_params)) if w.ndim >= 2]
    dev = pairs[0][1].device if pairs else torch.device("cpu")
    counts = torch.zeros(2, dtype=torch.int64, device=dev)  # carried, clamped
    for o, w in pairs:
        bias = floatsd.fit_bias(w)
        c_old, _ = kd.quantize(o, bias)
        c_new, _ = kd.quantize(w, bias)
        clamped = torch.abs(w.to(_f32)) >= top * floatsd.exp2i(bias)
        counts = counts + torch.stack([(c_old != c_new).sum(), clamped.sum()])
    f = counts.to(_f32) * _per_element([w for _, w in pairs], dev)
    return {"sd_carry_frac": f[0], "sd_clamp_frac": f[1]}


class KernelStats:
    """Sink for in-kernel quantizer events: ``kernels.dispatch.matmul_dw``
    calls ``record`` at every snapped dW while the sink is enabled. The
    saturated and zero counts arrive as device tensors and are summed there;
    ``snapshot()`` reads them to the host. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = False
        self._data: dict = {}

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        with self._lock:
            self._data = {}

    def record(self, op: str, elems: int, saturated, zeros) -> None:
        """One kernel flush: its element count and its saturated and zero
        counts (0-d tensors, or ints)."""
        with self._lock:
            d = self._data.setdefault(op, {"calls": 0, "elems": 0, "saturated": 0, "zeros": 0})
            d["calls"] += 1
            d["elems"] += int(elems)
            d["saturated"] = d["saturated"] + saturated
            d["zeros"] = d["zeros"] + zeros

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for op, d in sorted(self._data.items()):
                d = dict(d, saturated=int(d["saturated"]), zeros=int(d["zeros"]))
                e = max(d["elems"], 1)
                out[op] = dict(d, sat_frac=d["saturated"] / e, zero_frac=d["zeros"] / e)
            return out


#: Process-wide kernel-event sink.
KERNEL_STATS = KernelStats()


@dataclasses.dataclass
class TrainTelemetry:
    """One aggregated telemetry record: the window since the last emit."""

    step: int
    window_steps: int
    loss_mean: float
    loss_scale: float
    scale_ups: int  # cumulative loss-scale increases since the logger started
    scale_downs: int  # ... and decreases (overflow backoffs)
    nonfinite_steps: int  # cumulative skipped steps
    fp8_sat_frac: float  # window means of the per-step fractions
    fp8_underflow_frac: float
    fp8_zero_frac: float
    sd_carry_frac: float
    sd_clamp_frac: float
    grad_norms: dict  # the window's last snapshot, per layer
    kernel: dict  # KERNEL_STATS.snapshot() (cumulative), may be empty

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _to_host(metrics: dict) -> dict:
    """The step's metrics (nested dicts of 0-d tensors, f32 or bool) as
    Python floats and bools, with one device-to-host copy."""
    flat: list = []

    def walk(d, out):
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v, {})
            elif isinstance(v, torch.Tensor):
                out[k] = (len(flat), v.dtype == torch.bool)
                v = v.detach().reshape(())
                flat.append(v if v.dtype == torch.float32 else v.to(torch.float32))
            else:
                out[k] = v
        return out

    idx = walk(metrics, {})
    vals = torch.stack(flat).cpu().tolist() if flat else []

    def fill(d):
        return {k: fill(v) if isinstance(v, dict) else
                (bool(vals[v[0]]) if v[1] else vals[v[0]]) if isinstance(v, tuple) else v
                for k, v in d.items()}

    return fill(idx)


class TelemetryLogger:
    """Aggregator: feed every step's metrics to ``update``; ``emit`` at each
    ``--log-every`` boundary returns a ``TrainTelemetry`` record (appended
    as one JSONL line when ``path`` is set)."""

    _FRACS = ("fp8_sat_frac", "fp8_underflow_frac", "fp8_zero_frac", "sd_carry_frac", "sd_clamp_frac")

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.scale_ups = 0
        self.scale_downs = 0
        self.nonfinite_steps = 0
        self._last_scale: Optional[float] = None
        self._reset_window()

    def _reset_window(self) -> None:
        self._n = 0
        self._loss_sum = 0.0
        self._frac_sums = {k: 0.0 for k in self._FRACS}
        self._grad_norms: dict = {}
        self._scale = 0.0

    def update(self, step: int, metrics: dict) -> None:
        """Accumulate one step: its device scalars come to the host here, in
        one copy (values the CLI prints anyway)."""
        m = _to_host(metrics)
        self._n += 1
        self._loss_sum += float(m["loss"])
        self._scale = float(m["loss_scale"])
        if not bool(m["grads_finite"]):
            self.nonfinite_steps += 1
        if self._last_scale is not None and self._scale != self._last_scale:
            if self._scale > self._last_scale:
                self.scale_ups += 1
            else:
                self.scale_downs += 1
        self._last_scale = self._scale
        tel = m.get("tel")
        if tel:
            for k in self._FRACS:
                if k in tel:
                    self._frac_sums[k] += float(tel[k])
            if "grad_norm" in tel:
                self._grad_norms = {k: float(v) for k, v in tel["grad_norm"].items()}

    def emit(self, step: int) -> TrainTelemetry:
        """Close the window: build the record, append it as JSONL, reset."""
        n = max(self._n, 1)
        rec = TrainTelemetry(
            step=int(step), window_steps=self._n, loss_mean=self._loss_sum / n,
            loss_scale=self._scale, scale_ups=self.scale_ups, scale_downs=self.scale_downs,
            nonfinite_steps=self.nonfinite_steps,
            **{k: self._frac_sums[k] / n for k in self._FRACS},
            grad_norms=self._grad_norms, kernel=KERNEL_STATS.snapshot(),
        )
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec.to_dict()) + "\n")
        self._reset_window()
        return rec

    def format(self, rec: TrainTelemetry) -> str:
        """One compact line for the training log."""
        line = (
            f"tel: sat {rec.fp8_sat_frac:.2e} under {rec.fp8_underflow_frac:.2e} "
            f"zero {rec.fp8_zero_frac:.3f} | sd carry {rec.sd_carry_frac:.3f} "
            f"clamp {rec.sd_clamp_frac:.2e} | scale {rec.loss_scale:.0f} "
            f"(+{rec.scale_ups}/-{rec.scale_downs}, {rec.nonfinite_steps} skipped)"
        )
        if rec.grad_norms:
            top = max(rec.grad_norms.items(), key=lambda kv: kv[1])
            line += f" | max layer gnorm {top[0]}={top[1]:.3g}"
        return line
