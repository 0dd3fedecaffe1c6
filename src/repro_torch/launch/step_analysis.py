"""Cost analysis of a rank's program, traced on fake tensors.

Counterpart of ``repro.launch.hlo_analysis`` (its ``analyze_hlo`` and
``HloCost``). The reference parses the compiled per-device HLO; the port
runs eagerly, so ``analyze`` runs the rank's function itself under
``FakeTensorMode`` (no device, no data, nothing allocated) beneath a
``TorchDispatchMode`` that sees every ATen operation it dispatches:

  * **FLOPs**: a matrix product ([m, k] x [k, n], batched or not) 2 m k n
    (``dot_flops`` too); any other operation one a element of the larger
    of its output and its largest input; views, allocations and copies of
    metadata none. Loops are unrolled by running them, so a loop of 8
    matmuls counts 8 of them and nested loops multiply.
  * **bytes**: every dispatched operation reads its tensor operands and
    writes its outputs once (the port runs eagerly: each ATen call is a
    kernel of its own, nothing is fused, unlike the reference's "perfect
    elementwise fusion" TPU model); views are free.
  * **a dispatched kernel site** (``kernels/dispatch.py``, e.g. the
    flash-attention forward) counts as the kernel's own work: its ref
    ``Cost`` (the one the dispatch ledger records, held exact against the
    bytes handed over) in FLOPs and bytes, and none of the ATen operations
    of its plain version (the trace sees the site through
    ``dispatch.OBSERVERS``; on fake tensors ``flash_attention`` makes its
    outputs' shapes alone). Its backward, plain PyTorch in the port, is
    counted operation by operation.
  * **collectives**: from the counted wrappers of ``distributed.sharding``
    (which launch on the fake process group): their wire bytes under the
    reference's ring factors, by name and by mesh axis, their raw bytes
    (the larger of operand and result) and launches; their operand and
    result bytes join ``bytes_accessed``.
  * **memory**: the peak of the bytes of live tensors made during the
    trace (a storage counted once, from its first tensor to that tensor's
    end; unreachable cycles are collected before each operation).

Integer and boolean tensors made from nothing (positions, masks) and
operations on real host tensors alone run for real, so the host reads of index arithmetic (the flash backward's
block skip, the softmax scale) see their values. A host read
(``.item()``, ``bool()`` of a tensor) of a fake tensor has no value: the
trace takes a stand-in (true for a flag, 1 for a number). ``host_reads``
lists each read by the line that made it, with the value taken and
whether it was a stand-in.

The reference's ``unknown_while`` (a loop whose trip count the HLO does
not state) and its VMEM "flashable" variant (flash-attention tiles kept
in a TPU core's VMEM) have no counterpart: an eager trace runs every loop,
and the card's flash kernel is costed by its own model.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import traceback
import weakref
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode, unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode

from ..distributed import sharding as shd
from ..kernels import dispatch as kd

__all__ = ["StepCost", "analyze", "NOT_APPLICABLE"]

#: the reference's fields with no counterpart in an eager trace, and why
NOT_APPLICABLE = {
    "unknown_while": "not applicable: an eager trace runs every loop, so no trip count is unknown",
    "roofline_flash": "not applicable: the reference's VMEM-resident flash tiles are a TPU model; the card's "
                      "flash_attention kernel is counted by its own cost model",
}

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default, _aten.baddbmm.default,
            _aten.addbmm.default, _aten.mv.default, _aten.dot.default}
_FREE = {_aten.detach.default, _aten.alias.default, _aten.lift_fresh.default, _aten.empty.memory_format,
         _aten.empty_strided.default, _aten.empty_like.default, _aten._local_scalar_dense.default,
         _aten.sym_size.int, _aten.sym_numel.default, _aten.sym_stride.int, _aten.sym_storage_offset.default}


@dataclasses.dataclass
class StepCost:
    """The fields of the reference's ``HloCost`` for one rank's program."""

    flops: float = 0.0
    dot_flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0  # wire bytes with the ring factors
    collective_raw: float = 0.0  # the larger of operand and result, summed
    collective_breakdown: dict = dataclasses.field(default_factory=dict)
    collective_by_axis: dict = dataclasses.field(default_factory=dict)
    collective_count: int = 0
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    detail: dict = dataclasses.field(default_factory=dict)  # op -> bytes
    kernel_sites: dict = dataclasses.field(default_factory=dict)  # "op/backend" -> calls
    peak_bytes: int = 0  # the peak of live tensors made during the trace
    host_reads: list = dataclasses.field(default_factory=list)
    n_ops: int = 0


def _tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    return out


def _host_op(func, args, kwargs) -> bool:
    """Whether an operation with tensor inputs runs for real in the trace:
    one whose inputs are all real CPU tensors (index arithmetic on the
    host, a constant), so that a host read of what it computes has its
    value."""
    ts = _tensors((args, kwargs))
    return bool(ts) and not any(isinstance(t, FakeTensor) or t.device.type != "cpu" for t in ts)


_HOST_FACTORY_MAX = 1 << 24  # elements


def _host_factory(func, args, kwargs, out) -> bool:
    """Whether a tensor made from no tensor (``out``, its fake version) is
    made for real: an integer or boolean CPU tensor of at most
    ``_HOST_FACTORY_MAX`` elements (positions, masks)."""
    if _tensors((args, kwargs)) or not isinstance(out, torch.Tensor) or out.device.type != "cpu":
        return False
    return (out.dtype == torch.bool or not out.dtype.is_floating_point) and out.numel() <= _HOST_FACTORY_MAX


def _kind(func) -> str:
    name = func.__name__.split(".")[0]
    if func in _MATMULS:
        return "dot"
    if name in ("index", "index_select", "gather", "embedding", "take"):
        return "gather"
    if name.startswith(("index_put", "index_copy", "scatter", "index_add")):
        return "scatter"
    if name in ("copy_", "clone", "_to_copy", "cat", "stack", "contiguous", "_unsafe_view", "fill_", "zero_",
                "zeros_like", "ones_like", "full", "zeros", "ones", "new_zeros", "new_empty", "new_full",
                "repeat", "expand_copy", "constant_pad_nd", "where"):
        return "copy"
    if name.startswith(("sum", "mean", "amax", "amin", "max", "min", "logsumexp", "norm", "prod", "var",
                        "argmax", "cumsum", "softmax", "_softmax", "_log_softmax", "log_softmax", "all", "any")):
        return "reduce"
    return "elementwise"


class _Counter(TorchDispatchMode):
    def __init__(self, cost: StepCost):
        super().__init__()
        self.cost = cost
        self.depth = 0  # inside a dispatched kernel site's plain version
        self.live = 0
        self.seen: dict[int, int] = {}  # storage -> its bytes, while a tensor of it lives

    # --- kernel sites (dispatch.OBSERVERS) ---
    def enter(self):
        self.depth += 1

    def exit(self):
        self.depth -= 1

    def record(self, d):
        if self.depth == 0:  # a record outside any kernel site: its ATen operations were counted
            return
        c = self.cost
        if d.cost is not None:
            c.flops += d.cost.flops
            c.dot_flops += 2 * d.cost.macs
            nbytes = d.cost.hbm_read_bytes + d.cost.hbm_write_bytes
            c.bytes_accessed += nbytes
            key = f"kernel:{d.op}"
            c.bytes_by_op[key] = c.bytes_by_op.get(key, 0.0) + nbytes
            c.detail[key] = c.detail.get(key, 0.0) + nbytes
        site = f"{d.op}/{d.backend}"
        c.kernel_sites[site] = c.kernel_sites.get(site, 0) + 1

    # --- live bytes ---
    def _track(self, out) -> None:
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            key = st._cdata
            if key in self.seen:
                continue
            n = st.nbytes()
            self.seen[key] = n
            self.live += n
            self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
            weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        self.live -= self.seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # the fake-tensor machinery makes reference cycles (a caught
        # exception's frames hold an operation's tensors), which keep dead
        # tensors counted until Python's collector runs, at a time that
        # depends on the process's history: collecting the young
        # generations before each operation makes the live bytes the
        # reachable ones, and a cell's peak the same in every process
        gc.collect(1)
        if func is _aten._local_scalar_dense.default:
            return self._host_read(args[0])
        out = None if _host_op(func, args, kwargs) else func(*args, **kwargs)
        if out is None or _host_factory(func, args, kwargs, out):
            with unset_fake_temporarily():
                out = func(*args, **kwargs)
        self._track(out)
        if self.depth or func.namespace in ("c10d", "_c10d_functional", "prim") or func in _FREE:
            return out
        if getattr(func, "is_view", False) or func.__name__.split(".")[0] in ("view", "_unsafe_view", "t",
                                                                              "expand", "permute", "slice",
                                                                              "select", "unsqueeze",
                                                                              "squeeze", "as_strided",
                                                                              "transpose", "split",
                                                                              "unbind", "narrow"):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _host_read(self, t):
        """A host read: of a real tensor its value, of a fake one a
        stand-in (true for a flag, 1 for a number); either recorded under
        the port's line that read it."""
        stand_in = isinstance(t, FakeTensor)
        if stand_in:
            value = True if t.dtype == torch.bool else 1
        else:
            with unset_fake_temporarily():
                value = t.item()
        where = "?"
        for fr in reversed(traceback.extract_stack()[:-1]):
            if "repro_torch" in fr.filename and not fr.filename.endswith("step_analysis.py"):
                where = f"{fr.filename[fr.filename.rindex('repro_torch'):]}:{fr.lineno}"
                break
        for r in self.cost.host_reads:
            if r["at"] == where and r["stand_in"] == stand_in:
                r["count"] += 1
                if value not in r["values"]:
                    r["values"].append(value)
                return value
        self.cost.host_reads.append({"at": where, "dtype": str(t.dtype).replace("torch.", ""), "values": [value],
                                     "stand_in": stand_in, "count": 1})
        return value

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        c.n_ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        kind = _kind(func)
        if kind == "dot":
            a = [x for x in ins if x.dim() >= 1]
            lhs = a[-2] if func in (_aten.addmm.default, _aten.baddbmm.default, _aten.addbmm.default) else a[0]
            k = lhs.shape[-1]
            f = 2.0 * k * sum(o.numel() for o in outs)
            if func is _aten.addbmm.default:
                f = 2.0 * lhs.numel() * a[-1].shape[-1]
            c.flops += f
            c.dot_flops += f
        else:
            c.flops += max([x.numel() for x in ins + outs] or [0])
        nbytes = sum(x.nbytes for x in {id(x): x for x in ins}.values()) + sum(o.nbytes for o in outs)
        c.bytes_accessed += nbytes
        c.bytes_by_op[kind] = c.bytes_by_op.get(kind, 0.0) + nbytes
        key = func.__name__
        c.detail[key] = c.detail.get(key, 0.0) + nbytes


def analyze(fn: Callable, *args, make_args: Callable | None = None) -> tuple[StepCost, object]:
    """Run ``fn(*args)`` (or ``fn(*make_args())``, the arguments made under
    the fake mode) on fake tensors and count it. Returns (the cost, what
    ``fn`` returned, as fake tensors)."""
    gc.collect()  # the trace's live bytes from a clean start
    cost = StepCost()
    counter = _Counter(cost)
    with shd.collective_log() as launches, FakeTensorMode(allow_non_fake_inputs=True):
        if make_args is not None:
            args = make_args()
        kd.OBSERVERS.append(counter)
        try:
            with counter:
                out = fn(*args)
        finally:
            kd.OBSERVERS.remove(counter)
    wire, by_axis = collections.Counter(), collections.Counter()
    for c in launches:
        wire[c.name] += c.wire
        by_axis[c.axis] += c.wire
    # the names and axes that moved bytes
    cost.collective_breakdown = {k: float(v) for k, v in wire.items() if v > 0}
    cost.collective_by_axis = {k: float(v) for k, v in by_axis.items() if v > 0}
    cost.collective_bytes = float(sum(wire.values()))
    cost.collective_raw = float(sum(max(c.nin, c.nout) for c in launches))
    cost.collective_count = len(launches)
    io = float(sum(c.nin + c.nout for c in launches))
    cost.bytes_accessed += io
    cost.bytes_by_op["collective"] = io
    return cost, out
