"""Kernel dispatch: routes each op to its hand-written CUDA kernel or to its
plain PyTorch version.

Counterpart of ``repro.kernels.dispatch``: the serving ops over FloatSD8
(``PackedTensor``) and FloatSD4 (``PackedTensor4``, and ``LayerTensor4``:
one layer of a stacked FloatSD4 leaf, which the reference packs along its
layer axis) weights (an MoE's expert products one matmul launch an expert,
where the reference's engine decodes the packed tree), the backward
ops, weight hoists and training wrappers (``train_matmul``,
``lstm_cell_train``) of the fused quantized-BPTT training path, and the
element-wise ``quantize`` and ``qsigmoid`` entry points, the chunked
RWKV-6 ``rwkv_wkv`` of the model zoo's prefill, and the dense family's
``flash_attention``. The resolver
has one rule: a tensor on the card goes to the kernel, a tensor on the CPU
to the plain version. The only override is ``backend="ref"`` (an argument,
or ``use_backend("ref")`` around a whole model call), which runs the plain
version on any device; the tests and ``chip_smoke.py``'s cross-check use
it. There is no fallback from the kernel to the plain version: the kernels
bounds-check every tile, so every shape runs unpadded, and a kernel that
cannot run raises. Every call is recorded in ``STATS`` under the backend
that actually ran, with its predicted ``Cost`` (``COST_SPECS``: one
``obs.costmodel.CostSpec`` per op, its function in ``kernels/<op>/cost.py``)
and the bytes of the tensors it handed over; ``LEDGER`` joins the two with
the measured times fed through ``STATS.add_time``.

The zoo's three ops (``flash_attention``, ``rwkv_wkv``, ``qsigmoid``) are
differentiable when grad is on and an input requires a gradient: one
``torch.autograd.Function`` each, whose forward is the resolved backend as
above (the kernel on the card, recorded) and whose backward is a plain
PyTorch port of the reference's VJP (``flash_bwd`` on the saved o and the
kernel's lse; the reference model's chunked wkv recomputed under autograd;
the straight-through sigmoid derivative). The backwards record no
Decision and no cost. Otherwise (serving, ``no_grad``) no Function is
applied and the call is the forward alone.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, NamedTuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..core import floatsd, floatsd4
from ..distributed import sharding as shd
from ..obs import costmodel
from ..obs import telemetry as obs_telemetry
from .flash_attention import cost as fa_cost
from .flash_attention import ops as fa_ops
from .flash_attention.ref import flash_attention_gqa, flash_bwd
from .floatsd4_matmul import cost as fm4_cost
from .floatsd4_matmul import ops as fm4_ops
from .floatsd4_matmul.ref import floatsd4_matmul_ref
from .floatsd_matmul import cost as fm_cost
from .floatsd_matmul import ops as fm_ops
from .floatsd_matmul.ref import matmul_dw_ref, split_matmul
from .floatsd_quantize import cost as fq_cost
from .floatsd_quantize import ops as fq_ops
from .floatsd_quantize.ref import quantize_ref
from .lstm_cell import cost as lc_cost
from .lstm_cell import ops as lc_ops
from .lstm_cell.ref import lstm_cell_bwd_ref, lstm_cell_ref
from .qsigmoid import cost as qs_cost
from .qsigmoid import ops as qs_ops
from .qsigmoid.ref import qsigmoid_ref
from .rwkv_wkv import cost as rw_cost
from .rwkv_wkv import ops as rw_ops
from .rwkv_wkv.ref import wkv_chunked_scan, wkv_ref

__all__ = [
    "BACKENDS", "ZERO_CODE", "PackedTensor", "is_packed", "Decision",
    "DispatchStats", "STATS", "LEDGER", "COST_SPECS", "OBSERVERS", "use_backend", "matmul", "lstm_cell",
    "packed_einsum", "expert_einsum", "hoist_packed", "matmul_dx", "matmul_dw", "lstm_cell_grad",
    "pack_train", "hoist_train", "train_matmul", "lstm_cell_train", "inference_only",
    "PackedTensor4", "is_packed4", "LayerTensor4", "is_layer4", "layer_view4", "is_any_packed", "pack4",
    "unpack4", "matmul4", "quantize", "qsigmoid", "rwkv_wkv", "flash_attention",
]

BACKENDS = ("ref", "cuda")

# uint8 code that decodes to exactly 0.0 at any bias: e=0, mantissa index of
# 0.0 in the symmetric 31-entry grid.
ZERO_CODE = int(np.searchsorted(floatsd.MANTISSA_VALUES, 0.0))


class PackedTensor(NamedTuple):
    """A FloatSD8-packed tensor: uint8 codes + the per-tensor exponent bias,
    kept on the host so no launch waits on a device read."""

    codes: torch.Tensor  # uint8, same shape as the dense tensor
    bias: int
    # f32 decode of the codes, set by hoist_packed / hoist_train when the
    # plain version runs
    dense: torch.Tensor | None = None


def is_packed(x: Any) -> bool:
    return isinstance(x, PackedTensor)


class PackedTensor4(NamedTuple):
    """A FloatSD4-packed tensor: two 4-bit codes per byte along axis 0 (low
    nibble = even row) and one int8 exponent per 32 rows of axis 0 and
    column; ``k`` is the true length of axis 0."""

    codes: torch.Tensor  # uint8 [ceil(k/2), ...]
    exps: torch.Tensor  # int8 [ceil(k/32), ...]
    k: int
    # f32 decode [k, ...], set by hoist_packed when the plain version runs
    dense: torch.Tensor | None = None


def is_packed4(x: Any) -> bool:
    return isinstance(x, PackedTensor4)


class LayerTensor4(NamedTuple):
    """Layer l of a stacked FloatSD4 leaf [L, ..., K, N], which the
    reference's store nibble-packs and groups along axis 0, the layer axis
    (``PackedTensor4`` with k = L): the code-byte plane ``codes[l >> 1]``,
    the exponent plane ``exps[l >> 5]`` of the same shape, and the nibble
    ``l & 1``. Element (k, n) of the layer is ``LUT16[(byte >> 4 nibble) &
    0xF] * 2^exp``: one exponent an element, shared with the same element
    of up to 31 other layers, so it is not a ``PackedTensor4`` of the layer
    (whose exponents are shared along K)."""

    codes: torch.Tensor  # uint8 [..., K, N]
    exps: torch.Tensor  # int8, codes' shape
    nibble: int  # 0 or 1
    # f32 decode [..., K, N], set by hoist_packed when the plain version runs
    dense: torch.Tensor | None = None


def is_layer4(x: Any) -> bool:
    return isinstance(x, LayerTensor4)


def layer_view4(w4: PackedTensor4, l: int) -> LayerTensor4:
    """Layer ``l``'s view of a stacked FloatSD4 leaf (no copy)."""
    if not 0 <= l < w4.k:
        raise IndexError(f"layer {l} of a stacked FloatSD4 leaf of {w4.k} layers")
    return LayerTensor4(w4.codes[l >> 1], w4.exps[l // floatsd4.GROUP], l & 1)


def is_any_packed(x: Any) -> bool:
    return isinstance(x, (PackedTensor, PackedTensor4, LayerTensor4))


def pack4(w) -> PackedTensor4:
    """FloatSD4-encode a dense weight, or a FloatSD8 PackedTensor (decoded
    first: the serving conversion re-quantizes the FloatSD8 values)."""
    if is_packed(w):
        w = floatsd.decode(w.codes, w.bias, dtype=torch.float32)
    codes, exps = floatsd4.encode(w)
    return PackedTensor4(floatsd4.pack_nibbles(codes), exps, w.shape[0])


def unpack4(w4: PackedTensor4, dtype=torch.float32) -> torch.Tensor:
    """Decode a PackedTensor4 back to its dense tensor."""
    return floatsd4.decode_packed(w4.codes, w4.exps, w4.k, dtype=dtype)


class _DecisionFields(NamedTuple):
    op: str
    backend: str  # "ref" | "cuda"
    reason: str


class Decision(_DecisionFields):
    """What the resolver decided for one call, and ``cost``, the predicted
    ``obs.costmodel.Cost`` of that call: an attribute, not a field, so two
    Decisions are equal when they decided the same."""

    def __new__(cls, op: str, backend: str, reason: str, cost: costmodel.Cost | None = None):
        self = super().__new__(cls, op, backend, reason)
        self.cost = cost
        return self


class DispatchStats:
    """Per-(op, backend) call counters, the last Decision per op, and the
    cost ledger's inputs:

      * calls per recorded Decision (the dispatch records one cached
        Decision, with its predicted ``Cost``, per call shape), summed per
        (op, backend) by ``snapshot`` and ``cost_snapshot``;
      * the bytes touched: the ``nbytes`` of the tensors each call handed
        to the backend plus its outputs (and ``add_touched``'s); on ref, the
        measurement the predicted bytes must equal exactly;
      * ``wall``: measured (timed calls, seconds) per (op, backend), fed by
        ``add_time`` (``chip_smoke.py``'s kernel phase).

    One short lock guards them: calls are recorded on whatever thread runs
    them (the serving pump's worker thread, a test) while the HTTP
    server's /metrics scrape reads the snapshots from the event loop."""

    def __init__(self):
        # id(decision) -> [decision, calls, touched bytes]; the entry holds
        # the Decision, so its id is not reused while the entry lives
        self._calls: dict[int, list] = {}
        self._touched: collections.Counter = collections.Counter()  # add_touched's, per (op, backend)
        self.last: dict[str, Decision] = {}
        self.wall: dict[tuple[str, str], list] = {}
        self._lock = threading.Lock()

    def record(self, d: Decision, touched: int = 0) -> None:
        with self._lock:
            entry = self._calls.get(id(d))
            if entry is None:
                entry = self._calls[id(d)] = [d, 0, 0]
            entry[1] += 1
            entry[2] += touched
            self.last[d.op] = d

    def add_touched(self, op: str, backend: str, nbytes: int) -> None:
        with self._lock:
            self._touched[(op, backend)] += int(nbytes)

    def add_time(self, op: str, backend: str, seconds: float, calls: int = 1) -> None:
        """Attribute measured time to (op, backend): the ledger's measured
        columns, per call."""
        with self._lock:
            entry = self.wall.setdefault((op, backend), [0, 0.0])
            entry[0] += int(calls)
            entry[1] += float(seconds)

    def count(self, op: str | None = None, backend: str | None = None) -> int:
        return sum(n for (o, b), n in self.snapshot().items()
                   if (op is None or o == op) and (backend is None or b == backend))

    def reset(self) -> None:
        with self._lock:
            self._calls.clear()
            self._touched.clear()
            self.last.clear()
            self.wall.clear()

    def _entries(self) -> list:
        with self._lock:
            return [(d, n, t) for d, n, t in self._calls.values()]

    def snapshot(self) -> dict:
        """{(op, backend): calls}: what /metrics exports as
        ``repro_dispatch_decisions_total{op,backend}``."""
        out: collections.Counter = collections.Counter()
        for d, n, _ in self._entries():
            out[(d.op, d.backend)] += n
        return dict(out)

    def cost_snapshot(self) -> dict:
        """{(op, backend): {cost, calls, touched_bytes, timed_calls, wall_s}}:
        the CostLedger's join input."""
        entries = self._entries()
        with self._lock:
            wall, extra = dict(self.wall), dict(self._touched)
        sums: dict[tuple[str, str], list] = {}
        for d, n, touched in entries:
            acc = sums.setdefault((d.op, d.backend), [0] * 9)
            c = d.cost or costmodel.ZERO_COST
            acc[0] += n * c.flops
            acc[1] += n * c.macs
            acc[2] += n * c.hbm_read_bytes
            acc[3] += n * c.hbm_write_bytes
            acc[4] = max(acc[4], c.smem_bytes)
            acc[5] += n * c.pad_waste_flops
            acc[6] += n * c.pad_waste_bytes
            acc[7] += n
            acc[8] += touched
        return {
            key: {
                "cost": costmodel.Cost(*sums[key][:7]) if key in sums else costmodel.ZERO_COST,
                "calls": sums[key][7] if key in sums else 0,
                "touched_bytes": (sums[key][8] if key in sums else 0) + extra.get(key, 0),
                "timed_calls": wall.get(key, (0, 0.0))[0],
                "wall_s": wall.get(key, (0, 0.0))[1],
            }
            for key in set(sums) | set(wall) | set(extra)
        }


STATS = DispatchStats()

#: The predicted-and-measured cost ledger over STATS: the /metrics export,
#: the tracer's ``cost.<op>`` counter tracks and ``chip_smoke.py``'s table.
LEDGER = costmodel.CostLedger(STATS)

_OVERRIDE: list[str] = []  # use_backend() stack

#: observers of the dispatched calls (``launch/step_analysis.py``): each
#: one's ``enter()`` runs before a kernel site's backend and ``exit()``
#: after it, however the call ends (``_site``); ``record(decision)`` runs
#: for every recorded call, inside that bracket for a site's own record
OBSERVERS: list = []


def _check(backend: str | None) -> None:
    if backend not in (None, "ref"):
        raise ValueError(f"backend must be None or 'ref', got {backend!r}")


@contextlib.contextmanager
def use_backend(name: str | None):
    """Force ``"ref"`` for every resolution inside the block (``None``
    leaves the device rule in charge)."""
    _check(name)
    _OVERRIDE.append(name)
    try:
        yield
    finally:
        _OVERRIDE.pop()


def _resolve(t: torch.Tensor, backend: str | None) -> tuple[str, str]:
    """(backend, reason): the device rule, or the ``ref`` override."""
    _check(backend)
    if (backend or (_OVERRIDE[-1] if _OVERRIDE else None)) == "ref":
        return "ref", "policy:ref"
    if t.device.type == "cuda":
        return "cuda", "cuda tensor"
    return "ref", f"{t.device.type} tensor"


@contextlib.contextmanager
def _site(t: torch.Tensor, backend: str | None):
    """A kernel site's call: yields ``_resolve``'s (backend, reason); the
    site runs its backend and its ``_record`` inside, bracketed by every
    observer's ``enter()`` and ``exit()``."""
    resolved = _resolve(t, backend)
    observers = list(OBSERVERS)
    for o in observers:
        o.enter()
    try:
        yield resolved
    finally:
        for o in reversed(observers):
            o.exit()


_DECISIONS: dict[tuple, Decision] = {}  # (op, backend, reason, shape key) -> its Decision and Cost
_DECISIONS_MAX = 1 << 16


def _record(op: str, be: str, reason: str, shape: tuple, cost_fn, touched: int) -> None:
    """Record one call: the Decision of its (op, backend, reason, shape),
    made with ``cost_fn()``'s Cost at the first call of that shape and
    reused after, and the bytes it ``touched``."""
    key = (op, be, reason, shape)
    d = _DECISIONS.get(key)
    if d is None:
        if len(_DECISIONS) >= _DECISIONS_MAX:
            _DECISIONS.clear()
        d = _DECISIONS[key] = Decision(op, be, reason, cost_fn())
    STATS.record(d, touched)
    for o in OBSERVERS:
        o.record(d)


def _nbytes(*ts) -> int:
    """Bytes of the given tensors: what a call handed over and got back."""
    n = 0
    for t in ts:
        n += t.nbytes
    return n


def matmul(x: torch.Tensor, codes: torch.Tensor, bias, *, transposed: bool = False,
           dense: torch.Tensor | None = None, ordered: bool = False,
           backend: str | None = None) -> torch.Tensor:
    """x [..., K] @ decode(codes) -> [..., N] f32, codes [K, N] or, when
    ``transposed``, [N, K]. x is taken in f32 (exact from bf16/fp16, and
    decoded FloatSD8 weights are exact in bf16, so a bf16 policy's product
    is its bf16-issue product with f32 accumulation). ``dense`` is the
    codes' decode from ``hoist_packed``: the plain version then skips its
    own decode and sums in the same order (``floatsd_matmul.ref.plan``'s).
    ``ordered`` keeps the kernel on its ordered route at any M, so its bits
    are the plain version's on exact products, and a row's sum does not
    depend on how many rows share the call (every product of the fused
    BPTT)."""
    k = x.shape[-1]
    n = codes.shape[0] if transposed else codes.shape[1]
    x2 = x.reshape(-1, k).to(torch.float32).contiguous()
    with _site(x2, backend) as (be, why):
        if be == "ref":
            w = floatsd.decode(codes, bias, dtype=torch.float32) if dense is None else dense
            y = split_matmul(x2, w.t() if transposed else w, ordered)
            touched = _nbytes(x2, codes if dense is None else dense, y)
        else:
            y = fm_ops.floatsd_matmul(x2, codes, bias, transposed=transposed, ordered=ordered)
            touched = _nbytes(x2, codes, y)
        m, hoisted = x2.shape[0], dense is not None
        _record("floatsd_matmul", be, why, (m, k, n, ordered, hoisted), lambda: fm_cost.matmul_fwd_cost(
            m, k, n, backend=be, ordered=ordered, dense=hoisted), touched)
    return y.reshape(*x.shape[:-1], n)


def lstm_cell(z: torch.Tensor, c_prev: torch.Tensor, *, quantized: bool = True,
              c_dtype=torch.float16, backend: str | None = None):
    """Fused gates -> (h, c). z: [B, 4H] (i|f|g|o), c_prev: [B, H]."""
    with _site(z, backend) as (be, why):
        if be == "cuda":
            z, c_prev = z.contiguous(), c_prev.contiguous()
            h, c = lc_ops.lstm_cell(z, c_prev, quantized=quantized, c_dtype=c_dtype)
        else:
            h, c = lstm_cell_ref(z, c_prev, quantized, c_dtype=c_dtype)
        shape = (z.numel() // z.shape[-1], z.shape[-1] // 4, z.element_size(), c_prev.element_size(),
                 h.element_size(), c.element_size(), quantized)
        _record("lstm_cell", be, why, shape, lambda: lc_cost.lstm_cell_cost(
            *shape[:2], backend=be, z_bytes=shape[2], c_in_bytes=shape[3], h_out_bytes=shape[4], c_out_bytes=shape[5],
            quantized=quantized), _nbytes(z, c_prev, h, c))
    return h, c


def matmul4(x: torch.Tensor, w4, *, transposed: bool = False,
            backend: str | None = None) -> torch.Tensor:
    """x [..., K] @ decode4(w4) -> [..., N] f32, w4 a PackedTensor4 packed
    [K, N] or, when ``transposed``, the [N, K] table read in place (the tied
    head), or a LayerTensor4's [K, N] planes (a stacked leaf's layer). x is
    taken in f32, exactly as ``matmul`` takes it. On the card every layout
    runs the kernel; the JAX package decodes the table and multiplies
    densely for the head, because a Pallas block cannot transpose a nibble
    stream, and decodes a stacked tree whole each step: the same function,
    and a CUDA thread reads any nibble."""
    plane = is_layer4(w4)
    if plane and (transposed or w4.codes.dim() != 2):
        raise NotImplementedError(f"matmul4: a layer's planes {tuple(w4.codes.shape)} are [K, N], "
                                  f"contracted on K")
    k = x.shape[-1]
    rows = w4.codes.shape[0] if plane else w4.k
    n = w4.k if transposed else w4.codes.shape[1]
    x2 = x.reshape(-1, k).to(torch.float32).contiguous()
    m = x2.shape[0]
    nibble = w4.nibble if plane else None
    with _site(x2, backend) as (be, why):
        if be == "ref":
            y = floatsd4_matmul_ref(x2, w4.codes, w4.exps, rows, transposed=transposed,
                                    dense=w4.dense, nibble=nibble)
        else:
            y = fm4_ops.floatsd4_matmul(x2, w4.codes, w4.exps, rows, transposed=transposed, nibble=nibble)
        if be == "ref" and w4.dense is not None:  # the plain version reads the hoisted decode
            _record("floatsd4_matmul", be, why, (m, k, n, True), lambda: fm_cost.matmul_like_cost(
                m, k, n, b_bytes=4, decode=False), _nbytes(x2, w4.dense, y))
        else:
            wt = _nbytes(w4.codes, w4.exps)
            _record("floatsd4_matmul", be, why, (m, k, n, wt, plane), lambda: fm4_cost.matmul4_fwd_cost(
                m, k, n, backend=be, wt_nbytes=None if plane else wt, plane=plane), wt + _nbytes(x2, y))
    return y.reshape(*x.shape[:-1], n)


def packed_einsum(eq: str, x: torch.Tensor, packed, *,
                  backend: str | None = None) -> torch.Tensor:
    """The weight-site einsums over a PackedTensor, PackedTensor4 or
    LayerTensor4: ``...d,df->...f`` / ``bd,dk->bk`` (contract w's first
    axis), ``...d,vd->...v`` (contract w's second axis: the tied logits
    head, whose codes the kernel reads in place), and the experts' products
    ``gecd,edh->gech`` / ``gech,ehd->gecd`` over FloatSD8 codes [E, K, N]
    or a layer's FloatSD4 planes [E, K, N] (``expert_einsum``). Returns
    f32."""
    ins, out = eq.replace(" ", "").split("->")
    xl, wl = ins.split(",")
    cl = xl[-1]
    if len(wl) == 3 and (is_packed(packed) or is_layer4(packed)):
        return expert_einsum(eq, x, packed, backend=backend)
    if len(wl) != 2 or cl not in wl or packed.codes.dim() != 2:
        raise NotImplementedError(f"packed_einsum does not support {eq!r}")
    transposed = wl[1] == cl  # w stored [free, contract], e.g. "vd"
    wf = wl[0] if transposed else wl[1]
    if out != xl[:-1] + wf:
        raise NotImplementedError(f"packed_einsum does not support {eq!r}")
    if is_packed4(packed) or is_layer4(packed):
        return matmul4(x, packed, transposed=transposed, backend=backend)
    return matmul(x, packed.codes, packed.bias, transposed=transposed, dense=packed.dense,
                  backend=backend)


def expert_einsum(eq: str, x: torch.Tensor, packed, *,
                  backend: str | None = None) -> torch.Tensor:
    """The MoE's per-expert products over FloatSD8 codes [E, K, N] with
    one bias, or over a stacked MoE layer's FloatSD4 planes [E, K, N]
    (a ``LayerTensor4``): ``gecd,edh->gech`` (and ``gech,ehd->gecd``). For
    each expert e, x[:, e] ([g, C, K], g*C rows) times the codes[e] through
    ``matmul`` or ``matmul4``: E calls, each the kernel on the card (and
    recorded) or the plain version's decode and product. Returns f32 [g,
    E, C, N]."""
    ins, out = eq.replace(" ", "").split("->")
    xl, wl = ins.split(",")
    el, cl, fl = wl
    if (len(xl) != 4 or xl[1] != el or xl[-1] != cl or out != xl[:-1] + fl
            or packed.codes.shape[0] != x.shape[1]):
        raise NotImplementedError(f"packed_einsum does not support {eq!r} on codes "
                                  f"{tuple(packed.codes.shape)}")
    e = x.shape[1]
    if is_layer4(packed):
        ys = [matmul4(x[:, i], LayerTensor4(packed.codes[i], packed.exps[i], packed.nibble,
                                            None if packed.dense is None else packed.dense[i]),
                      backend=backend)
              for i in range(e)]
    else:
        ys = [matmul(x[:, i], packed.codes[i], packed.bias,
                     dense=None if packed.dense is None else packed.dense[i], backend=backend)
              for i in range(e)]
    return torch.stack(ys, dim=1)


def hoist_packed(w, *, backend: str | None = None):
    """Loop-hoist hint for packed weights used inside a time loop.

    When the plain version will run the matmuls, decoding the codes once
    outside the loop beats a decode at every step: the returned
    PackedTensor / PackedTensor4 / LayerTensor4 carries the decode in
    ``dense``. On the card the codes stay as they are, since decoding in the
    tile is the kernel's point. Anything else passes through.
    """
    if not is_any_packed(w) or w.dense is not None:
        return w
    if _resolve(w.codes, backend)[0] != "ref":
        return w
    if is_packed4(w):
        return w._replace(dense=unpack4(w))
    if is_layer4(w):
        return w._replace(dense=floatsd4.decode_plane(w.codes, w.exps, w.nibble))
    return w._replace(dense=floatsd.decode(w.codes, w.bias, dtype=torch.float32))


# ---------------------------------------------------------------------------
# backward ops and weight hoists of the fused quantized-BPTT training path
# ---------------------------------------------------------------------------


def matmul_dx(g: torch.Tensor, codes: torch.Tensor, bias, *, dense: torch.Tensor | None = None,
              ordered: bool = False, backend: str | None = None) -> torch.Tensor:
    """Activation gradient of the FloatSD8 matmul: g [..., N] @
    decode(codes [K, N])^T -> [..., K] f32 (the precise datapath: FP8
    activation-gradient quantization lives at the act_quant nodes). The
    kernel is ``floatsd_matmul`` on the codes read in place as [K, N] =
    [out, contraction]; ``dense`` is the codes' decode from ``hoist_train``."""
    k, n = codes.shape
    g2 = g.reshape(-1, n).to(torch.float32).contiguous()
    with _site(g2, backend) as (be, why):
        if be == "ref":
            w = floatsd.decode(codes, bias, dtype=torch.float32) if dense is None else dense
            y = split_matmul(g2, w.t(), ordered)
            touched = _nbytes(g2, codes if dense is None else dense, y)
        else:
            y = fm_ops.matmul_dx(g2, codes, bias, ordered=ordered)
            touched = _nbytes(g2, codes, y)
        m, hoisted = g2.shape[0], dense is not None
        _record("floatsd_matmul_dx", be, why, (m, n, k, ordered, hoisted), lambda: fm_cost.matmul_dx_cost(
            m, n, k, backend=be, ordered=ordered, dense=hoisted), touched)
    return y.reshape(*g.shape[:-1], k)


def matmul_dw(x: torch.Tensor, g: torch.Tensor, *, quant: bool = True,
              backend: str | None = None, mesh=None, batch_dim: int = 0) -> torch.Tensor:
    """Weight gradient of the FloatSD8 matmul: x [..., K]^T @ g [..., N] ->
    [K, N] f32, f32 accumulation over all leading rows, snapped to the FP8
    e5m2 grid at the flush (``quant=False``: the raw sum, for parity
    oracles).

    ``mesh``: x and g hold this rank's share of a batch split along
    ``batch_dim`` over the mesh's batch axes (the caller captures the mesh
    in its forward: autograd may run the backward on another thread). Both
    are all-gathered, so the one chain runs over the global rows in their
    order and the snap sees the global sum; the batch's first rank returns
    that dW and every other rank zeros, so the train step's sum of the
    ranks' shares is the global dW exactly."""
    k, n = x.shape[-1], g.shape[-1]
    if mesh is not None:
        axes = shd.batch_axes(mesh)
        x, g = shd.all_gather(x, batch_dim, axes, mesh), shd.all_gather(g, batch_dim, axes, mesh)
        if shd.batch_rank(mesh):
            return torch.zeros((k, n), dtype=torch.float32, device=x.device)
    x2 = x.reshape(-1, k).to(torch.float32).contiguous()
    g2 = g.reshape(-1, n).to(torch.float32).contiguous()
    if x2.shape[0] != g2.shape[0]:
        raise ValueError(f"matmul_dw: x {tuple(x.shape)} vs g {tuple(g.shape)}")
    with _site(x2, backend) as (be, why):
        if be == "ref":
            dw = matmul_dw_ref(x2, g2, quant)
        else:
            dw = fm_ops.matmul_dw(x2, g2, quant=quant)
        m = x2.shape[0]
        _record("floatsd_matmul_dw", be, why, (k, m, n, quant), lambda: fm_cost.matmul_dw_cost(
            k, m, n, backend=be, quant=quant), _nbytes(x2, g2, dw))
    return _dw_flush_telemetry(dw, quant)


def _dw_flush_telemetry(dw: torch.Tensor, quant: bool) -> torch.Tensor:
    """The quantizer-health hook at matmul_dw's flush: while
    ``obs.telemetry.KERNEL_STATS`` is enabled, count the snapped dW's
    saturated values (|dw| at the e5m2 clamp) and zeros (true zeros and
    underflows, which the snap has made zeros) in torch ops on dw's device.
    The sink keeps the counts there until ``snapshot()``, so no step waits
    on the host."""
    if quant and obs_telemetry.KERNEL_STATS.enabled:
        obs_telemetry.KERNEL_STATS.record(
            "floatsd_matmul_dw", dw.numel(),
            (dw.abs() >= obs_telemetry.FP8_SAT_THRESHOLD).sum(), (dw == 0).sum())
    return dw


def lstm_cell_grad(z: torch.Tensor, c_prev: torch.Tensor, dh: torch.Tensor, dc: torch.Tensor, *,
                   quantized: bool = True, c_dtype=torch.float16, backend: str | None = None):
    """Recompute-gates backward of the fused cell. z: [B, 4H], c_prev: [B, H]
    in ``c_dtype`` (as the forward stored it), dh, dc: [B, H] -> (dz [B, 4H]
    f32, dc_prev [B, H] f32). Its only residuals are (z, c_prev)."""
    with _site(z, backend) as (be, why):
        if be == "ref":
            c_prev = c_prev.to(torch.float32)  # the plain version takes the f32 cell state
            dz, dcp = lstm_cell_bwd_ref(z, c_prev, dh, dc, quantized, c_dtype=c_dtype)
        else:
            z, c_prev = z.contiguous(), c_prev.contiguous()
            dh, dc = dh.to(torch.float32).contiguous(), dc.to(torch.float32).contiguous()
            dz, dcp = lc_ops.lstm_cell_grad(z, c_prev, dh, dc, quantized=quantized, c_dtype=c_dtype)
        shape = (z.numel() // z.shape[-1], z.shape[-1] // 4, z.element_size(), c_prev.element_size(),
                 dh.element_size(), dc.element_size(), dz.element_size(), dcp.element_size(), quantized)
        _record("lstm_cell_grad", be, why, shape, lambda: lc_cost.lstm_cell_grad_cost(
            *shape[:2], backend=be, z_bytes=shape[2], c_in_bytes=shape[3], dh_bytes=shape[4], dc_bytes=shape[5],
            dz_bytes=shape[6], dcp_bytes=shape[7], quantized=quantized), _nbytes(z, c_prev, dh, dc, dz, dcp))
    return dz, dcp


class _InferenceOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        raise TypeError("a gradient reached values computed from packed (FloatSD8/FloatSD4-coded) "
                        "weights, which are inference-only: train on the dense masters")


def inference_only(y: torch.Tensor) -> torch.Tensor:
    """Identity whose backward raises: marks values computed from packed
    weights, where a missing gradient to the codes would otherwise pass in
    silence."""
    return _InferenceOnly.apply(y)


def pack_train(w: torch.Tensor) -> PackedTensor:
    """Encode a dense master weight to FloatSD8 codes for the fused training
    path, once per step (the encode is time-invariant). decode(codes) equals
    ``quantize(w).values`` bit for bit. The bias becomes a host int, which
    reads it from the device: one synchronisation per packed weight."""
    codes, bias = floatsd.encode(w.detach())
    return PackedTensor(codes, int(bias))


def hoist_train(w: torch.Tensor, *, backend: str | None = None) -> PackedTensor:
    """The fused training path's weight hoist, the gradient-side twin of
    ``hoist_packed``: the packed codes, plus their decode in ``dense`` when
    the plain versions will run (so neither scan decodes per step)."""
    return hoist_packed(pack_train(w), backend=backend)


class _TrainMatmulPacked(torch.autograd.Function):
    """x @ decode(codes) with the fused backward: dx = matmul_dx in f32 (in
    x's dtype), dw = matmul_dw with its FP8 snap at the flush, cast to the
    master's dtype and passed straight through to the master ``w``."""

    @staticmethod
    def forward(ctx, x, w, wq, backend):
        ctx.save_for_backward(x)
        ctx.wq, ctx.w_dtype, ctx.backend, ctx.mesh = wq, w.dtype, backend, shd.active_mesh()
        return matmul(x, wq.codes, wq.bias, dense=wq.dense, backend=backend)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        wq, backend = ctx.wq, ctx.backend
        dx = matmul_dx(g, wq.codes, wq.bias, dense=wq.dense, backend=backend).to(x.dtype)
        dw = matmul_dw(x, g, backend=backend, mesh=ctx.mesh).to(ctx.w_dtype)
        return dx, dw, None, None


class _TrainMatmulDense(torch.autograd.Function):
    """The dense hoist's twin (the reference's ref-backend path): x @ wq as a
    plain f32 product; dx likewise, dw through the FP8 oracle (the plain
    ``matmul_dw``), both in their primal's dtype. dw goes to ``wq`` (the
    caller's straight-through node on the master)."""

    @staticmethod
    def forward(ctx, x, wq):
        ctx.save_for_backward(x, wq)
        return torch.matmul(x.to(torch.float32), wq.to(torch.float32))

    @staticmethod
    def backward(ctx, g):
        x, wq = ctx.saved_tensors
        (k2, n2), m = wq.shape, g.numel() // g.shape[-1]
        shape = (m, n2, k2, g.element_size(), wq.element_size(), x.element_size())
        _record("floatsd_matmul_dx", "ref", "train:hoisted-dense", shape, lambda: fm_cost.matmul_like_cost(
            m, n2, k2, a_bytes=shape[3], b_bytes=shape[4], o_bytes=shape[5], decode=False),
            _nbytes(g, wq) + m * k2 * x.element_size())
        dx = torch.matmul(g, wq.to(torch.float32).t()).to(x.dtype)
        return dx, matmul_dw(x, g, backend="ref").to(wq.dtype)


def train_matmul(x: torch.Tensor, w: torch.Tensor, wq, *, backend: str | None = None) -> torch.Tensor:
    """The training path's matmul: x [..., K] @ quantized(w) -> [..., N] f32
    with the fused backward. ``w`` is the dense master the FP8 dW flows to;
    ``wq`` its hoist: a ``PackedTensor`` from ``hoist_train`` (the forward
    and dx on the codes, dw from matmul_dw with its in-kernel FP8 snap), or
    a dense quantized value (a plain f32 product, dw through the FP8
    oracle, to ``wq``; ``w`` is then unused)."""
    _check(backend)
    if is_packed(wq):
        return _TrainMatmulPacked.apply(x, w, wq, backend)
    (k2, n2), m = wq.shape, x.numel() // x.shape[-1]
    shape = (m, k2, n2, x.element_size(), wq.element_size())
    _record("floatsd_matmul", "ref", "train:hoisted-dense", shape, lambda: fm_cost.matmul_like_cost(
        m, k2, n2, a_bytes=shape[3], b_bytes=shape[4], decode=False), _nbytes(x, wq) + m * n2 * 4)
    return _TrainMatmulDense.apply(x, wq)


class _LSTMCellTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, c_prev, quantized, c_dtype, backend):
        ctx.save_for_backward(z, c_prev)  # the only residuals: the gates are recomputed
        ctx.cfg = (quantized, c_dtype, backend)
        return lstm_cell(z, c_prev, quantized=quantized, c_dtype=c_dtype, backend=backend)

    @staticmethod
    def backward(ctx, dh, dc):
        z, c_prev = ctx.saved_tensors
        quantized, c_dtype, backend = ctx.cfg
        dz, dc_prev = lstm_cell_grad(z, c_prev, dh, dc, quantized=quantized, c_dtype=c_dtype,
                                     backend=backend)
        return dz.to(z.dtype), dc_prev.to(c_prev.dtype), None, None, None


def lstm_cell_train(z: torch.Tensor, c_prev: torch.Tensor, *, quantized: bool = True,
                    c_dtype=torch.float16, backend: str | None = None):
    """The fused cell with the recompute-gates backward, the training twin of
    ``lstm_cell``: the same forward (the same dispatched op); the backward
    is ``lstm_cell_grad``, saving only (z, c_prev) where autodiff keeps
    every gate."""
    _check(backend)
    return _LSTMCellTrain.apply(z, c_prev, quantized, c_dtype, backend)


# ---------------------------------------------------------------------------
# element-wise entry points
# ---------------------------------------------------------------------------


def quantize(x: torch.Tensor, bias=None, *, backend: str | None = None):
    """Any-shape finite tensor -> (uint8 FloatSD8 codes of its shape, bias).
    ``bias`` defaults to ``floatsd.fit_bias(x)``, a device int32 that the
    kernel reads in place, so no host synchronisation happens here; it is
    returned as given (a 0-d int32 tensor), and the codes use it clamped
    as ``floatsd.encode`` clamps it."""
    bias = floatsd.fit_bias(x) if bias is None else torch.as_tensor(
        bias, dtype=torch.int32, device=x.device)
    with _site(x, backend) as (be, why):
        if be == "ref":
            codes = quantize_ref(x, bias)
            x_bytes = x.element_size()
        else:
            codes = fq_ops.floatsd_quantize(x, bias)
            # the kernel reads f32 and fp16 as they are, any other dtype cast to f32
            x_bytes = x.element_size() if x.dtype in (torch.float32, torch.float16) else 4
        shape = (x.numel(), x_bytes, bias.element_size())
        _record("floatsd_quantize", be, why, shape, lambda: fq_cost.quantize_cost(
            shape[0], backend=be, x_bytes=x_bytes, bias_bytes=shape[2]), _nbytes(x, bias, codes))
    return codes, bias


def _grad_wanted(*ts: torch.Tensor) -> bool:
    """Does the call build an autograd node: grad mode on and an input
    that requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _qsigmoid(x: torch.Tensor, backend: str | None) -> torch.Tensor:
    with _site(x, backend) as (be, why):
        y = qsigmoid_ref(x) if be == "ref" else qs_ops.qsigmoid(x)
        shape = (x.numel(), x.element_size(), y.element_size())
        _record("qsigmoid", be, why, shape, lambda: qs_cost.qsigmoid_cost(
            shape[0], backend=be, x_bytes=shape[1], y_bytes=shape[2]), _nbytes(x, y))
    return y


class _QSigmoid(torch.autograd.Function):
    """The dispatched forward; the reference's straight-through backward,
    the exact sigmoid's derivative g s (1 - s) in x's dtype
    (``repro.core.qsigmoid.qsigmoid``)."""

    @staticmethod
    def forward(ctx, x, backend):
        ctx.save_for_backward(x)
        return _qsigmoid(x, backend)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        return g * (s * (1 - s)), None


def qsigmoid(x: torch.Tensor, *, backend: str | None = None) -> torch.Tensor:
    """Two-region FloatSD8 sigmoid of any-shape ``x``, same shape and
    dtype. Differentiable (straight through) when grad is on and ``x``
    requires it."""
    if _grad_wanted(x):
        _check(backend)
        return _QSigmoid.apply(x, backend)
    return _qsigmoid(x, backend)


# ---------------------------------------------------------------------------
# the model zoo's recurrence and attention
# ---------------------------------------------------------------------------


class _RwkvWkv(torch.autograd.Function):
    """The dispatched forward; the backward recomputes the wkv under
    autograd through ``wkv_chunked_scan``, the reference model's chunked
    scan, the function whose gradient the reference takes."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, backend):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.set_materialize_grads(False)
        return _rwkv_wkv(r, k, v, w, u, backend)

    @staticmethod
    def backward(ctx, gy, gs):
        ins = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, st = wkv_chunked_scan(*ins)
        outs = [(o, g) for o, g in ((y, gy), (st, gs)) if g is not None and o.requires_grad]
        wanted = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in outs], wanted, [g for _, g in outs], allow_unused=True)
                     if outs and wanted else ())
        return (*(next(grads) if t.requires_grad else None for t in ins), None)


def rwkv_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
             *, chunk: int = 16, backend: str | None = None):
    """Chunked RWKV-6 wkv from a zero state, in the model's per-head layout:
    r, k, w [B, S, H, K], v [B, S, H, V], u [H, K] or [B, H, K] -> (y [B, S,
    H, V] f32, the state after the last token [B, H, K, V] f32). The kernel
    evaluates 16 tokens at a time with the state kept on chip; ``chunk`` is
    the reference's argument and must be 16, the kernel's fixed chunk. The
    plain version is the per-token recurrence (the same function). A short
    last chunk is bounds-checked, so every S runs unpadded. Differentiable
    when grad is on and an input requires it (``_RwkvWkv``)."""
    if chunk != rw_ops.CHUNK:
        raise ValueError(f"rwkv_wkv: the kernel's chunk is {rw_ops.CHUNK}, got {chunk}")
    if _grad_wanted(r, k, v, w, u):
        _check(backend)
        return _RwkvWkv.apply(r, k, v, w, u, backend)
    return _rwkv_wkv(r, k, v, w, u, backend)


def _rwkv_wkv(r, k, v, w, u, backend):
    with _site(r, backend) as (be, why):
        y, state = wkv_ref(r, k, v, w, u) if be == "ref" else rw_ops.rwkv_wkv(r, k, v, w, u)
        b, s, h, kk = r.shape
        shape = (b, s, h, kk, v.shape[-1], u.dim() == 3, r.element_size())
        _record("rwkv_wkv", be, why, shape, lambda: rw_cost.wkv_cost(
            *shape[:5], backend=be, u_batched=shape[5], elem_bytes=shape[6]), _nbytes(r, k, v, w, u, y, state))
    return y, state


class _FlashAttention(torch.autograd.Function):
    """The dispatched forward, asked for each row's log-sum-exp; the
    backward is ``flash_bwd`` on the saved o and lse (the reference's
    custom VJP), with the reference's query chunk min(1024, Skv)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix, backend):
        o, lse = _flash_attention(q, k, v, causal, window, prefix, backend, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, window, prefix)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, prefix = ctx.cfg
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal=causal, window=window, prefix=prefix,
                               chunk=min(1024, k.shape[1]))
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, prefix: int = 0, backend: str | None = None) -> torch.Tensor:
    """Attention over contiguous positions from 0 in the model layout: q
    [B, Sq, H, D], k, v [B, Skv, Kh, D] (query head h reads KV head h // (H
    / Kh)), causal (row i admits the keys j <= max(i, prefix - 1): a
    ``prefix`` of positions that see one another whole, Qwen2-VL's patches)
    or full (an encoder's, a cross-attention's, any Sq and Skv), with an
    optional sliding window -> [B, Sq, H, D] in q's dtype. The kernel walks
    KV tiles of its own size with the running softmax state on chip; the
    plain version is the model's chunked online softmax (1024 query rows
    against 512 keys at a time, the reference model's split), the same
    function: both round p and v to bf16 before their product.
    Differentiable when grad is on and an input requires it
    (``_FlashAttention``: the forward also writes each row's log-sum-exp)."""
    if _grad_wanted(q, k, v):
        _check(backend)
        return _FlashAttention.apply(q, k, v, causal, window, prefix, backend)
    return _flash_attention(q, k, v, causal, window, prefix, backend, False)[0]


def _flash_attention(q, k, v, causal, window, prefix, backend, lse: bool):
    """(o, each row's log-sum-exp or None) from the resolved backend."""
    with _site(q, backend) as (be, why):
        if isinstance(q, FakeTensor):  # a trace's (launch.step_analysis): no values, the outputs' shapes alone
            o = torch.empty_like(q)
            out = (o, q.new_empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32)) if lse else o
        elif be == "ref":
            out = flash_attention_gqa(q, k, v, causal=causal, window=window, prefix=prefix, return_lse=lse)
        else:
            out = fa_ops.flash_attention(q, k, v, causal=causal, window=window, prefix=prefix, return_lse=lse)
        o, row_lse = out if lse else (out, None)
        b, sq, h, d = q.shape
        shape = (b, sq, k.shape[1], h, k.shape[2], d, causal, window, q.element_size(), prefix, lse)
        _record("flash_attention", be, why, shape, lambda: fa_cost.flash_attention_cost(
            *shape[:6], backend=be, causal=causal, window=window, elem_bytes=shape[8], prefix=prefix, lse=lse),
            _nbytes(q, k, v, o, *([row_lse] if lse else [])))
    return o, row_lse


# ---------------------------------------------------------------------------
# the cost model of each op (obs.costmodel's CostSpec contract)
# ---------------------------------------------------------------------------

#: op -> its CostSpec: every op name a Decision is recorded under.
COST_SPECS: dict[str, costmodel.CostSpec] = {spec.op: spec for spec in (
    costmodel.CostSpec(
        "floatsd_matmul", fm_cost.matmul_fwd_cost,
        "decode-in-tile GEMM, codes 1 byte a weight (ref: a read of the hoisted f32 decode instead, "
        "and the train path's dense product); cuda: plan()'s route, x once per 128-column block, codes "
        "once per row block, partials written and read back when split; route B's bf16 pieces of x "
        "written once and read per column block"),
    costmodel.CostSpec(
        "floatsd_matmul_dx", fm_cost.matmul_dx_cost,
        "the forward kernel on the codes read in place as [out, contraction]; f32 g"),
    costmodel.CostSpec(
        "floatsd_matmul_dw", fm_cost.matmul_dw_cost,
        "dense f32 GEMM summed over the rows in order, FP8-e5m2 snap at the flush; cuda: 128 x 128 "
        "tiles, x once per column tile, g once per row tile, 48 KiB of shared memory"),
    costmodel.CostSpec(
        "lstm_cell", lc_cost.lstm_cell_cost,
        "element-wise, one pass; 3 MACs an element (Table-7 Eq. 5-6 lanes); c in c_dtype (fp16 state); "
        "cuda: the gate function's 289-entry table in shared memory"),
    costmodel.CostSpec(
        "lstm_cell_grad", lc_cost.lstm_cell_grad_cost,
        "recompute-gates backward, one pass; residuals (z, c_prev) only; ref reads c_prev as f32"),
    costmodel.CostSpec(
        "floatsd4_matmul", fm4_cost.matmul4_fwd_cost,
        "sub-byte decode-in-tile GEMM: 2 codes a byte + int8 group exponents (~0.53 byte a weight); "
        "a stacked leaf's layer reads its code-byte and exponent planes (2 bytes a weight); "
        "cuda: route A at every M, as floatsd_matmul's"),
    costmodel.CostSpec(
        "floatsd_quantize", fq_cost.quantize_cost,
        "element-wise encode to 1-byte codes, one pass; the bias a 4-byte device int"),
    costmodel.CostSpec(
        "qsigmoid", qs_cost.qsigmoid_cost,
        "element-wise two-region LUT sigmoid, one pass"),
    costmodel.CostSpec(
        "rwkv_wkv", rw_cost.wkv_cost,
        "ref: the per-token recurrence; cuda: chunks of 16, the pre-pass's records written once and "
        "read once per 16-column slice of V; y and the final state f32"),
    costmodel.CostSpec(
        "flash_attention", fa_cost.flash_attention_cost,
        "online softmax, GQA read in place; cuda: K/V bf16 pieces written once by the pre-pass and read "
        "per 128-row query block over the tiles its band admits; masked pairs of visited tiles charged "
        "to pad_waste_flops"),
)}
