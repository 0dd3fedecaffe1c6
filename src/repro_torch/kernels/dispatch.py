"""Kernel dispatch: routes each op to its hand-written CUDA kernel or to its
plain PyTorch version.

Counterpart of ``repro.kernels.dispatch``: the serving ops over FloatSD8
(``PackedTensor``) and FloatSD4 (``PackedTensor4``) weights, the backward
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
that actually ran.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import floatsd, floatsd4
from ..obs import telemetry as obs_telemetry
from .flash_attention import ops as fa_ops
from .flash_attention.ref import flash_attention_gqa
from .floatsd4_matmul import ops as fm4_ops
from .floatsd4_matmul.ref import floatsd4_matmul_ref
from .floatsd_matmul import ops as fm_ops
from .floatsd_matmul.ref import matmul_dw_ref, split_matmul
from .floatsd_quantize import ops as fq_ops
from .floatsd_quantize.ref import quantize_ref
from .lstm_cell import ops as lc_ops
from .lstm_cell.ref import lstm_cell_bwd_ref, lstm_cell_ref
from .qsigmoid import ops as qs_ops
from .qsigmoid.ref import qsigmoid_ref
from .rwkv_wkv import ops as rw_ops
from .rwkv_wkv.ref import wkv_ref

__all__ = [
    "BACKENDS", "ZERO_CODE", "PackedTensor", "is_packed", "Decision",
    "DispatchStats", "STATS", "use_backend", "matmul", "lstm_cell",
    "packed_einsum", "hoist_packed", "matmul_dx", "matmul_dw", "lstm_cell_grad",
    "pack_train", "hoist_train", "train_matmul", "lstm_cell_train", "inference_only",
    "PackedTensor4", "is_packed4", "is_any_packed", "pack4",
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


def is_any_packed(x: Any) -> bool:
    return isinstance(x, (PackedTensor, PackedTensor4))


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


class Decision(NamedTuple):
    op: str
    backend: str  # "ref" | "cuda"
    reason: str


class DispatchStats:
    """Per-(op, backend) call counters and the last Decision per op."""

    def __init__(self):
        self.counts: collections.Counter = collections.Counter()
        self.last: dict[str, Decision] = {}
        self._lock = threading.Lock()

    def record(self, d: Decision) -> None:
        with self._lock:
            self.counts[(d.op, d.backend)] += 1
            self.last[d.op] = d

    def count(self, op: str | None = None, backend: str | None = None) -> int:
        with self._lock:
            return sum(
                n for (o, b), n in self.counts.items()
                if (op is None or o == op) and (backend is None or b == backend)
            )

    def reset(self) -> None:
        with self._lock:
            self.counts.clear()
            self.last.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counts)


STATS = DispatchStats()

_OVERRIDE: list[str] = []  # use_backend() stack


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


def _decide(op: str, t: torch.Tensor, backend: str | None) -> Decision:
    _check(backend)
    if (backend or (_OVERRIDE[-1] if _OVERRIDE else None)) == "ref":
        return Decision(op, "ref", "policy:ref")
    if t.device.type == "cuda":
        return Decision(op, "cuda", "cuda tensor")
    return Decision(op, "ref", f"{t.device.type} tensor")


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
    dec = _decide("floatsd_matmul", x2, backend)
    if dec.backend == "ref":
        w = floatsd.decode(codes, bias, dtype=torch.float32) if dense is None else dense
        y = split_matmul(x2, w.t() if transposed else w, ordered)
    else:
        y = fm_ops.floatsd_matmul(x2, codes, bias, transposed=transposed, ordered=ordered)
    STATS.record(dec)
    return y.reshape(*x.shape[:-1], n)


def lstm_cell(z: torch.Tensor, c_prev: torch.Tensor, *, quantized: bool = True,
              c_dtype=torch.float16, backend: str | None = None):
    """Fused gates -> (h, c). z: [B, 4H] (i|f|g|o), c_prev: [B, H]."""
    dec = _decide("lstm_cell", z, backend)
    if dec.backend == "ref":
        out = lstm_cell_ref(z, c_prev, quantized, c_dtype=c_dtype)
    else:
        out = lc_ops.lstm_cell(
            z.contiguous(), c_prev.contiguous(), quantized=quantized, c_dtype=c_dtype
        )
    STATS.record(dec)
    return out


def matmul4(x: torch.Tensor, w4: PackedTensor4, *, transposed: bool = False,
            backend: str | None = None) -> torch.Tensor:
    """x [..., K] @ decode4(w4) -> [..., N] f32, w4 packed [K, N] or, when
    ``transposed``, the [N, K] table read in place (the tied head). x is
    taken in f32, exactly as ``matmul`` takes it. On the card both layouts
    run the kernel; the JAX package decodes the table and multiplies
    densely for the head, because a Pallas block cannot transpose a nibble
    stream: the same function, and a CUDA thread reads any nibble."""
    k = x.shape[-1]
    n = w4.k if transposed else w4.codes.shape[1]
    x2 = x.reshape(-1, k).to(torch.float32).contiguous()
    dec = _decide("floatsd4_matmul", x2, backend)
    if dec.backend == "ref":
        y = floatsd4_matmul_ref(x2, w4.codes, w4.exps, w4.k, transposed=transposed,
                                dense=w4.dense)
    else:
        y = fm4_ops.floatsd4_matmul(x2, w4.codes, w4.exps, w4.k, transposed=transposed)
    STATS.record(dec)
    return y.reshape(*x.shape[:-1], n)


def packed_einsum(eq: str, x: torch.Tensor, packed, *,
                  backend: str | None = None) -> torch.Tensor:
    """The weight-site einsums over a PackedTensor or PackedTensor4:
    ``...d,df->...f`` / ``bd,dk->bk`` (contract w's first axis) and
    ``...d,vd->...v`` (contract w's second axis: the tied logits head,
    whose codes the kernel reads in place). Returns f32."""
    ins, out = eq.replace(" ", "").split("->")
    xl, wl = ins.split(",")
    cl = xl[-1]
    if len(wl) != 2 or cl not in wl:
        raise NotImplementedError(f"packed_einsum does not support {eq!r}")
    transposed = wl[1] == cl  # w stored [free, contract], e.g. "vd"
    wf = wl[0] if transposed else wl[1]
    if out != xl[:-1] + wf:
        raise NotImplementedError(f"packed_einsum does not support {eq!r}")
    if is_packed4(packed):
        return matmul4(x, packed, transposed=transposed, backend=backend)
    return matmul(x, packed.codes, packed.bias, transposed=transposed, dense=packed.dense,
                  backend=backend)


def hoist_packed(w, *, backend: str | None = None):
    """Loop-hoist hint for packed weights used inside a time loop.

    When the plain version will run the matmuls, decoding the codes once
    outside the loop beats a decode at every step: the returned
    PackedTensor / PackedTensor4 carries the decode in ``dense``. On the
    card the codes stay as they are, since decoding in the tile is the
    kernel's point. Anything else passes through.
    """
    if not is_any_packed(w) or w.dense is not None:
        return w
    op = "floatsd4_matmul" if is_packed4(w) else "floatsd_matmul"
    if _decide(op, w.codes, backend).backend != "ref":
        return w
    if is_packed4(w):
        return w._replace(dense=unpack4(w))
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
    dec = _decide("floatsd_matmul_dx", g2, backend)
    if dec.backend == "ref":
        w = floatsd.decode(codes, bias, dtype=torch.float32) if dense is None else dense
        y = split_matmul(g2, w.t(), ordered)
    else:
        y = fm_ops.matmul_dx(g2, codes, bias, ordered=ordered)
    STATS.record(dec)
    return y.reshape(*g.shape[:-1], k)


def matmul_dw(x: torch.Tensor, g: torch.Tensor, *, quant: bool = True,
              backend: str | None = None) -> torch.Tensor:
    """Weight gradient of the FloatSD8 matmul: x [..., K]^T @ g [..., N] ->
    [K, N] f32, f32 accumulation over all leading rows, snapped to the FP8
    e5m2 grid at the flush (``quant=False``: the raw sum, for parity
    oracles)."""
    k, n = x.shape[-1], g.shape[-1]
    x2 = x.reshape(-1, k).to(torch.float32).contiguous()
    g2 = g.reshape(-1, n).to(torch.float32).contiguous()
    if x2.shape[0] != g2.shape[0]:
        raise ValueError(f"matmul_dw: x {tuple(x.shape)} vs g {tuple(g.shape)}")
    dec = _decide("floatsd_matmul_dw", x2, backend)
    if dec.backend == "ref":
        dw = matmul_dw_ref(x2, g2, quant)
    else:
        dw = fm_ops.matmul_dw(x2, g2, quant=quant)
    STATS.record(dec)
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
    dec = _decide("lstm_cell_grad", z, backend)
    if dec.backend == "ref":
        out = lstm_cell_bwd_ref(z, c_prev.to(torch.float32), dh, dc, quantized, c_dtype=c_dtype)
    else:
        out = lc_ops.lstm_cell_grad(
            z.contiguous(), c_prev.contiguous(), dh.to(torch.float32).contiguous(),
            dc.to(torch.float32).contiguous(), quantized=quantized, c_dtype=c_dtype,
        )
    STATS.record(dec)
    return out


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
        ctx.wq, ctx.w_dtype, ctx.backend = wq, w.dtype, backend
        return matmul(x, wq.codes, wq.bias, dense=wq.dense, backend=backend)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        wq, backend = ctx.wq, ctx.backend
        dx = matmul_dx(g, wq.codes, wq.bias, dense=wq.dense, backend=backend).to(x.dtype)
        dw = matmul_dw(x, g, backend=backend).to(ctx.w_dtype)
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
        STATS.record(Decision("floatsd_matmul_dx", "ref", "train:hoisted-dense"))
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
    STATS.record(Decision("floatsd_matmul", "ref", "train:hoisted-dense"))
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
    dec = _decide("floatsd_quantize", x, backend)
    if dec.backend == "ref":
        codes = quantize_ref(x, bias)
    else:
        codes = fq_ops.floatsd_quantize(x, bias)
    STATS.record(dec)
    return codes, bias


def qsigmoid(x: torch.Tensor, *, backend: str | None = None) -> torch.Tensor:
    """Two-region FloatSD8 sigmoid of any-shape ``x``, same shape and
    dtype."""
    dec = _decide("qsigmoid", x, backend)
    y = qsigmoid_ref(x) if dec.backend == "ref" else qs_ops.qsigmoid(x)
    STATS.record(dec)
    return y


# ---------------------------------------------------------------------------
# the model zoo's recurrence and attention
# ---------------------------------------------------------------------------


def rwkv_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
             *, chunk: int = 16, backend: str | None = None):
    """Chunked RWKV-6 wkv from a zero state, in the model's per-head layout:
    r, k, w [B, S, H, K], v [B, S, H, V], u [H, K] or [B, H, K] -> (y [B, S,
    H, V] f32, the state after the last token [B, H, K, V] f32). The kernel
    evaluates 16 tokens at a time with the state kept on chip; ``chunk`` is
    the reference's argument and must be 16, the kernel's fixed chunk. The
    plain version is the per-token recurrence (the same function). A short
    last chunk is bounds-checked, so every S runs unpadded."""
    if chunk != rw_ops.CHUNK:
        raise ValueError(f"rwkv_wkv: the kernel's chunk is {rw_ops.CHUNK}, got {chunk}")
    dec = _decide("rwkv_wkv", r, backend)
    out = wkv_ref(r, k, v, w, u) if dec.backend == "ref" else rw_ops.rwkv_wkv(r, k, v, w, u)
    STATS.record(dec)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, backend: str | None = None) -> torch.Tensor:
    """Self-attention over contiguous positions from 0 in the model layout:
    q [B, Sq, H, D], k, v [B, Skv, Kh, D] (query head h reads KV head h //
    (H / Kh)), causal and an optional sliding window -> [B, Sq, H, D] in
    q's dtype. The kernel walks KV tiles of its own size with the running
    softmax state on chip; the plain version is the model's chunked online
    softmax (1024 query rows against 512 keys at a time, the reference
    model's split), the same function: both round p and v to bf16 before
    their product."""
    dec = _decide("flash_attention", q, backend)
    if dec.backend == "ref":
        o = flash_attention_gqa(q, k, v, causal=causal, window=window)
    else:
        o = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    STATS.record(dec)
    return o
