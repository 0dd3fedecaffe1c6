"""FloatSD8 number format (paper §III-A), in PyTorch.

An 8-bit weight code: 3-bit exponent field | 5-bit mantissa code.

mantissa = m + s/4 with m in {0,±1,±2,±4}, s in {0,±1,±2}  -> 35 combos,
31 distinct values (collisions at ±0.5, ±1.5), range [-4.5, +4.5].

value = mantissa * 2^(e + bias),  e in [0, 7], per-tensor integer ``bias``.

Counterpart of ``repro.core.floatsd``: the tables are built by the same
numpy code, and ``encode``/``decode``/``quantize`` are bit-identical to it
on finite inputs. Two places compute exactly where the reference rounds:
``exp2i`` builds 2^k from its exponent bits, and ``fit_bias`` takes
ceil(log2) from ``frexp`` instead of a floating ``log2`` (the reference's
``log2`` is off by one ulp at some powers of two, so its bias is one higher
there).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "MANTISSA_VALUES", "EXP_LEVELS", "exp2i", "fit_bias", "quantize",
    "quantize_ste", "encode", "decode",
]

EXP_BITS = 3
EXP_LEVELS = 1 << EXP_BITS  # 8


def _build_mantissas() -> np.ndarray:
    vals = {m + s / 4.0 for m in (-4, -2, -1, 0, 1, 2, 4) for s in (-2, -1, 0, 1, 2)}
    keys = np.array(sorted(vals), dtype=np.float32)
    assert keys.size == 31, keys.size
    return keys


MANTISSA_VALUES = _build_mantissas()


def _value_grid_np() -> np.ndarray:
    """All distinct non-negative representable values at bias=0, sorted."""
    g = np.unique(
        np.abs(MANTISSA_VALUES)[:, None] * (2.0 ** np.arange(EXP_LEVELS))[None, :]
    )
    return g.astype(np.float64)


_GRID_POS = _value_grid_np()  # includes 0
_GRID_MID = (_GRID_POS[1:] + _GRID_POS[:-1]) / 2.0


def _grid_codes() -> tuple[np.ndarray, np.ndarray]:
    """Canonical (e, mantissa-index) per grid value: the smallest exponent
    that represents it exactly."""
    es = np.zeros(_GRID_POS.size, dtype=np.int64)
    mi = np.zeros(_GRID_POS.size, dtype=np.int64)
    for i, v in enumerate(_GRID_POS):
        for e in range(EXP_LEVELS):
            hit = np.flatnonzero(MANTISSA_VALUES == v / (2.0**e))
            if hit.size:
                es[i], mi[i] = e, hit[0]
                break
        else:
            raise AssertionError(v)
    return es, mi


_GRID_E, _GRID_MIDX = _grid_codes()


_TABLES: dict = {}  # (table, device, dtype) -> the table on that device


def _table(values: np.ndarray, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """One of this module's constant tables on ``like``'s device, copied
    there once: a copy from host memory at every call would make the host
    wait for the card each time."""
    key = (id(values), like.device, dtype)
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not values:
        hit = _TABLES[key] = (values, torch.as_tensor(values, dtype=dtype, device=like.device))
    return hit[1]


def exp2i(k) -> torch.Tensor:
    """Exact 2^k as f32 for integer k, clamped to the normal range
    [-126, 127], built from the exponent bits (``torch.exp2`` is not
    guaranteed exact on every device)."""
    k = torch.clamp(torch.as_tensor(k).to(torch.int32), -126, 127)
    return ((k + 127) << 23).view(torch.float32)


def _clamp_bias(bias) -> torch.Tensor:
    """Keep every reachable exponent e + bias (e in [0, 7]) in f32's normal
    range; applied identically by quantize/encode/decode."""
    return torch.clamp(torch.as_tensor(bias).to(torch.int32), -126, 127 - (EXP_LEVELS - 1))


def fit_bias(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor exponent bias: the smallest bias with
    4.5 * 2^(7+bias) >= max|x|. Returns a 0-d int32 tensor."""
    amax = torch.max(torch.abs(x.to(torch.float32)))
    ok = torch.isfinite(amax) & (amax > 0)
    amax = torch.where(ok, amax, torch.ones_like(amax))
    mant, ex = torch.frexp(amax / 4.5)  # amax/4.5 = mant * 2^ex, mant in [0.5, 1)
    ceil_log2 = ex - (mant == 0.5).to(ex.dtype)
    return _clamp_bias(ceil_log2 - (EXP_LEVELS - 1))


def _grid_index(n: torch.Tensor) -> torch.Tensor:
    """#(grid midpoints < n): nearest grid value, ties to the lower one."""
    mids = _table(_GRID_MID, n)
    return torch.searchsorted(mids, n.contiguous(), right=False)


def quantize(x: torch.Tensor, bias=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-representable-value FloatSD8 fake-quant -> (values, bias)."""
    if bias is None:
        bias = fit_bias(x)
    bias = _clamp_bias(bias).to(x.device)
    xf = x.to(torch.float32)
    scale = exp2i(bias)
    n = torch.clamp(torch.abs(xf) / scale, 0.0, float(_GRID_POS[-1]))
    q = _table(_GRID_POS, xf)[_grid_index(n)] * scale
    return (torch.sign(xf) * q).to(x.dtype), bias


def encode(x: torch.Tensor, bias=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize and pack to uint8 codes ``(e << 5) | m_idx`` with the sign
    folded into the mantissa index (the mantissa set is symmetric).
    Returns (codes uint8, bias 0-d int32). ``x`` must be finite: codes
    have no NaN/inf representation."""
    if bias is None:
        bias = fit_bias(x)
    bias = _clamp_bias(bias).to(x.device)
    xf = x.to(torch.float32)
    n = torch.clamp(torch.abs(xf) / exp2i(bias), 0.0, float(_GRID_POS[-1]))
    gidx = _grid_index(n)
    e = _table(_GRID_E, xf, torch.int32)[gidx]
    midx = _table(_GRID_MIDX, xf, torch.int32)[gidx]  # index of |mantissa|
    midx = torch.where(xf < 0, 30 - midx, midx)
    return ((e << 5) | midx).to(torch.uint8), bias


def _decode_lut() -> np.ndarray:
    """Every uint8 code decoded at bias 0: its mantissa (index 31 clipped
    to 30) times 2^e, exact in f32 (at most 5 significant bits)."""
    c = np.arange(256)
    return (MANTISSA_VALUES[np.minimum(c & 0x1F, 30)] * 2.0 ** (c >> 5)).astype(np.float32)


_DECODE_LUT = _decode_lut()


def decode(codes: torch.Tensor, bias, dtype=torch.float32) -> torch.Tensor:
    """uint8 FloatSD8 codes -> values: the code's value at bias 0 from a
    256-entry table, times 2^bias. Both factors are exact and the product
    is rounded once, so this equals mantissa * 2^(e + bias) bit for bit.
    Mantissa index 31 (never emitted by ``encode``) clips to 30, as in the
    reference. A host ``bias`` (a packed tensor's int) stays on the host: a
    0-d CPU factor enters a card's product as a scalar, with no copy."""
    v = _table(_DECODE_LUT, codes)[codes.long()]
    return (v * exp2i(_clamp_bias(bias))).to(dtype)


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias):
        return quantize(x, bias)[0]

    @staticmethod
    def backward(ctx, g):
        return g, None  # straight-through: identity gradient, none to the bias


def quantize_ste(x: torch.Tensor, bias) -> torch.Tensor:
    """``quantize(x, bias).values`` forward, identity gradient (the weight
    quantizer of training). Keeps x's dtype, so an fp16 master stays fp16."""
    return _QuantizeSTE.apply(x, bias)
