"""Two-region FloatSD8 sigmoid quantization (paper §III-C, Eqs. 7-8).

    y = Q(sigma(x))          for x <= 0
    y = 1 - Q(sigma(-x))     for x >  0

Counterpart of ``repro.core.qsigmoid``: the raw LUT function, and
``qsigmoid`` and ``qtanh_fp8`` with the reference's straight-through
gradients (the exact sigma' and tanh'), which the LSTM's autodiff path
trains through. Q is FloatSD8 rounding at the fixed bias -7, whose non-positive
branch has the paper's 42 distinct values; it is computed octave-folded,
as in the reference, with the octave taken exactly from ``frexp``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import floatsd
from .fp8 import FP8_E5M2, quantize_fp8

__all__ = ["SIGMOID_LUT_BIAS", "qsigmoid_raw", "qsigmoid", "qtanh_fp8", "sigmoid_lut_values"]

SIGMOID_LUT_BIAS = -7  # gives the paper's 42-entry LUT for x <= 0


def _octave_tables():
    """Per-octave value/midpoint tables for octave levels 0, 1 and 2+,
    padded to width 8 (midpoints +inf are never counted)."""
    g = [float(v) for v in floatsd._GRID_POS]
    levels = []
    for e in range(3):
        lo, hi = 2.0**e, 2.0 ** (e + 1)
        vals = sorted(v / lo for v in g if lo <= v < hi)
        ext = np.array(vals + [2.0], np.float32)  # boundary -> next octave
        mids = (ext[1:] + ext[:-1]) / 2
        pad = 8 - ext.size
        ext = np.pad(ext, (0, pad), constant_values=2.0)
        mids = np.pad(mids, (0, pad + 1), constant_values=np.inf)
        levels.append((ext, mids.astype(np.float32)))
    return np.stack([l[0] for l in levels]), np.stack([l[1] for l in levels])


_OCT_VALS, _OCT_MIDS = _octave_tables()
_BOT_VALS = np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)
_BOT_MIDS = ((_BOT_VALS[1:] + _BOT_VALS[:-1]) / 2).astype(np.float32)


def _t(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def _Q(v: torch.Tensor) -> torch.Tensor:
    """FloatSD8 quantize for v in [0, 0.5] at the fixed LUT bias (folded)."""
    n = v.to(torch.float32) * float(2.0 ** (-SIGMOID_LUT_BIAS))
    _, ex = torch.frexp(torch.clamp(n, min=1e-30))
    e = torch.clamp(ex - 1, 0, 6)  # floor(log2(n)), exact
    m = n * floatsd.exp2i(-e)
    lvl = torch.clamp(e, max=2).long()
    idx = (m[..., None] > _t(_OCT_MIDS, n)[lvl]).sum(-1)
    q_int = torch.gather(_t(_OCT_VALS, n)[lvl], -1, idx[..., None])[..., 0]
    q_int = q_int * floatsd.exp2i(e)
    bidx = (n[..., None] > _t(_BOT_MIDS, n)).sum(-1)
    q_bot = _t(_BOT_VALS, n)[bidx]
    q = torch.where(n >= 1.0, q_int, q_bot)
    return q * float(2.0**SIGMOID_LUT_BIAS)


def qsigmoid_raw(x: torch.Tensor) -> torch.Tensor:
    """Quantized sigmoid (the kernel/LUT oracle)."""
    s_neg = _Q(torch.sigmoid(-torch.abs(x)))  # Q(sigma(x)) evaluated at -|x|
    return torch.where(x > 0, 1.0 - s_neg, s_neg).to(x.dtype)


def qsigmoid(x: torch.Tensor) -> torch.Tensor:
    """Quantized sigmoid with a straight-through gradient (exact sigma')."""
    s = torch.sigmoid(x)
    return s + (qsigmoid_raw(x) - s).detach()


def qtanh_fp8(x: torch.Tensor) -> torch.Tensor:
    """tanh, then FP8 e5m2 activation quantization, with a straight-through
    gradient (exact tanh')."""
    t = torch.tanh(x)
    return t + (quantize_fp8(t, FP8_E5M2) - t).detach()


def sigmoid_lut_values() -> np.ndarray:
    """The non-positive-branch LUT (42 entries + 0)."""
    grid = floatsd._GRID_POS * (2.0**SIGMOID_LUT_BIAS)
    return grid[(grid >= 0) & (grid <= 0.5)]
