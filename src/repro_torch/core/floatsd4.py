"""FloatSD4 number format (the sub-byte serving variant), in PyTorch.

A 4-bit code indexes a 15-entry signed-digit mantissa grid,
m + s/4 with m in {0, ±1, ±2} and s in {0, ±1}: range [-2.25, +2.25], at
most two non-zero digits. Code 15 is spare and decodes to exactly 0.0. The
exponent is shared: one int8 per GROUP consecutive rows of axis 0 (the
contraction axis of a [K, N] weight) per column, so a weight's value is
``mantissa * 2^e(group)``. Two codes pack per byte along axis 0 (low
nibble = even row), so a packed [K, N] weight is ceil(K/2)*N code bytes +
ceil(K/GROUP)*N exponent bytes.

Counterpart of ``repro.core.floatsd4``, bit-identical to it on finite
inputs: scales are built from exponent bits (``floatsd.exp2i``), the group
exponent's estimate is corrected with exact comparisons, and rounding is
the reference's nearest-midpoint count. Where the reference on the CPU
flushes an f32 subnormal to zero (a 0.25 mantissa at exponent -126), the
port keeps it, as the card does.
"""
from __future__ import annotations

import numpy as np
import torch

from .floatsd import exp2i

__all__ = [
    "MANTISSA_VALUES", "LUT16", "ZERO_CODE", "SPARE_CODE", "GROUP", "TOP",
    "fit_group_exp", "encode", "decode", "pack_nibbles", "unpack_nibbles",
    "decode_packed", "decode_plane", "gather_decode",
]

GROUP = 32  # rows of axis 0 sharing one exponent
TOP = 2.25  # largest |mantissa|


def _build_mantissas() -> np.ndarray:
    vals = sorted({m + s / 4.0 for m in (-2, -1, 0, 1, 2) for s in (-1, 0, 1)})
    arr = np.array(vals, dtype=np.float32)
    assert arr.size == 15, arr.size
    return arr


MANTISSA_VALUES = _build_mantissas()
_MANTISSA_MID = ((MANTISSA_VALUES[1:] + MANTISSA_VALUES[:-1]) / 2.0).astype(np.float32)

# the code of 0.0 (pads an odd K: a pad byte is 0x77) and the unused code
ZERO_CODE = int(np.searchsorted(MANTISSA_VALUES, 0.0))
assert ZERO_CODE == 7
SPARE_CODE = 15

# 16-entry decode table; the spare code decodes to 0.0
LUT16 = np.zeros(16, dtype=np.float32)
LUT16[:15] = MANTISSA_VALUES


def _table(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, device=like.device)


def _num_groups(k: int) -> int:
    return -(-k // GROUP)


def _expand_group_rows(e: torch.Tensor, k: int) -> torch.Tensor:
    """[G, ...] per-group values -> [k, ...] per-row."""
    return torch.repeat_interleave(e, GROUP, dim=0)[:k]


def _count_idx(mids: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """#(mids < n) per element: the reference's compare-count, as a
    binary search (the same index for every non-NaN n)."""
    return torch.searchsorted(mids, n.contiguous(), right=False)


def fit_group_exp(x: torch.Tensor) -> torch.Tensor:
    """Per-(group, column) exponent: the tightest e with TOP * 2^e >=
    max|x| over the group, so the group's max lands in (1.125, 2.25].
    The estimate, ceil(log2(max / TOP)) from ``frexp``, is corrected with
    the reference's exact comparisons against ``TOP * exp2i(e)``;
    all-zero (and nonfinite) groups get 0. Returns int8 [ceil(K/GROUP),
    ...trailing dims]."""
    xf = torch.abs(x.to(torch.float32))
    k = x.shape[0]
    g = _num_groups(k)
    pad = g * GROUP - k
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, *x.shape[1:]))])
    amax = xf.reshape(g, GROUP, *x.shape[1:]).amax(dim=1)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    pos = amax > 0
    mant, ex = torch.frexp(torch.where(pos, amax, torch.ones_like(amax)) / TOP)
    raw = torch.where(pos, ex - (mant == 0.5).to(ex.dtype), torch.zeros_like(ex))
    raw = torch.where(amax > TOP * exp2i(raw), raw + 1, raw)
    raw = torch.where(pos & (amax <= TOP * exp2i(raw - 1)), raw - 1, raw)
    e = torch.where(pos, torch.clamp(raw, -126, 127), torch.zeros_like(raw))
    return e.to(torch.int8)


def encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """FloatSD4-quantize ``x`` along axis 0 -> (codes uint8 in [0, 14],
    same shape as x; exps int8 [ceil(K/GROUP), ...]). ``x`` must be
    finite."""
    exps = fit_group_exp(x)
    scale = exp2i(_expand_group_rows(exps.to(torch.int32), x.shape[0]))
    n = torch.clamp(x.to(torch.float32) / scale, -TOP, TOP)
    return _count_idx(_table(_MANTISSA_MID, n), n).to(torch.uint8), exps


def decode(codes: torch.Tensor, exps: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Unpacked uint8 codes [K, ...] + group exponents -> values."""
    m = _table(LUT16, codes)[codes.to(torch.int64) & 0xF]
    scale = exp2i(_expand_group_rows(exps.to(torch.int32), codes.shape[0]))
    return (m * scale).to(dtype)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """[K, ...] uint8 codes -> [ceil(K/2), ...] bytes, byte i = codes[2i] |
    codes[2i+1] << 4. An odd K pads one ZERO_CODE row."""
    c = codes.to(torch.uint8)
    if c.shape[0] % 2:
        c = torch.cat([c, torch.full((1, *c.shape[1:]), ZERO_CODE, dtype=torch.uint8,
                                     device=c.device)])
    return c[0::2] | (c[1::2] << 4)


def unpack_nibbles(packed: torch.Tensor, k: int) -> torch.Tensor:
    """[ceil(K/2), ...] bytes -> [k, ...] uint8 codes (the exact inverse)."""
    inter = torch.stack([packed & 0xF, (packed >> 4) & 0xF], dim=1)
    return inter.reshape(2 * packed.shape[0], *packed.shape[1:])[:k]


def decode_packed(packed: torch.Tensor, exps: torch.Tensor, k: int,
                  dtype=torch.float32) -> torch.Tensor:
    """A nibble-packed code stream -> the dense [k, ...] tensor."""
    return decode(unpack_nibbles(packed, k), exps, dtype=dtype)


def decode_plane(codes: torch.Tensor, exps: torch.Tensor, nibble: int,
                 dtype=torch.float32) -> torch.Tensor:
    """One layer of a stacked leaf packed along its layer axis: ``codes``
    is the byte plane ``codes[l >> 1]`` and ``exps`` the exponent plane
    ``exps[l >> 5]`` of the same shape, ``nibble`` = l & 1. Each element
    has its own exponent, shared with the same element of up to 31 other
    layers."""
    code = (codes >> (4 * nibble)) & 0xF
    m = _table(LUT16, codes)[code.to(torch.int64)]
    return (m * exp2i(exps.to(torch.int32))).to(dtype)


def gather_decode(packed: torch.Tensor, exps: torch.Tensor, tokens: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Rows ``tokens`` of a nibble-packed [V, D] table, decoded: byte row
    t // 2, nibble t % 2, exponent row t // GROUP. Equal to decoding the
    table and gathering (decode is element-wise), at half the bytes of a
    FloatSD8 gather."""
    t = tokens.to(torch.int64)
    byte = packed[t // 2]  # [..., D]
    code = (byte >> ((t % 2) * 4).to(torch.uint8)[..., None]) & 0xF
    m = _table(LUT16, code)[code.to(torch.int64)]
    return (m * exp2i(exps[t // GROUP].to(torch.int32))).to(dtype)
