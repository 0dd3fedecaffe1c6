"""Plain PyTorch versions of the fused LSTM cell (paper Eqs. 5-6 +
q-sigmoid) and of its recompute-gates backward.

Counterparts of ``repro.kernels.lstm_cell.ref`` and ``.bwd``. The CPU tests
use them, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.
"""
from __future__ import annotations

import torch

from ...core.fp8 import quantize_fp8
from ...core.qsigmoid import qsigmoid_raw

__all__ = ["lstm_cell_ref", "lstm_cell_bwd_ref"]


def lstm_cell_ref(z: torch.Tensor, c_prev: torch.Tensor, quantized: bool = True,
                  c_dtype=torch.float16):
    """z: [B, 4H] pre-activations (i|f|g|o), c_prev: [B, H] ->
    (h [B, H] in z's dtype, c [B, H] in ``c_dtype``)."""
    zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
    if quantized:
        i_t, f_t, o_t = qsigmoid_raw(zi), qsigmoid_raw(zf), qsigmoid_raw(zo)
        g_t = quantize_fp8(torch.tanh(zg))
    else:
        i_t, f_t, o_t = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
        g_t = torch.tanh(zg)
    c_t = (f_t * c_prev.to(f_t.dtype) + i_t * g_t).to(c_dtype)
    tc = torch.tanh(c_t.to(z.dtype))
    if quantized:
        tc = quantize_fp8(tc)
    return (o_t * tc).to(z.dtype), c_t


def lstm_cell_bwd_ref(z: torch.Tensor, c_prev: torch.Tensor, dh: torch.Tensor, dc: torch.Tensor,
                      quantized: bool = True, c_dtype=torch.float16):
    """Recompute-gates backward of the cell (a line-for-line port of
    ``repro.kernels.lstm_cell.bwd.lstm_cell_bwd_ref``). z: [B, 4H]
    (i|f|g|o), c_prev: [B, H], dh: cotangent of h_t, dc: cotangent of c_t
    from the carry -> (dz [B, 4H] f32, dc_prev [B, H] in c_prev's dtype).

    Products use the quantized forward values (recomputed exactly, the
    storage rounding of c included); derivative factors are the smooth
    sigma' and tanh', as in the straight-through estimators. Each torch op
    rounds on its own; ``lstm_cell_bwd.cu`` repeats the order."""
    z32 = z.to(torch.float32)
    zi, zf, zg, zo = torch.chunk(z32, 4, dim=-1)
    si, sf, so = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
    tg = torch.tanh(zg)
    if quantized:
        i_t, f_t, o_t = qsigmoid_raw(zi), qsigmoid_raw(zf), qsigmoid_raw(zo)
        g_t = quantize_fp8(tg)
    else:
        i_t, f_t, o_t, g_t = si, sf, so, tg
    c_prev32 = c_prev.to(torch.float32)
    c32 = (f_t * c_prev32 + i_t * g_t).to(c_dtype).to(torch.float32)
    tanh_c = torch.tanh(c32)
    tc = quantize_fp8(tanh_c) if quantized else tanh_c

    dh32 = dh.to(torch.float32)
    dc32 = dc.to(torch.float32)
    dzo = (dh32 * tc) * so * (1.0 - so)
    dct = dc32 + dh32 * o_t * (1.0 - tanh_c * tanh_c)
    dzf = (dct * c_prev32) * sf * (1.0 - sf)
    dzi = (dct * g_t) * si * (1.0 - si)
    dzg = (dct * i_t) * (1.0 - tg * tg)
    dz = torch.cat([dzi, dzf, dzg, dzo], dim=-1)
    return dz, (dct * f_t).to(c_prev.dtype)
