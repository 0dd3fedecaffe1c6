"""Plain PyTorch version of the fused LSTM cell (paper Eqs. 5-6 + q-sigmoid).

Counterpart of ``repro.kernels.lstm_cell.ref``. The CPU tests use it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

from ...core.fp8 import quantize_fp8
from ...core.qsigmoid import qsigmoid_raw

__all__ = ["lstm_cell_ref"]


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
