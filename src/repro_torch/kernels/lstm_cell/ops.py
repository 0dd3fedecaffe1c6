"""Wrapper of the fused LSTM cell kernel (``lstm_cell.cu``).

``lstm_cell`` takes the plain version for tensors on the CPU and launches
the CUDA kernel for tensors on the card; there is no fallback between the
two. ``lstm_cell.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import lstm_cell_ref

__all__ = ["lstm_cell"]

_C_DTYPES = (torch.float16, torch.float32)


def _launcher():
    fn = _build.load("lstm_cell").lstm_cell_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, p, i, i, i, i, p]
        fn.restype = i
    return fn


def lstm_cell(z: torch.Tensor, c_prev: torch.Tensor, *, quantized: bool = True,
              c_dtype=torch.float16):
    """z [B, 4H] f32 (i|f|g|o), c_prev [B, H] f16/f32 -> (h [B, H] f32,
    c [B, H] ``c_dtype``)."""
    if z.device.type == "cpu":
        return lstm_cell_ref(z, c_prev, quantized, c_dtype=c_dtype)
    if z.device.type != "cuda" or c_prev.device != z.device:
        raise ValueError(f"lstm_cell: z on {z.device}, c_prev on {c_prev.device}")
    if z.dtype != torch.float32 or c_prev.dtype not in _C_DTYPES or c_dtype not in _C_DTYPES:
        raise ValueError(
            f"lstm_cell: needs f32 z and f16/f32 cell state, got {z.dtype}, "
            f"{c_prev.dtype} -> {c_dtype}"
        )
    b, h4 = z.shape
    h = h4 // 4
    if h4 != 4 * h or tuple(c_prev.shape) != (b, h):
        raise ValueError(f"lstm_cell: z {tuple(z.shape)} vs c_prev {tuple(c_prev.shape)}")
    if not (z.is_contiguous() and c_prev.is_contiguous()):
        raise ValueError("lstm_cell: needs contiguous z and c_prev")
    h_t = torch.empty((b, h), dtype=torch.float32, device=z.device)
    c_t = torch.empty((b, h), dtype=c_dtype, device=z.device)
    if b * h == 0:
        return h_t, c_t
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            z.data_ptr(), c_prev.data_ptr(), int(c_prev.dtype == torch.float16),
            h_t.data_ptr(), c_t.data_ptr(), int(c_dtype == torch.float16),
            b, h, int(quantized), stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm_cell launch failed: cudaError {err}")
    lstm_cell.launches += 1
    return h_t, c_t


lstm_cell.launches = 0
