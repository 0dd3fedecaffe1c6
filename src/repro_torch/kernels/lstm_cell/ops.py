"""Wrappers of the fused LSTM cell kernels: the forward (``lstm_cell.cu``)
and the recompute-gates backward (``lstm_cell_bwd.cu``).

Each takes its plain version for tensors on the CPU and launches its CUDA
kernel for tensors on the card; there is no fallback between the two.
``lstm_cell.launches`` and ``lstm_cell_grad.launches`` count kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import lstm_cell_bwd_ref, lstm_cell_ref

__all__ = ["lstm_cell", "lstm_cell_grad"]

_C_DTYPES = (torch.float16, torch.float32)


def _launcher():
    fn = _build.load("lstm_cell").lstm_cell_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, p, i, i, i, i, p]
        fn.restype = i
    return fn


def _bwd_launcher():
    fn = _build.load("lstm_cell_bwd").lstm_cell_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
    return fn


def _check_shapes(op: str, z: torch.Tensor, c_prev: torch.Tensor) -> tuple[int, int]:
    b, h4 = z.shape
    h = h4 // 4
    if h4 != 4 * h or tuple(c_prev.shape) != (b, h):
        raise ValueError(f"{op}: z {tuple(z.shape)} vs c_prev {tuple(c_prev.shape)}")
    return b, h


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
    b, h = _check_shapes("lstm_cell", z, c_prev)
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


def lstm_cell_grad(z: torch.Tensor, c_prev: torch.Tensor, dh: torch.Tensor, dc: torch.Tensor, *,
                   quantized: bool = True, c_dtype=torch.float16):
    """z [B, 4H] f32, c_prev [B, H] in ``c_dtype`` (the dtype the forward
    stored the cell state in, f16/f32), dh and dc [B, H] f32 ->
    (dz [B, 4H] f32, dc_prev [B, H] f32: the dc chain stays f32)."""
    if z.device.type == "cpu":
        return lstm_cell_bwd_ref(z, c_prev.to(torch.float32), dh, dc, quantized, c_dtype=c_dtype)
    if z.device.type != "cuda" or any(t.device != z.device for t in (c_prev, dh, dc)):
        raise ValueError("lstm_cell_grad: z, c_prev, dh and dc must share one CUDA device")
    if (z.dtype, dh.dtype, dc.dtype) != (torch.float32,) * 3 or c_dtype not in _C_DTYPES \
            or c_prev.dtype != c_dtype:
        raise ValueError(
            f"lstm_cell_grad: needs f32 z, dh, dc and the cell state in its f16/f32 storage "
            f"dtype, got {z.dtype}, {dh.dtype}, {dc.dtype}, {c_prev.dtype} (stored as {c_dtype})"
        )
    b, h = _check_shapes("lstm_cell_grad", z, c_prev)
    if tuple(dh.shape) != (b, h) or tuple(dc.shape) != (b, h):
        raise ValueError(f"lstm_cell_grad: dh {tuple(dh.shape)}, dc {tuple(dc.shape)} vs [{b}, {h}]")
    if not all(t.is_contiguous() for t in (z, c_prev, dh, dc)):
        raise ValueError("lstm_cell_grad: needs contiguous inputs")
    dz = torch.empty((b, 4 * h), dtype=torch.float32, device=z.device)
    dc_prev = torch.empty((b, h), dtype=torch.float32, device=z.device)
    if b * h == 0:
        return dz, dc_prev
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_launcher()(
            z.data_ptr(), c_prev.data_ptr(), dh.data_ptr(), dc.data_ptr(), dz.data_ptr(),
            dc_prev.data_ptr(), int(c_dtype == torch.float16), b, h, int(quantized), stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm_cell_grad launch failed: cudaError {err}")
    lstm_cell_grad.launches += 1
    return dz, dc_prev


lstm_cell_grad.launches = 0
