"""Wrapper of the FloatSD8 matmul kernel (``floatsd_matmul.cu``).

``floatsd_matmul`` takes the plain version for tensors on the CPU and
launches the CUDA kernel for tensors on the card; there is no fallback
between the two. ``floatsd_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...core.floatsd import EXP_LEVELS
from .ref import floatsd_matmul_ref

__all__ = ["floatsd_matmul", "clamp_bias"]


def clamp_bias(bias) -> int:
    """The per-tensor bias as a host int, clamped as ``floatsd.decode``
    clamps it (every exponent e + bias, e in [0, 7], stays normal)."""
    return max(-126, min(127 - (EXP_LEVELS - 1), int(bias)))


def _launcher():
    fn = _build.load("floatsd_matmul").floatsd_matmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, i, i, i, p]
        fn.restype = i
    return fn


def floatsd_matmul(x: torch.Tensor, codes: torch.Tensor, bias, *,
                   transposed: bool = False) -> torch.Tensor:
    """x [M, K] f32 @ decode(codes) -> y [M, N] f32, with codes uint8 [K, N]
    or, when ``transposed``, [N, K] (read in place)."""
    if x.device.type == "cpu":
        return floatsd_matmul_ref(x, codes, bias, transposed=transposed)
    if x.device.type != "cuda" or codes.device != x.device:
        raise ValueError(f"floatsd_matmul: x on {x.device}, codes on {codes.device}")
    if x.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise ValueError(f"floatsd_matmul: needs f32 x and uint8 codes, got {x.dtype}, {codes.dtype}")
    if x.dim() != 2 or codes.dim() != 2 or not (x.is_contiguous() and codes.is_contiguous()):
        raise ValueError("floatsd_matmul: needs contiguous 2-D x and codes")
    m, k = x.shape
    n, k2 = codes.shape if transposed else codes.shape[::-1]
    if k != k2:
        raise ValueError(f"floatsd_matmul: x {tuple(x.shape)} vs codes {tuple(codes.shape)}")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            x.data_ptr(), codes.data_ptr(), clamp_bias(bias), y.data_ptr(),
            m, n, k, int(transposed), stream,
        )
    if err != 0:
        raise RuntimeError(f"floatsd_matmul launch failed: cudaError {err}")
    floatsd_matmul.launches += 1
    return y


floatsd_matmul.launches = 0
