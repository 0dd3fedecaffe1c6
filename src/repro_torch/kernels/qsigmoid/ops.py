"""Wrapper of the two-region FloatSD8 sigmoid kernel (``qsigmoid.cu``).

Takes the plain version for tensors on the CPU and launches the CUDA kernel
for tensors on the card; there is no fallback between the two.
``qsigmoid.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import qsigmoid_ref

__all__ = ["qsigmoid"]

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _launcher():
    fn = _build.load("qsigmoid").qsigmoid_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, ctypes.c_longlong, i, p]
        fn.restype = i
    return fn


def qsigmoid(x: torch.Tensor) -> torch.Tensor:
    """Any-shape f32/fp16/bf16 ``x`` -> the quantized sigmoid, same shape
    and dtype."""
    if x.device.type == "cpu":
        return qsigmoid_ref(x)
    if x.device.type != "cuda" or x.dtype not in _DTYPES:
        raise ValueError(f"qsigmoid: needs an f32, fp16 or bf16 tensor on the card, got "
                         f"{x.dtype} on {x.device}")
    x = x.contiguous()
    # y starts at x's offset within 16 bytes, so the kernel's vectors of the
    # two line up (x may be a view at any element offset)
    off = x.data_ptr() % 16 // x.element_size()
    y = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)[off:].view(x.shape)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(x.data_ptr(), y.data_ptr(), x.numel(), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"qsigmoid launch failed: cudaError {err}")
    qsigmoid.launches += 1
    return y


qsigmoid.launches = 0
