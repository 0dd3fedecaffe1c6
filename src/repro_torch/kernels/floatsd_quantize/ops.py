"""Wrapper of the FloatSD8 quantize kernel (``floatsd_quantize.cu``).

Takes the plain version for tensors on the CPU and launches the CUDA kernel
for tensors on the card; there is no fallback between the two.
``floatsd_quantize.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import quantize_ref

__all__ = ["floatsd_quantize"]


def _launcher():
    fn = _build.load("floatsd_quantize").floatsd_quantize_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, ctypes.c_longlong, p]
        fn.restype = i
    return fn


def floatsd_quantize(x: torch.Tensor, bias) -> torch.Tensor:
    """Any-shape finite ``x`` -> uint8 FloatSD8 codes of its shape, at
    ``bias`` (an int, or an int32 tensor of one element on x's device: the
    kernel reads it there, so the host does not wait for it). On the card
    f32 and fp16 are read as they are; other floating dtypes are cast to
    f32 first, as ``encode`` casts them."""
    if x.device.type == "cpu":
        return quantize_ref(x, bias)
    if x.device.type != "cuda" or not x.is_floating_point():
        raise ValueError(f"floatsd_quantize: needs a floating tensor on the card, got "
                         f"{x.dtype} on {x.device}")
    if not isinstance(bias, torch.Tensor):
        bias = torch.tensor(int(bias), dtype=torch.int32, device=x.device)
    if bias.device != x.device or bias.dtype != torch.int32 or bias.numel() != 1:
        raise ValueError(f"floatsd_quantize: bias must be one int32 on {x.device}, got "
                         f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
    if x.dtype not in (torch.float32, torch.float16):
        x = x.to(torch.float32)
    x = x.contiguous()
    # the codes start at x's element index modulo 16, so the kernel's
    # 16-element groups of the two line up (x may be a view at any offset)
    off = x.data_ptr() // x.element_size() % 16
    codes = torch.empty(x.numel() + off, dtype=torch.uint8, device=x.device)[off:].view(x.shape)
    if x.numel() == 0:
        return codes
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(x.data_ptr(), int(x.dtype == torch.float16), bias.data_ptr(),
                          codes.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"floatsd_quantize launch failed: cudaError {err}")
    floatsd_quantize.launches += 1
    return codes


floatsd_quantize.launches = 0
