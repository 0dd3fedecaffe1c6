"""FP8 quantization (paper §III-D): ``float8_e5m2`` with round-to-nearest-even,
``float8_e4m3fn`` as the inference-activation option, and FP16.

Counterpart of ``repro.core.fp8``, training half included: the
``act_quant`` node (forward and gradient fake-quant) and ``grad_quant``.
Finite values saturate at the format's largest finite value; inf and NaN
stay nonfinite. A bare torch cast does
neither: e5m2 overflows to inf, and e4m3fn saturates inf to ±448. So the
clip is explicit, and e4m3fn (which has no inf code) maps inf to NaN, as
the reference does.
"""
from __future__ import annotations

import torch

from .._tree import tree_map

__all__ = [
    "FP8_E5M2", "FP8_E4M3", "FP16", "quantize_fp8", "cast_fp8", "act_quant", "grad_quant",
]

FP8_E5M2 = torch.float8_e5m2
FP8_E4M3 = torch.float8_e4m3fn
FP16 = torch.float16

_MAX = {FP8_E5M2: 57344.0, FP8_E4M3: 448.0, FP16: 65504.0}


def _saturate(x: torch.Tensor, dtype) -> torch.Tensor:
    m = _MAX[dtype]
    xf = x.to(torch.float32)
    finite = torch.isfinite(xf)
    nonfinite = xf if dtype != FP8_E4M3 else torch.full_like(xf, float("nan"))
    return torch.where(finite, torch.clamp(xf, -m, m), nonfinite)


def quantize_fp8(x: torch.Tensor, dtype=FP8_E5M2) -> torch.Tensor:
    """Round-trip cast x -> dtype -> x.dtype (fake-quant), saturating on
    finite overflow only. ``dtype=None`` passes x through."""
    if dtype is None:
        return x
    return _saturate(x, dtype).to(dtype).to(x.dtype)


def cast_fp8(x: torch.Tensor, dtype=FP8_E5M2) -> torch.Tensor:
    """Storage cast x -> dtype with the same saturation as ``quantize_fp8``;
    returns the 1-byte (or fp16) tensor itself."""
    return _saturate(x, dtype).to(dtype)


class _ActQuant(torch.autograd.Function):
    """Quantization node: forward fake-quant to ``fwd``, the incoming
    activation-gradient fake-quant to ``bwd``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return quantize_fp8(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return quantize_fp8(g, ctx.bwd), None, None


def act_quant(x: torch.Tensor, fwd_dtype=FP8_E5M2, bwd_dtype=FP8_E5M2) -> torch.Tensor:
    """Forward activation -> ``fwd_dtype``, its gradient -> ``bwd_dtype``
    (both fake-quant; ``None`` passes through, FP16 is the paper's
    last-layer setting)."""
    return _ActQuant.apply(x, fwd_dtype, bwd_dtype)


def grad_quant(grads):
    """Fake-quantize a (loss-scaled) gradient tree to e5m2 after backward,
    before the optimizer: an exact no-op on leaves already on the grid
    (the fused backward's dW), the quantizer for every other leaf."""
    return tree_map(quantize_fp8, grads)
