"""FP8 quantization (paper §III-D): ``float8_e5m2`` with round-to-nearest-even,
``float8_e4m3fn`` as the inference-activation option, and FP16.

Counterpart of ``repro.core.fp8``. Finite values saturate at the format's
largest finite value; inf and NaN stay nonfinite. A bare torch cast does
neither: e5m2 overflows to inf, and e4m3fn saturates inf to ±448. So the
clip is explicit, and e4m3fn (which has no inf code) maps inf to NaN, as
the reference does.
"""
from __future__ import annotations

import torch

__all__ = ["FP8_E5M2", "FP8_E4M3", "FP16", "quantize_fp8", "cast_fp8"]

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
