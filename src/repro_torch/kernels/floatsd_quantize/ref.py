"""Plain PyTorch version of the FloatSD8 quantize kernel: the port's
``core.floatsd.encode`` (nearest grid value by midpoint count, sign folded
into the mantissa index). The CPU tests use it, and ``chip_smoke.py`` holds
the kernel against it on the card, byte for byte."""
from __future__ import annotations

import torch

from ...core import floatsd

__all__ = ["quantize_ref"]


def quantize_ref(x: torch.Tensor, bias) -> torch.Tensor:
    """Any-shape finite ``x`` -> uint8 FloatSD8 codes at ``bias``."""
    codes, _ = floatsd.encode(x, bias)
    return codes
