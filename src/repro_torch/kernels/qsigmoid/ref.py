"""Plain PyTorch version of the two-region FloatSD8 sigmoid kernel: the
port's ``core.qsigmoid.qsigmoid_raw``. The CPU tests use it, and
``chip_smoke.py`` holds the kernel against it on the card, bit for bit on
f32 inputs."""
from __future__ import annotations

import torch

from ...core.qsigmoid import qsigmoid_raw

__all__ = ["qsigmoid_ref"]


def qsigmoid_ref(x: torch.Tensor) -> torch.Tensor:
    """Any-shape ``x`` -> the quantized sigmoid, same shape and dtype."""
    return qsigmoid_raw(x)
