"""Plain PyTorch version of the FloatSD8 matmul: decode, then an f32 sum
over K in the CUDA kernel's order.

The CPU tests use it, ``chip_smoke.py`` holds the kernel against it on the
card, and ``backend="ref"`` serves with it. The kernel accumulates each
output as ``acc = fma(x[m, k], w[k, n], acc)`` for k = 0, 1, ..., K-1; this
version adds the products in the same order, one ``addcmul_`` per k. On the
serving path every product is exact in f32 (FP8/FP16-quantized activations
times FloatSD8 weights, at most 16 significant bits), so the two agree bit
for bit there; on arbitrary f32 inputs they agree to rounding (1e-5 of the
sum of term magnitudes). No matmul runs here, so TF32 cannot enter.
"""
from __future__ import annotations

import contextlib

import torch

from ...core import floatsd

__all__ = ["floatsd_matmul_ref", "ordered_matmul", "no_tf32"]


@contextlib.contextmanager
def no_tf32():
    """Full-f32 matmuls inside the block, whatever the process default."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def ordered_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [K, N] in f32, summed over k = 0 .. K-1 in order."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    y = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for k in range(x.shape[1]):
        y.addcmul_(x[:, k : k + 1], w[k : k + 1])
    return y


def floatsd_matmul_ref(x: torch.Tensor, codes: torch.Tensor, bias, *,
                       transposed: bool = False) -> torch.Tensor:
    """x [M, K] @ decode(codes) -> [M, N] f32; codes are [K, N], or [N, K]
    when ``transposed``."""
    w = floatsd.decode(codes, bias, dtype=torch.float32)
    return ordered_matmul(x, w.t() if transposed else w)
