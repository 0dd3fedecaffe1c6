"""Plain PyTorch versions of the FloatSD8 matmul and of its two backward
products: decode, then an f32 sum over the contraction in the CUDA
kernels' order.

The CPU tests use it, ``chip_smoke.py`` holds the kernel against it on the
card, and ``backend="ref"`` serves with it. The kernel accumulates each
output as ``acc = fma(x[m, k], w[k, n], acc)`` for k = 0, 1, ..., K-1; this
version adds the products in the same order, one ``addcmul_`` per k. On the
serving path every product is exact in f32 (FP8/FP16-quantized activations
times FloatSD8 weights, at most 16 significant bits), so the two agree bit
for bit there; on arbitrary f32 inputs they agree to rounding (1e-5 of the
sum of term magnitudes). No matmul runs here, so TF32 cannot enter.

The backward (counterpart of ``repro.kernels.floatsd_matmul.bwd``):
``matmul_dx_ref`` is g @ decode(codes)^T in f32 (the precise datapath;
FP8 activation-gradient quantization lives at the ``act_quant`` nodes), and
``matmul_dw_ref`` is x^T @ g summed over rows m = 0 .. M-1 in order, snapped
to the FP8 e5m2 grid unless ``quant=False``.
"""
from __future__ import annotations

import contextlib

import torch

from ...core import floatsd
from ...core.fp8 import quantize_fp8

__all__ = [
    "floatsd_matmul_ref", "matmul_dx_ref", "matmul_dw_ref", "ordered_matmul", "no_tf32",
]


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


def matmul_dx_ref(g: torch.Tensor, codes: torch.Tensor, bias) -> torch.Tensor:
    """g [M, N] @ decode(codes [K, N])^T -> [M, K] f32."""
    return floatsd_matmul_ref(g, codes, bias, transposed=True)


def matmul_dw_ref(x: torch.Tensor, g: torch.Tensor, quant: bool = True) -> torch.Tensor:
    """x [M, K]^T @ g [M, N] -> [K, N] f32, on the e5m2 grid when ``quant``
    (finite values saturate, inf and NaN stay nonfinite)."""
    dw = ordered_matmul(x.to(torch.float32).t(), g)
    return quantize_fp8(dw) if quant else dw
