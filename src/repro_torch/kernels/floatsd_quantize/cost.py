"""Cost model of the FloatSD8 encoder, f32/fp16 -> 1-byte codes;
counterpart of ``repro.kernels.floatsd_quantize.cost``.

Element-wise over the flattened tensor. An element costs the model
constant ``QUANT_FLOPS_PER_ELEM`` (a search over the 31 mantissas, the
exponent and the bias shift) and writes one byte: where the paper's 4x
smaller weights enter the ledger. The bias is a device int32 on both
backends (4 bytes). The kernel reads each element and the bias once and
writes each code once; its static shared memory is the 2 x 417-entry byte
table of the bucket index, in 32-bit words (``kQuantWords``).
"""
from __future__ import annotations

from ...obs.costmodel import Cost

__all__ = ["quantize_cost", "QUANT_FLOPS_PER_ELEM", "STATIC_SMEM"]

QUANT_FLOPS_PER_ELEM = 12  # ~5-compare search over 31 mantissas + exp/bias
STATIC_SMEM = 4 * ((2 * (416 + 1) + 3) // 4)  # floatsd_quantize.cu: words[kQuantWords]


def quantize_cost(n: int, *, backend: str, x_bytes: int = 4, bias_bytes: int = 4) -> Cost:
    return Cost(flops=QUANT_FLOPS_PER_ELEM * n, hbm_read_bytes=n * x_bytes + bias_bytes, hbm_write_bytes=n,
                smem_bytes=0 if backend == "ref" else STATIC_SMEM)
