"""Cost model of the FloatSD4 packed matmul; counterpart of
``repro.kernels.floatsd4_matmul.cost``.

The floatsd_matmul model with a sub-byte weight stream: a [c, n] FloatSD4
weight is ``ceil(c/2) * n`` code bytes (two 4-bit codes a byte along axis 0)
plus ``ceil(c/32) * n`` int8 group-exponent bytes, about 0.53 bytes a
weight against FloatSD8's 1.

  * **ref**: each operand read once, the output written once; the plain
    version's unpack and decode are intermediates and excluded. ``wt_nbytes``
    gives the stored bytes where the packed axis is not the contraction
    axis (the tied head's [N, K] table packed along N). ``plane``: one
    layer of a stacked leaf packed along its layer axis, read as its [c, n]
    code-byte plane and its [c, n] exponent plane, ``2 * c * n`` bytes (the
    byte holds another layer's nibble too, and every element has its own
    exponent). A call on the
    hoisted f32 decode reads that instead (``floatsd_matmul.cost``'s
    ``matmul_like_cost`` with ``decode=False, b_bytes=4``).
  * **cuda**: route A of ``routed_gemm.cuh`` at every M (``plan(...,
    ordered=True)``), as ``floatsd_matmul.cost.routed_cost`` models it: x
    once per column block, the packed codes and exponents once per row
    block (each fetch decoded), the partials where ``use_partials`` holds;
    the kernel's static table is the 16-entry f32 LUT.

``DECODE4_FLOPS_PER_CODE`` covers the nibble unpack, the 16-entry LUT read,
the group exponent and the scale multiply.
"""
from __future__ import annotations

from ...obs.costmodel import Cost
from ..floatsd_matmul.cost import routed_cost

__all__ = ["matmul4_fwd_cost", "DECODE4_FLOPS_PER_CODE", "GROUP", "STATIC_SMEM"]

DECODE4_FLOPS_PER_CODE = 5  # nibble mask+shift, LUT gather, exp2, scale
GROUP = 32  # rows of axis 0 that share one exponent (core.floatsd4.GROUP)
STATIC_SMEM = {"floatsd4_matmul_ordered_kernel": 16 * 4, "add_partials": 0}  # lut[16] f32


def matmul4_fwd_cost(m: int, c: int, n: int, *, backend: str, x_bytes: int = 4, out_bytes: int = 4,
                     wt_nbytes: int | None = None, plane: bool = False) -> Cost:
    """x [m, c] @ decode4(codes [ceil(c/2), n], exps [ceil(c/32), n]), or,
    with ``plane``, of a layer's codes and exps planes, [c, n] each."""
    if plane:
        wt_bytes = 2 * c * n
    else:
        wt_bytes = -(-c // 2) * n + -(-c // GROUP) * n if wt_nbytes is None else wt_nbytes
    if backend == "ref":
        macs = m * c * n
        return Cost(flops=2 * macs + DECODE4_FLOPS_PER_CODE * c * n, macs=macs,
                    hbm_read_bytes=m * c * x_bytes + wt_bytes, hbm_write_bytes=m * n * out_bytes)
    return routed_cost(m, c, n, w_bytes=wt_bytes, decode_flops=DECODE4_FLOPS_PER_CODE, route_a_only=True,
                       static_a=STATIC_SMEM["floatsd4_matmul_ordered_kernel"])
