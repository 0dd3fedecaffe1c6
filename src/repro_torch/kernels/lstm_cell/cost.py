"""Cost model of the fused LSTM cell and its recompute-gates backward;
counterpart of ``repro.kernels.lstm_cell.cost``.

Element-wise over [B, H]; one pass over every operand on both backends
(the kernels' grid of a row x 128 columns reads and writes each element
once, and a thread past H loads nothing), so the cuda model equals the ref
model plus the block's static shared memory: the gate function's 289-entry
f32 bucket table when quantized (``lstm_cell_common.cuh``'s
``kSigTable``), none otherwise.

MAC counts are the paper's Table-7 element-wise lanes: Eq. (5) ``c = f*c_prev
+ i*g`` is 2 MACs an element and Eq. (6) ``h = o*tanh(c)`` 1 more
(``CELL_MACS_PER_ELEM = 3``). The FLOP constants cover the rest: 3 quantized
sigmoids (the 42-boundary two-region LUT: 42 compares + 1 select each) and 2
tanh (~8 ops each). The backward recomputes the gates from (z, c_prev),
then runs the product-rule chain: 6 more MACs an element and ~30 ops of
sigmoid' and tanh'.
"""
from __future__ import annotations

from ...obs.costmodel import Cost

__all__ = [
    "lstm_cell_cost", "lstm_cell_grad_cost", "static_smem",
    "CELL_MACS_PER_ELEM", "CELL_FLOPS_PER_ELEM", "GRAD_MACS_PER_ELEM", "GRAD_FLOPS_PER_ELEM",
]

QSIG_FLOPS = 43  # 42 region-boundary compares + 1 select (two-region LUT)
TANH_FLOPS = 8

CELL_MACS_PER_ELEM = 3  # Eq.5: f*c + i*g (2), Eq.6: o*tanh(c) (1)
CELL_FLOPS_PER_ELEM = 3 * QSIG_FLOPS + 2 * TANH_FLOPS + 2 * CELL_MACS_PER_ELEM

GRAD_MACS_PER_ELEM = CELL_MACS_PER_ELEM + 6  # recompute + product-rule chain
GRAD_FLOPS_PER_ELEM = CELL_FLOPS_PER_ELEM + 2 * 6 + 30  # + sigmoid'/tanh'

SIG_TABLE = 288 + 1  # lstm_cell_common.cuh: kSigBuckets + the clamp entry


def static_smem(quantized: bool) -> int:
    """Static shared memory of ``lstm_cell_kernel`` / ``lstm_cell_bwd_kernel``
    (and, quantized, of ``qsigmoid_kernel``): ``table[Q ? kSigTable : 1]``,
    which the unquantized kernels never touch, so ptxas drops it."""
    return 4 * SIG_TABLE if quantized else 0


def _cell_cost(b: int, h: int, *, read_per_elem_h: int, write_per_elem_h: int, z_bytes: int,
               macs_per_elem: int, flops_per_elem: int, backend: str, quantized: bool) -> Cost:
    elems = b * h
    return Cost(flops=flops_per_elem * elems, macs=macs_per_elem * elems,
                hbm_read_bytes=elems * 4 * z_bytes + elems * read_per_elem_h,
                hbm_write_bytes=elems * write_per_elem_h,
                smem_bytes=0 if backend == "ref" else static_smem(quantized))


def lstm_cell_cost(b: int, h: int, *, backend: str, z_bytes: int = 4, c_in_bytes: int = 2,
                   h_out_bytes: int = 4, c_out_bytes: int = 2, quantized: bool = True) -> Cost:
    """z [b, 4h], c_prev [b, h] -> h [b, h], c [b, h] (c in ``c_dtype``, f16
    by default: the serving state)."""
    return _cell_cost(b, h, read_per_elem_h=c_in_bytes, write_per_elem_h=h_out_bytes + c_out_bytes,
                      z_bytes=z_bytes, macs_per_elem=CELL_MACS_PER_ELEM, flops_per_elem=CELL_FLOPS_PER_ELEM,
                      backend=backend, quantized=quantized)


def lstm_cell_grad_cost(b: int, h: int, *, backend: str, z_bytes: int = 4, c_in_bytes: int = 2,
                        dh_bytes: int = 4, dc_bytes: int = 4, dz_bytes: int = 4, dcp_bytes: int = 4,
                        quantized: bool = True) -> Cost:
    """(z, c_prev, dh, dc) -> (dz [b, 4h], dc_prev [b, h])."""
    return _cell_cost(b, h, read_per_elem_h=c_in_bytes + dh_bytes + dc_bytes,
                      write_per_elem_h=4 * dz_bytes + dcp_bytes, z_bytes=z_bytes,
                      macs_per_elem=GRAD_MACS_PER_ELEM, flops_per_elem=GRAD_FLOPS_PER_ELEM, backend=backend,
                      quantized=quantized)
