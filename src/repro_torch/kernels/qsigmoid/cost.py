"""Cost model of the two-region quantized sigmoid; counterpart of
``repro.kernels.qsigmoid.cost``.

Element-wise over the flattened tensor: per element the paper's
42-boundary two-region LUT, 42 compares + 1 select
(``QSIG_FLOPS_PER_ELEM``). The kernel reads and writes each element once;
its static shared memory is the gate function's bucket table
(``lstm_cell.cost.static_smem``).
"""
from __future__ import annotations

from ...obs.costmodel import Cost
from ..lstm_cell.cost import static_smem

__all__ = ["qsigmoid_cost", "QSIG_FLOPS_PER_ELEM"]

QSIG_FLOPS_PER_ELEM = 43  # 42 region-boundary compares + 1 select


def qsigmoid_cost(n: int, *, backend: str, x_bytes: int = 4, y_bytes: int = 4) -> Cost:
    return Cost(flops=QSIG_FLOPS_PER_ELEM * n, hbm_read_bytes=n * x_bytes, hbm_write_bytes=n * y_bytes,
                smem_bytes=0 if backend == "ref" else static_smem(True))
