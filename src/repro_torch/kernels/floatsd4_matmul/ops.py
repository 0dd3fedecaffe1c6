"""Wrapper of the FloatSD4 matmul kernel (``floatsd4_matmul.cu``).

Takes the plain version for tensors on the CPU and launches the CUDA kernel
for tensors on the card; there is no fallback between the two.
``floatsd4_matmul.launches`` counts kernel launches.

Every call takes the FloatSD8 matmul's route A, ordered split-K on the CUDA
cores, at any M: ``plan(M, N, K, ordered=True)`` (``floatsd_matmul/ref.py``)
gives the split of K, which the wrapper passes to the kernel as launch
arguments and the plain version sums in (``split_matmul``), so the two
agree bit for bit on exact products.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...core.floatsd4 import GROUP
from ..floatsd_matmul.ops import plan, use_partials
from .ref import floatsd4_matmul_ref

__all__ = ["floatsd4_matmul"]


def _launcher():
    fn = _build.load("floatsd4_matmul").floatsd4_matmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def floatsd4_matmul(x: torch.Tensor, codes: torch.Tensor, exps: torch.Tensor, rows: int, *,
                    transposed: bool = False) -> torch.Tensor:
    """x [M, K] f32 @ decode4(codes, exps) -> y [M, N] f32. Without
    ``transposed`` codes are [ceil(K/2), N] and ``rows`` = K; with it they
    are the [N, K] table packed as [ceil(N/2), K] and ``rows`` = N."""
    if x.device.type == "cpu":
        return floatsd4_matmul_ref(x, codes, exps, rows, transposed=transposed)
    if x.device.type != "cuda" or codes.device != x.device or exps.device != x.device:
        raise ValueError(f"floatsd4_matmul: x on {x.device}, codes on {codes.device}, "
                         f"exps on {exps.device}")
    if x.dtype != torch.float32 or codes.dtype != torch.uint8 or exps.dtype != torch.int8:
        raise ValueError(f"floatsd4_matmul: needs f32 x, uint8 codes and int8 exps, got "
                         f"{x.dtype}, {codes.dtype}, {exps.dtype}")
    if x.dim() != 2 or codes.dim() != 2 or exps.dim() != 2 or not (
            x.is_contiguous() and codes.is_contiguous() and exps.is_contiguous()):
        raise ValueError("floatsd4_matmul: needs contiguous 2-D x, codes and exps")
    m, k = x.shape
    n = rows if transposed else codes.shape[1]
    free = codes.shape[1]  # the unpacked axis: K when transposed, else N
    want = ((-(-rows // 2), free), (-(-rows // GROUP), free))
    if (tuple(codes.shape), tuple(exps.shape)) != want or (free if transposed else rows) != k:
        raise ValueError(f"floatsd4_matmul: x {tuple(x.shape)} vs codes {tuple(codes.shape)}, "
                         f"exps {tuple(exps.shape)}, rows {rows}, transposed={transposed}")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    p = plan(m, n, k, ordered=True)
    part = torch.empty((p.splits, m, n), dtype=torch.float32, device=x.device) if use_partials(p, m, k) else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(x.data_ptr(), codes.data_ptr(), exps.data_ptr(), y.data_ptr(),
                          None if part is None else part.data_ptr(), m, n, k, int(transposed), p.splits,
                          p.chunk, stream)
    if err != 0:
        raise RuntimeError(f"floatsd4_matmul launch failed: cudaError {err}")
    floatsd4_matmul.launches += 1
    return y


floatsd4_matmul.launches = 0
