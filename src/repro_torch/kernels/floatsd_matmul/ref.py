"""Plain PyTorch versions of the FloatSD8 matmul and of its two backward
products: decode, then an f32 sum over the contraction in the CUDA
kernels' order.

The CPU tests use it, ``chip_smoke.py`` holds the kernel against it on the
card, and ``backend="ref"`` serves with it.

``plan(M, N, K, ordered)`` is the one rule that picks the kernel's route
and its split of K from the shapes (and a caller's request for the ordered
route at any M); the wrapper (``ops.py``) passes it to
``floatsd_matmul.cu`` and the plain versions sum in the order it gives
(``split_matmul``): K is cut into ``splits`` chunks of ``chunk``
consecutive k (the last may be shorter); each chunk is summed from 0 in k
order, ``acc = acc + x[m, k] * w[k, n]``, one rounding a step; the chunk
sums are then added in chunk order, ((p0 + p1) + p2) + ... Route A (M <=
64, or ``ordered``; CUDA cores) computes exactly that with fmaf: on the
serving path every
product is exact in f32 (FP8/FP16-quantized activations times FloatSD8
weights, at most 16 significant bits), so kernel and plain version agree
bit for bit there, and on arbitrary f32 inputs to rounding (1e-5 of the sum
of term magnitudes). Route B (M > 64, bf16 tensor cores) takes the same
chunks but sums inside each in the tensor cores' own order, which no
PyTorch code repeats: it is held to that bound alone. A caller that needs
the plain version's bits at M > 64 asks for ``ordered``: the fused BPTT,
whose backward recomputes the forward's per-step gate pre-activations over
S x B rows and must get the same bits (so both the per-step products, at
M = B, and the recompute ask for it), and whose training run is held bit
for bit against the plain path. No matmul runs here, so TF32 cannot enter.

The backward (counterpart of ``repro.kernels.floatsd_matmul.bwd``):
``matmul_dx_ref`` is g @ decode(codes)^T in f32 in the same order (the
kernel reads the codes in place as [out, contraction]; the precise
datapath: FP8 activation-gradient quantization lives at the ``act_quant``
nodes), and ``matmul_dw_ref`` is x^T @ g summed over rows m = 0 .. M-1 in
order (``ordered_matmul``), snapped to the FP8 e5m2 grid unless
``quant=False``. The FloatSD4 matmul (``floatsd4_matmul/ref.py``) runs route
A at every M and sums in ``plan(..., ordered=True)``'s order.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...core import floatsd
from ...core.fp8 import quantize_fp8

__all__ = [
    "Plan", "plan", "split_matmul", "floatsd_matmul_ref", "matmul_dx_ref", "matmul_dw_ref",
    "ordered_matmul", "no_tf32",
]

ROUTE_A_MAX_M = 64  # rows up to which route A (ordered split-K, CUDA cores) runs
SMS = 132  # streaming multiprocessors of an H100 SXM
# the kernel's tiles, which only size the grid: route A's columns a block,
# route B's rows and columns a block, and the stage depth a chunk is a
# multiple of when K is split
A_TILE_N, B_TILE, CHUNK_ALIGN = 128, 128, 64


class Plan(NamedTuple):
    route: str  # "A": ordered split-K on CUDA cores; "B": bf16 tensor cores
    splits: int  # chunks of consecutive k, summed apart, then added in order
    chunk: int  # k a chunk (the last chunk may be shorter)


def plan(m: int, n: int, k: int, ordered: bool = False) -> Plan:
    """The route and the split of K for y[m, n] = x[m, k] @ w[k, n].

    Route A for m <= 64, or for any m when ``ordered``: the grid of n / 128 column blocks is split over K
    until some 2 x 132 blocks keep the codes streaming, with chunks of at
    least 128 k (so the partials, splits x m x n x 4 bytes, stay at most
    twice the k x n code bytes at m = 64, a quarter of them at m = 8). It
    depends on n and k only, so a row's sum order does not depend on how
    many rows share the launch. Route B above: split only while the 128 x
    128 tiles leave SMs idle, with chunks of at least 512 k."""
    if m <= ROUTE_A_MAX_M or ordered:
        route, tiles, cap = "A", max(1, -(-n // A_TILE_N)), k // 128
        want = -(-2 * SMS // tiles)
    else:
        route, tiles, cap = "B", max(1, -(-m // B_TILE) * -(-n // B_TILE)), k // 512
        want = SMS // tiles
    splits = max(1, min(want, cap))
    if splits == 1:
        return Plan(route, 1, k)
    chunk = -(-k // splits)
    chunk = -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN
    return Plan(route, -(-k // chunk), chunk)


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


def split_matmul(x: torch.Tensor, w: torch.Tensor, ordered: bool = False) -> torch.Tensor:
    """x [M, K] @ w [K, N] in f32 in ``plan(M, N, K, ordered)``'s order: each chunk
    of consecutive k summed in k order, the chunk sums added in chunk order.
    Vectorised over the chunks (zero-padded to equal length: adding 0 * 0
    leaves a sum unchanged, and a sum that starts at +0 is never -0)."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    (m, k), n = x.shape, w.shape[1]
    p = plan(m, n, k, ordered)
    if p.splits == 1:
        return ordered_matmul(x, w)
    pad = p.splits * p.chunk - k
    xs = F.pad(x, (0, pad)).reshape(m, p.splits, p.chunk).transpose(0, 1)  # [P, M, C]
    ws = F.pad(w, (0, 0, 0, pad)).reshape(p.splits, p.chunk, n)  # [P, C, N]
    part = torch.zeros((p.splits, m, n), dtype=torch.float32, device=x.device)
    for c in range(p.chunk):
        part.addcmul_(xs[:, :, c : c + 1], ws[:, c : c + 1])
    y = part[0].clone()
    for q in range(1, p.splits):
        y += part[q]
    return y


def floatsd_matmul_ref(x: torch.Tensor, codes: torch.Tensor, bias, *, transposed: bool = False,
                       ordered: bool = False) -> torch.Tensor:
    """x [M, K] @ decode(codes) -> [M, N] f32; codes are [K, N], or [N, K]
    when ``transposed``."""
    w = floatsd.decode(codes, bias, dtype=torch.float32)
    return split_matmul(x, w.t() if transposed else w, ordered)


def matmul_dx_ref(g: torch.Tensor, codes: torch.Tensor, bias, *, ordered: bool = False) -> torch.Tensor:
    """g [M, N] @ decode(codes [K, N])^T -> [M, K] f32."""
    return floatsd_matmul_ref(g, codes, bias, transposed=True, ordered=ordered)


def matmul_dw_ref(x: torch.Tensor, g: torch.Tensor, quant: bool = True) -> torch.Tensor:
    """x [M, K]^T @ g [M, N] -> [K, N] f32, on the e5m2 grid when ``quant``
    (finite values saturate, inf and NaN stay nonfinite)."""
    dw = ordered_matmul(x.to(torch.float32).t(), g)
    return quantize_fp8(dw) if quant else dw
