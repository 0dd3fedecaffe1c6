"""Cost model of the FloatSD8 matmul family (forward, ``matmul_dx``,
``matmul_dw``); counterpart of ``repro.kernels.floatsd_matmul.cost``.

One matmul-shaped model covers the three ops; they differ in which operand
is the 1-byte codes, the contraction axis, and the extra work an output
(the dw kernel's FP8 snap at the flush).

  * **ref** (``matmul_like_cost``): each operand read once, the output
    written once: ``m*c*a_bytes + c*n*b_bytes + bias_bytes`` read,
    ``m*n*o_bytes`` written. The plain version's decode of the codes is an
    intermediate and excluded, so the prediction equals the bytes of the
    tensors the dispatch hands over. The bias is a host int in the port
    (``bias_bytes=0``; the reference charges its 4-byte device scalar), and
    a call that reads the hoisted f32 decode reads no codes (``decode=False,
    b_bytes=4``).
  * **cuda** (``routed_cost``, ``dw_cost``): the launch ``ops.py`` makes.
    ``plan(M, N, K, ordered)`` gives the route and the split of K:
    - route A (CUDA cores): a grid of ceil(N/128) column blocks x
      ceil(M/MT) row blocks (MT the smallest of 8, 16, 32, 64 that holds M)
      x the chunks; x is fetched once per column block, the codes once per
      row block (and decoded once per fetch);
    - route B (bf16 tensor cores): a pre-pass reads x once and writes its
      three bf16 pieces [3, M, ceil8(K)] and the tile flags [ceil(M/128),
      ceil(K/64)] int32; the main kernel's 128 x 128 tiles read the pieces
      and flags once per column block (all three pieces are charged: the
      kernel skips a piece that is zero in a tile, which depends on the
      data), the codes once per row block;
    - with ``use_partials``, the chunks' sums [splits, M, N] f32 are
      written, read back by ``add_partials`` and y written; else y once.
    ``pad_waste_flops`` is the tiles' products past the matrix (rows to
    the row tile, columns to the column block). ``smem_bytes`` is the
    kernel's static table plus its dynamic shared memory (``a_smem`` /
    ``B_SMEM``, mirrors of ``routed_gemm.cuh``'s ``a_smem<MT>()`` and
    ``kBSmem``).
  * ``dw_cost`` (cuda): 128 x 128 tiles of dw over the full M: x fetched
    once per column tile of dw, g once per row tile; dw written once; 48 KiB
    of dynamic shared memory (three stages of 16 rows of both tiles); the
    last stage's rows past M and the tiles' edges are padding work.

FLOP constants: 2 FLOPs a MAC; ``DECODE_FLOPS_PER_CODE`` covers the code ->
value unpack (mantissa table read and the exponent shift);
``FP8_QUANT_FLOPS_PER_OUT`` the dw flush's clamp and round.
"""
from __future__ import annotations

from ...obs.costmodel import Cost
from .ops import use_partials
from .ref import plan

__all__ = [
    "matmul_like_cost", "matmul_fwd_cost", "matmul_dx_cost", "matmul_dw_cost", "routed_cost",
    "dw_cost", "a_row_tile", "a_smem", "B_SMEM", "DW_SMEM", "STATIC_SMEM",
    "DECODE_FLOPS_PER_CODE", "FP8_QUANT_FLOPS_PER_OUT",
]

DECODE_FLOPS_PER_CODE = 4  # mask+gather mantissa, shift by (e - bias), scale
FP8_QUANT_FLOPS_PER_OUT = 3  # clamp to +-57344, round-to-nearest-even cast

# routed_gemm.cuh's tiles and ring
A_BN, A_BK = 128, 64  # route A: columns a block, k a stage
B_BM, B_BN, B_BK = 128, 128, 64  # route B: the block tile, k a stage
_B_LDK, _B_LDN, _B_STAGES = B_BK + 8, B_BN + 8, 3
_B_PIECE = B_BM * _B_LDK
_B_W = max(B_BN * _B_LDK, B_BK * _B_LDN)
_B_SLOT = 3 * _B_PIECE + B_BK * B_BN // 2
B_SMEM = (_B_STAGES * _B_SLOT + 2 * _B_W) * 2  # kBSmem: the ring + two decoded w' tiles, bf16
DW_TK, DW_TN, DW_TM, DW_STAGES = 128, 128, 16, 3  # floatsd_matmul_dw.cu's tile and ring
DW_SMEM = DW_STAGES * DW_TM * (DW_TK + DW_TN) * 4  # kSmem: 48 KiB
# static shared memory of each kernel function, by the function's name (the
# decoders' code tables; ptxas's "bytes smem", checked on the card)
STATIC_SMEM = {
    "floatsd_matmul_ordered_kernel": 256 * 4,  # tab: f32 value of every code byte
    "floatsd_matmul_mma_kernel": 256 * 2,  # tab: bf16 bits of every code byte without the bias
    "split_pieces": 0,
    "add_partials": 0,
    "matmul_dw_kernel": 0,
}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def a_row_tile(m: int) -> int:
    """Route A's row tile MT: the smallest of 8, 16, 32, 64 that holds m
    (``with_row_tile``)."""
    return next((t for t in (8, 16, 32) if m <= t), 64)


def a_smem(mt: int) -> int:
    """Route A's dynamic shared memory: the f32 w tile [64][128] and the x
    tile [64][MT + 4] (``a_smem<MT>()``)."""
    return (A_BK * A_BN + A_BK * (mt + 4)) * 4


def matmul_like_cost(
    m: int, c: int, n: int, *, backend: str = "ref",
    a_bytes: int = 4, b_bytes: int = 1, o_bytes: int = 4,
    bias_bytes: int = 0, decode: bool = True, quant_flops_per_out: int = 0,
) -> Cost:
    """[m, c] x [c, n] -> [m, n] on the plain version; ``c`` is the
    contraction axis."""
    if backend != "ref":
        raise ValueError(f"matmul_like_cost models the plain version only, got backend {backend!r}")
    macs = m * c * n
    flops = 2 * macs + quant_flops_per_out * m * n
    if decode:
        flops += DECODE_FLOPS_PER_CODE * c * n
    return Cost(flops=flops, macs=macs, hbm_read_bytes=m * c * a_bytes + c * n * b_bytes + bias_bytes,
                hbm_write_bytes=m * n * o_bytes)


def routed_cost(m: int, c: int, n: int, *, ordered: bool = False, w_bytes: int | None = None,
                decode_flops: int = DECODE_FLOPS_PER_CODE, route_a_only: bool = False,
                static_a: int = STATIC_SMEM["floatsd_matmul_ordered_kernel"]) -> Cost:
    """x [m, c] f32 @ W [c, n] -> [m, n] f32 through ``routed_gemm.cuh`` as
    ``ops.py`` launches it. ``w_bytes`` is the bytes of one full read of
    the weight's stored form (FloatSD8: c * n codes); ``route_a_only``
    forces route A at every m (FloatSD4's ``plan(..., ordered=True)``)."""
    w_bytes = c * n if w_bytes is None else w_bytes
    p = plan(m, n, c, ordered or route_a_only)
    col_blocks = _cdiv(n, A_BN if p.route == "A" else B_BN)
    read = write = 0
    if p.route == "A":
        mt = a_row_tile(m)
        row_blocks = _cdiv(m, mt)
        read += col_blocks * m * c * 4
        smem = static_a + a_smem(mt)
        issued = row_blocks * mt * col_blocks * A_BN
    else:
        row_blocks = _cdiv(m, B_BM)
        scratch = 3 * m * _cdiv(c, 8) * 8 * 2 + row_blocks * _cdiv(c, B_BK) * 4  # pieces + flags
        read += m * c * 4 + col_blocks * scratch  # the pre-pass reads x; each column block the scratch
        write += scratch
        smem = max(STATIC_SMEM["floatsd_matmul_mma_kernel"] + B_SMEM, STATIC_SMEM["split_pieces"])
        issued = row_blocks * B_BM * col_blocks * B_BN
    read += row_blocks * w_bytes
    out = m * n * 4
    if use_partials(p, m, c):
        write += p.splits * out + out
        read += p.splits * out
    else:
        write += out
    macs = m * c * n
    return Cost(flops=2 * macs + decode_flops * row_blocks * c * n, macs=macs, hbm_read_bytes=read,
                hbm_write_bytes=write, smem_bytes=smem, pad_waste_flops=2 * c * (issued - m * n))


def matmul_fwd_cost(m: int, k: int, n: int, *, backend: str, x_bytes: int = 4, out_bytes: int = 4,
                    ordered: bool = False, dense: bool = False) -> Cost:
    """x [m, k] @ decode(codes [k, n]) -> [m, n] (the codes may be stored
    [n, k]: the same bytes). ``dense``: the plain version reads the hoisted
    f32 decode instead of the codes."""
    if backend == "ref":
        return matmul_like_cost(m, k, n, a_bytes=x_bytes, b_bytes=4 if dense else 1, o_bytes=out_bytes,
                                decode=not dense)
    return routed_cost(m, k, n, ordered=ordered)


def matmul_dx_cost(m: int, n: int, k: int, *, backend: str, g_bytes: int = 4, out_bytes: int = 4,
                   ordered: bool = False, dense: bool = False) -> Cost:
    """g [m, n] @ decode(codes [k, n])^T -> dx [m, k]; contraction over n.
    The kernel is the forward on the codes read in place as [out,
    contraction], so the model is the forward's with (c, n) = (n, k)."""
    if backend == "ref":
        return matmul_like_cost(m, n, k, a_bytes=g_bytes, b_bytes=4 if dense else 1, o_bytes=out_bytes,
                                decode=not dense)
    return routed_cost(m, n, k, ordered=ordered)


def dw_cost(k: int, m: int, n: int, quant: bool = True) -> Cost:
    """x [m, k]^T @ g [m, n] -> dw [k, n] f32 through ``floatsd_matmul_dw.cu``."""
    macs = m * k * n
    issued = _cdiv(m, DW_TM) * DW_TM * _cdiv(k, DW_TK) * DW_TK * _cdiv(n, DW_TN) * DW_TN
    return Cost(
        flops=2 * macs + (FP8_QUANT_FLOPS_PER_OUT * k * n if quant else 0), macs=macs,
        hbm_read_bytes=_cdiv(n, DW_TN) * m * k * 4 + _cdiv(k, DW_TK) * m * n * 4, hbm_write_bytes=k * n * 4,
        smem_bytes=STATIC_SMEM["matmul_dw_kernel"] + DW_SMEM, pad_waste_flops=2 * (issued - macs),
    )


def matmul_dw_cost(k: int, m: int, n: int, *, backend: str, x_bytes: int = 4, g_bytes: int = 4,
                   out_bytes: int = 4, quant: bool = True) -> Cost:
    """x [m, k]^T @ g [m, n] -> dw [k, n]; contraction over m. Both operands
    dense f32; ``quant`` adds the flush's FP8 snap an output."""
    if backend == "ref":
        return matmul_like_cost(k, m, n, a_bytes=x_bytes, b_bytes=g_bytes, o_bytes=out_bytes, decode=False,
                                quant_flops_per_out=FP8_QUANT_FLOPS_PER_OUT if quant else 0)
    return dw_cost(k, m, n, quant)
