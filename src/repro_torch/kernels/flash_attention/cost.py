"""Cost model of the flash-attention forward; counterpart of
``repro.kernels.flash_attention.cost``.

The port's layout: q [B, Sq, H, D], k, v [B, Skv, Kh, D] (grouped-query:
query head h reads KV head h // (H / Kh), K and V never expanded) -> o [B,
Sq, H, D] in q's dtype.

  * **ref**: ``attend_pairs`` counts the (query, key) pairs the masks admit
    (causal: ``k <= max(q, prefix - 1)``), the algorithm's minimum; q, k and v read once (k and v at their Kh
    heads), o written once.
  * **cuda** (``flash_attention.cu``, two device kernels a call): the
    pre-pass reads k and v once and writes their bf16 pieces
    (``scratch_bytes``, the mirror of the library's
    ``flash_attention_scratch_bytes``: P + 1 matrices of [ceil8(Skv), DP]
    a (batch, KV head), P = 3 pieces of K on f32, 1 on bf16, DP the head
    size padded to 64 or 128); the forward, a block of 128 query rows a
    (batch, head), reads its q once and the 64-key tiles of its KV head
    between the first and last key any of its rows admits, so the scratch
    is read once per query block that needs it; o written once. A
    warpgroup (64 rows) skips a tile its band admits no key of
    (``visited_pairs`` mirrors the kernel's rule); the pairs of the tiles it
    visits that the masks reject, and the head size's padding to DP, are
    ``pad_waste_flops``. The f32 QK^T runs as six exact-piece bf16
    products on the tensor cores; the model counts it once, as the
    function's MACs (``chip_smoke.py``'s hand bound counts the six).
    ``smem_bytes`` is the forward's dynamic shared memory
    (``fwd_smem``: q's pieces and a two-stage ring of K's pieces and V).
"""
from __future__ import annotations

from ...obs.costmodel import Cost

__all__ = ["attend_pairs", "visited_pairs", "flash_attention_cost", "scratch_bytes", "fwd_smem", "padded_d",
           "STATIC_SMEM"]

SOFTMAX_FLOPS_PER_PAIR = 6  # max, sub, exp, sum-add, rescale mul, mask
BM, BN, STAGES = 128, 64, 2  # query rows a block, keys a tile, the ring's stages
STATIC_SMEM = {"flash_split_kv": 0, "flash_fwd_kernel": 0}


def padded_d(d: int) -> int:
    return 64 if d <= 64 else 128


def _pieces(elem_bytes: int) -> int:
    return 3 if elem_bytes == 4 else 1


def scratch_bytes(b: int, skv: int, kh: int, d: int, elem_bytes: int = 4) -> int:
    return 2 * b * kh * (_pieces(elem_bytes) + 1) * -(-skv // 8) * 8 * padded_d(d)


def fwd_smem(d: int, elem_bytes: int = 4) -> int:
    p = _pieces(elem_bytes)
    return 2 * (p * BM + STAGES * (p + 1) * BN) * padded_d(d)


def attend_pairs(sq: int, skv: int, causal: bool, window: int | None, prefix: int = 0) -> int:
    """Exact count of (q, k) pairs the masks admit, positions from 0:
    ``k <= max(q, prefix - 1)`` when causal, ``q - k < window``."""
    total = 0
    for q in range(sq):
        hi = min(skv - 1, max(q, prefix - 1)) if causal else skv - 1
        lo = max(0, q - window + 1) if window is not None else 0
        total += max(hi - lo + 1, 0)
    return total


def visited_pairs(sq: int, skv: int, causal: bool, window: int | None, prefix: int = 0) -> tuple[int, int]:
    """(pairs the forward's warpgroups compute, keys its blocks load) for one
    (batch, head), by the kernel's tile rule."""
    skv8 = -(-skv // 8) * 8
    cap = prefix - 1
    pairs = keys = 0
    for q0 in range(0, sq, BM):
        q_last = min(q0 + BM, sq) - 1
        kb, ke = 0, skv
        if not (window is not None and q_last >= skv - 1 + window):
            if causal:
                ke = min(skv, max(q_last, cap) + 1)
            if window is not None and q0 - window + 1 > 0:
                kb = (q0 - window + 1) // BN * BN
        tiles = -(-(ke - kb) // BN) if ke > kb else 0
        if tiles:
            keys += min(kb + tiles * BN, skv8) - kb
        for gr0 in (q0, q0 + 64):
            if gr0 >= sq:
                continue
            gr1 = min(gr0 + 63, sq - 1)
            group_all = window is not None and gr1 >= skv - 1 + window
            for t in range(tiles):
                k0 = kb + t * BN
                k_hi = min(k0 + BN, skv) - 1
                if group_all or not ((causal and k0 > max(gr1, cap)) or
                                     (window is not None and gr0 - k_hi >= window)):
                    pairs += 64 * BN
    return pairs, keys


def flash_attention_cost(b: int, sq: int, skv: int, h: int, kh: int, d: int, *, backend: str,
                         causal: bool = True, window: int | None = None, elem_bytes: int = 4,
                         prefix: int = 0, lse: bool = False) -> Cost:
    """``lse``: the training forward also writes each row's f32
    log-sum-exp (4 B a (batch, head, row))."""
    bh = b * h
    pairs = attend_pairs(sq, skv, causal, window, prefix)
    write = bh * sq * (d * elem_bytes + (4 if lse else 0))
    if backend == "ref":
        macs = 2 * bh * pairs * d  # QK^T + PV
        return Cost(flops=2 * macs + bh * (SOFTMAX_FLOPS_PER_PAIR * pairs + 2 * sq * d), macs=macs,
                    hbm_read_bytes=(bh * sq + 2 * b * kh * skv) * d * elem_bytes, hbm_write_bytes=write)
    dp, p = padded_d(d), _pieces(elem_bytes)
    visited, keys = visited_pairs(sq, skv, causal, window, prefix)
    scratch = scratch_bytes(b, skv, kh, d, elem_bytes)
    macs = 2 * bh * visited * dp
    flops = 2 * macs + bh * (SOFTMAX_FLOPS_PER_PAIR * visited + 2 * sq * d)
    ref_flops = 4 * bh * pairs * d + bh * (SOFTMAX_FLOPS_PER_PAIR * pairs + 2 * sq * d)
    return Cost(
        flops=flops, macs=macs,
        hbm_read_bytes=2 * b * kh * skv * d * elem_bytes + bh * sq * d * elem_bytes + bh * keys * (p + 1) * dp * 2,
        hbm_write_bytes=scratch + write, smem_bytes=fwd_smem(d, elem_bytes), pad_waste_flops=flops - ref_flops,
    )
