"""Cost model of the chunked RWKV-6 wkv; counterpart of
``repro.kernels.rwkv_wkv.cost``.

The port's layout: r, k, w [B, S, H, K], v [B, S, H, V], u [H, K] (shared by
the batch) or [B, H, K] -> y [B, S, H, V] f32 and the final state [B, H,
K, V] f32, which the reference's call does not return.

  * **ref** (the per-token recurrence): each step builds the k v^T outer
    product (K V MACs), contracts r against the state (K V MACs) and applies
    the decay and the bonus (~4 more ops a state element). Every operand
    read once, y and the state written once.
  * **cuda** (``rwkv_wkv.cu``, two device kernels a call): the pre-pass, a
    block a (batch x head, chunk of 16), reads r, k, w and u and writes each
    chunk's record (``scratch_bytes``, the mirror of the library's
    ``rwkv_wkv_scratch_bytes``); the walk, a block a (16 columns of V, batch
    x head), reads every record of its head and its columns of v, and
    writes y and the final state. So the records are read once per
    16-column slice of V. MACs are the chunked form's (the inter-chunk term
    and the state update, 2 L K V a chunk, and the tile, L L (K + V)), at
    the padded head size KT (64 or 128) with the K padding charged to
    ``pad_waste_flops``. ``smem_bytes`` is the larger of the pre-pass's and
    the walk's dynamic shared memory (``prep_smem`` / ``walk_smem``); neither
    has static shared memory.
"""
from __future__ import annotations

from ...obs.costmodel import Cost

__all__ = ["wkv_cost", "scratch_bytes", "prep_smem", "walk_smem", "padded_k", "CHUNK", "STATIC_SMEM"]

CHUNK = 16  # kL: the kernel's chunk length
V_SLICE = 16  # kVS: V columns a walk block
RING = 4  # kRing: the walk's chunks in shared memory
STATIC_SMEM = {"wkv_chunk_prep": 0, "rwkv_wkv_kernel": 0}


def padded_k(k: int) -> int:
    return 64 if k <= 64 else 128


def scratch_bytes(b: int, h: int, s: int, k: int) -> int:
    """The chunk records a call needs: (2 L KT + L L + KT) f32 a (batch,
    head, chunk of L)."""
    kt = padded_k(k)
    return 4 * b * h * -(-s // CHUNK) * (2 * CHUNK * kt + CHUNK * CHUNK + kt)


def prep_smem(k: int) -> int:
    kt = padded_k(k)
    return 4 * (6 * CHUNK * (kt + 4) + 2 * kt)


def walk_smem(k: int) -> int:
    kt = padded_k(k)
    return 4 * RING * ((2 * CHUNK * kt + CHUNK * CHUNK + kt) + CHUNK * V_SLICE)


def _chunk_flops(bh: int, n: int, dk: int, dv: int) -> tuple[int, int]:
    macs = bh * n * (2 * CHUNK * dk * dv + CHUNK * CHUNK * (dk + dv))
    exp_flops = bh * n * (3 * CHUNK * CHUNK * dk + 6 * CHUNK * dk)
    return 2 * macs + exp_flops, macs


def wkv_cost(b: int, s: int, h: int, dk: int, dv: int, *, backend: str, u_batched: bool = False,
             elem_bytes: int = 4) -> Cost:
    bh = b * h
    u_elems = (bh if u_batched else h) * dk
    out = bh * s * dv * 4 + bh * dk * dv * 4  # y and the final state, f32
    if backend == "ref":
        macs = 2 * bh * s * dk * dv
        return Cost(flops=2 * macs + 4 * bh * s * dk * dv + 2 * bh * s * dk, macs=macs,
                    hbm_read_bytes=(bh * s * (3 * dk + dv) + u_elems) * elem_bytes, hbm_write_bytes=out)
    n = -(-s // CHUNK)
    scratch = scratch_bytes(b, h, s, dk)
    flops, macs = _chunk_flops(bh, n, padded_k(dk), dv)
    return Cost(
        flops=flops, macs=macs,
        hbm_read_bytes=bh * s * 3 * dk * 4 + n * bh * dk * 4 + -(-dv // V_SLICE) * scratch + bh * s * dv * 4,
        hbm_write_bytes=scratch + out, smem_bytes=max(prep_smem(dk), walk_smem(dk)),
        pad_waste_flops=flops - _chunk_flops(bh, n, dk, dv)[0],
    )
