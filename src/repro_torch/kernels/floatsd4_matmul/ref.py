"""Plain PyTorch version of the FloatSD4 matmul: decode the nibble-packed
codes, then an f32 sum over the contraction in the CUDA kernel's order
(``split_matmul(x, w, ordered=True)``: K cut into the chunks of
``floatsd_matmul.ref.plan(M, N, K, ordered=True)``, each summed in k order,
the chunk sums added in chunk order).

Three layouts of the packed weight:

  * ``transposed=False``: codes [ceil(K/2), N], exps [ceil(K/32), N], the
    gate weights (K = ``rows`` is the contraction);
  * ``transposed=True``: the [N, K] table read in place, codes
    [ceil(N/2), K], exps [ceil(N/32), K], the tied logits head (N =
    ``rows`` vocabulary rows are the output);
  * ``nibble`` given (0 or 1): layer l's planes of a stacked [L, K, N] leaf
    packed along its layer axis, codes ``codes[l >> 1]`` and exps
    ``exps[l >> 5]``, both [K, N], nibble l & 1 (``core.floatsd4.
    decode_plane``: one exponent an element).

On the serving path every product is exact in f32 (FP8/FP16 activations
times FloatSD4 values of at most 4 significant bits), so this version and
the kernel agree bit for bit there.
"""
from __future__ import annotations

import torch

from ...core.floatsd4 import decode_packed, decode_plane
from ..floatsd_matmul.ref import split_matmul

__all__ = ["floatsd4_matmul_ref"]


def floatsd4_matmul_ref(x: torch.Tensor, codes: torch.Tensor, exps: torch.Tensor, rows: int, *,
                        transposed: bool = False, dense: torch.Tensor | None = None,
                        nibble: int | None = None) -> torch.Tensor:
    """x [M, K] @ decode4(codes, exps) -> [M, N] f32. ``rows`` is the true
    length of the packed axis (an odd one carries a pad nibble; K for a
    layer's planes); ``dense`` is the weight's decode [rows, ...] if the
    caller has it."""
    if dense is not None:
        w = dense
    elif nibble is not None:
        w = decode_plane(codes, exps, nibble)
    else:
        w = decode_packed(codes, exps, rows)
    return split_matmul(x, w.t() if transposed else w, ordered=True)
