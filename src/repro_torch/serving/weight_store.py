"""Packed weight store — the serving deployment formats.

Counterpart of ``repro.serving.weight_store``. Every matmul-site weight
(ndim >= 2, floating) is packed once, at engine construction; 1-D biases
stay dense. Two formats:

  * ``floatsd8``: uint8 FloatSD8 codes + a per-tensor exponent bias
    (``core.floatsd.encode``). ``decode(*encode(w)) == quantize(w)``
    exactly, so serving from codes computes the training-time fake-quant
    function.
  * ``floatsd4``: two 4-bit codes per byte + one int8 exponent per 32 rows
    and column (``core.floatsd4``), about half FloatSD8's bytes. It is
    always derived from the FloatSD8 values (``pack_floatsd4`` packs to
    FloatSD8 first), so it re-quantizes the served model: an accuracy for
    footprint trade, not the same function.

Codes, biases and exponents are byte-identical to the reference's on the
same weights. A stacked model (the zoo's scanned layers) packs each
stacked leaf whole, with one bias for all its layers, as the reference
does: its norm scales and biases, token-shift mixes, decay base and bonus
are >= 2-D there, so they are served FloatSD8-quantized too; only the 1-D
final norm stays dense.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .._tree import tree_leaves, tree_map
from ..core import floatsd
from ..kernels.dispatch import (
    PackedTensor, PackedTensor4, is_any_packed, is_packed, is_packed4, pack4, unpack4,
)

__all__ = [
    "PackedTensor", "PackedTensor4", "WeightStore", "WEIGHT_FORMATS", "pack_tree",
    "pack_floatsd4", "unpack_tree", "tree_nbytes",
]

#: serving weight formats: FloatSD8 (1 byte a weight, per-tensor bias) and
#: FloatSD4 (2 codes a byte + int8 group exponents, ~0.53 byte a weight)
WEIGHT_FORMATS = ("floatsd8", "floatsd4")


def _packable(x, min_ndim: int) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= min_ndim and x.is_floating_point()


def pack_tree(params: Any, min_ndim: int = 2) -> Any:
    """Dense param tree -> tree with a PackedTensor at every packable leaf.
    Leaves already packed (a store the JAX package packed, carried across
    by ``bridge.from_jax_packed``) pass through unchanged.

    Raises on nonfinite weights: codes cannot represent NaN/inf, and
    ``encode`` would otherwise serve a finite but wrong model."""

    def _pack(w):
        if not _packable(w, min_ndim):
            return w
        if not bool(torch.isfinite(w.to(torch.float32)).all()):
            raise ValueError(
                f"pack_tree: nonfinite values in weight tensor shape={tuple(w.shape)} "
                f"— refusing to encode NaN/inf to a finite FloatSD8 code (corrupt checkpoint?)"
            )
        codes, bias = floatsd.encode(w)
        return PackedTensor(codes, int(bias))

    return tree_map(_pack, params, is_leaf=is_any_packed)


def pack_floatsd4(tree: Any, min_ndim: int = 2) -> Any:
    """Dense param tree -> tree with a PackedTensor4 at every packable leaf,
    through the FloatSD8 codes first: FloatSD4 re-quantizes the FloatSD8
    values the model was trained against, never the raw masters."""
    return tree_map(lambda x: pack4(x) if is_packed(x) else x,
                    pack_tree(tree, min_ndim=min_ndim), is_leaf=is_any_packed)


def unpack_tree(tree: Any, dtype=torch.float32) -> Any:
    """Packed leaves (either format) -> dense ``dtype`` tensors."""

    def _unpack(x):
        if is_packed(x):
            return floatsd.decode(x.codes, x.bias, dtype=dtype)
        if is_packed4(x):
            return unpack4(x, dtype=dtype)
        return x

    return tree_map(_unpack, tree, is_leaf=is_any_packed)


def tree_nbytes(tree: Any) -> int:
    """Bytes of every tensor leaf; a PackedTensor counts its codes plus a
    4-byte bias, a PackedTensor4 its codes plus its exponents (one byte
    each), as the reference stores them."""

    def _n(x):
        if is_packed(x):
            return x.codes.numel() + 4
        if is_packed4(x):
            return x.codes.numel() + x.exps.numel()
        return x.numel() * x.element_size()

    return sum(_n(x) for x in tree_leaves(tree, is_leaf=is_any_packed))


@dataclasses.dataclass(frozen=True)
class WeightStore:
    """The packed serving weights plus size bookkeeping."""

    tree: Any  # param tree with PackedTensor / PackedTensor4 leaves at the packed sites
    dense_nbytes: int
    n_packed: int
    fmt: str = "floatsd8"  # one of WEIGHT_FORMATS

    @classmethod
    def pack(cls, params: Any, min_ndim: int = 2, fmt: str = "floatsd8") -> "WeightStore":
        if fmt not in WEIGHT_FORMATS:
            raise ValueError(f"weight format must be one of {WEIGHT_FORMATS}, got {fmt!r}")
        pack = pack_floatsd4 if fmt == "floatsd4" else pack_tree
        packed = pack(params, min_ndim=min_ndim)
        n = sum(is_any_packed(x) for x in tree_leaves(packed, is_leaf=is_any_packed))
        return cls(tree=packed, dense_nbytes=tree_nbytes(params), n_packed=n, fmt=fmt)

    @property
    def packed_nbytes(self) -> int:
        return tree_nbytes(self.tree)

    @property
    def compression(self) -> float:
        return self.dense_nbytes / max(self.packed_nbytes, 1)
