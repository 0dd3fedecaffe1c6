"""Packed FloatSD8 weight store — the serving deployment format.

Counterpart of ``repro.serving.weight_store`` (FloatSD8 only). Every
matmul-site weight (ndim >= 2, floating) is packed once, at engine
construction, to uint8 FloatSD8 codes + a per-tensor exponent bias by
``core.floatsd.encode``; 1-D biases stay dense. The codes are byte-identical
to the reference's ``pack_tree`` on the same weights, and
``decode(*encode(w)) == quantize(w)`` exactly, so serving from codes
computes the training-time fake-quant function.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .._tree import tree_leaves, tree_map
from ..core import floatsd
from ..kernels.dispatch import PackedTensor, is_packed

__all__ = ["PackedTensor", "WeightStore", "pack_tree", "unpack_tree", "tree_nbytes"]


def _packable(x, min_ndim: int) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= min_ndim and x.is_floating_point()


def pack_tree(params: Any, min_ndim: int = 2) -> Any:
    """Dense param tree -> tree with a PackedTensor at every packable leaf.

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

    return tree_map(_pack, params)


def unpack_tree(tree: Any, dtype=torch.float32) -> Any:
    """Packed leaves -> dense ``dtype`` tensors."""
    return tree_map(
        lambda x: floatsd.decode(x.codes, x.bias, dtype=dtype) if is_packed(x) else x,
        tree, is_leaf=is_packed,
    )


def tree_nbytes(tree: Any) -> int:
    """Bytes of every tensor leaf; a PackedTensor counts its codes plus a
    4-byte bias, as the reference stores it."""

    def _n(x):
        if is_packed(x):
            return x.codes.numel() + 4
        return x.numel() * x.element_size()

    return sum(_n(x) for x in tree_leaves(tree, is_leaf=is_packed))


@dataclasses.dataclass(frozen=True)
class WeightStore:
    """The packed serving weights plus size bookkeeping."""

    tree: Any  # param tree with PackedTensor leaves at the packed sites
    dense_nbytes: int
    n_packed: int

    @classmethod
    def pack(cls, params: Any, min_ndim: int = 2) -> "WeightStore":
        packed = pack_tree(params, min_ndim=min_ndim)
        n = sum(is_packed(x) for x in tree_leaves(packed, is_leaf=is_packed))
        return cls(tree=packed, dense_nbytes=tree_nbytes(params), n_packed=n)

    @property
    def packed_nbytes(self) -> int:
        return tree_nbytes(self.tree)

    @property
    def compression(self) -> float:
        return self.dense_nbytes / max(self.packed_nbytes, 1)
