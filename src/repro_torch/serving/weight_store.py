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
final norm stays dense. In FloatSD4 a stacked leaf is nibble-packed and
grouped along its axis 0, the layer axis, as the reference's ``pack4``
does: layer l's code of (k, n) is nibble l & 1 of ``codes[l >> 1, k, n]``
and its exponent ``exps[l >> 5, k, n]`` (``dispatch.LayerTensor4``).

``WeightStore.pack_streamed`` builds a store whose f32 tree would not fit
beside it: the model draws its parts one at a time (a stacked block one
group at a time) and the packer keeps only what the store needs. A
stacked leaf of several groups needs its one FloatSD8 bias before any
group is encoded, and ``floatsd.fit_bias`` reads only max|w|: a first pass
draws everything and keeps each such leaf's max|w|, a second draws the
same numbers again, from a generator seeded anew, and encodes each group
into the preallocated codes (and raises if its max|w| is not the first
pass's). Every FloatSD4 store is converted from FloatSD8 codes by one
converter, ``floatsd4_of``, leaf by leaf in slabs of axis 1 (a column's
axis-0 exponents do not depend on other columns).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .._tree import tree_leaves, tree_map
from ..core import floatsd, floatsd4
from ..device import resolve_device
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
        _check_finite(bool(torch.isfinite(w.to(torch.float32)).all()), w.shape)
        codes, bias = floatsd.encode(w)
        return PackedTensor(codes, int(bias))

    return tree_map(_pack, params, is_leaf=is_any_packed)


def _check_finite(ok: bool, shape) -> None:
    if not ok:
        raise ValueError(
            f"pack_tree: nonfinite values in weight tensor shape={tuple(shape)} "
            f"— refusing to encode NaN/inf to a finite FloatSD8 code (corrupt checkpoint?)"
        )


#: f32 bytes of one slab of a leaf's FloatSD8 -> FloatSD4 conversion
SLAB_BYTES = 1 << 28


def floatsd4_of(w: Any) -> Any:
    """``pack4(w)`` of a FloatSD8 leaf, formed in slabs of its axis 1 with
    at most ``SLAB_BYTES`` of f32 decoded at a time: a column's axis-0
    exponents and codes depend on that column alone, so the bytes are
    ``pack4(w)``'s. Any other leaf is returned as it is."""
    if not is_packed(w):
        return w
    c = w.codes
    if c.dim() < 2:
        return pack4(w)
    k, cols = c.shape[0], c.shape[1]
    codes = torch.empty((-(-k // 2), *c.shape[1:]), dtype=torch.uint8, device=c.device)
    exps = torch.empty((-(-k // floatsd4.GROUP), *c.shape[1:]), dtype=torch.int8, device=c.device)
    step = max(1, SLAB_BYTES // (4 * c[:, :1].numel()))
    for j in range(0, cols, step):
        s = pack4(PackedTensor(c[:, j:j + step], w.bias))
        codes[:, j:j + step] = s.codes
        exps[:, j:j + step] = s.exps
    return PackedTensor4(codes, exps, k)


class _TwoPass:
    """``pack_streamed``'s packer, handed each part of the tree as it is
    drawn: ``pack(tree)`` for a part drawn whole, ``pack(tree, (key, g,
    n))`` for group g of n of the stacked block ``key`` (its tree without
    the group axis). Returns what the tree keeps there. Pass 1 packs the
    whole parts and one-group blocks and keeps a running max|w| of every
    leaf of a block of several groups (returning None for them); pass 2
    (``second``), on the same draws, returns pass 1's packs and encodes
    each group of the other blocks with its leaf's bias into codes
    preallocated at group 0, the stacked tree returned at group n - 1, once
    its leaves' max|w| are found equal to pass 1's: a draw that is not the
    first pass's would otherwise be encoded at the wrong biases."""

    def __init__(self, min_ndim: int):
        self.min_ndim = min_ndim
        self.second = False
        self.dense = 0
        self._parts: list = []  # pass 1's packed whole parts, in draw order
        self._calls = 0
        self._single: dict = {}  # key -> a packed one-group block
        self._amax: dict = {}  # key -> its leaves' max|w| in pass 1 (device tensors)
        self._again: dict = {}  # key -> the same in pass 2
        self._slots: dict = {}  # key -> its stacked leaves being filled in pass 2

    def needs_second(self) -> bool:
        """After pass 1: whether a block of several groups was drawn (then
        arms pass 2)."""
        self.second, self._calls = bool(self._amax), 0
        return self.second

    def __call__(self, tree, at=None):
        if at is None:
            i, self._calls = self._calls, self._calls + 1
            if not self.second:
                self.dense += tree_nbytes(tree)
                self._parts.append(pack_tree(tree, min_ndim=self.min_ndim))
            return self._parts[i]
        key, g, n = at
        if n == 1:
            if not self.second:
                self.dense += tree_nbytes(tree)
                self._single[key] = pack_tree(tree_map(lambda t: t.unsqueeze(0), tree), self.min_ndim)
            return self._single[key]
        seen = self._again if self.second else self._amax
        amax = tree_map(lambda t: t.detach().to(torch.float32).abs().amax(), tree)
        seen[key] = amax if g == 0 else tree_map(torch.maximum, seen[key], amax)
        if not self.second:
            self.dense += tree_nbytes(tree)
            return None
        if g == 0:
            self._slots[key] = tree_map(lambda t, a: self._slot(t, a, n), tree, self._amax[key])
        slots = self._slots[key]
        tree_map(lambda slot, t: self._fill(slot, t, g), slots, tree, is_leaf=is_packed)
        if g < n - 1:
            return None
        first, again = tree_leaves(self._amax.pop(key)), tree_leaves(self._again.pop(key))
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise ValueError(f"pack_streamed: the second draw of {key!r} is not the first's "
                             f"(max|w| differs): init must draw from the generator it is handed")
        return self._slots.pop(key)

    def _slot(self, t: torch.Tensor, amax: torch.Tensor, n: int):
        """A stacked leaf's storage: FloatSD8 codes at the bias of its
        max|w|, or the dense tensor where the leaf is not packed."""
        if not _packable(t.unsqueeze(0), self.min_ndim):
            return t.new_empty((n, *t.shape))
        _check_finite(bool(torch.isfinite(amax)), (n, *t.shape))
        return PackedTensor(torch.empty((n, *t.shape), dtype=torch.uint8, device=t.device),
                            int(floatsd.fit_bias(amax)))

    @staticmethod
    def _fill(slot, t: torch.Tensor, g: int) -> None:
        if is_packed(slot):
            slot.codes[g].copy_(floatsd.encode(t, slot.bias)[0])
        else:
            slot[g].copy_(t)


def pack_floatsd4(tree: Any, min_ndim: int = 2) -> Any:
    """Dense param tree -> tree with a PackedTensor4 at every packable leaf,
    through the FloatSD8 codes first: FloatSD4 re-quantizes the FloatSD8
    values the model was trained against, never the raw masters."""
    return _floatsd4_in_place(pack_tree(tree, min_ndim=min_ndim))


def _floatsd4_in_place(tree: Any) -> Any:
    """``tree`` with each FloatSD8 leaf replaced by ``floatsd4_of``'s, in
    place in its dicts and lists, so a leaf nothing else holds is freed as
    soon as it is converted."""
    if is_any_packed(tree):
        return floatsd4_of(tree)
    if isinstance(tree, (dict, list)):
        for key in list(tree) if isinstance(tree, dict) else range(len(tree)):
            tree[key] = _floatsd4_in_place(tree[key])
        return tree
    if isinstance(tree, tuple):
        vals = [_floatsd4_in_place(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return tree


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

    @classmethod
    def pack_streamed(cls, init, seed: int, device=None, min_ndim: int = 2,
                      fmt: str = "floatsd8") -> "WeightStore":
        """The ``fmt`` store of the tree ``init(generator, pack)`` returns
        (``CausalLM.init``), where ``init`` draws from ``generator`` and
        hands ``pack`` each part of the tree as soon as it is drawn (a
        stacked block group by group): its f32 is freed once packed, so a
        model whose f32 tree would not fit is built one block at a time. A
        stack of several groups is drawn twice (the module docstring), each
        time from a generator on ``device`` seeded with ``seed``. The same
        bytes as ``pack(init(that generator), fmt=fmt)``."""
        if fmt not in WEIGHT_FORMATS:
            raise ValueError(f"weight format must be one of {WEIGHT_FORMATS}, got {fmt!r}")
        dev = resolve_device(device)
        pack = _TwoPass(min_ndim)

        def draw():
            return init(torch.Generator(device=dev).manual_seed(seed), pack)

        packed = draw()
        if pack.needs_second():
            packed = draw()
        n = sum(is_any_packed(x) for x in tree_leaves(packed, is_leaf=is_any_packed))
        store = cls(tree=packed, dense_nbytes=pack.dense, n_packed=n)
        return cls.requantized4(store) if fmt == "floatsd4" else store

    @classmethod
    def requantized4(cls, store: "WeightStore") -> "WeightStore":
        """The FloatSD4 store of a FloatSD8 one, the bytes of ``pack(...,
        fmt="floatsd4")``: each leaf converted as ``pack_floatsd4`` converts
        it, in the place of its FloatSD8 codes in ``store``'s tree, which the
        new store takes over (do not use ``store`` after), so each FloatSD8
        leaf is freed as soon as it is converted."""
        if store.fmt != "floatsd8":
            raise ValueError(f"requantized4 takes a FloatSD8 store, got {store.fmt!r}")
        return cls(tree=_floatsd4_in_place(store.tree), dense_nbytes=store.dense_nbytes,
                   n_packed=store.n_packed, fmt="floatsd4")

    @property
    def packed_nbytes(self) -> int:
        return tree_nbytes(self.tree)

    @property
    def compression(self) -> float:
        return self.dense_nbytes / max(self.packed_nbytes, 1)
