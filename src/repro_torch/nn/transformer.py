"""Residual blocks and the stack over layers.

Counterpart of ``repro.nn.transformer`` for two of its blocks: the ``ssm``
family's RWKV-6 block (norm -> time mix -> residual, norm -> channel mix ->
residual) and the ``dense`` family's attention block (norm -> attention ->
residual, norm -> FFN -> residual). A ``Stack`` holds ``n_groups`` copies
of one block with every parameter leaf stacked on a leading layer axis,
under the reference's ``b0`` key (a period of one block), as the
reference's scanned stack has them, and loops over the layers. Mamba and
MoE come with their families (``ROADMAP.md`` Queue 1 item 8).

A served stack's leaves are FloatSD8 ``PackedTensor``s with one bias per
stacked leaf. ``hoist`` decodes the small ones (everything but the weight
sites) to f32 once, for all layers; layer ``l`` then gets ``codes[l]``
with that bias at each weight site, which runs the matmul kernel on the
slice.
"""
from __future__ import annotations

import dataclasses

import torch

from .._tree import tree_map
from ..core import floatsd
from ..core.policy import Policy
from ..kernels import dispatch as kd
from .attention import Attention, KVCache
from .ffn import FFN
from .module import stack_init
from .norms import LayerNorm, RMSNorm
from .rwkv import WEIGHT_SITES as RWKV_SITES
from .rwkv import RWKV6ChannelMix, RWKV6TimeMix, RWKVState

__all__ = ["Block", "Stack", "hoist", "WEIGHT_SITES"]

#: the leaf names a matmul reads: the RWKV mixes' projections, and the
#: weight ``w`` of every ``QuantDense`` (attention's q, k, v, o and the
#: FFN's); their biases ``b``, like every other leaf, are small
WEIGHT_SITES = RWKV_SITES | {"w"}


def _norm(kind: str, dim: int):
    return RMSNorm(dim) if kind == "rmsnorm" else LayerNorm(dim)


def hoist(tree, name: str = ""):
    """A stacked block tree with every FloatSD8-packed leaf that is not a
    weight site decoded to f32, all layers at once: norm scales and
    biases, projection biases, and the RWKV token-shift mixes, decay base
    and LoRA, bonus and output-norm scale (46.5 MB of f32 at rwkv6_3b's
    full width). The weight sites keep their codes for the matmul kernel.
    A decoded tree passes through unchanged."""
    if isinstance(tree, dict):
        return {k: hoist(v, k) for k, v in tree.items()}
    if kd.is_packed4(tree):
        raise NotImplementedError(
            "FloatSD4 serving of a stacked model is not ported (this slice serves FloatSD8; "
            "ROADMAP.md Queue 1 item 8)")
    if kd.is_packed(tree) and name not in WEIGHT_SITES:
        return floatsd.decode(tree.codes, tree.bias)
    return tree


def _layer(tree, l: int):
    """Layer ``l`` of a stacked parameter (or cache) tree: ``x[l]`` of every
    tensor, ``PackedTensor(codes[l], bias)`` of every packed leaf."""
    return tree_map(lambda x: kd.PackedTensor(x.codes[l], x.bias) if kd.is_packed(x) else x[l],
                    tree, is_leaf=kd.is_packed)


@dataclasses.dataclass(frozen=True)
class Block:
    """One residual block: attention and an FFN (``attn``, ``ffn_mod``: the
    reference's mixer ``attn``, mlp ``ffn``), or the RWKV-6 time and
    channel mixes (``rwkv_mod``, ``cmix_mod``: mixer ``rwkv``, mlp
    ``none``). The modules that are set say which."""

    dim: int
    attn: Attention | None = None
    ffn_mod: FFN | None = None
    rwkv_mod: RWKV6TimeMix | None = None
    cmix_mod: RWKV6ChannelMix | None = None
    norm: str = "rmsnorm"

    def __post_init__(self):
        pairs = ((self.attn, self.ffn_mod), (self.rwkv_mod, self.cmix_mod))
        if sorted(sum(m is not None for m in pair) for pair in pairs) != [0, 2]:
            raise ValueError("a Block takes attn and ffn_mod, or rwkv_mod and cmix_mod")

    def init(self, generator: torch.Generator):
        n = _norm(self.norm, self.dim)
        mixer, mlp = (self.attn, self.ffn_mod) if self.attn is not None else (self.rwkv_mod, self.cmix_mod)
        return {"norm1": n.init(generator), "mixer": mixer.init(generator),
                "norm2": n.init(generator), "mlp": mlp.init(generator)}

    def apply(self, p, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        """Full-sequence path (forward / prefill): x [B, S, d] -> [B, S, d]."""
        n = _norm(self.norm, self.dim)
        h = n.apply(p["norm1"], x)
        if self.attn is not None:
            x = x + self.attn.apply(p["mixer"], h, policy)
            return x + self.ffn_mod.apply(p["mlp"], n.apply(p["norm2"], x), policy)
        mix, _ = self.rwkv_mod.apply(p["mixer"], h, policy)
        x = x + mix
        y, _ = self.cmix_mod.apply(p["mlp"], n.apply(p["norm2"], x), policy)
        return x + y

    def init_cache(self, batch: int, s_max: int | None, dtype, device):
        """Zero decode state: a KV cache of min(s_max, window) slots, or the
        RWKV state (s_max unused)."""
        if self.attn is not None:
            a = self.attn
            return KVCache.init(batch, min(s_max, a.window or s_max), a.kv_heads, a.hd, dtype, device)
        r = self.rwkv_mod
        return RWKVState(
            torch.zeros((batch, r.heads, r.head_dim, r.head_dim), dtype=torch.float32, device=device),
            torch.zeros((batch, self.dim), dtype=dtype, device=device),
            torch.zeros((batch, self.dim), dtype=dtype, device=device),
        )

    def decode(self, p, x: torch.Tensor, cache, policy: Policy):
        n = _norm(self.norm, self.dim)
        h = n.apply(p["norm1"], x)
        if self.attn is not None:
            mix, cache = self.attn.decode(p["mixer"], h, cache, policy)
            x = x + mix
            return x + self.ffn_mod.apply(p["mlp"], n.apply(p["norm2"], x), policy), cache
        mix, (s_new, x_tm) = self.rwkv_mod.apply(p["mixer"], h, policy, state=cache)
        x = x + mix
        y, x_cm = self.cmix_mod.apply(p["mlp"], n.apply(p["norm2"], x), policy, cache.x_cm)
        return x + y, RWKVState(s_new, x_tm, x_cm)


@dataclasses.dataclass(frozen=True)
class Stack:
    """``n_groups`` copies of ``block``, every leaf stacked on axis 0 under
    the key ``b0``. Parameters are ``hoist``ed (a served tree's small leaves
    decoded)."""

    block: Block
    n_groups: int

    def init(self, generator: torch.Generator):
        return stack_init(lambda g: {"b0": self.block.init(g)}, self.n_groups)(generator)

    def apply(self, p, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        for layer in range(self.n_groups):
            x = self.block.apply(_layer(p, layer)["b0"], x, policy)
        return x

    def init_cache(self, batch: int, s_max: int | None, dtype, device):
        one = {"b0": self.block.init_cache(batch, s_max, dtype, device)}
        return tree_map(lambda c: c.unsqueeze(0).repeat((self.n_groups,) + (1,) * c.dim()), one)

    def decode(self, p, x: torch.Tensor, caches, policy: Policy):
        """One step of every layer; the caches are layer-major ([n_groups,
        B, ...] per leaf), as the reference's scanned stack keeps them."""
        new = []
        for layer in range(self.n_groups):
            x, c = self.block.decode(_layer(p, layer)["b0"], x, _layer(caches, layer)["b0"], policy)
            new.append({"b0": c})
        return x, tree_map(lambda *xs: torch.stack(xs), *new)
