"""Residual blocks and the stack over layers.

Counterpart of ``repro.nn.transformer`` for the ``rwkv`` mixer (the model
zoo's ``ssm`` family): a ``Block`` is norm -> RWKV-6 time mix -> residual,
norm -> channel mix -> residual; a ``Stack`` holds ``n_groups`` copies of
it with every parameter leaf stacked on a leading layer axis, under the
reference's ``b0`` key (a period of one block), as the reference's scanned
stack has them, and loops over the layers. The other mixers (attention,
Mamba) and MLPs (FFN, MoE) come with their families (``ROADMAP.md`` Queue
1 item 10).

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
from .module import stack_init
from .norms import LayerNorm, RMSNorm
from .rwkv import WEIGHT_SITES, RWKV6ChannelMix, RWKV6TimeMix, RWKVState

__all__ = ["Block", "Stack", "hoist"]


def _norm(kind: str, dim: int):
    return RMSNorm(dim) if kind == "rmsnorm" else LayerNorm(dim)


def hoist(tree, name: str = ""):
    """A stacked block tree with every FloatSD8-packed leaf that is not a
    weight site (norm scales and biases, token-shift mixes, decay base and
    LoRA, bonus, output-norm scale: 46.5 MB of f32 at rwkv6_3b's full
    width) decoded to f32, all layers at once. The weight sites keep their
    codes for the matmul kernel. A decoded tree passes through unchanged."""
    if isinstance(tree, dict):
        return {k: hoist(v, k) for k, v in tree.items()}
    if kd.is_packed4(tree):
        raise NotImplementedError(
            "FloatSD4 serving of a stacked model is not ported (this slice serves FloatSD8; "
            "ROADMAP.md Queue 1 item 10)")
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
    """One residual block: the RWKV-6 time mix and its channel mix."""

    dim: int
    rwkv_mod: RWKV6TimeMix
    cmix_mod: RWKV6ChannelMix
    norm: str = "rmsnorm"

    def init(self, generator: torch.Generator):
        n = _norm(self.norm, self.dim)
        return {"norm1": n.init(generator), "mixer": self.rwkv_mod.init(generator),
                "norm2": n.init(generator), "mlp": self.cmix_mod.init(generator)}

    def apply(self, p, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        """Full-sequence path (forward / prefill): x [B, S, d] -> [B, S, d]."""
        n = _norm(self.norm, self.dim)
        mix, _ = self.rwkv_mod.apply(p["mixer"], n.apply(p["norm1"], x), policy)
        x = x + mix
        y, _ = self.cmix_mod.apply(p["mlp"], n.apply(p["norm2"], x), policy)
        return x + y

    def init_cache(self, batch: int, dtype, device) -> RWKVState:
        r = self.rwkv_mod
        return RWKVState(
            torch.zeros((batch, r.heads, r.head_dim, r.head_dim), dtype=torch.float32, device=device),
            torch.zeros((batch, self.dim), dtype=dtype, device=device),
            torch.zeros((batch, self.dim), dtype=dtype, device=device),
        )

    def decode(self, p, x: torch.Tensor, cache: RWKVState, policy: Policy):
        n = _norm(self.norm, self.dim)
        mix, (s_new, x_tm) = self.rwkv_mod.apply(p["mixer"], n.apply(p["norm1"], x), policy, state=cache)
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

    def init_cache(self, batch: int, dtype, device):
        one = {"b0": self.block.init_cache(batch, dtype, device)}
        return tree_map(lambda c: c.unsqueeze(0).repeat((self.n_groups,) + (1,) * c.dim()), one)

    def decode(self, p, x: torch.Tensor, caches, policy: Policy):
        """One step of every layer; the caches are layer-major ([n_groups,
        B, ...] per leaf), as the reference's scanned stack keeps them."""
        new = []
        for layer in range(self.n_groups):
            x, c = self.block.decode(_layer(p, layer)["b0"], x, _layer(caches, layer)["b0"], policy)
            new.append({"b0": c})
        return x, tree_map(lambda *xs: torch.stack(xs), *new)
