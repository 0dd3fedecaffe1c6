"""Residual blocks and the stack over layers.

Counterpart of ``repro.nn.transformer``: a ``Block`` is norm -> mixer ->
residual, norm -> MLP -> residual, with the reference's mixers (``attn``:
GQA attention; ``mamba``: the S6 mixer; ``rwkv``: the RWKV-6 time mix) and
MLPs (``ffn``; ``moe``: the mixture of experts, whose load-balancing loss
``apply`` returns beside x; ``none``: the RWKV block's own channel mix). A
``Stack`` holds ``n_groups`` copies of a period of blocks under the keys
``b0`` .. ``b{P-1}`` (the dense, MoE and RWKV families: one block; Jamba's
hybrid: 8), with every parameter leaf stacked on a leading group axis, as
the reference's scanned stack has them, and loops over the groups.

Trained (grad on and an input requiring it), each group runs under
``torch.utils.checkpoint`` (``remat``): its activations are recomputed in
the backward, as the reference's scanned stack rematerialises its body
(``jax.checkpoint``). The reference keeps the body's matmul outputs (its
``dots`` policy); the port recomputes the whole group, the same values
(a recorded deviation, ``ROADMAP.md`` Queue 3), and the recompute's
kernel launches are counted like any other.

A served stack's leaves are FloatSD8 ``PackedTensor``s with one bias per
stacked leaf, or FloatSD4 ``PackedTensor4``s nibble-packed and grouped
along the layer axis, as the reference's store packs every leaf along its
axis 0. ``hoist`` decodes the small ones (everything but the weight sites)
to f32 once, for all layers; layer ``l`` then gets ``codes[l]`` with that
bias at each FloatSD8 weight site, or the ``LayerTensor4`` view
(``codes[l >> 1]``, ``exps[l >> 5]``, nibble ``l & 1``) at each FloatSD4
one, which runs the matmul kernel on the slice or the planes (an MoE's [E,
d, h] codes: once per expert).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from .._tree import tree_leaves, tree_map
from ..core import floatsd
from ..core.policy import Policy
from ..distributed import sharding as shd
from ..distributed.sharding import constrain
from ..kernels import dispatch as kd
from .attention import Attention, KVCache
from .ffn import FFN
from .mamba import Mamba, MambaCache
from .module import stack_init, stack_specs
from .moe import MoE
from .norms import LayerNorm, RMSNorm
from .rwkv import WEIGHT_SITES as RWKV_SITES
from .rwkv import RWKV6ChannelMix, RWKV6TimeMix, RWKVState

__all__ = ["Block", "Stack", "hoist", "remat", "WEIGHT_SITES"]

#: the leaf names a matmul reads: the RWKV mixes' projections, Mamba's four
#: projections, the experts' wi, wg and wo, and the weight ``w`` of every
#: ``QuantDense`` (attention's q, k, v, o and the FFN's); their biases ``b``,
#: like every other leaf (the router, Mamba's convolution, dt bias, a_log
#: and d), are small
WEIGHT_SITES = RWKV_SITES | {"w", "in_proj", "x_proj", "dt_proj", "out_proj", "wi", "wg", "wo"}


def _norm(kind: str, dim: int):
    return RMSNorm(dim) if kind == "rmsnorm" else LayerNorm(dim)


def hoist(tree, name: str = ""):
    """A stacked block tree with every packed leaf (FloatSD8 or FloatSD4)
    that is not a weight site decoded to f32, all layers at once, exactly:
    norm scales and biases, projection biases, the RWKV token-shift mixes,
    decay base and LoRA, bonus and output-norm scale (46.5 MB of f32 at
    rwkv6_3b's full width), the MoE router and Mamba's convolution, dt
    bias, a_log and d. The weight sites keep their codes for the matmul
    kernel. A decoded tree passes through unchanged."""
    if isinstance(tree, dict):
        return {k: hoist(v, k) for k, v in tree.items()}
    if name in WEIGHT_SITES:
        return tree
    if kd.is_packed(tree):
        return floatsd.decode(tree.codes, tree.bias)
    if kd.is_packed4(tree):
        return kd.unpack4(tree)
    return tree


def remat(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    grad is on and a tensor among ``args`` (nested in dicts, tuples and
    lists) requires it: the backward recomputes ``fn`` instead of keeping
    its activations. Otherwise a plain call. The recompute runs under the
    mesh active at the forward (``sharding.bind``): on the card autograd
    runs it on its device thread."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(args)):
        return torch.utils.checkpoint.checkpoint(shd.bind(fn), *args, use_reentrant=False)
    return fn(*args)


def _layer_of(x, l: int):
    if kd.is_packed(x):
        return kd.PackedTensor(x.codes[l], x.bias)
    if kd.is_packed4(x):
        return kd.layer_view4(x, l)
    return x[l]


def _layer(tree, l: int):
    """Layer ``l`` of a stacked parameter (or cache) tree: ``x[l]`` of every
    tensor, ``PackedTensor(codes[l], bias)`` of every FloatSD8 leaf, the
    ``LayerTensor4`` planes of every FloatSD4 one."""
    return tree_map(lambda x: _layer_of(x, l), tree, is_leaf=kd.is_any_packed)


_MIXERS = (("attn", "attn"), ("mamba", "mamba_mod"), ("rwkv", "rwkv_mod"))
_MLPS = (("ffn", "ffn_mod"), ("moe", "moe_mod"), ("none", "cmix_mod"))


@dataclasses.dataclass(frozen=True)
class Block:
    """One residual block, read from the modules it is given: a mixer
    (``attn``, ``mamba_mod`` or ``rwkv_mod``: the reference's ``mixer``
    attn, mamba, rwkv) and its MLP (``ffn_mod`` or ``moe_mod`` after
    attention or Mamba; ``cmix_mod``, the channel mix, after the RWKV time
    mix: the reference's ``mlp`` ffn, moe, none)."""

    dim: int
    attn: Attention | None = None
    ffn_mod: FFN | None = None
    rwkv_mod: RWKV6TimeMix | None = None
    cmix_mod: RWKV6ChannelMix | None = None
    mamba_mod: Mamba | None = None
    moe_mod: MoE | None = None
    norm: str = "rmsnorm"

    def __post_init__(self):
        mixers = [m for m, f in _MIXERS if getattr(self, f) is not None]
        mlps = [m for m, f in _MLPS if getattr(self, f) is not None]
        if len(mixers) != 1 or len(mlps) != 1 or (mixers[0] == "rwkv") != (mlps[0] == "none"):
            raise ValueError("a Block takes attn and ffn_mod, or rwkv_mod and cmix_mod, or mamba_mod "
                             "in place of attn, or moe_mod in place of ffn_mod")

    @property
    def mixer(self) -> str:
        return next(m for m, f in _MIXERS if getattr(self, f) is not None)

    @property
    def mlp(self) -> str:
        return next(m for m, f in _MLPS if getattr(self, f) is not None)

    def _mixer_mod(self):
        return getattr(self, dict(_MIXERS)[self.mixer])

    def _mlp_mod(self):
        return getattr(self, dict(_MLPS)[self.mlp])

    def init(self, generator: torch.Generator):
        n = _norm(self.norm, self.dim)
        return {"norm1": n.init(generator), "mixer": self._mixer_mod().init(generator),
                "norm2": n.init(generator), "mlp": self._mlp_mod().init(generator)}

    def specs(self):
        n = _norm(self.norm, self.dim).specs()
        return {"norm1": n, "mixer": self._mixer_mod().specs(), "norm2": n, "mlp": self._mlp_mod().specs()}

    def apply(self, p, x: torch.Tensor, policy: Policy, positions=None, prefix: int = 0):
        """Full-sequence path (forward / prefill): x [B, S, d] -> (x, the
        MoE's load-balancing loss, or 0). ``positions`` and the causal
        ``prefix`` reach attention (``Attention.apply``) only."""
        n = _norm(self.norm, self.dim)
        h = n.apply(p["norm1"], x)
        if self.mixer == "rwkv":
            mix, _ = self.rwkv_mod.apply(p["mixer"], h, policy)
        elif self.mixer == "attn":
            mix = self.attn.apply(p["mixer"], h, policy, positions=positions, prefix=prefix)
        else:
            mix = self.mamba_mod.apply(p["mixer"], h, policy)
        x = constrain(x + mix, ("batch", "seq", "act_embed"))
        h2 = n.apply(p["norm2"], x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.mlp == "moe":
            y, aux = self.moe_mod.apply(p["mlp"], h2, policy)
        elif self.mlp == "ffn":
            y = self.ffn_mod.apply(p["mlp"], h2, policy)
        else:
            y, _ = self.cmix_mod.apply(p["mlp"], h2, policy)
        return constrain(x + y, ("batch", "seq", "act_embed")), aux

    def init_cache(self, batch: int, s_max: int | None, dtype, device):
        """Zero decode state: a KV cache of min(s_max, window) slots, the
        Mamba state (f32) and convolution window (``dtype``), or the RWKV
        state (s_max unused by the last two)."""
        if self.mixer == "attn":
            a = self.attn
            return KVCache.init(batch, min(s_max, a.window or s_max), a.kv_heads, a.hd, dtype, device)
        if self.mixer == "mamba":
            m = self.mamba_mod
            return MambaCache(
                torch.zeros((batch, m.d_inner, m.d_state), dtype=torch.float32, device=device),
                torch.zeros((batch, m.d_conv - 1, m.d_inner), dtype=dtype, device=device),
            )
        r = self.rwkv_mod
        return RWKVState(
            torch.zeros((batch, r.heads, r.head_dim, r.head_dim), dtype=torch.float32, device=device),
            torch.zeros((batch, self.dim), dtype=dtype, device=device),
            torch.zeros((batch, self.dim), dtype=dtype, device=device),
        )

    def cache_specs(self):
        """Logical-axis tuples mirroring ``init_cache``."""
        if self.mixer == "attn":
            kv = ("batch", "seq", "act_kv_heads", None)
            return KVCache(kv, kv, ())
        if self.mixer == "mamba":
            return MambaCache(("batch", "act_mlp", None), ("batch", None, "act_mlp"))
        return RWKVState(("batch", "act_heads", None, None), ("batch", None), ("batch", None))

    def decode(self, p, x: torch.Tensor, cache, policy: Policy):
        """One token: x [B, 1, d] -> (x, new cache)."""
        n = _norm(self.norm, self.dim)
        h = n.apply(p["norm1"], x)
        if self.mixer == "rwkv":
            mix, (s_new, x_tm) = self.rwkv_mod.apply(p["mixer"], h, policy, state=cache)
            x = x + mix
            y, x_cm = self.cmix_mod.apply(p["mlp"], n.apply(p["norm2"], x), policy, cache.x_cm)
            return x + y, RWKVState(s_new, x_tm, x_cm)
        if self.mixer == "attn":
            mix, cache = self.attn.decode(p["mixer"], h, cache, policy)
        else:
            mix, cache = self.mamba_mod.decode(p["mixer"], h, cache, policy)
        x = x + mix
        h2 = n.apply(p["norm2"], x)
        y = self.moe_mod.apply(p["mlp"], h2, policy)[0] if self.mlp == "moe" else self.ffn_mod.apply(
            p["mlp"], h2, policy)
        return x + y, cache


@dataclasses.dataclass(frozen=True)
class Stack:
    """``n_groups`` copies of a period of ``blocks``, every leaf stacked on
    axis 0 under the keys ``b0`` .. ``b{P-1}``. Parameters are ``hoist``ed
    (a served tree's small leaves decoded)."""

    blocks: tuple
    n_groups: int

    def init(self, generator: torch.Generator, each=None):
        """Random parameters, group by group, each group's blocks in order.
        ``each``, where given, takes each block's tree as soon as it is
        drawn, ``each(tree, (f"b{i}", group, n_groups))``, and returns what
        the stack keeps under ``b{i}`` (after the last group, its stacked
        packed codes: ``WeightStore.pack_streamed``), so at most one block
        is live in f32. The same draws in the same order either way."""
        def group(g):
            return {f"b{i}": b.init(g) for i, b in enumerate(self.blocks)}

        if each is None:
            return stack_init(group, self.n_groups)(generator)
        out = {}
        for g in range(self.n_groups):
            for i, b in enumerate(self.blocks):
                out[f"b{i}"] = each(b.init(generator), (f"b{i}", g, self.n_groups))
        return out

    def specs(self):
        return stack_specs({f"b{i}": b.specs() for i, b in enumerate(self.blocks)})

    def cache_specs(self):
        return stack_specs({f"b{i}": b.cache_specs() for i, b in enumerate(self.blocks)})

    def apply(self, p, x: torch.Tensor, policy: Policy, positions=None, prefix: int = 0):
        """x [B, S, d] -> (x, the summed load-balancing loss). Trained, each
        group is rematerialised (``remat``)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in range(self.n_groups):
            x, aux = remat(self._group, _layer(p, layer), x, aux, policy, positions, prefix)
        return x, aux

    def _group(self, lp, x: torch.Tensor, aux: torch.Tensor, policy: Policy, positions, prefix: int):
        """One group's blocks in order, each's loss added to ``aux``."""
        for i, b in enumerate(self.blocks):
            x, a = b.apply(lp[f"b{i}"], x, policy, positions, prefix)
            aux = aux + a
        return x, aux

    def init_cache(self, batch: int, s_max: int | None, dtype, device):
        one = {f"b{i}": b.init_cache(batch, s_max, dtype, device) for i, b in enumerate(self.blocks)}
        return tree_map(lambda c: c.unsqueeze(0).repeat((self.n_groups,) + (1,) * c.dim()), one)

    def decode(self, p, x: torch.Tensor, caches, policy: Policy):
        """One step of every layer; the caches are group-major ([n_groups,
        B, ...] per leaf), as the reference's scanned stack keeps them."""
        new = []
        for layer in range(self.n_groups):
            lp, lc = _layer(p, layer), _layer(caches, layer)
            c = {}
            for i, b in enumerate(self.blocks):
                x, c[f"b{i}"] = b.decode(lp[f"b{i}"], x, lc[f"b{i}"], policy)
            new.append(c)
        return x, tree_map(lambda *xs: torch.stack(xs), *new)
