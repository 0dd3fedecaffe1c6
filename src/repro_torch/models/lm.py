"""Causal language models of the model zoo, and the loss helpers.

Counterpart of ``repro.models.lm``: ``CausalLM`` for the ``ssm`` family
(RWKV-6), the ``dense`` family (attention + FFN blocks), the ``moe`` family
(attention + MoE blocks, after ``first_k_dense`` leading dense layers),
the ``hybrid`` family (Jamba's period of ``attn_every`` sub-layers: Mamba
mixers with attention at sub-layer attn_every/2 - 1, an MoE MLP on every
``moe_every``-th) and the ``vlm`` family (Qwen2-VL's decoder: dense blocks
under M-RoPE, with ``n_patches`` stub patch embeddings that replace the
first embeddings through the [d, d] ``patch_proj``): embedding -> leading
dense blocks -> stack of periods -> final norm -> tied head, with the
reference's parameter names (``embed/table``, ``head_block{i}/<leaf>``,
``stack/b{i}/<leaf>`` stacked over the groups, ``final_norm``,
``patch_proj/w``), so ``repro_torch.bridge`` carries a JAX model or its
packed store across unchanged. The ``audio`` family is ``Whisper``
(``models/whisper.py``). Entry points: forward, loss (trained through
``optim.make_train_step``, every family; the stack rematerialises its
groups), prefill and decode. Under tensor parallelism (the dense family on
a "model" axis above one) the logits are this rank's vocab columns and the
loss reduces over "model" (``cross_entropy``).

A vlm prefill with patches attends as the reference does on its M-RoPE t
ids: the patches see one another whole, text sees every patch and the text
before it; ``dispatch.flash_attention`` takes that as its causal
``prefix`` = ``n_patches``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..core import floatsd
from ..core.policy import Policy
from ..device import resolve_device
from ..distributed import sharding as shd
from ..distributed.sharding import constrain
from ..kernels import dispatch as kd
from ..kernels.floatsd_matmul.ref import no_tf32
from ..nn.attention import Attention
from ..nn.ffn import FFN
from ..nn.linear import QuantEmbedding
from ..nn.mamba import Mamba
from ..nn.module import truncated_normal_init
from ..nn.moe import MoE
from ..nn.norms import LayerNorm, RMSNorm
from ..nn.rwkv import RWKV6ChannelMix, RWKV6TimeMix
from ..nn.transformer import Block, Stack, hoist

__all__ = ["CausalLM", "FAMILIES", "cross_entropy", "mask_padded_vocab"]


def _vocab_offset(logits: torch.Tensor, vocab_pieces: bool) -> int:
    """The first vocab column of ``logits``: this rank's piece's under
    tensor parallelism, else 0."""
    return shd.model_rank() * logits.shape[-1] if vocab_pieces else 0


def mask_padded_vocab(logits: torch.Tensor, vocab: int, vocab_pieces: bool = False) -> torch.Tensor:
    """Set the padded vocab tail of the logits to -1e30. ``vocab_pieces``:
    the logits are this rank's vocab columns (tensor parallelism)."""
    if logits.shape[-1] == vocab and not vocab_pieces:
        return logits
    iota = torch.arange(logits.shape[-1], device=logits.device) + _vocab_offset(logits, vocab_pieces)
    return torch.where(iota >= vocab, torch.full((), -1e30, dtype=logits.dtype,
                                                 device=logits.device), logits)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, vocab_pieces: bool = False) -> torch.Tensor:
    """Mean token cross entropy with f32 reductions: a max-shifted
    log-sum-exp (the shift carries no gradient) minus the label's logit.
    The reference picks that logit by a one-hot sum; a gather gives the
    same value and gradient.

    Under a mesh (``distributed.sharding``) the rows are this rank's share
    of the batch and the result is its share of the global mean: the mean
    over its rows over the number of shares, or its masked sum over the
    mask's global sum (one all-reduce), so the shares sum to the global
    mean. With ``vocab_pieces`` the logits are this rank's vocab columns:
    the row max is reduced by max over "model", the sum of exponentials
    and the label's logit (from the rank that holds it) by sum."""
    lf = logits.to(torch.float32)
    m = lf.max(dim=-1, keepdim=True).values.detach()
    if vocab_pieces:
        m = shd.all_reduce(m, ("model",), op="max")
        se = shd.reduce_from_model(torch.exp(lf - m).sum(dim=-1))
        local = labels.long() - _vocab_offset(lf, True)
        inside = (local >= 0) & (local < lf.shape[-1])
        ll = lf.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
        ll = shd.reduce_from_model(torch.where(inside, ll, 0.0))
        lse = torch.log(se) + m[..., 0]
    else:
        lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
        ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean() / shd.batch_ranks()
    mk = mask.to(torch.float32)
    count = mk.sum()
    if shd.active_mesh() is not None:
        count = shd.all_reduce(count, shd.batch_axes())
    return (nll * mk).sum() / torch.clamp(count, min=1.0)


#: dtype of the decode cache (the KV cache, the RWKV shift tokens; the wkv
#: state is f32), as the reference's ``CausalLM.cache_dtype`` defaults
CACHE_DTYPE = torch.bfloat16


#: the families ``CausalLM`` builds
FAMILIES = ("ssm", "dense", "moe", "hybrid", "vlm")


@dataclasses.dataclass(frozen=True)
class CausalLM:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise ValueError(
                f"CausalLM builds the {', '.join(FAMILIES)} families, not {self.cfg.family!r} "
                f"({self.cfg.name}): models.build gives each family its model")

    def _attn(self) -> Attention:
        c = self.cfg
        return Attention(c.d_model, c.n_heads, c.kv_heads, head_dim=c.hd, window=c.window, rope=c.rope,
                         rope_theta=c.rope_theta, mrope_sections=c.mrope_sections, qkv_bias=c.qkv_bias)

    def _ffn(self, hidden: int | None = None) -> FFN:
        c = self.cfg
        return FFN(c.d_model, hidden or c.d_ff, kind=c.ffn_kind)

    def _moe(self) -> MoE:
        c = self.cfg
        return MoE(c.d_model, c.d_ff, c.n_experts, c.top_k)

    def _period(self) -> tuple:
        """The blocks of one stack group, as the reference's ``_period``."""
        c = self.cfg
        if c.family in ("dense", "vlm"):
            return (Block(c.d_model, attn=self._attn(), ffn_mod=self._ffn(), norm=c.norm),)
        if c.family == "moe":
            return (Block(c.d_model, attn=self._attn(), moe_mod=self._moe(), norm=c.norm),)
        if c.family == "hybrid":
            return tuple(
                Block(c.d_model, norm=c.norm,
                      **({"attn": self._attn()} if i == c.attn_every // 2 - 1
                         else {"mamba_mod": Mamba(c.d_model, d_state=c.mamba_state)}),
                      **({"moe_mod": self._moe()} if i % c.moe_every == c.moe_every - 1
                         else {"ffn_mod": self._ffn()}))
                for i in range(c.attn_every))
        return (Block(c.d_model, rwkv_mod=RWKV6TimeMix(c.d_model, c.rwkv_head_dim),
                      cmix_mod=RWKV6ChannelMix(c.d_model, c.d_ff), norm=c.norm),)

    def _block(self) -> Block:
        """The period's first block (a one-block family's only one)."""
        return self._period()[0]

    def _stack(self) -> Stack:
        period = self._period()
        body = self.cfg.n_layers - self.cfg.first_k_dense
        if body % len(period):
            raise ValueError(f"{self.cfg.name}: {body} stacked layers are not whole periods of {len(period)}")
        return Stack(period, body // len(period))

    def _head_blocks(self) -> tuple:
        """The leading dense layers, unstacked (kimi's ``first_k_dense``)."""
        c = self.cfg
        return tuple(Block(c.d_model, attn=self._attn(), ffn_mod=self._ffn(c.first_dense_ff or c.d_ff),
                           norm=c.norm) for _ in range(c.first_k_dense))

    def _embed(self) -> QuantEmbedding:
        return QuantEmbedding(self.cfg.vocab_padded(), self.cfg.d_model)

    def _final_norm(self):
        d = self.cfg.d_model
        return RMSNorm(d) if self.cfg.norm == "rmsnorm" else LayerNorm(d)

    def init(self, generator: torch.Generator, each=None):
        """Random parameters from ``generator``, on its device: the
        embedding, the stack, the final norm, the leading dense blocks.
        ``each``, where given, takes each of those parts as soon as it is
        drawn, and each of the stack's blocks group by group (``Stack.init``),
        and returns what the tree keeps (``WeightStore.pack_streamed`` packs
        them), so at most one block is live in f32. A vlm gets its [d, d]
        ``patch_proj``."""
        keep = each or (lambda tree: tree)
        p = {"embed": keep(self._embed().init(generator)),
             "stack": self._stack().init(generator, each),
             "final_norm": keep(self._final_norm().init(generator))}
        for i, hb in enumerate(self._head_blocks()):
            p[f"head_block{i}"] = keep(hb.init(generator))
        if self.cfg.n_patches:
            d = self.cfg.d_model
            p["patch_proj"] = keep({"w": truncated_normal_init(generator, (d, d), 0.02)})
        return p

    def specs(self):
        """The logical-axis tree of ``init``'s parameters (the reference's)."""
        s = {"embed": self._embed().specs(), "stack": self._stack().specs(),
             "final_norm": self._final_norm().specs()}
        for i, hb in enumerate(self._head_blocks()):
            s[f"head_block{i}"] = hb.specs()
        if self.cfg.n_patches:
            s["patch_proj"] = {"w": ("embed", "embed2")}
        return s

    def cache_specs(self):
        """The logical-axis tree of ``init_cache``'s state."""
        s = {"stack": self._stack().cache_specs()}
        for i, hb in enumerate(self._head_blocks()):
            s[f"head_block{i}"] = hb.cache_specs()
        return s

    def hoist(self, p):
        """A served tree with the small packed leaves of the stack and the
        leading blocks decoded to f32 once (``nn.transformer.hoist``), and
        the vlm's ``patch_proj`` too (a dense product outside any kernel,
        as in the reference); the weight sites and the embedding keep their
        codes. The entry points hoist what they are given, so a tree
        hoisted once is decoded no more at each call."""
        out = {k: v if k in ("embed", "final_norm") else hoist(v) for k, v in p.items()}
        w = out.get("patch_proj", {}).get("w")
        if kd.is_packed(w):
            out["patch_proj"] = {"w": floatsd.decode(w.codes, w.bias)}
        elif kd.is_packed4(w):
            out["patch_proj"] = {"w": kd.unpack4(w)}
        return out

    def _positions(self, batch_dict, b: int, s: int, device):
        """(rotary positions, the attention's causal prefix), as the
        reference's ``_positions``: [B, S] ids 0, 1, ...; under M-RoPE [B,
        S, 3] (t, h, w) ids, with patches at t = 0 on a side x side grid (side
        = floor(sqrt(n_patches))) and text from t = h = w = side on; the
        prefix is the patches, which see one another whole."""
        base = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
        if self.cfg.rope != "mrope":
            return base, 0
        npat = self.cfg.n_patches if "patch_embeds" in batch_dict else 0
        side = max(1, int(npat ** 0.5))
        patch = base < npat
        text = base - npat + side
        t = torch.where(patch, 0, text)
        h = torch.where(patch, (base % max(npat, 1)) // side, text)
        w = torch.where(patch, base % side, text)
        return torch.stack([t, h, w], dim=-1), npat

    def _embed_inputs(self, p, batch_dict, policy: Policy) -> torch.Tensor:
        """The token embeddings, with the first ``n_patches`` replaced by
        ``patch_embeds`` [B, n_patches, d] @ ``patch_proj/w`` (f32, TF32
        off) where they are given."""
        c = self.cfg
        tokens = batch_dict["tokens"]
        x = self._embed().apply(p["embed"], tokens, policy)
        if c.n_patches and "patch_embeds" in batch_dict:
            pe = batch_dict["patch_embeds"]
            if pe.shape[1] != c.n_patches or tokens.shape[1] < c.n_patches:
                raise ValueError(f"{c.name}: {c.n_patches} patch embeddings go first in the sequence; got "
                                 f"{pe.shape[1]} of them for {tokens.shape[1]} positions")
            with no_tf32():
                pe = torch.matmul(pe.to(x.dtype), p["patch_proj"]["w"].to(x.dtype))
            x = torch.cat([pe, x[:, c.n_patches:]], dim=1)
        return x

    def forward(self, p, batch_dict, policy: Policy):
        """Full-sequence forward of {"tokens" [B, S]} (a vlm's optionally
        with "patch_embeds" [B, n_patches, d]) -> (logits [B, S, vocab
        padded], aux: the MoE layers' summed load-balancing loss, 0 for the
        families without)."""
        with shd.tp_scope(self.cfg.family):
            shd.check_tp()
            return self._forward(self.hoist(p), batch_dict, policy)

    def _forward(self, p, batch_dict, policy: Policy):
        emb = self._embed()
        x = constrain(self._embed_inputs(p, batch_dict, policy), ("batch", "seq", "act_embed"))
        pos, prefix = self._positions(batch_dict, *x.shape[:2], x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, hb in enumerate(self._head_blocks()):
            x, a = hb.apply(p[f"head_block{i}"], x, policy, pos, prefix)
            aux = aux + a
        x, a = self._stack().apply(p["stack"], x, policy, pos, prefix)
        x = self._final_norm().apply(p["final_norm"], x)
        return constrain(emb.attend(p["embed"], x, policy), ("batch", "seq", "vocab")), aux + a

    def loss(self, p, batch_dict, policy: Policy) -> torch.Tensor:
        """Mean next-token cross entropy, the padded vocab tail masked, plus
        0.01 x aux."""
        logits, aux = self.forward(p, batch_dict, policy)
        with shd.tp_scope(self.cfg.family):
            pieces = self._embed().tp()
        logits = mask_padded_vocab(logits, self.cfg.vocab, pieces)
        return cross_entropy(logits, batch_dict["labels"], batch_dict.get("mask"), pieces) + 0.01 * aux

    def prefill(self, p, batch_dict, policy: Policy) -> torch.Tensor:
        """The teacher-forced pass over a whole prompt: its logits."""
        return self.forward(p, batch_dict, policy)[0]

    def init_cache(self, batch: int, policy: Policy | None = None, device=None,
                   cache_len: int | None = None):
        """Zero decode state, group-major in the stack: per attention layer
        a KV cache of min(cache_len, window) positions in ``CACHE_DTYPE``
        (the reference's ``s_max``), per Mamba layer the f32 state and the
        convolution window in ``CACHE_DTYPE``, per RWKV layer the [B, H, K,
        V] f32 wkv state and the two shift tokens in ``CACHE_DTYPE``;
        the leading dense blocks' caches are lane-major. ``policy`` is
        unused (the serving pool passes it to every model)."""
        del policy
        if self.cfg.family != "ssm" and cache_len is None:
            raise ValueError(f"{self.cfg.name}: an attention model's cache needs cache_len")
        dev = resolve_device(device)
        caches = {"stack": self._stack().init_cache(batch, cache_len, CACHE_DTYPE, dev)}
        for i, hb in enumerate(self._head_blocks()):
            caches[f"head_block{i}"] = hb.init_cache(batch, cache_len, CACHE_DTYPE, dev)
        return caches

    def decode_step(self, p, tokens: torch.Tensor, caches, policy: Policy):
        """tokens [B, 1] -> (logits [B, 1, vocab padded], new caches)."""
        with shd.tp_scope(self.cfg.family):
            shd.check_tp()
            return self._decode_step(self.hoist(p), tokens, caches, policy)

    def _decode_step(self, p, tokens: torch.Tensor, caches, policy: Policy):
        emb = self._embed()
        x = emb.apply(p["embed"], tokens, policy)
        new = dict(caches)
        for i, hb in enumerate(self._head_blocks()):
            x, new[f"head_block{i}"] = hb.decode(p[f"head_block{i}"], x, caches[f"head_block{i}"], policy)
        x, new["stack"] = self._stack().decode(p["stack"], x, caches["stack"], policy)
        x = self._final_norm().apply(p["final_norm"], x)
        return emb.attend(p["embed"], x, policy), new
