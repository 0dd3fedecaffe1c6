"""Causal language models of the model zoo, and the loss helpers.

Counterpart of ``repro.models.lm``: ``CausalLM`` for the ``ssm`` family
(RWKV-6) and the ``dense`` family (attention + FFN blocks): embedding ->
stack of blocks -> final norm -> tied head, with the reference's parameter
names (``embed/table``, ``stack/b0/<leaf>`` stacked over the layers,
``final_norm``), so ``repro_torch.bridge`` carries a JAX model or its
packed store across unchanged. The ``moe``, ``hybrid``, ``audio`` and
``vlm`` families raise until they are ported (``ROADMAP.md`` Queue 1 item
8). Inference only (forward, loss, prefill, decode): the zoo's training is
not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..core.policy import Policy
from ..device import resolve_device
from ..nn.attention import Attention
from ..nn.ffn import FFN
from ..nn.linear import QuantEmbedding
from ..nn.norms import LayerNorm, RMSNorm
from ..nn.rwkv import RWKV6ChannelMix, RWKV6TimeMix
from ..nn.transformer import Block, Stack, hoist

__all__ = ["CausalLM", "cross_entropy", "mask_padded_vocab"]


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Set the padded vocab tail of the logits to -1e30."""
    if logits.shape[-1] == vocab:
        return logits
    iota = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(iota >= vocab, torch.full((), -1e30, dtype=logits.dtype,
                                                 device=logits.device), logits)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross entropy with f32 reductions: a max-shifted
    log-sum-exp (the shift carries no gradient) minus the label's logit.
    The reference picks that logit by a one-hot sum; a gather gives the
    same value and gradient."""
    lf = logits.to(torch.float32)
    m = lf.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mk = mask.to(torch.float32)
    return (nll * mk).sum() / torch.clamp(mk.sum(), min=1.0)


#: dtype of the decode cache (the KV cache, the RWKV shift tokens; the wkv
#: state is f32), as the reference's ``CausalLM.cache_dtype`` defaults
CACHE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class CausalLM:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family not in ("ssm", "dense"):
            raise NotImplementedError(
                f"the port's CausalLM builds the ssm (RWKV-6) and dense families; family "
                f"{self.cfg.family!r} ({self.cfg.name}) is still to port (ROADMAP.md Queue 1 item 8)")

    def _block(self) -> Block:
        """The stack's one block (the reference's one-block period)."""
        c = self.cfg
        if c.family == "dense":
            attn = Attention(c.d_model, c.n_heads, c.kv_heads, head_dim=c.hd, window=c.window, rope=c.rope,
                             rope_theta=c.rope_theta, qkv_bias=c.qkv_bias)
            return Block(c.d_model, attn=attn, ffn_mod=FFN(c.d_model, c.d_ff, kind=c.ffn_kind),
                         norm=c.norm)
        return Block(c.d_model, rwkv_mod=RWKV6TimeMix(c.d_model, c.rwkv_head_dim),
                     cmix_mod=RWKV6ChannelMix(c.d_model, c.d_ff), norm=c.norm)

    def _stack(self) -> Stack:
        return Stack(self._block(), self.cfg.n_layers)

    def _embed(self) -> QuantEmbedding:
        return QuantEmbedding(self.cfg.vocab_padded(), self.cfg.d_model)

    def _final_norm(self):
        d = self.cfg.d_model
        return RMSNorm(d) if self.cfg.norm == "rmsnorm" else LayerNorm(d)

    def init(self, generator: torch.Generator):
        """Random parameters from ``generator``, on its device."""
        return {"embed": self._embed().init(generator), "stack": self._stack().init(generator),
                "final_norm": self._final_norm().init(generator)}

    def hoist(self, p):
        """A served tree with the stack's small packed leaves decoded to f32
        once (``nn.transformer.hoist``); the weight sites and the embedding
        keep their codes. The entry points hoist what they are given, so a
        tree hoisted once is decoded no more at each call."""
        return {**p, "stack": hoist(p["stack"])}

    def forward(self, p, batch_dict, policy: Policy):
        """Full-sequence forward of {"tokens" [B, S]} -> (logits [B, S,
        vocab padded], aux = 0: the family has no auxiliary loss)."""
        p = self.hoist(p)
        emb = self._embed()
        x = emb.apply(p["embed"], batch_dict["tokens"], policy)
        x = self._stack().apply(p["stack"], x, policy)
        x = self._final_norm().apply(p["final_norm"], x)
        return emb.attend(p["embed"], x, policy), torch.zeros((), device=x.device)

    def loss(self, p, batch_dict, policy: Policy) -> torch.Tensor:
        """Mean next-token cross entropy, the padded vocab tail masked."""
        logits, aux = self.forward(p, batch_dict, policy)
        logits = mask_padded_vocab(logits, self.cfg.vocab)
        return cross_entropy(logits, batch_dict["labels"], batch_dict.get("mask")) + 0.01 * aux

    def prefill(self, p, batch_dict, policy: Policy) -> torch.Tensor:
        """The teacher-forced pass over a whole prompt: its logits."""
        return self.forward(p, batch_dict, policy)[0]

    def init_cache(self, batch: int, policy: Policy | None = None, device=None,
                   cache_len: int | None = None):
        """Zero decode state, layer-major: per layer a KV cache of
        min(cache_len, window) positions in ``CACHE_DTYPE`` (dense; the
        reference's ``s_max``), or the [B, H, K, V] f32 wkv state and the
        two shift tokens in ``CACHE_DTYPE`` (ssm; ``cache_len`` unused).
        ``policy`` is unused (the serving pool passes it to every model)."""
        del policy
        if self.cfg.family == "dense" and cache_len is None:
            raise ValueError(f"{self.cfg.name}: an attention model's cache needs cache_len")
        return {"stack": self._stack().init_cache(batch, cache_len, CACHE_DTYPE,
                                                  resolve_device(device))}

    def decode_step(self, p, tokens: torch.Tensor, caches, policy: Policy):
        """tokens [B, 1] -> (logits [B, 1, vocab padded], new caches)."""
        p = self.hoist(p)
        emb = self._embed()
        x = emb.apply(p["embed"], tokens, policy)
        x, stack = self._stack().decode(p["stack"], x, caches["stack"], policy)
        x = self._final_norm().apply(p["final_norm"], x)
        return emb.attend(p["embed"], x, policy), {**caches, "stack": stack}
