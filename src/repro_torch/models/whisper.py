"""Whisper large-v3's backbone: an encoder stack and a decoder stack.

Counterpart of ``repro.models.whisper``. The audio frontend (mel and two
convolutions) is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, enc_seq, d]. Encoder layer: LayerNorm ->
self-attention without a causal mask -> residual, LayerNorm -> GELU FFN ->
residual. Decoder layer: causal self-attention, cross-attention over the
encoder states, GELU FFN, each behind its LayerNorm. Every matmul is a
FloatSD8 weight site; the head is the tied embedding. Parameter names are
the reference's (``embed/table``, ``pos_dec`` [4096, d], ``pos_enc``
[enc_seq, d], ``enc/...`` and ``dec/...`` stacked over the layers,
``ln_enc``, ``ln_dec``), so ``repro_torch.bridge`` carries a JAX model or
its packed store across unchanged.

Entry points: ``encode``, ``decode_seq`` (teacher-forced logits), ``loss``,
and incremental decoding: ``init_cache``, ``prefill_cross`` (the encoder
once, then every decoder layer's cross-attention K and V into a bf16 cache)
and ``decode_step`` (the self-attention ring buffer, then an f32 softmax
over the cached cross keys in plain torch ops, as the reference). The
serving engine feeds no encoder input, so Whisper is driven through these
(the JAX package's CLI cannot serve it either). Trained through ``loss``
with ``frames`` in the batch; each encoder and decoder layer is then
rematerialised (``nn.transformer.remat``), as the reference checkpoints
its scanned layer bodies.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..core.policy import Policy
from ..device import resolve_device
from ..distributed.sharding import constrain
from ..nn.attention import Attention, KVCache
from ..nn.ffn import FFN
from ..nn.linear import QuantEmbedding
from ..nn.module import stack_init, stack_specs, truncated_normal_init
from ..nn.norms import LayerNorm
from ..nn.transformer import _layer, hoist, remat
from .lm import CACHE_DTYPE, cross_entropy, mask_padded_vocab

__all__ = ["Whisper"]

POS_DEC = 4096  # rows of the decoder's learned position table


@dataclasses.dataclass(frozen=True)
class Whisper:
    cfg: ArchConfig

    def _attn(self, causal: bool) -> Attention:
        c = self.cfg
        return Attention(c.d_model, c.n_heads, c.kv_heads, head_dim=c.hd, causal=causal, rope="none",
                         qkv_bias=c.qkv_bias)

    def _ffn(self) -> FFN:
        return FFN(self.cfg.d_model, self.cfg.d_ff, kind="gelu")

    def _ln(self) -> LayerNorm:
        return LayerNorm(self.cfg.d_model)

    def _embed(self) -> QuantEmbedding:
        return QuantEmbedding(self.cfg.vocab_padded(), self.cfg.d_model)

    def init(self, generator: torch.Generator):
        """Random parameters from ``generator``, on its device."""
        c, ln = self.cfg, self._ln()

        def enc_layer(g):
            return {"ln1": ln.init(g), "attn": self._attn(False).init(g), "ln2": ln.init(g),
                    "ffn": self._ffn().init(g)}

        def dec_layer(g):
            return {"ln1": ln.init(g), "self_attn": self._attn(True).init(g), "ln_x": ln.init(g),
                    "cross_attn": self._attn(False).init(g), "ln2": ln.init(g), "ffn": self._ffn().init(g)}

        return {"embed": self._embed().init(generator),
                "pos_dec": truncated_normal_init(generator, (POS_DEC, c.d_model), 0.01),
                "pos_enc": truncated_normal_init(generator, (c.enc_seq, c.d_model), 0.01),
                "enc": stack_init(enc_layer, c.enc_layers)(generator),
                "dec": stack_init(dec_layer, c.n_layers)(generator),
                "ln_enc": ln.init(generator), "ln_dec": ln.init(generator)}

    def specs(self):
        """The logical-axis tree of ``init``'s parameters (the reference's)."""
        ln, ffn = self._ln().specs(), self._ffn().specs()
        enc = {"ln1": ln, "attn": self._attn(False).specs(), "ln2": ln, "ffn": ffn}
        dec = {"ln1": ln, "self_attn": self._attn(True).specs(), "ln_x": ln,
               "cross_attn": self._attn(False).specs(), "ln2": ln, "ffn": ffn}
        return {"embed": self._embed().specs(), "pos_dec": (None, "act_embed"),
                "pos_enc": (None, "act_embed"), "enc": stack_specs(enc), "dec": stack_specs(dec),
                "ln_enc": ln, "ln_dec": ln}

    def cache_specs(self):
        """The logical-axis tree of ``init_cache``'s state."""
        kv = ("layers", "batch", "seq", "act_kv_heads", None)
        cross = ("layers", "batch", None, "act_kv_heads", None)
        return {"self": KVCache(kv, kv, ("layers",)), "cross_k": cross, "cross_v": cross}

    def hoist(self, p):
        """A served tree with the stacks' small packed leaves (LayerNorm
        scales and biases, q/k/v biases) and both position tables decoded to
        f32 once (``nn.transformer.hoist``); the weight sites and the
        embedding keep their codes. The entry points hoist what they get."""
        return {k: v if k == "embed" else hoist(v, k) for k, v in p.items()}

    def encode(self, p, frames: torch.Tensor, policy: Policy) -> torch.Tensor:
        """frames [B, enc_seq, d] stub embeddings -> encoder states [B,
        enc_seq, d]."""
        p = self.hoist(p)
        ln, attn, ffn = self._ln(), self._attn(False), self._ffn()
        x = frames + p["pos_enc"].to(frames.dtype)[None]

        def layer_fn(lp, x):
            x = x + attn.apply(lp["attn"], ln.apply(lp["ln1"], x), policy)
            return x + ffn.apply(lp["ffn"], ln.apply(lp["ln2"], x), policy)

        for layer in range(self.cfg.enc_layers):
            x = remat(layer_fn, _layer(p["enc"], layer), x)
        return ln.apply(p["ln_enc"], x)

    def decode_seq(self, p, tokens: torch.Tensor, enc_states: torch.Tensor, policy: Policy) -> torch.Tensor:
        """Teacher-forced decoder pass: tokens [B, S] over the encoder states
        -> logits [B, S, vocab padded]. Past 4096 positions the position
        table repeats, as the reference tiles it."""
        p = self.hoist(p)
        ln, sattn, xattn, ffn, emb = self._ln(), self._attn(True), self._attn(False), self._ffn(), self._embed()
        x = emb.apply(p["embed"], tokens, policy)
        s, table = tokens.shape[1], p["pos_dec"]
        if s > table.shape[0]:
            table = table.repeat(-(-s // table.shape[0]), 1)
        x = constrain(x + table[:s].to(x.dtype)[None], ("batch", "seq", "act_embed"))

        def layer_fn(lp, x, enc_states):
            x = x + sattn.apply(lp["self_attn"], ln.apply(lp["ln1"], x), policy)
            x = x + xattn.apply(lp["cross_attn"], ln.apply(lp["ln_x"], x), policy, kv=enc_states)
            return x + ffn.apply(lp["ffn"], ln.apply(lp["ln2"], x), policy)

        for layer in range(self.cfg.n_layers):
            x = remat(layer_fn, _layer(p["dec"], layer), x, enc_states)
        return emb.attend(p["embed"], ln.apply(p["ln_dec"], x), policy)

    def loss(self, p, batch_dict, policy: Policy) -> torch.Tensor:
        """Mean next-token cross entropy of {"frames", "tokens", "labels"
        (, "mask")}, the padded vocab tail masked."""
        enc = self.encode(p, batch_dict["frames"], policy)
        logits = mask_padded_vocab(self.decode_seq(p, batch_dict["tokens"], enc, policy), self.cfg.vocab)
        return cross_entropy(logits, batch_dict["labels"], batch_dict.get("mask"))

    def init_cache(self, batch: int, policy: Policy | None = None, device=None, cache_len: int | None = None):
        """Zero decode state in ``CACHE_DTYPE``: {"self": a KV cache of
        ``cache_len`` positions per decoder layer (leaves [L, B, ...], pos
        [L]), "cross_k", "cross_v": [L, B, enc_seq, Kh, D] each, two
        tensors (the reference hands one zero array to both)}. ``policy``
        is unused."""
        del policy
        if cache_len is None:
            raise ValueError(f"{self.cfg.name}: the decoder's self-attention cache needs cache_len")
        c, dev = self.cfg, resolve_device(device)
        one = KVCache.init(batch, cache_len, c.kv_heads, c.hd, CACHE_DTYPE, dev)
        cross = (c.n_layers, batch, c.enc_seq, c.kv_heads, c.hd)
        return {"self": KVCache(*(t.unsqueeze(0).repeat((c.n_layers,) + (1,) * t.dim()) for t in one)),
                "cross_k": torch.zeros(cross, dtype=CACHE_DTYPE, device=dev),
                "cross_v": torch.zeros(cross, dtype=CACHE_DTYPE, device=dev)}

    def prefill_cross(self, p, frames: torch.Tensor, caches, policy: Policy):
        """The encoder over ``frames``, then each decoder layer's
        cross-attention K and V of its states through wk and wv, cast to the
        cache dtype -> caches with "cross_k" and "cross_v" filled."""
        p = self.hoist(p)
        enc = self.encode(p, frames, policy)
        xattn = self._attn(False)
        kv = [xattn.kv_proj(_layer(p["dec"], layer)["cross_attn"], enc, policy)
              for layer in range(self.cfg.n_layers)]
        return {**caches, "cross_k": torch.stack([k.to(CACHE_DTYPE) for k, _ in kv]),
                "cross_v": torch.stack([v.to(CACHE_DTYPE) for _, v in kv])}

    def decode_step(self, p, tokens: torch.Tensor, caches, policy: Policy):
        """tokens [B, 1] -> (logits [B, 1, vocab padded], new caches): the
        self-attention ring-buffer decode, then attention over the cached
        cross keys and values (every key; q / sqrt(D), f32, as the
        reference), then the FFN, in every layer."""
        p = self.hoist(p)
        c = self.cfg
        ln, sattn, xattn, ffn, emb = self._ln(), self._attn(True), self._attn(False), self._ffn(), self._embed()
        x = emb.apply(p["embed"], tokens, policy)
        table = p["pos_dec"]
        x = x + table[(caches["self"].pos[0] % table.shape[0]).long()].to(x.dtype)
        new_self = []
        for layer in range(c.n_layers):
            lp = _layer(p["dec"], layer)
            h, sc = sattn.decode(lp["self_attn"], ln.apply(lp["ln1"], x), _layer(caches["self"], layer), policy)
            new_self.append(sc)
            x = x + h
            x = x + xattn.cross_decode(lp["cross_attn"], ln.apply(lp["ln_x"], x), caches["cross_k"][layer],
                                       caches["cross_v"][layer], policy)
            x = x + ffn.apply(lp["ffn"], ln.apply(lp["ln2"], x), policy)
        logits = emb.attend(p["embed"], ln.apply(p["ln_dec"], x), policy)
        return logits, {**caches, "self": KVCache(*(torch.stack(t) for t in zip(*new_self)))}
