"""The paper's four LSTM models (§IV-A, Table III).

  UDPOS     : embed -> 2-layer BiLSTM -> FC tagger          (Adam)
  SNLI      : embed -> FC proj -> 1-layer BiLSTM -> 4 x FC  (Adam)
  Multi30K  : enc(embed + LSTM) -> dec(embed + LSTM + FC)   (Adam)
  WikiText-2: embed -> 2-layer LSTM -> tied FC decoder      (SGD)

Counterparts of ``repro.models.lstm_models``, with the reference's
parameter names (``embed/table``, ``bilstm1/fwd/wx``, ``lstm<i>/wh``,
``fc1/w`` ...), so ``repro_torch.bridge`` carries a JAX model across
unchanged. Every LSTM trains through the fused quantized BPTT under the
train step's policy, or through autodiff under the FP32 baseline; the
dense sites (the heads, SNLI's projection and classifier) are
``QuantDense`` einsums. The packed serving tree of the LM has
``PackedTensor`` leaves at every weight site.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.policy import Policy
from ..nn.linear import QuantDense, QuantEmbedding
from ..nn.lstm import BiLSTM, LSTMLayer, LSTMState
from .lm import cross_entropy, mask_padded_vocab

__all__ = ["UDPOSTagger", "SNLIClassifier", "Multi30KSeq2Seq", "WikiText2LM"]


@dataclasses.dataclass(frozen=True)
class UDPOSTagger:
    vocab: int = 8000
    n_tags: int = 18
    emb: int = 100
    hidden: int = 128

    def _mods(self):
        return (QuantEmbedding(self.vocab, self.emb), BiLSTM(self.emb, self.hidden),
                BiLSTM(2 * self.hidden, self.hidden), QuantDense(2 * self.hidden, self.n_tags))

    def init(self, generator: torch.Generator):
        emb, l1, l2, out = self._mods()
        return {"embed": emb.init(generator), "bilstm1": l1.init(generator),
                "bilstm2": l2.init(generator), "out": out.init(generator)}

    def specs(self):
        emb, l1, l2, out = self._mods()
        return {"embed": emb.specs(), "bilstm1": l1.specs(), "bilstm2": l2.specs(), "out": out.specs()}

    def logits(self, p, tokens: torch.Tensor, policy: Policy) -> torch.Tensor:
        emb, l1, l2, out = self._mods()
        x = emb.apply(p["embed"], tokens, policy)
        x = l1.apply(p["bilstm1"], x, policy)
        x = l2.apply(p["bilstm2"], x, policy)
        return out.apply(p["out"], x, policy, site="last")

    def loss(self, p, batch, policy: Policy) -> torch.Tensor:
        return cross_entropy(self.logits(p, batch["tokens"], policy), batch["labels"],
                             batch.get("mask"))

    def accuracy(self, p, batch, policy: Policy) -> torch.Tensor:
        pred = torch.argmax(self.logits(p, batch["tokens"], policy), -1)
        m = batch.get("mask", torch.ones_like(batch["labels"])).to(torch.float32)
        return torch.sum((pred == batch["labels"]) * m) / torch.clamp(torch.sum(m), min=1.0)


class _Abs(torch.autograd.Function):
    """|x| whose gradient at 0 is +1, as JAX's abs has it (``select(x >= 0,
    g, -g)``); torch.abs gives 0 there. SNLI's |u - v| is 0 wherever the
    two max-pooled FP8-grid h values tie, which is often."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


@dataclasses.dataclass(frozen=True)
class SNLIClassifier:
    vocab: int = 20000
    emb: int = 300
    proj: int = 200
    hidden: int = 300
    n_cls: int = 3

    def _mods(self):
        return (
            QuantEmbedding(self.vocab, self.emb),
            QuantDense(self.emb, self.proj),
            BiLSTM(self.proj, self.hidden),
            QuantDense(8 * self.hidden, 512),
            QuantDense(512, 512),
            QuantDense(512, 512),
            QuantDense(512, self.n_cls),
        )

    def init(self, generator: torch.Generator):
        names = ("embed", "proj", "bilstm", "fc1", "fc2", "fc3", "fc4")
        return {n: m.init(generator) for n, m in zip(names, self._mods())}

    def specs(self):
        names = ("embed", "proj", "bilstm", "fc1", "fc2", "fc3", "fc4")
        return {n: m.specs() for n, m in zip(names, self._mods())}

    def _encode(self, p, tokens: torch.Tensor, policy: Policy) -> torch.Tensor:
        emb, proj, lstm, *_ = self._mods()
        x = emb.apply(p["embed"], tokens, policy)
        x = torch.relu(proj.apply(p["proj"], x, policy))
        # max-pool over time; amax splits the gradient evenly among ties
        # (FP8-grid h values tie often), as the reference's max does
        return torch.amax(lstm.apply(p["bilstm"], x, policy), dim=1)

    def logits(self, p, batch, policy: Policy) -> torch.Tensor:
        *_, f1, f2, f3, f4 = self._mods()
        u = self._encode(p, batch["premise"], policy)
        v = self._encode(p, batch["hypothesis"], policy)
        feat = torch.cat([u, v, _Abs.apply(u - v), u * v], dim=-1)
        h = torch.relu(f1.apply(p["fc1"], feat, policy))
        h = torch.relu(f2.apply(p["fc2"], h, policy))
        h = torch.relu(f3.apply(p["fc3"], h, policy))
        return f4.apply(p["fc4"], h, policy, site="last")

    def loss(self, p, batch, policy: Policy) -> torch.Tensor:
        return cross_entropy(self.logits(p, batch, policy)[:, None, :], batch["label"][:, None])

    def accuracy(self, p, batch, policy: Policy) -> torch.Tensor:
        pred = torch.argmax(self.logits(p, batch, policy), -1)
        return torch.mean((pred == batch["label"]).to(torch.float32))


@dataclasses.dataclass(frozen=True)
class Multi30KSeq2Seq:
    src_vocab: int = 8000
    tgt_vocab: int = 8000
    emb: int = 256
    hidden: int = 512

    def _mods(self):
        return (
            QuantEmbedding(self.src_vocab, self.emb),
            LSTMLayer(self.emb, self.hidden),
            QuantEmbedding(self.tgt_vocab, self.emb),
            LSTMLayer(self.emb, self.hidden),
            QuantDense(self.hidden, self.tgt_vocab),
        )

    def init(self, generator: torch.Generator):
        names = ("src_embed", "enc", "tgt_embed", "dec", "out")
        return {n: m.init(generator) for n, m in zip(names, self._mods())}

    def specs(self):
        names = ("src_embed", "enc", "tgt_embed", "dec", "out")
        return {n: m.specs() for n, m in zip(names, self._mods())}

    def logits(self, p, batch, policy: Policy) -> torch.Tensor:
        """The encoder's final (h, c) starts the decoder; its gradient flows
        back into the encoder (dc in the cell dtype)."""
        se, sl, te, tl, out = self._mods()
        _, enc_state = sl.apply(p["enc"], se.apply(p["src_embed"], batch["src"], policy), policy)
        h, _ = tl.apply(p["dec"], te.apply(p["tgt_embed"], batch["tgt_in"], policy), policy,
                        state=enc_state)
        return out.apply(p["out"], h, policy, site="last")

    def loss(self, p, batch, policy: Policy) -> torch.Tensor:
        return cross_entropy(self.logits(p, batch, policy), batch["tgt_out"], batch.get("mask"))

    def perplexity(self, p, batch, policy: Policy) -> torch.Tensor:
        return torch.exp(self.loss(p, batch, policy))


@dataclasses.dataclass(frozen=True)
class WikiText2LM:
    """vocab 33278 (table padded to 33280), tied embeddings, 2-layer LSTM,
    hidden 1024. Where the hidden width differs from the embedding's, a
    bias-free ``proj`` maps it back before the tied head."""

    vocab: int = 33278
    emb: int = 1024
    hidden: int = 1024
    n_layers: int = 2

    def _vp(self) -> int:
        """Embedding rows: the vocab padded to a multiple of 256."""
        return -(-self.vocab // 256) * 256

    def _mods(self):
        proj = QuantDense(self.hidden, self.emb, use_bias=False) if self.hidden != self.emb else None
        return (
            QuantEmbedding(self._vp(), self.emb),
            [LSTMLayer(self.emb if i == 0 else self.hidden, self.hidden)
             for i in range(self.n_layers)],
            proj,
        )

    def init(self, generator: torch.Generator):
        """Random parameters from ``generator``, on its device."""
        emb, layers, proj = self._mods()
        p = {"embed": emb.init(generator)}
        for i, layer in enumerate(layers):
            p[f"lstm{i}"] = layer.init(generator)
        if proj is not None:
            p["proj"] = proj.init(generator)
        return p

    def specs(self):
        emb, layers, proj = self._mods()
        s = {"embed": emb.specs(), **{f"lstm{i}": layer.specs() for i, layer in enumerate(layers)}}
        if proj is not None:
            s["proj"] = proj.specs()
        return s

    def logits(self, p, tokens: torch.Tensor, policy: Policy, states=None, lengths=None):
        """tokens [B, S] -> (logits [B, S, vocab padded], new states).
        Under the train step's policy every layer runs the fused quantized
        BPTT."""
        emb, layers, proj = self._mods()
        x = emb.apply(p["embed"], tokens, policy)
        new_states = []
        for i, layer in enumerate(layers):
            x, st = layer.apply(
                p[f"lstm{i}"], x, policy, None if states is None else states[i],
                lengths=lengths,
            )
            new_states.append(st)
        if proj is not None:
            x = proj.apply(p["proj"], x, policy)
        return emb.attend(p["embed"], x, policy), new_states

    def loss(self, p, batch, policy: Policy) -> torch.Tensor:
        """Mean next-token cross entropy of a {"tokens", "labels"[, "mask"]}
        batch, the padded vocab tail masked out."""
        lg, _ = self.logits(p, batch["tokens"], policy)
        lg = mask_padded_vocab(lg, self.vocab)
        return cross_entropy(lg, batch["labels"], batch.get("mask"))

    def perplexity(self, p, batch, policy: Policy) -> torch.Tensor:
        return torch.exp(self.loss(p, batch, policy))

    def init_cache(self, batch: int, policy: Policy, device, cache_len: int | None = None) -> list[LSTMState]:
        """Zero recurrent state per layer: h in the compute dtype, c in the
        cell dtype (``cache_len``, an attention model's, is unused)."""
        hdt = policy.cdt() or torch.float32
        return [
            LSTMState(
                torch.zeros((batch, self.hidden), dtype=hdt, device=device),
                torch.zeros((batch, self.hidden), dtype=policy.cell_dtype(), device=device),
            )
            for _ in range(self.n_layers)
        ]

    def decode_step(self, p, tokens: torch.Tensor, states, policy: Policy, lengths=None):
        """One batched serving step over a [B, S] token block; ``lengths``
        ([B]) marks how many positions are valid per lane."""
        return self.logits(p, tokens, policy, states, lengths=lengths)
