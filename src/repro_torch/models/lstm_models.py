"""The paper's WikiText-2 language model (§IV-A, Table III):
embed -> 2-layer LSTM -> tied FC decoder.

Counterpart of ``repro.models.lstm_models.WikiText2LM``: the training loss
(through the fused quantized BPTT) and the serving step.
Parameters are a nested dict of tensors with the reference's keys
(``embed/table``, ``lstm<i>/wx``, ``lstm<i>/wh``, ``lstm<i>/b``), so
``repro_torch.bridge`` carries a JAX model across unchanged. The packed
serving tree has ``PackedTensor`` leaves at every weight site.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.policy import Policy
from ..nn.linear import QuantEmbedding
from ..nn.lstm import LSTMLayer, LSTMState
from .lm import cross_entropy, mask_padded_vocab

__all__ = ["WikiText2LM"]


@dataclasses.dataclass(frozen=True)
class WikiText2LM:
    """vocab 33278 (table padded to 33280), tied embeddings, 2-layer LSTM,
    hidden 1024. The embedding width equals the hidden width (the
    reference's projection for emb != hidden is not ported)."""

    vocab: int = 33278
    emb: int = 1024
    hidden: int = 1024
    n_layers: int = 2

    def __post_init__(self):
        if self.emb != self.hidden:
            raise ValueError("WikiText2LM: emb must equal hidden (no projection layer)")

    def _vp(self) -> int:
        """Embedding rows: the vocab padded to a multiple of 256."""
        return -(-self.vocab // 256) * 256

    def _mods(self):
        return (
            QuantEmbedding(self._vp(), self.emb),
            [LSTMLayer(self.emb if i == 0 else self.hidden, self.hidden)
             for i in range(self.n_layers)],
        )

    def init(self, generator: torch.Generator):
        """Random parameters from ``generator``, on its device."""
        emb, layers = self._mods()
        p = {"embed": emb.init(generator)}
        for i, layer in enumerate(layers):
            p[f"lstm{i}"] = layer.init(generator)
        return p

    def logits(self, p, tokens: torch.Tensor, policy: Policy, states=None, lengths=None):
        """tokens [B, S] -> (logits [B, S, vocab padded], new states).
        Under the train step's policy every layer runs the fused quantized
        BPTT."""
        emb, layers = self._mods()
        x = emb.apply(p["embed"], tokens, policy)
        new_states = []
        for i, layer in enumerate(layers):
            x, st = layer.apply(
                p[f"lstm{i}"], x, policy, None if states is None else states[i],
                lengths=lengths,
            )
            new_states.append(st)
        return emb.attend(p["embed"], x, policy), new_states

    def loss(self, p, batch, policy: Policy) -> torch.Tensor:
        """Mean next-token cross entropy of a {"tokens", "labels"[, "mask"]}
        batch, the padded vocab tail masked out."""
        lg, _ = self.logits(p, batch["tokens"], policy)
        lg = mask_padded_vocab(lg, self.vocab)
        return cross_entropy(lg, batch["labels"], batch.get("mask"))

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
