"""Synthetic corpora for the paper's four tasks, copied from
``repro.data.synthetic`` so the port imports nothing of the JAX package.
The generators are plain numpy, so the same seed gives the same batches as
the reference, element for element.

  UDPOS      : tags from a bigram grammar, words from per-tag vocab bands.
  SNLI       : entailment iff the hypothesis is a (noised) subset of the
               premise; contradiction iff it is the premise's anti-band.
  Multi30K   : 'translation' = a fixed vocab permutation + local reordering.
  WikiText-2 : a Zipf-weighted sparse second-order Markov chain.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["TaskSpec", "udpos", "snli", "multi30k", "wikitext2"]


@dataclasses.dataclass
class TaskSpec:
    name: str
    vocab: int
    n_labels: int
    batches: Iterator
    eval_batches: Iterator
    token_keys: tuple = ("tokens",)  # the batch's token inputs: tokens per step is their total size


def _rng(seed):
    return np.random.default_rng(seed)


def udpos(batch=64, seq=32, vocab=8000, n_tags=18, seed=0, eval_seed=10_000):
    """Batches {"tokens", "labels", "mask"} int32 [batch, seq]: words drawn
    per tag from disjoint-ish vocab bands (10% band noise), tags from a
    Dirichlet bigram grammar."""

    def gen(seed):
        r = _rng(seed)
        trans = r.dirichlet(np.full(n_tags, 0.3), size=n_tags)
        band = vocab // n_tags
        while True:
            tags = np.zeros((batch, seq), np.int32)
            tags[:, 0] = r.integers(0, n_tags, batch)
            for t in range(1, seq):
                cum = trans[tags[:, t - 1]].cumsum(-1)
                tags[:, t] = (cum < r.random((batch, 1))).sum(-1)
            words = tags * band + r.integers(0, band, (batch, seq))
            noise = r.random((batch, seq)) < 0.10
            words = np.where(noise, r.integers(0, vocab, (batch, seq)), words)
            mask = np.ones((batch, seq), np.int32)
            yield {"tokens": words.astype(np.int32), "labels": tags, "mask": mask}

    return TaskSpec("udpos", vocab, n_tags, gen(seed), gen(eval_seed))


def snli(batch=128, seq=24, vocab=20000, seed=1, eval_seed=10_001):
    """Batches {"premise", "hypothesis"} int32 [batch, seq] and "label"
    int32 [batch] (0 entailment, 1 contradiction, 2 neutral)."""

    def gen(seed):
        r = _rng(seed)
        while True:
            prem = r.integers(4, vocab, (batch, seq)).astype(np.int32)
            label = r.integers(0, 3, batch).astype(np.int32)
            hyp = np.zeros_like(prem)
            for i in range(batch):
                if label[i] == 0:  # entailment: subset + noise
                    idx = r.permutation(seq)[: seq // 2]
                    hyp[i, : seq // 2] = prem[i, np.sort(idx)]
                    hyp[i, seq // 2 :] = prem[i, r.integers(0, seq, seq - seq // 2)]
                elif label[i] == 1:  # contradiction: anti-premise band
                    hyp[i] = (prem[i] + vocab // 2) % vocab
                else:  # neutral: unrelated
                    hyp[i] = r.integers(4, vocab, seq)
            yield {"premise": prem, "hypothesis": hyp, "label": label}

    return TaskSpec("snli", vocab, 3, gen(seed), gen(eval_seed), ("premise", "hypothesis"))


def multi30k(batch=128, seq=20, vocab=8000, seed=2, eval_seed=10_002):
    """Batches {"src", "tgt_in", "tgt_out", "mask"} int32 [batch, seq]:
    the target is a fixed permutation of the source with adjacent pairs
    swapped; ``tgt_in`` is it shifted right behind a BOS of 1."""

    def gen(seed):
        r = _rng(seed)
        perm = _rng(42).permutation(vocab)  # fixed "bilingual dictionary"
        while True:
            src = r.integers(4, vocab, (batch, seq)).astype(np.int32)
            tgt = perm[src].astype(np.int32)
            # local reordering: swap adjacent pairs at even positions
            tgt_r = tgt.copy()
            tgt_r[:, 0:-1:2], tgt_r[:, 1::2] = tgt[:, 1::2], tgt[:, 0:-1:2]
            bos = np.ones((batch, 1), np.int32)
            tgt_in = np.concatenate([bos, tgt_r[:, :-1]], axis=1)
            mask = np.ones((batch, seq), np.int32)
            yield {"src": src, "tgt_in": tgt_in, "tgt_out": tgt_r, "mask": mask}

    return TaskSpec("multi30k", vocab, vocab, gen(seed), gen(eval_seed), ("src", "tgt_in"))


def wikitext2(batch=64, seq=64, vocab=33278, seed=3, eval_seed=10_003,
              zipf_a=1.1, branch=64):
    """Each (prev2, prev1) context allows ``branch`` successors with
    Zipf-ish weights. Batches are {"tokens", "labels"} int32 [batch, seq],
    the labels the tokens shifted by one."""

    def gen(seed):
        r = _rng(seed)
        gbase = _rng(7)
        # successor table: context hash -> branch candidate tokens
        zipf_p = 1.0 / np.arange(1, branch + 1) ** zipf_a
        zipf_p /= zipf_p.sum()
        table = gbase.integers(0, vocab, (4096, branch))
        while True:
            toks = np.zeros((batch, seq + 1), np.int64)
            toks[:, 0] = r.integers(0, vocab, batch)
            toks[:, 1] = r.integers(0, vocab, batch)
            for t in range(2, seq + 1):
                ctx = (toks[:, t - 2] * 31 + toks[:, t - 1]) % 4096
                choice = r.choice(branch, size=batch, p=zipf_p)
                toks[:, t] = table[ctx, choice]
            yield {
                "tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
            }

    return TaskSpec("wikitext2", vocab, vocab, gen(seed), gen(eval_seed))
