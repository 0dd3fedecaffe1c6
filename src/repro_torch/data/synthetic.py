"""Synthetic WikiText-2 stream (the LSTM LM's subset of
``repro.data.synthetic``, copied so the port imports nothing of the JAX
package): a Zipf-weighted sparse second-order Markov chain over the
vocabulary. The generators are plain numpy, so the same seed gives the
same batches as the reference, element for element.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["TaskSpec", "wikitext2"]


@dataclasses.dataclass
class TaskSpec:
    name: str
    vocab: int
    n_labels: int
    batches: Iterator
    eval_batches: Iterator


def _rng(seed):
    return np.random.default_rng(seed)


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
