"""The paper's four tasks as (model, data, optimizer) bundles (§IV-A).
Counterpart of ``repro.models.task_zoo``: ``full=True`` is the paper's
width (Table III); the default is the reference's reduced configuration,
which still exercises every quantization site."""
from __future__ import annotations

from ..data import synthetic
from ..optim import adam, sgd
from .lstm_models import Multi30KSeq2Seq, SNLIClassifier, UDPOSTagger, WikiText2LM

__all__ = ["make_task", "TASKS"]

TASKS = ("udpos", "snli", "multi30k", "wikitext2")


def make_task(name: str, full: bool = False):
    """Returns (model, data TaskSpec, optimizer, lr, metric name); an
    unknown name raises ``ValueError``."""
    if name == "udpos":
        model = UDPOSTagger() if full else UDPOSTagger(vocab=2000, emb=64, hidden=96)
        data = synthetic.udpos(batch=64, vocab=model.vocab, n_tags=model.n_tags)
        return model, data, adam(), 1e-3, "accuracy"
    if name == "snli":
        model = SNLIClassifier() if full else SNLIClassifier(vocab=4000, emb=96, proj=64, hidden=96)
        data = synthetic.snli(batch=128, vocab=model.vocab)
        return model, data, adam(), 1e-3, "accuracy"
    if name == "multi30k":
        model = Multi30KSeq2Seq() if full else Multi30KSeq2Seq(src_vocab=2000, tgt_vocab=2000,
                                                               emb=96, hidden=128)
        data = synthetic.multi30k(batch=128, vocab=model.src_vocab)
        return model, data, adam(), 1e-3, "perplexity"
    if name == "wikitext2":
        model = WikiText2LM() if full else WikiText2LM(vocab=4000, emb=192, hidden=192, n_layers=2)
        data = synthetic.wikitext2(batch=64, seq=48, vocab=model.vocab)
        return model, data, sgd(0.9), 0.5 if full else 1.0, "perplexity"
    raise ValueError(f"unknown task {name!r}; the tasks are {TASKS}")
