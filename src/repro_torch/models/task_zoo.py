"""The paper's tasks as (model, data, optimizer) bundles (§IV-A): the
WikiText-2 language model, the one the port trains so far. Counterpart of
``repro.models.task_zoo``."""
from __future__ import annotations

from ..data import synthetic
from ..optim import sgd
from .lstm_models import WikiText2LM

__all__ = ["make_task"]


def make_task(name: str, full: bool = False):
    """Returns (model, data TaskSpec, optimizer, lr, metric name).
    ``full=True`` is the paper's width (Table III); the default is the
    reference's reduced configuration (vocab 4000, 192 wide)."""
    if name != "wikitext2":
        raise NotImplementedError(f"the port trains the wikitext2 task only, got {name!r}")
    model = WikiText2LM() if full else WikiText2LM(vocab=4000, emb=192, hidden=192, n_layers=2)
    data = synthetic.wikitext2(batch=64, seq=48, vocab=model.vocab)
    return model, data, sgd(0.9), 0.5 if full else 1.0, "perplexity"
