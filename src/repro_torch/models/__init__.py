from ..configs.base import ArchConfig
from .lm import CausalLM
from .lstm_models import Multi30KSeq2Seq, SNLIClassifier, UDPOSTagger, WikiText2LM

__all__ = ["CausalLM", "UDPOSTagger", "SNLIClassifier", "Multi30KSeq2Seq", "WikiText2LM", "build"]


def build(cfg: ArchConfig):
    """Arch config -> model object: the paper's LSTM LM (``lstm``) or the
    zoo's ``CausalLM`` (``ssm``: RWKV-6; ``dense``). The other families
    raise ``NotImplementedError`` until they are ported (ROADMAP.md Queue 1
    item 8)."""
    if cfg.family == "lstm":
        return WikiText2LM(vocab=cfg.vocab, emb=cfg.d_model, hidden=cfg.d_model,
                           n_layers=cfg.n_layers)
    return CausalLM(cfg)
