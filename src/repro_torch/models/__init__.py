from ..configs.base import ArchConfig
from .lm import CausalLM
from .lstm_models import Multi30KSeq2Seq, SNLIClassifier, UDPOSTagger, WikiText2LM
from .whisper import Whisper

__all__ = ["CausalLM", "Whisper", "UDPOSTagger", "SNLIClassifier", "Multi30KSeq2Seq", "WikiText2LM", "build"]


def build(cfg: ArchConfig):
    """Arch config -> model object: the paper's LSTM LM (``lstm``),
    ``Whisper`` (``audio``) or the zoo's ``CausalLM`` (``ssm``: RWKV-6;
    ``dense``; ``moe``: DBRX, Kimi K2; ``hybrid``: Jamba; ``vlm``:
    Qwen2-VL)."""
    if cfg.family == "lstm":
        return WikiText2LM(vocab=cfg.vocab, emb=cfg.d_model, hidden=cfg.d_model,
                           n_layers=cfg.n_layers)
    if cfg.family == "audio":
        return Whisper(cfg)
    return CausalLM(cfg)
