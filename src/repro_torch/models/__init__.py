from ..configs.base import ArchConfig
from .lstm_models import WikiText2LM

__all__ = ["WikiText2LM", "build"]


def build(cfg: ArchConfig) -> WikiText2LM:
    """Arch config -> model object (the LSTM family only, in the port)."""
    if cfg.family != "lstm":
        raise NotImplementedError(f"the port builds LSTM models only, got {cfg.family!r}")
    return WikiText2LM(vocab=cfg.vocab, emb=cfg.d_model, hidden=cfg.d_model,
                       n_layers=cfg.n_layers)
