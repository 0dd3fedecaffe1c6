"""Architecture config schema and lookup (the LSTM subset of
``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ArchConfig", "get_config"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    vocab: int
    tie_embeddings: bool = True
    source: str = ""
    notes: str = ""


def get_config(name: str) -> ArchConfig:
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
