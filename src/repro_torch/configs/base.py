"""Architecture config schema and lookup.

Counterpart of ``repro.configs.base`` for the families the port builds:
the paper's LSTM (``lstm``) and the model zoo's RWKV-6 family (``ssm``).
The fields are the reference's that those families read; the attention,
MoE, hybrid, audio and vision fields come with their families
(``ROADMAP.md`` Queue 1 item 10)."""
from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ArchConfig", "get_config"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # lstm | ssm (dense | moe | hybrid | audio | vlm: not ported yet)
    n_layers: int
    d_model: int
    vocab: int
    d_ff: int = 0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = True
    rwkv_head_dim: int = 64
    source: str = ""
    notes: str = ""

    def vocab_padded(self, multiple: int = 256) -> int:
        return -(-self.vocab // multiple) * multiple

    def reduced(self) -> "ArchConfig":
        """The reference's tiny same-family config for CPU tests (2 layers,
        d_model 128, head_dim 32, d_ff 256, vocab 512)."""
        return dataclasses.replace(self, n_layers=2, d_model=128, d_ff=256, vocab=512, rwkv_head_dim=32)


def get_config(name: str) -> ArchConfig:
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
