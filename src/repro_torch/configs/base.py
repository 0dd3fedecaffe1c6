"""Architecture config schema and lookup.

Counterpart of ``repro.configs.base`` for the families the port builds:
the paper's LSTM (``lstm``), the model zoo's RWKV-6 family (``ssm``) and
its dense decoders (``dense``). The fields are the reference's that those
families read; the MoE, hybrid, audio and vision fields come with their
families (``ROADMAP.md`` Queue 1 item 8)."""
from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ArchConfig", "get_config"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # lstm | ssm | dense (moe | hybrid | audio | vlm: not ported yet)
    n_layers: int
    d_model: int
    vocab: int
    d_ff: int = 0
    # --- attention (dense) ---
    n_heads: int = 0
    kv_heads: int = 0
    head_dim: int | None = None
    window: int | None = None  # sliding window (SWA)
    rope: str = "rope"  # rope | mrope | none
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    ffn_kind: str = "swiglu"  # swiglu | gelu | geglu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = True
    rwkv_head_dim: int = 64
    source: str = ""
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def vocab_padded(self, multiple: int = 256) -> int:
        return -(-self.vocab // multiple) * multiple

    def reduced(self) -> "ArchConfig":
        """The reference's tiny same-family config for CPU tests: 2 layers,
        d_model 128, d_ff 256, vocab 512, at most 4 heads over the largest
        KV head count that divides them, head_dim 32, a window of 64 where
        there is one, RWKV head_dim 32."""
        heads = min(self.n_heads, 4)
        kvh = max(1, min(self.kv_heads, heads))
        while heads % kvh:
            kvh -= 1
        return dataclasses.replace(
            self, n_layers=2, d_model=128, d_ff=256, vocab=512, n_heads=heads, kv_heads=kvh,
            head_dim=32, window=64 if self.window else None, rwkv_head_dim=32)


def get_config(name: str) -> ArchConfig:
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
