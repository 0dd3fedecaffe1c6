"""Architecture config schema and lookup.

Counterpart of ``repro.configs.base`` for every family of the reference:
the paper's LSTM (``lstm``), the model zoo's RWKV-6 family (``ssm``), its
dense decoders (``dense``), its mixtures of experts (``moe``), the
Mamba/attention hybrid (``hybrid``), Whisper's encoder-decoder (``audio``)
and Qwen2-VL's M-RoPE decoder with stub patch embeddings (``vlm``). The
fields are the reference's that those families read. ``ARCH_IDS``,
``SHAPES`` (the assigned input shapes: name -> (seq_len, global_batch,
kind)), ``shape_spec`` and ``ArchConfig.skips`` are the reference's, for
the dry run (``launch/dryrun.py``)."""
from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ArchConfig", "get_config", "ARCH_IDS", "SHAPES", "shape_spec"]

ARCH_IDS = [
    "h2o_danube3_4b",
    "granite_20b",
    "stablelm_3b",
    "phi4_mini_3p8b",
    "kimi_k2_1t_a32b",
    "dbrx_132b",
    "jamba_v01_52b",
    "rwkv6_3b",
    "whisper_large_v3",
    "qwen2_vl_2b",
    "lstm_wikitext2",  # the paper's own largest model, as an arch config
]

# the assigned input-shape set: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def shape_spec(name: str):
    return SHAPES[name]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # lstm | ssm | dense | moe | hybrid | audio | vlm
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
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # an MoE MLP every k-th sub-layer (jamba: 2)
    first_k_dense: int = 0  # leading dense layers (kimi-k2: 1)
    first_dense_ff: int = 0  # their FFN width (0: d_ff)
    # --- hybrid (jamba) ---
    attn_every: int = 0  # one attention sub-layer per this many (0: every layer attends)
    mamba_state: int = 16
    rwkv_head_dim: int = 64
    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0  # stub frontend sequence length (1500 audio frames)
    # --- vlm ---
    n_patches: int = 0  # stub patch embeddings in the first positions of the sequence
    mrope_sections: tuple = (16, 24, 24)  # M-RoPE's (t, h, w) shares of the D/2 frequencies
    supports_long: bool = False  # a sub-quadratic path for long_500k
    source: str = ""
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def vocab_padded(self, multiple: int = 256) -> int:
        return -(-self.vocab // multiple) * multiple

    def reduced(self) -> "ArchConfig":
        """The reference's tiny same-family config for CPU tests: d_model
        128, d_ff 256, vocab 512, at most 4 heads over the largest KV head
        count that divides them, head_dim 32, a window of 64 where there is
        one, RWKV head_dim 32; max(2, 2 moe_every, attn_every) layers (2 for
        every family but the hybrid's one period of 8), at most 4 experts,
        top-2, one leading dense layer of width 256; 2 encoder layers over
        16 stub frames, 16 stub patches and M-RoPE sections (8, 4, 4) where
        the full config has them."""
        heads = min(self.n_heads, 4)
        kvh = max(1, min(self.kv_heads, heads))
        while heads % kvh:
            kvh -= 1
        return dataclasses.replace(
            self, n_layers=max(2, 2 * max(self.moe_every, 1), self.attn_every or 2), d_model=128,
            d_ff=256, vocab=512, n_heads=heads, kv_heads=kvh, head_dim=32,
            n_experts=min(self.n_experts, 4), top_k=min(self.top_k, 2),
            first_k_dense=min(self.first_k_dense, 1),
            first_dense_ff=256 if self.first_dense_ff else 0,
            window=64 if self.window else None, rwkv_head_dim=32,
            enc_layers=2 if self.enc_layers else 0, enc_seq=16 if self.enc_seq else 0,
            n_patches=16 if self.n_patches else 0,
            mrope_sections=(8, 4, 4) if self.rope == "mrope" else self.mrope_sections)


    def skips(self, shape: str) -> str | None:
        """The reason this (arch, shape) cell is skipped, or None."""
        if shape == "long_500k" and not self.supports_long:
            return "full quadratic attention at 524288 — sub-quadratic required (DESIGN.md §5)"
        return None


def get_config(name: str) -> ArchConfig:
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
