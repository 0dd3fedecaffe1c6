"""Jamba v0.1 52B [arXiv:2403.19887; hf]: Mamba+attention 1:7, MoE every 2."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba_v01_52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, kv_heads=8, d_ff=14336, vocab=65536,
    n_experts=16, top_k=2, moe_every=2, attn_every=8,
    rope="none",  # jamba uses no positional encoding (mamba provides order)
    supports_long=True,
    source="arXiv:2403.19887 (hf)",
    notes="period-8 groups: [mamba x3, attn, mamba x4], MoE on odd sub-layers.",
)
