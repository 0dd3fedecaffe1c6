"""Phi-4-mini 3.8B [arXiv:2412.08905]: RoPE, SwiGLU, GQA (24 over 8), a
200k vocab."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4_mini_3p8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, kv_heads=8, d_ff=8192, vocab=200064,
    rope="rope", qkv_bias=False, tie_embeddings=True,
    source="arXiv:2412.08905 (hf)",
    notes="200064-token vocab stresses the embedding/vocab-sharded logits path.",
)
