"""Qwen2-VL 2B [arXiv:2409.12191; hf]: M-RoPE, dynamic-resolution ViT stub.

Backbone only: precomputed patch embeddings occupy the first n_patches
sequence positions."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_vl_2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, kv_heads=2, d_ff=8960, vocab=151936,
    rope="mrope", mrope_sections=(16, 24, 24), qkv_bias=True,
    n_patches=256, tie_embeddings=True,
    source="arXiv:2409.12191 (hf)",
)
