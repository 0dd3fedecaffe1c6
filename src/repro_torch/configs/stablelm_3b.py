"""StableLM 3B [hf:stabilityai/stablelm-2-1_6b family]: MHA (kv = 32),
layernorm, biased q/k/v projections."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm_3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, kv_heads=32, d_ff=6912, vocab=50304,
    rope="rope", norm="layernorm", qkv_bias=True,
    source="hf:stabilityai/stablelm-2-1_6b (unverified)",
)
