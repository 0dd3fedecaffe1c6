"""IBM Granite 20B code model [arXiv:2405.04324]: llama architecture with
MQA (kv = 1), GELU FFN, layernorm, biased q/k/v projections."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite_20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, kv_heads=1, d_ff=24576, vocab=49152,
    rope="rope", ffn_kind="gelu", norm="layernorm", qkv_bias=True,
    source="arXiv:2405.04324 (hf)",
    notes="MQA (kv=1): kv projections replicate over the model axis.",
)
