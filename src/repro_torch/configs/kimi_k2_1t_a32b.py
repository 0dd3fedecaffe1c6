"""Kimi K2 1T-A32B [arXiv:2501.kimi2; unverified]: 384-expert top-8 MoE.

61 layers, d_model 7168, expert FFN hidden 2048, first layer dense
(DeepSeek-V3-style first_k_dense_replace=1)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi_k2_1t_a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, kv_heads=8, d_ff=2048, vocab=163840,
    head_dim=112, n_experts=384, top_k=8, first_k_dense=1, first_dense_ff=18432,
    rope="rope",
    source="arXiv:2501.kimi2 (unverified, paper-table)",
    notes="~1T total params, ~32B active; EP over model axis + capacity routing.",
)
