"""DBRX 132B [hf:databricks/dbrx-base; unverified]: 16-expert top-4 MoE."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx_132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, kv_heads=8, d_ff=10752, vocab=100352,
    n_experts=16, top_k=4, rope="rope",
    source="hf:databricks/dbrx-base (unverified)",
    notes="fine-grained MoE: every layer MoE, no shared expert.",
)
