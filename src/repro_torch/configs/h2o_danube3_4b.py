"""H2O Danube-3 4B [arXiv:2401.16818]: llama + mistral mix with a sliding
window (4096) and GQA (32 query heads over 8 KV heads of 120)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o_danube3_4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, kv_heads=8, d_ff=10240, vocab=32000,
    head_dim=120, window=4096, rope="rope", rope_theta=10000.0,
    supports_long=True,
    source="arXiv:2401.16818 (unverified)",
    notes="SWA window 4096; GQA kv=8.",
)
