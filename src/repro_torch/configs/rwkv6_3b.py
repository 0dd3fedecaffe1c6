"""RWKV-6 'Finch' 3B [arXiv:2404.05892; hf]: attention-free, O(1) state."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6_3b", family="ssm",
    n_layers=32, d_model=2560, d_ff=8960, vocab=65536,
    rope="none", rwkv_head_dim=64, norm="layernorm",
    supports_long=True,
    source="arXiv:2404.05892 (hf)",
    notes="receptance sigmoid is a native FloatSD8 q-sigmoid site.",
)
