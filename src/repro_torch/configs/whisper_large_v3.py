"""Whisper large-v3 [arXiv:2212.04356; unverified]: enc-dec, conv stub.

'32L' = 32 encoder + 32 decoder blocks (the published large-v3 layout).
The conv frontend is a STUB: the encoder takes precomputed 1500-frame
embeddings straight."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_large_v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, kv_heads=20, d_ff=5120, vocab=51866,
    rope="none", norm="layernorm", ffn_kind="gelu", qkv_bias=True,
    enc_layers=32, enc_seq=1500, tie_embeddings=True,
    source="arXiv:2212.04356 (unverified)",
)
