"""Qwen2-1.5B [arXiv:2407.10671].

28L d_model=1536 12H GQA kv=2, SwiGLU ff 8960, QKV bias, RMSNorm,
tied embeddings, vocab 151936. Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
    head_pad_factor=4,  # §Perf: 12 heads -> 48, shardable over TP=16
    remat="full",
)
