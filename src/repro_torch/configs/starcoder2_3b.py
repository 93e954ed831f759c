"""StarCoder2-3B [arXiv:2402.19173].

30L d_model=3072 24H GQA kv=2, d_ff=12288 (GELU, non-GLU), LayerNorm,
RoPE, biases, vocab 49152. Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    norm="layernorm", act="gelu", glu=False,
    qkv_bias=True, mlp_bias=True, rope_theta=1e5,
    head_pad_factor=2,  # §Perf: 24 heads -> 48, shardable over TP=16
    remat="full",
)
