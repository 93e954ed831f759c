"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892] — attention-free,
data-dependent decay.

24L d_model=2048, head_size 64 (32 heads), channel-mix ff 7168,
vocab 65536.  O(1) recurrent state -> long_500k runs.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    mixer="rwkv6", rwkv_head_size=64,
    rope=False, pos_emb="none",
    supports_long_context=True,
    remat="full",
)
