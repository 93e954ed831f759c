"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H GQA kv=4 (head_dim 128, QK-norm), 128 experts
top-8 (expert ff 768), vocab 151936.  Pure full-attention -> long_500k
skipped (DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128, d_ff=6144, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
    moe=True, n_experts=128, top_k=8, moe_d_ff=768,
    remat="full",
)
