"""Jamba-v0.1 52B [arXiv:2403.19887] — Mamba+attention 1:7, MoE.

32L d_model=4096; attention layer once per 8 (offset 4), Mamba
elsewhere; MoE (16 experts top-2, ff 14336) every other layer; GQA
kv=8 on attention layers; no positional encoding (Mamba provides
position).  Hybrid: Mamba state is O(1) and only 4 layers carry KV ->
long_500k runs.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    rope=False, pos_emb="none",
    mixer="attention", attn_every=8, attn_offset=4,
    moe=True, n_experts=16, top_k=2, moe_d_ff=14336,
    moe_every=2, moe_offset=1,
    mamba_d_state=16, mamba_conv=4, mamba_expand=2,
    supports_long_context=True,
    remat="full",
)
