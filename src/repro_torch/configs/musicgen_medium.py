"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48L d_model=1536 24H MHA, GELU ff 6144 (non-GLU), LayerNorm,
sinusoidal positions, vocab 2048 (per-codebook).  The EnCodec frontend
is a STUB: input_specs() provides precomputed frame embeddings
(input_mode='embeddings').  Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    norm="layernorm", act="gelu", glu=False,
    rope=False, pos_emb="sinusoidal",
    input_mode="embeddings",
    head_pad_factor=2,  # §Perf: 24 heads -> 48, shardable over TP=16
    remat="full",
)
