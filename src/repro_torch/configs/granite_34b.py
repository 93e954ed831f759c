"""Granite-34B (code) [arXiv:2405.04324] — llama-arch, MQA kv=1.

88L d_model=6144 48H kv=1, SwiGLU ff 24576, vocab 49152.
Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    remat="full",
)
