"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone only per assignment: 32L d_model=4096 32H GQA kv=8, SwiGLU
ff 14336, vocab 32000.  The anyres vision tower is a STUB:
input_specs() provides precomputed patch+text embeddings
(input_mode='embeddings').  Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    rope_theta=1e6,
    input_mode="embeddings",
    remat="full",
)
