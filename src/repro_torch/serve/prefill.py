"""Prefill: full-sequence forward that also materialises the KV / latent
/ state caches decode will consume (the counterpart of
``repro.serve.prefill``)."""
from __future__ import annotations

import torch

from ..models import transformer as T

__all__ = ["prefill_step"]


@torch.no_grad()
def prefill_step(params, inputs, cfg):
    """inputs: (B, S) int32 tokens or (B, S, d) embeddings.

    Returns (next_tokens (B, 1) int32, prefill_cache, cur_len), cur_len
    a one-element int32 tensor on the inputs' device.  The cache covers
    positions [0, S); decode continues at S.  Only the last position is
    projected onto the vocabulary: its logits equal ``forward``'s there,
    and the (B, S, V) logits are never materialised.
    """
    hidden, _aux, cache = T.backbone(params, inputs, cfg,
                                     collect_cache=True)
    logits = T.lm_head(params, hidden[:, -1:], cfg)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    s = inputs.shape[1]
    return next_tokens, cache, torch.full((1,), s, dtype=torch.int32,
                                          device=inputs.device)
