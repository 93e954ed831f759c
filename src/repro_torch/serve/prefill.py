"""Prefill: full-sequence forward that also materialises the KV / latent
/ state caches decode will consume (the counterpart of
``repro.serve.prefill``)."""
from __future__ import annotations

import torch

from ..models import transformer as T

__all__ = ["prefill_step", "greedy"]


def greedy(logits, cfg, mesh=None) -> torch.Tensor:
    """(B, 1, V) logits -> (B, 1) int32 argmax tokens.  On a mesh whose
    ``model`` axis cuts the vocabulary, each rank's best (value, index)
    is gathered over ``model`` and the first of the largest wins, as
    ``argmax`` over the whole vocabulary picks."""
    v_loc = logits.shape[-1]
    if mesh is None or v_loc == cfg.vocab_size:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    val, idx = logits.float().max(dim=-1)             # (B, 1)
    idx = idx + mesh.index("model") * v_loc
    vals = mesh.all_gather(val[None, None], "model", axis=0)[0]  # (m, B, 1)
    idxs = mesh.all_gather(idx[None, None], "model", axis=0)[0]
    best = torch.argmax(vals, dim=0, keepdim=True)    # (1, B, 1) ranks
    return idxs.gather(0, best)[0].to(torch.int32)


@torch.no_grad()
def prefill_step(params, inputs, cfg, mesh=None, dp=None):
    """inputs: (B, S) int32 tokens or (B, S, d) embeddings.

    Returns (next_tokens (B, 1) int32, prefill_cache, cur_len), cur_len
    a one-element int32 tensor on the inputs' device.  The cache covers
    positions [0, S); decode continues at S.  Only the last position is
    projected onto the vocabulary: its logits equal ``forward``'s there,
    and the (B, S, V) logits are never materialised.  On a process
    ``mesh``, inputs and caches are this process's shards (see
    ``transformer.forward``; the caches hold its own KV heads).
    """
    hidden, _aux, cache = T.backbone(params, inputs, cfg,
                                     collect_cache=True, mesh=mesh, dp=dp)
    logits = T.lm_head(params, hidden[:, -1:], cfg, mesh)
    next_tokens = greedy(logits, cfg, mesh)
    s = inputs.shape[1]
    return next_tokens, cache, torch.full((1,), s, dtype=torch.int32,
                                          device=inputs.device)
