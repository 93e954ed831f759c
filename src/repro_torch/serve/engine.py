"""Serving: decode steps over the segment-structured cache (the
counterpart of ``repro.serve.engine``).

``decode_step`` appends one token.  The cache is updated in place and
``cur_len`` stays a one-element int32 tensor on the device from end to
end, so a decode step never waits for the host: no ``.item()``, no copy
to the CPU.  ``decode_shardings`` and ``serve_input_specs`` (sharding
and the dry-run) wait for ROADMAP A12.
"""
from __future__ import annotations

import torch

from ..models import transformer as T
from ..models.common import resolve_device, tree_leaves, tree_map

__all__ = ["decode_step", "init_serve_state", "pad_cache"]


def init_serve_state(cfg, batch: int, max_len: int, *, device=None):
    """Zero caches + cur_len = 0, on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    return {"cache": T.cache_init(cfg, batch, max_len, device=dev),
            "cur_len": torch.zeros((1,), dtype=torch.int32, device=dev)}


def pad_cache(prefill_cache, cfg, batch: int, max_len: int):
    """A ``max_len`` decode cache, on the prefill cache's device, that
    holds the prefill cache's rows (``prefill_step`` returns a cache of
    the prompt's length); the rows after them are zero."""
    dev = tree_leaves(prefill_cache)[0].device
    full = T.cache_init(cfg, batch, max_len, device=dev)
    tree_map(lambda f, p: f[:, :, :p.shape[2]].copy_(p), full, prefill_cache)
    return full


@torch.no_grad()
def decode_step(params, state, tokens_or_embeds, cfg):
    """One decode step.

    tokens_or_embeds: (B, 1) int32 (or (B, 1, d) for stub-frontend
    archs).  Returns (next_tokens (B, 1) int32, new_state).  The caches
    of ``state`` are written in place and shared with ``new_state``;
    ``state["cur_len"]`` is left as it was.
    """
    logits, _hidden, _aux, new_cache = T.forward(
        params, tokens_or_embeds, cfg,
        cache=state["cache"], cur_len=state["cur_len"])
    next_tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    return next_tokens, {"cache": new_cache,
                         "cur_len": state["cur_len"] + 1}
