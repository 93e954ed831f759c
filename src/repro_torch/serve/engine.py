"""Serving: decode steps over the segment-structured cache (the
counterpart of ``repro.serve.engine``).

``decode_step`` appends one token, for every layer kind: attention KV,
MLA latents, Mamba conv and SSM states, RWKV shifts and WKV states.
Every cache is updated in place and ``cur_len`` stays a one-element
int32 tensor on the device from end to end, so a decode step never waits
for the host: no ``.item()``, no copy to the CPU.
``serve_input_specs`` gives the decode step's inputs as meta tensors and
``decode_shardings`` their partition specs (resolved spec trees: the
port has no ``NamedSharding``; ``Mesh.shard`` consumes specs), for the
dry-run.
"""
from __future__ import annotations

import torch

from ..launch.mesh import P
from ..models import transformer as T
from ..models.common import resolve_device, resolve_specs, tree_map
from .prefill import greedy

__all__ = ["decode_step", "init_serve_state", "pad_cache",
           "serve_input_specs", "decode_shardings"]


def init_serve_state(cfg, batch: int, max_len: int, *, device=None,
                     mesh=None):
    """Zero caches + cur_len = 0, on ``device`` (default CUDA); on a
    process ``mesh`` this rank's shards of the caches of ``batch``
    sequences (``transformer.cache_shapes``)."""
    dev = resolve_device(device)
    return {"cache": T.cache_init(cfg, batch, max_len, device=dev,
                                  mesh=mesh),
            "cur_len": torch.zeros((1,), dtype=torch.int32, device=dev)}


def pad_cache(prefill_cache, cfg, batch: int, max_len: int):
    """A ``max_len`` decode cache, on the prefill cache's device, that
    holds the prefill cache (``prefill_step`` returns one of the prompt's
    length).  Attention and MLA caches keep the prompt's rows, and the
    rows after them are zero; Mamba and RWKV states are copied whole.
    Each leaf takes the prefill leaf's shape (on a mesh, a process's
    shard) with ``max_len`` rows."""
    full = []
    dtypes = T.cache_shapes(cfg, 1, 1)
    for (_, period), pseg, dseg in zip(T.segment_plan(cfg), prefill_cache,
                                       dtypes):
        seg = []
        for (mix, _), player, dlayer in zip(period, pseg, dseg):
            grow = mix in ("attention", "mla")   # (layers, B, length, ...)

            def one(p, meta, grow=grow):
                shape = ((p.shape[0], batch, max_len) + tuple(p.shape[3:])
                         if grow else p.shape)
                f = torch.zeros(shape, dtype=meta.dtype, device=p.device)
                (f[:, :, :p.shape[2]] if grow else f).copy_(p)
                return f

            seg.append(tree_map(one, player, dlayer))
        full.append(seg)
    return full


@torch.no_grad()
def decode_step(params, state, tokens_or_embeds, cfg, mesh=None, dp=None):
    """One decode step.

    tokens_or_embeds: (B, 1) int32 (or (B, 1, d) for stub-frontend
    archs).  Returns (next_tokens (B, 1) int32, new_state).  The caches
    of ``state`` are written in place and shared with ``new_state``;
    ``state["cur_len"]`` is left as it was.  On a process ``mesh`` the
    tokens and caches are this process's shards (``prefill_step``), the
    batch cut over the data axes ``dp`` (default all of them; () where
    each rank holds it whole).
    """
    logits, _hidden, _aux, new_cache = T.forward(
        params, tokens_or_embeds, cfg,
        cache=state["cache"], cur_len=state["cur_len"], mesh=mesh, dp=dp)
    next_tokens = greedy(logits[:, -1:], cfg, mesh)
    return next_tokens, {"cache": new_cache,
                         "cur_len": state["cur_len"] + 1}


def decode_shardings(cfg, mesh, *, batch=None, kv_len=None):
    """(state specs, token spec) of the decode step on ``mesh``: the cache
    specs resolved against the cache shapes where batch and kv_len are
    given; ``cur_len``, a one-element tensor, replicated."""
    cspecs = T.cache_specs(cfg, mesh, batch=batch)
    if batch is not None and kv_len is not None:
        cspecs = resolve_specs(cspecs, T.cache_shapes(cfg, batch, kv_len),
                               mesh)
    state = {"cache": cspecs, "cur_len": P(None)}
    dp = T.dp_axes(mesh)
    if batch is not None:
        n_dp = 1
        for a in dp:
            n_dp *= mesh.shape[a]
        if batch % max(n_dp, 1) != 0:
            dp = ()
    if cfg.input_mode == "embeddings":
        return state, P(dp, None, None)
    return state, P(dp, None)


def serve_input_specs(cfg, *, batch: int, kv_len: int):
    """(state, tokens) of the decode dry-run as meta tensors: one new
    token with a cache of kv_len."""
    if cfg.input_mode == "embeddings":
        tokens = torch.empty((batch, 1, cfg.d_model),
                             dtype=getattr(torch, cfg.dtype), device="meta")
    else:
        tokens = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    state = {"cache": T.cache_shapes(cfg, batch, kv_len),
             "cur_len": torch.empty((1,), dtype=torch.int32, device="meta")}
    return state, tokens
