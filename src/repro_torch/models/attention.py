"""Attention mixers: GQA/MHA/MQA with RoPE, QK-norm, bias options;
memory-efficient blockwise causal attention for long sequences; KV-cache
prefill and decode paths.

The counterpart of ``repro.models.attention``.  The decode path calls
the hand-written CUDA kernel (``kernels/decode_attention``), reading the
cache in place; the cache write is an in-place ``index_copy_`` at the
device-resident ``cur_len``, so a decode step never waits for the host.

On a mesh the query heads are local to their ``model`` shard, and so
are the KV heads where ``model`` divides them; where it does not (MQA)
the KV projection is replicated and each rank keeps the KV heads its
query heads read.  The caches hold a rank's own KV heads for the whole
sequence, so the decode kernel runs unchanged on each process (the JAX
package's cache specs cut the sequence over ``model`` instead and leave
the combine to GSPMD: a named departure of the layout, not of the
values).  ``wo`` is row-parallel: one psum over ``model``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from ..kernels.decode_attention import ops as decode_ops
from ..launch.mesh import P, enter_rep
from .common import (ParamDef, apply_rope, block_enter, block_exit,
                     model_shard, rms_norm)

NEG_INF = -1e30


def pick_blocks(sq: int, skv: int, block_q: int, block_kv: int):
    """Adaptive blocking: ~16 q-blocks keeps the q loop short while
    bounding the per-block score tile."""
    bq = min(block_q, max(512, sq // 16))
    while sq % bq:
        bq //= 2
    bkv = min(block_kv, max(512, bq))
    while skv % bkv:
        bkv //= 2
    return max(bq, 1), max(bkv, 1)


# ---------------------------------------------------------------------------
# parameter declarations
# ---------------------------------------------------------------------------


def effective_heads(cfg):
    """(q, kv) head counts after the JAX package's TP padding.

    head_pad_factor=c scales BOTH counts by the integer c, appending
    heads that ``attention_apply`` zero-masks, so the padded model
    computes exactly the original attention.  One card needs no such
    padding; it is kept so that parameters and caches carry over from
    the JAX package shape for shape (ROADMAP: an open item).
    """
    c = max(1, cfg.head_pad_factor)
    return cfg.num_heads * c, cfg.num_kv_heads * c


def attention_defs(cfg) -> Dict[str, ParamDef]:
    d = cfg.d_model
    dh = cfg.head_dim or d // cfg.num_heads
    h, hkv = effective_heads(cfg)
    defs = {
        "wq": ParamDef((d, h, dh), spec=P(None, "model", None)),
        "wk": ParamDef((d, hkv, dh), spec=P(None, "model", None)),
        "wv": ParamDef((d, hkv, dh), spec=P(None, "model", None)),
        "wo": ParamDef((h, dh, d), spec=P("model", None, None)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, dh), "zeros", spec=P("model", None))
        defs["bk"] = ParamDef((hkv, dh), "zeros", spec=P("model", None))
        defs["bv"] = ParamDef((hkv, dh), "zeros", spec=P("model", None))
    if cfg.qk_norm:
        defs["q_norm"] = {"scale": ParamDef((dh,), "ones", spec=P(None))}
        defs["k_norm"] = {"scale": ParamDef((dh,), "ones", spec=P(None))}
    return defs


def kv_heads_read(h: int, hkv: int, h_loc: int, r: int):
    """(lo, hi): the KV heads that query heads [r h_loc, (r+1) h_loc) of
    ``h`` read, grouped over ``hkv`` KV heads (a rank's share where
    ``model`` cuts the query heads and not the KV heads)."""
    group = h // hkv
    if h_loc % group and group % h_loc:
        raise ValueError(f"{h_loc} query heads a rank straddle the groups "
                         f"of {group} of a KV head")
    return r * h_loc // group, ((r + 1) * h_loc - 1) // group + 1


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _tf32(enabled: bool):
    flags = torch.backends.cuda.matmul
    caller = flags.allow_tf32
    flags.allow_tf32 = enabled
    try:
        yield
    finally:
        flags.allow_tf32 = caller


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with f32 products, f32 sums and an f32 result: the JAX
    package's ``preferred_element_type=float32``.  bf16 operands are
    widened to f32 and multiplied in TF32, which holds every bf16 value
    exactly; f32 operands are multiplied in IEEE f32 (TF32 off)."""
    exact_in_tf32 = a.dtype == b.dtype == torch.bfloat16
    with _tf32(exact_in_tf32):
        return torch.einsum(eq, a.float(), b.float())


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hkv*n_rep, Dh)"""
    if n_rep == 1:
        return k
    b, s, hkv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, hkv, n_rep, dh).reshape(
        b, s, hkv * n_rep, dh)


def full_causal_attention(q, k, v, *, scale: float) -> torch.Tensor:
    """Naive O(S^2)-memory attention — reference / short sequences.

    q (B, Sq, H, Dh); k, v (B, Skv, H, Dh); causal with Sq == Skv.
    """
    sq, skv = q.shape[1], k.shape[1]
    scores = _einsum_f32("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def blockwise_causal_attention(q, k, v, *, scale: float, block_q: int = 512,
                               block_kv: int = 512) -> torch.Tensor:
    """Flash-style online-softmax attention in plain PyTorch.

    Memory is O(S * block) instead of O(S^2); a Python loop over the q
    blocks visits only the kv blocks that meet the causal triangle, as
    the JAX package's unrolled q loop with static kv trip counts does.
    """
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    block_q, block_kv = pick_blocks(sq, skv, block_q, block_kv)
    nq, nkv = sq // block_q, skv // block_kv
    q_pos0 = skv - sq  # alignment offset (prefill continuation)
    dev = q.device
    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * block_q:(qi + 1) * block_q]
        q_pos = q_pos0 + qi * block_q + torch.arange(block_q, device=dev)
        acc = torch.zeros((b, h, block_q, dh), dtype=torch.float32, device=dev)
        m = torch.full((b, h, block_q), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, block_q), dtype=torch.float32, device=dev)
        # only kv blocks that intersect the causal triangle
        hi = min((q_pos0 + (qi + 1) * block_q + block_kv - 1) // block_kv, nkv)
        for ki in range(hi):
            k_blk = k[:, ki * block_kv:(ki + 1) * block_kv]
            v_blk = v[:, ki * block_kv:(ki + 1) * block_kv]
            s = _einsum_f32("bqhd,bkhd->bhqk", q_blk, k_blk) * scale
            kv_pos = ki * block_kv + torch.arange(block_kv, device=dev)
            causal = q_pos[:, None] >= kv_pos[None, :]
            s = torch.where(causal, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _einsum_f32(
                "bhqk,bkhd->bhqd", p.to(v.dtype), v_blk)
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        # cast to the compute dtype per block: concatenating f32 blocks
        # would materialise a 2x-sized tensor before the cast
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))
    return torch.cat(outs, dim=1) if nq > 1 else outs[0]


def decode_attention(q, k_cache, v_cache, cur_len, *, scale: float):
    """Single-token decode: q (B, 1, H, Dh); caches (B, Smax, Hkv, Dh);
    cur_len (one-element int32 tensor) — number of valid cache entries.

    GQA stays grouped (q as (Hkv, n_rep)) so the cache is read at Hkv
    width.  On the card this is the CUDA kernel; it keeps the softmax
    weights in f32 where the JAX package's jnp decode casts them to
    q.dtype before the product with V (identical in f32, more precise in
    bf16).
    """
    return decode_ops.decode_attention(q, k_cache, v_cache, cur_len,
                                       scale=scale)


# ---------------------------------------------------------------------------
# the attention block (projections + mixer + cache plumbing)
# ---------------------------------------------------------------------------


def attention_apply(
    params: Dict,
    x: torch.Tensor,                 # (B, S, d)
    positions: torch.Tensor,         # (B, S)
    cfg,
    *,
    cache: Optional[Tuple] = None,   # (k_cache, v_cache, cur_len) for decode
    block_q: int = 512,
    block_kv: int = 512,
    long_seq_threshold: int = 8192,
    mesh=None,
    sp: bool = False,
):
    """Returns (out (B, S, d), new_cache).

    With a cache, the new token's K and V are written into ``k_cache``
    and ``v_cache`` in place (at ``cur_len``, clamped so the write fits,
    as ``dynamic_update_slice`` clamps), and those same tensors are
    returned as the new cache.  With ``sp`` x and out are this rank's
    rows of the sequence (``common.block_enter``)."""
    d = cfg.d_model
    dh = cfg.head_dim or d // cfg.num_heads
    h, hkv = effective_heads(cfg)
    scale = dh ** -0.5
    h_loc = params["wq"].shape[1]
    n_tp, r = model_shard(mesh, h, h_loc)
    kv_rep = n_tp > 1 and params["wk"].shape[1] == hkv
    p = params
    x = block_enter(x, mesh, sp, n_tp > 1)
    if n_tp > 1:
        # parameters every rank holds alike but uses on its own heads
        shared = ["wk", "wv", "bk", "bv"] if kv_rep else []
        p = dict(params, **{n: enter_rep(params[n], mesh, "model")
                            for n in shared if n in params})
        for n in ("q_norm", "k_norm"):
            if n in params:
                p[n] = {"scale": enter_rep(params[n]["scale"], mesh, "model")}

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if kv_rep:   # the KV heads this rank's query heads read
        lo, hi = kv_heads_read(h, hkv, h_loc, r)
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"])
        k = rms_norm(k, p["k_norm"]["scale"])
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    n_rep = q.shape[2] // k.shape[2]
    if cache is None:
        k_full = _repeat_kv(k, n_rep)
        v_full = _repeat_kv(v, n_rep)
        if x.shape[1] > long_seq_threshold:
            out = blockwise_causal_attention(
                q, k_full, v_full, scale=scale,
                block_q=block_q, block_kv=block_kv)
        else:
            out = full_causal_attention(q, k_full, v_full, scale=scale)
        new_cache = (k, v)  # pre-repeat KV (what a prefill would store)
    else:
        k_cache, v_cache, cur_len = cache
        s = x.shape[1]
        start = torch.clamp(cur_len.reshape(1).long(), max=k_cache.shape[1] - s)
        idx = start + torch.arange(s, device=x.device)
        k_cache.index_copy_(1, idx, k)
        v_cache.index_copy_(1, idx, v)
        out = decode_attention(q, k_cache, v_cache, cur_len + 1, scale=scale)
        new_cache = (k_cache, v_cache)

    if cfg.head_pad_factor > 1:
        # hard-mask padded heads: keeps the padded model exactly the original
        head_mask = (torch.arange(r * h_loc, (r + 1) * h_loc, device=x.device)
                     < cfg.num_heads).to(out.dtype)
        out = out * head_mask[None, None, :, None]
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return block_exit(out, mesh, sp, n_tp > 1), new_cache
