"""Multi-head Latent Attention (DeepSeek-V2/V3), the counterpart of
``repro.models.mla``.

MLA compresses the KV stream into a small latent: per token the cache
holds kv_lora_rank + qk_rope_dim values (512 + 64 = 576 for DeepSeek-V3)
instead of 2 * H * Dh.

Two paths, as in the JAX package:
  * prefill: expand the latent into per-head K_nope and V and run the
    port's causal attention (full, or blockwise past
    ``long_seq_threshold``), with V zero-padded to the Q/K head size and
    sliced back;
  * decode: the *absorbed* form.  wk_b's K half folds into the query (a
    query in latent space), scores are taken against the latent cache in
    f32, and the attention-weighted sum stays in latent space until the
    V half expands it for the one new token.  The new token's latent and
    rope key are written into the caches in place at the device-resident
    ``cur_len`` (``index_copy_``), so a decode step never waits for the
    host.  MLA does not use the decode_attention kernel, in the JAX
    package or here.

On a mesh the heads are local to their ``model`` shard (``wq_b``,
``wk_b``, ``wv_b`` and ``wo`` cut on the head dim); the latent
projections, their norms and the latent caches are every rank's alike,
and ``wo``'s product is summed over ``model``.  With the sequence-
parallel residual the latent projections run on this rank's rows, and
the latents enter the head-local part (``common.block_enter``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..launch.mesh import P, cut_rep
from .attention import (NEG_INF, _einsum_f32, blockwise_causal_attention,
                        full_causal_attention)
from .common import (ParamDef, apply_rope, block_enter, block_exit,
                     model_shard, rms_norm, sp_rep)

__all__ = ["mla_defs", "mla_apply"]


def mla_defs(cfg) -> Dict[str, ParamDef]:
    d = cfg.d_model
    h = cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": ParamDef((d, qr), spec=P(None, None)),
        "q_a_norm": {"scale": ParamDef((qr,), "ones", spec=P(None))},
        "wq_b": ParamDef((qr, h, dn + dr), spec=P(None, "model", None)),
        "wkv_a": ParamDef((d, kvr + dr), spec=P(None, None)),
        "kv_a_norm": {"scale": ParamDef((kvr,), "ones", spec=P(None))},
        "wk_b": ParamDef((kvr, h, dn), spec=P(None, "model", None)),
        "wv_b": ParamDef((kvr, h, dv), spec=P(None, "model", None)),
        "wo": ParamDef((h, dv, d), spec=P("model", None, None)),
    }


def _project_q(params, x, positions, cfg, mesh=None, sp=False, tp=False):
    dn = cfg.qk_nope_dim
    q_lat = x @ params["wq_a"].to(x.dtype)
    q_lat = block_enter(rms_norm(q_lat, params["q_a_norm"]["scale"]), mesh,
                        sp, tp)
    q = torch.einsum("bsr,rhk->bshk", q_lat, params["wq_b"].to(x.dtype))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _project_kv_latent(params, x, positions, cfg):
    kvr = cfg.kv_lora_rank
    kv = x @ params["wkv_a"].to(x.dtype)
    c_kv, k_rope = kv[..., :kvr], kv[..., kvr:]
    c_kv = rms_norm(c_kv, params["kv_a_norm"]["scale"])
    # the rope part is a single shared "head"
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_apply(
    params: Dict,
    x: torch.Tensor,                 # (B, S, d)
    positions: torch.Tensor,         # (B, S)
    cfg,
    *,
    cache: Optional[Tuple] = None,   # (c_kv_cache, k_rope_cache, cur_len)
    block_q: int = 512,
    block_kv: int = 512,
    long_seq_threshold: int = 8192,
    mesh=None,
    sp: bool = False,
):
    """Returns (out (B, S, d), new_cache).  Prefill returns the latents it
    would cache, (c_kv (B, S, kvr), k_rope (B, S, dr)); decode writes them
    into the caches in place and returns those same tensors.  With ``sp``
    x and out are this rank's rows of the sequence."""
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    scale = (dn + dr) ** -0.5
    n_tp, _ = model_shard(mesh, cfg.num_heads, params["wq_b"].shape[1])
    tp = n_tp > 1      # the latents enter the head-local part
    # the latent projections run on the rows x holds
    params = dict(params, **sp_rep(
        {n: params[n] for n in ("wq_a", "q_a_norm", "wkv_a", "kv_a_norm")},
        mesh, sp))
    rows = cut_rep(positions, mesh, "model", axis=1) if sp else positions

    q_nope, q_rope = _project_q(params, x, positions, cfg, mesh, sp, tp)
    c_kv, k_rope = _project_kv_latent(params, x, rows, cfg)
    # the caches keep the latents as every rank computes them
    cache_kv, cache_rope = c_kv, k_rope
    c_kv = block_enter(c_kv, mesh, sp, tp)
    k_rope = block_enter(k_rope, mesh, sp, tp)

    if cache is None:
        # expanded path
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["wk_b"].to(x.dtype))
        v = torch.einsum("bsr,rhk->bshk", c_kv, params["wv_b"].to(x.dtype))
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            *k_nope.shape[:3], dr)], dim=-1)
        # V's head dim padded to Q/K's so one attention serves both
        v = F.pad(v, (0, dn + dr - dv))
        if q.shape[1] > long_seq_threshold:
            out = blockwise_causal_attention(q, k, v, scale=scale,
                                             block_q=block_q,
                                             block_kv=block_kv)
        else:
            out = full_causal_attention(q, k, v, scale=scale)
        out = out[..., :dv]
        new_cache = (cache_kv, cache_rope)
    else:
        # absorbed decode: scores and reads stay in latent space
        c_cache, r_cache, cur_len = cache
        s = x.shape[1]
        start = torch.clamp(cur_len.reshape(1).long(), max=c_cache.shape[1] - s)
        idx = start + torch.arange(s, device=x.device)
        c_cache.index_copy_(1, idx, c_kv)
        r_cache.index_copy_(1, idx, k_rope)
        # wk_b absorbed into q: q_lat (B, S, H, kvr)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope,
                             params["wk_b"].to(x.dtype))
        scores = (_einsum_f32("bshr,bkr->bhsk", q_lat, c_cache)
                  + _einsum_f32("bshr,bkr->bhsk", q_rope, r_cache)) * scale
        valid = (torch.arange(c_cache.shape[1], device=x.device)
                 < (cur_len.reshape(1) + 1))
        scores = torch.where(valid[None, None, None], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1).to(x.dtype)
        attn_lat = torch.einsum("bhsk,bkr->bshr", p, c_cache)
        out = torch.einsum("bshr,rhk->bshk", attn_lat,
                           params["wv_b"].to(x.dtype))
        new_cache = (c_cache, r_cache)

    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return block_exit(out, mesh, sp, tp), new_cache
