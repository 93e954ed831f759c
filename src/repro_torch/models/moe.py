"""Mixture-of-Experts layer, the counterpart of ``repro.models.moe``:
DBCSR's densification applied to tokens.

The token -> expert dispatch is a block-sparse (token x expert) product;
densification gathers each expert's tokens into one contiguous capacity
buffer, so the expert compute is a batch of dense GEMMs (``torch.bmm``,
as the JAX package computes them with ``jnp.einsum`` outside any Pallas
kernel).  The ``"blocked"`` local path runs the same buffer in token
blocks of ``block_c``, one small batch of GEMMs a block.

Routing is the JAX package's, exactly, because which tokens a full expert
drops depends on order: router logits in f32, sigmoid or softmax, top-k
with ties broken toward the lower expert index (``jax.lax.top_k``), gates
renormalised over the k, a *stable* sort rank of each (token, slot) in
its expert's queue, and ``valid = pos < capacity``.  Capacity ranking is
sort-based and never materialises the (T, E, C) one-hot dispatch tensor.

One card: the JAX package's ``shard_map`` over the expert axis collapses
to one shard (E_loc = E, shard index 0), its psums are identities, and
with one data shard ``moe_apply``'s partial-compute crossover is off
(``n_fsdp = 1``).  So the FSDP weight gathers and the activation-partial
path (``token_gathered``) are not ported: one card never runs them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..launch.mesh import P
from .common import ParamDef, act_fn

__all__ = ["moe_defs", "moe_apply", "route", "dispatch_slots"]


def moe_defs(cfg) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.moe_d_ff
    e = cfg.n_experts
    # moe_fsdp (DeepSeek-671B scale): expert weights additionally shard
    # dim 1 over the data axes, as in the JAX package
    fs = ("pod", "data") if cfg.moe_fsdp else None
    defs = {
        "router": ParamDef((d, e), "normal", spec=P(None, None)),
        "w_gate": ParamDef((e, d, f), spec=P("model", fs, None)),
        "w_up": ParamDef((e, d, f), spec=P("model", fs, None)),
        "w_down": ParamDef((e, f, d), spec=P("model", fs, None)),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        defs["shared"] = {
            "w_gate": ParamDef((d, fs), spec=P(None, "model")),
            "w_up": ParamDef((d, fs), spec=P(None, "model")),
            "w_down": ParamDef((fs, d), spec=P("model", None)),
        }
    return defs


def _capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # rounded up to 8, as the JAX package does


def _top_k(scores: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, equal values in ascending index order (a stable descending
    sort; ``torch.topk`` does not promise an order for ties)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _rank_within_expert(flat_eid: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each (token, slot) in its expert's queue, in (token,
    slot) order: a stable argsort over the expert ids and each expert's
    start in it (no (T*k, E) one-hot cumsum)."""
    tk = flat_eid.shape[0]
    order = torch.argsort(flat_eid, stable=True)
    sorted_eid = flat_eid[order]
    ar = torch.arange(tk, device=flat_eid.device)
    starts = torch.searchsorted(
        sorted_eid, torch.arange(n_experts, device=flat_eid.device,
                                 dtype=sorted_eid.dtype))
    rank_sorted = ar - starts[sorted_eid]
    pos = torch.empty_like(rank_sorted)
    pos[order] = rank_sorted
    return pos


def route(params: Dict, x: torch.Tensor, cfg):
    """x (T, d) -> (scores (T, E) f32, gate weights (T, k) f32, expert ids
    (T, k) int64)."""
    logits = x.float() @ params["router"].float()
    if cfg.router == "sigmoid":      # DeepSeek-V3 style
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    gate_w, eid = _top_k(scores, cfg.top_k)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return scores, gate_w, eid


def dispatch_slots(eid: torch.Tensor, n_experts: int, cap: int):
    """(slot, valid), both (T, k): the row of the flat (E * cap) capacity
    buffer each (token, slot) goes to, and whether it fits.  A dropped
    entry points at row E * cap, the scratch row past the buffer (the
    JAX package's out-of-range index, dropped by its scatter and read as
    0 by its gather)."""
    pos = _rank_within_expert(eid.reshape(-1), n_experts).reshape(eid.shape)
    valid = pos < cap
    slot = torch.where(valid, eid * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return slot, valid


def _expert_ffn(tokens, wg, wu, wd, act, out=None):
    """(E, C, d) -> (E, C, d), into ``out`` if given"""
    h = act(torch.bmm(tokens, wg.to(tokens.dtype)))
    h = h * torch.bmm(tokens, wu.to(tokens.dtype))
    return torch.bmm(h, wd.to(tokens.dtype), out=out)


def moe_local(params: Dict, x: torch.Tensor, cfg, *,
              local_path: str = "densified",
              block_c: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (out (T, d), aux loss, f32 scalar)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(t, cfg)
    act = act_fn(cfg.act)

    scores, gate_w, eid = route(params, x, cfg)
    slot, valid = dispatch_slots(eid, e, cap)

    # densify: one scatter per top-k slot into the capacity buffer plus
    # its scratch row (a (T, d) write per slot, never a (T*k, d) tensor)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    for kk in range(k):
        buf.index_copy_(0, slot[:, kk], x)
    buf = buf[:-1].view(e, cap, d)

    # the experts' outputs, in a buffer whose scratch row reads 0.
    # DBCSR's 'blocked' regime runs the capacity buffer in token blocks,
    # each block a separate batch of small GEMMs
    if local_path == "blocked":
        if cap % block_c:
            raise ValueError(f"capacity {cap} is no multiple of block_c "
                             f"{block_c}")
    elif local_path != "densified":
        raise ValueError(local_path)
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wg, wu, wd)):
        # training: autograd refuses out=, so the blocks are concatenated
        # and the zero scratch row is padded on
        step = block_c if local_path == "blocked" else cap
        y = torch.cat([_expert_ffn(buf[:, i:i + step], wg, wu, wd, act)
                       for i in range(0, cap, step)], dim=1)
        flat = torch.nn.functional.pad(y.reshape(e * cap, d), (0, 0, 0, 1))
    else:
        flat = torch.empty((e * cap + 1, d), dtype=x.dtype, device=x.device)
        flat[-1] = 0
        buf_out = flat[:-1].view(e, cap, d)
        if local_path == "densified":
            _expert_ffn(buf, wg, wu, wd, act, out=buf_out)
        else:
            for i in range(0, cap, block_c):
                buf_out[:, i:i + block_c] = _expert_ffn(
                    buf[:, i:i + block_c], wg, wu, wd, act)
    del buf

    # combine: gather back (the scratch row reads 0), weight, sum the k
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for kk in range(k):
        w_ = (gate_w[:, kk] * valid[:, kk]).to(out.dtype)
        out = out + flat.index_select(0, slot[:, kk]) * w_[:, None]

    if cfg.n_shared_experts:
        sh = params["shared"]
        g = x @ sh["w_gate"].to(x.dtype)
        u = x @ sh["w_up"].to(x.dtype)
        out = out + (act(g) * u) @ sh["w_down"].to(x.dtype)

    # Switch-style load-balancing loss
    me = torch.nn.functional.one_hot(eid[:, 0], e).float().mean(0)
    ce = scores.mean(0)
    aux = e * (me * ce).sum()
    return out, aux


def moe_apply(params: Dict, x: torch.Tensor, cfg, *,
              local_path: str = "densified",
              block_c: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole MoE layer: x (B, S, d) -> (out (B, S, d), aux loss)."""
    b, s, d = x.shape
    out, aux = moe_local(params, x.reshape(b * s, d), cfg,
                         local_path=local_path, block_c=block_c)
    return out.reshape(b, s, d), aux
