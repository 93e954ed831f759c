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

On a mesh, ``moe_apply`` is the JAX package's ``shard_map`` island
written out with explicit collectives: each ``model`` rank holds
E_loc = E / model experts (shard index ``index("model")``), dispatches
its data shard's tokens to them locally and the outputs are summed over
``model``; the router loss is averaged over ``model`` and then over the
data shards.  ``moe_fsdp`` experts are also cut on dim 1 over the data
axes: either gathered for the layer (their backward reduce-scatters the
gradients), or, where the step's tokens are few (``_use_partial``, the
JAX package's crossover exactly), left cut: the tokens are gathered
instead, each rank contracts its slice of d (and then of f), and the
output is summed over ``model`` and scattered back over the data axes.
A batch the data axes do not divide stays whole on every rank.  As
``shard_map``'s transpose does, the cotangents of what enters the island
alike on every ``model`` rank (the tokens, the router) are summed over
``model`` (``enter_rep``).  With the sequence-parallel residual the
layer takes and returns this rank's rows of the sequence: its tokens
are all-gathered over ``model`` on entry and its output, the sum over
``model``, is reduce-scattered back to the rows (``common.block_enter``,
``block_exit``), on every path (the partial path's sum over the data
axes follows, as without the cut).

One departure: the JAX package's partial path adds the shared experts
inside the island, before its psum over the data axes, so their output
is counted once a data shard (ROADMAP Queue C); here each data shard
adds them for its own tokens only, so both paths compute the layer.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..launch.mesh import (P, all_gather_ad, axis_size, enter_rep, psum_ad,
                           psum_rep, psum_scatter_ad)
from .common import ParamDef, act_fn, block_enter, block_exit, model_shard

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


def dispatch_slots(eid: torch.Tensor, n_experts: int, cap: int,
                   first: int = 0, n_local: int | None = None):
    """(slot, valid), both (T, k): the row of the flat (E_loc * cap)
    capacity buffer of experts ``first .. first + n_local`` (default:
    all E) each (token, slot) goes to, and whether it is one of them and
    fits.  Any other entry points at row E_loc * cap, the scratch row
    past the buffer (the JAX package's out-of-range index, dropped by its
    scatter and read as 0 by its gather)."""
    n_local = n_experts if n_local is None else n_local
    pos = _rank_within_expert(eid.reshape(-1), n_experts).reshape(eid.shape)
    local = eid - first
    valid = (pos < cap) & (local >= 0) & (local < n_local)
    slot = torch.where(valid, local * cap + pos,
                       torch.full_like(pos, n_local * cap))
    return slot, valid


def _expert_ffn(tokens, wg, wu, wd, act, out=None):
    """(E, C, d) -> (E, C, d), into ``out`` if given"""
    h = act(torch.bmm(tokens, wg.to(tokens.dtype)))
    h = h * torch.bmm(tokens, wu.to(tokens.dtype))
    return torch.bmm(h, wd.to(tokens.dtype), out=out)


def moe_local(params: Dict, x: torch.Tensor, cfg, *,
              local_path: str = "densified",
              block_c: int = 64, mesh=None, fsdp=(),
              partial: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (out (T, d), aux loss, f32 scalar).  On a mesh, out is
    this rank's part (its experts; with ``partial``, its slices of d and
    f too; the shared experts are the caller's there) and the caller
    sums it; ``fsdp`` names the data axes that cut the experts' dim 1."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = params["w_gate"].shape[0]
    _, m = model_shard(mesh, e, e_loc)
    cap = _capacity(t, cfg)
    act = act_fn(cfg.act)

    scores, gate_w, eid = route(params, x, cfg)
    slot, valid = dispatch_slots(eid, e, cap, m * e_loc, e_loc)

    # densify: one scatter per top-k slot into the capacity buffer plus
    # its scratch row (a (T, d) write per slot, never a (T*k, d) tensor)
    buf = torch.zeros((e_loc * cap + 1, d), dtype=x.dtype, device=x.device)
    for kk in range(k):
        buf.index_copy_(0, slot[:, kk], x)
    buf = buf[:-1].view(e_loc, cap, d)

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
    cut = bool(fsdp) and wg.shape[1] != d
    if cut and not partial:
        # weight-gathered FSDP: dim 1 is stored cut over the data axes;
        # gather it for this layer (the backward reduce-scatters)
        wg, wu, wd = (all_gather_ad(w, mesh, fsdp, axis=1)
                      for w in (wg, wu, wd))
    ffn = _expert_ffn
    if partial:
        if not cut:
            raise ValueError("the partial path needs experts cut over "
                             f"{fsdp}")
        ffn = _partial_ffn(mesh, fsdp)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wg, wu, wd)):
        # training: autograd refuses out=, so the blocks are concatenated
        # and the zero scratch row is padded on
        step = block_c if local_path == "blocked" else cap
        y = torch.cat([ffn(buf[:, i:i + step], wg, wu, wd, act)
                       for i in range(0, cap, step)], dim=1)
        flat = torch.nn.functional.pad(y.reshape(e_loc * cap, d),
                                       (0, 0, 0, 1))
    else:
        flat = torch.empty((e_loc * cap + 1, d), dtype=x.dtype,
                           device=x.device)
        flat[-1] = 0
        buf_out = flat[:-1].view(e_loc, cap, d)
        if local_path == "densified":
            ffn(buf, wg, wu, wd, act, out=buf_out)
        else:
            for i in range(0, cap, block_c):
                buf_out[:, i:i + block_c] = ffn(
                    buf[:, i:i + block_c], wg, wu, wd, act)
    del buf

    # combine: gather back (the scratch row reads 0), weight, sum the k
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for kk in range(k):
        w_ = (gate_w[:, kk] * valid[:, kk]).to(out.dtype)
        out = out + flat.index_select(0, slot[:, kk]) * w_[:, None]

    if cfg.n_shared_experts and not partial:
        out = out + _shared(params["shared"], x, act)

    # Switch-style load-balancing loss
    me = torch.nn.functional.one_hot(eid[:, 0], e).float().mean(0)
    ce = scores.mean(0)
    aux = e * (me * ce).sum()
    return out, aux


def _shared(sh: Dict, x: torch.Tensor, act) -> torch.Tensor:
    g = x @ sh["w_gate"].to(x.dtype)
    u = x @ sh["w_up"].to(x.dtype)
    return (act(g) * u) @ sh["w_down"].to(x.dtype)


def _partial_ffn(mesh, fsdp):
    """The expert FFN of the partial path: the weights stay cut over the
    data axes ``fsdp`` (w_gate and w_up on d, w_down on f); each rank
    contracts its slice of d, the (E_loc, C, f) products are summed over
    ``fsdp``, and its slice of f gives a part of the output that the
    caller sums."""
    n, ix = axis_size(mesh, fsdp), mesh.index(fsdp)

    def ffn(tokens, wg, wu, wd, act, out=None):
        dsl = wg.shape[1]
        tok = tokens[..., ix * dsl:(ix + 1) * dsl]
        g = psum_ad(torch.bmm(tok, wg.to(tokens.dtype)), mesh, fsdp)
        u = psum_ad(torch.bmm(tok, wu.to(tokens.dtype)), mesh, fsdp)
        h = act(g) * u
        fsl = h.shape[-1] // n
        return torch.bmm(h[..., ix * fsl:(ix + 1) * fsl], wd.to(tokens.dtype),
                         out=out)

    return ffn


def _use_partial(cfg, t_all: int, e_loc: int, n_fsdp: int) -> bool:
    """The JAX package's crossover: move the step's tokens (T_all x d)
    instead of gathering the experts' weights (3 x E_loc x d x f) when
    ``T_all * 8 < 3 * E_loc * moe_d_ff``."""
    return bool(cfg.moe_fsdp and cfg.moe_small_t_partial and n_fsdp > 1
                and t_all * 8 < 3 * e_loc * cfg.moe_d_ff)


def moe_path(cfg, mesh, batch: int, seq: int) -> str:
    """Which of the layer's paths a global (batch, seq) step takes on
    ``mesh``: "local" (experts whole on their rank), "gather" (FSDP
    weight gathers) or "partial"."""
    fsdp = _fsdp_axes(cfg, mesh)
    e_loc = cfg.n_experts // axis_size(mesh, "model")
    if _use_partial(cfg, batch * seq, e_loc, axis_size(mesh, fsdp)):
        return "partial"
    return "gather" if axis_size(mesh, fsdp) > 1 else "local"


def _fsdp_axes(cfg, mesh) -> tuple:
    if mesh is None or not cfg.moe_fsdp:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def moe_apply(params: Dict, x: torch.Tensor, cfg, *,
              local_path: str = "densified", block_c: int = 64,
              mesh=None, dp=(), sp: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole MoE layer: x (B, S, d) -> (out (B, S, d), aux loss).
    On a mesh, x is this rank's data shard (``dp``, the data axes that
    cut the batch; () where every rank holds it whole), and with ``sp``
    x and out are this rank's rows of the sequence."""
    if mesh is None or mesh.n_ranks == 1:
        b, s, d = x.shape
        out, aux = moe_local(params, x.reshape(b * s, d), cfg,
                             local_path=local_path, block_c=block_c)
        return out.reshape(b, s, d), aux
    # the tokens enter whole on every model rank: their cotangent is
    # summed over it
    x = block_enter(x, mesh, sp)
    b, s, d = x.shape
    fsdp = _fsdp_axes(cfg, mesh)
    if params["w_gate"].shape[1] == d:
        fsdp = ()      # dim 1 left whole (its spec resolved away)
    n_tp = axis_size(mesh, "model")
    e_loc = params["w_gate"].shape[0]
    t_all = b * s * axis_size(mesh, dp)
    partial = _use_partial(cfg, t_all, e_loc, axis_size(mesh, fsdp))
    xt = x.reshape(b * s, d)
    p = dict(params, router=enter_rep(params["router"], mesh, "model"))
    kw = dict(local_path=local_path, block_c=block_c, mesh=mesh, fsdp=fsdp)
    if not partial:
        out, aux = moe_local(p, xt, cfg, **kw)
        out = block_exit(out.reshape(b, s, d), mesh, sp)
    else:
        act = act_fn(cfg.act)
        tok = all_gather_ad(xt, mesh, dp, axis=0) if dp else xt
        out, aux = moe_local(p, tok, cfg, partial=True, **kw)
        if cfg.n_shared_experts:
            sh = _shared(p["shared"], xt, act)
            if dp:     # this data shard's tokens only
                ix = mesh.index(dp)
                rows = torch.arange(ix * b * s, (ix + 1) * b * s,
                                    device=x.device)
                out = out.index_add(0, rows, sh)
            elif mesh.index(fsdp) == 0:
                out = out + sh
        # every data shard's tokens, (n_dp * B, S, d): summed over model
        # (and cut to the rows under sp), then over the data axes
        out = block_exit(out.reshape(-1, s, d), mesh, sp)
        if dp:
            out = psum_scatter_ad(out, mesh, dp, axis=0)
        else:
            out = psum_rep(out, mesh, fsdp)
    aux = psum_rep(aux, mesh, "model") / n_tp
    if dp:
        aux = psum_rep(aux, mesh, dp) / axis_size(mesh, dp)
    return out, aux
