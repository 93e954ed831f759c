"""RWKV-6 "Finch" mixer (attention-free, data-dependent decay), the
counterpart of ``repro.models.rwkv6``.

Time mix: a token shift with data-dependent (LoRA) interpolation feeds
the r / k / v / gate / decay projections; per head the WKV state runs
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
with w_t = exp(-exp(w_base + lora(x))) per channel, then a per-head
group norm (eps 64e-5) in f32.  The recurrence is a Python loop over the
sequence (the JAX package's ``lax.scan`` over time), its state in f32.

Channel mix: squared-ReLU MLP with token shift and a receptance gate.

Decode carries (time-mix shift, WKV state) and the channel-mix shift in
the serve cache; each function writes its part in place when given a
cache.

On a mesh the time mix is cut by heads over ``model``, by the JAX
package's specs: every rank computes the token shift, the five-stream
LoRA lerp and the decay (whose ``w_lora_b`` is replicated) alike and
keeps its own heads' channels of the decay; ``wr``, ``wk``, ``wv``,
``wg``, ``u`` and ``ln_x`` are its heads', the recurrence and the group
norm run on them, and ``wo``, cut on its rows, ends the block with one
``psum_rep``.  The input and the replicated parameters enter the block
through ``enter_rep`` (each rank's use of them covers its own heads).
The WKV state is cut on heads, the shift state whole.  The channel mix
is cut on ``d_ff``: ``wk``'s columns and ``wv``'s rows, one
``psum_rep``; the receptance (``wr``, replicated) and the shift state
stay whole.

With the sequence-parallel residual both take and return this rank's
rows of the sequence (``common.block_enter`` / ``block_exit``).  The time
mix gathers the rows first and shifts the whole sequence.  The channel
mix shifts, lerps and gates on its own rows: its shift state is the
previous rank's last row (an all-gather of each rank's last row over
``model``; zeros on the first rank), its lerp and receptance parameters
pass ``sp_rep``, and the rows enter the ``d_ff``-cut product.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..launch.mesh import P, all_gather_ad, enter_rep
from .common import ParamDef, block_enter, block_exit, model_shard, sp_rep

__all__ = ["rwkv6_defs", "rwkv6_time_mix", "rwkv6_channel_mix"]

_LORA_R = 32
_DECAY_R = 64


def rwkv6_defs(cfg) -> Dict[str, ParamDef]:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    h = d // hs
    return {
        "tm": {
            # base lerp coefficients for the (w, k, v, r, g) shifts
            "mix_base": ParamDef((5, d), "zeros", spec=P(None, None)),
            "mix_lora_a": ParamDef((d, 5 * _LORA_R), spec=P(None, None)),
            "mix_lora_b": ParamDef((5, _LORA_R, d), "zeros",
                                  spec=P(None, None, None)),
            "w_base": ParamDef((d,), "zeros", spec=P(None)),
            "w_lora_a": ParamDef((d, _DECAY_R), spec=P(None, None)),
            "w_lora_b": ParamDef((_DECAY_R, d), "zeros", spec=P(None, None)),
            "u": ParamDef((h, hs), "zeros", spec=P("model", None)),
            "wr": ParamDef((d, h, hs), spec=P(None, "model", None)),
            "wk": ParamDef((d, h, hs), spec=P(None, "model", None)),
            "wv": ParamDef((d, h, hs), spec=P(None, "model", None)),
            "wg": ParamDef((d, h, hs), spec=P(None, "model", None)),
            "ln_x": {"scale": ParamDef((h, hs), "ones",
                                       spec=P("model", None)),
                     "bias": ParamDef((h, hs), "zeros",
                                      spec=P("model", None))},
            "wo": ParamDef((h, hs, d), spec=P("model", None, None)),
        },
        "cm": {
            "mix_k": ParamDef((d,), "zeros", spec=P(None)),
            "mix_r": ParamDef((d,), "zeros", spec=P(None)),
            "wk": ParamDef((d, cfg.d_ff), spec=P(None, "model")),
            "wr": ParamDef((d, d), spec=P(None, None)),
            "wv": ParamDef((cfg.d_ff, d), spec=P("model", None)),
        },
    }


def _token_shift(x, shift_state):
    """x (B, S, d) -> the previous-token stream; shift_state (B, d) is
    x_{-1}."""
    return torch.cat([shift_state[:, None], x[:, :-1]], dim=1)


def _previous_rank_row(x, mesh):
    """(B, d): the row before this rank's first of the sequence-parallel
    residual, the previous ``model`` rank's last (zeros on the first).
    Every rank takes part in the gather and in its backward."""
    last = all_gather_ad(x[:, -1:], mesh, "model", axis=1)   # (B, model, d)
    r = mesh.index("model")
    return last[:, r - 1] * (1.0 if r > 0 else 0.0)


def rwkv6_time_mix(
    params: Dict,
    x: torch.Tensor,                   # (B, S, d)
    cfg,
    *,
    cache: Optional[Tuple] = None,     # (shift_state (B,d), wkv_state (B,H,hs,hs))
    mesh=None,
    sp: bool = False,
):
    """Returns (out (B, S, d), (shift, wkv_state)): the cache's tensors,
    written in place, when one is given.  On a mesh H is this rank's
    heads (see the module's docstring); with ``sp`` x and out are this
    rank's rows."""
    p = params["tm"]
    hs = cfg.rwkv_head_size
    h_loc = p["wr"].shape[1]
    n_tp, rank = model_shard(mesh, x.shape[-1] // hs, h_loc)
    x = block_enter(x, mesh, sp, n_tp > 1)
    bsz, s, d = x.shape
    if n_tp > 1:
        p = dict(p, **{n: enter_rep(p[n], mesh, "model") for n in (
            "mix_base", "mix_lora_a", "mix_lora_b", "w_base", "w_lora_a",
            "w_lora_b")})

    shift_state = (cache[0] if cache is not None
                   else torch.zeros((bsz, d), dtype=x.dtype, device=x.device))
    prev = _token_shift(x, shift_state)
    dx = prev - x

    # data-dependent lerp (LoRA over the 5 mix streams)
    lora = torch.tanh((x + dx * p["mix_base"][0])
                      @ p["mix_lora_a"].to(x.dtype))
    lora = lora.reshape(bsz, s, 5, _LORA_R)
    delta = torch.einsum("bsfr,frd->bsfd", lora, p["mix_lora_b"].to(x.dtype))
    mix = p["mix_base"].to(x.dtype)[None, None] + delta    # (B, S, 5, d)
    xw, xk, xv, xr, xg = (x + dx * mix[:, :, i] for i in range(5))

    # decay (per channel, data dependent)
    w = p["w_base"].float() + (
        torch.tanh(xw @ p["w_lora_a"].to(x.dtype)).float()
        @ p["w_lora_b"].float())
    w = torch.exp(-torch.exp(w))                            # (B, S, d) in (0, 1)
    if n_tp > 1:   # this rank's heads' channels
        w = w[..., rank * h_loc * hs:(rank + 1) * h_loc * hs]

    def heads(xs, wt):
        return torch.einsum("bsd,dhk->bshk", xs, wt.to(x.dtype))

    r, k, v = heads(xr, p["wr"]), heads(xk, p["wk"]), heads(xv, p["wv"])
    g = F.silu(heads(xg, p["wg"]))
    w = w.reshape(bsz, s, h_loc, hs)
    u = p["u"].float()

    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    state = (cache[1].float() if cache is not None
             else torch.zeros((bsz, h_loc, hs, hs), dtype=torch.float32,
                              device=x.device))
    ys = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # (B, H, hs, hs)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t],
                               state + u[..., :, None] * kv))
        state = wf[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1)                               # (B, S, H, hs)

    # per-head group norm
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, unbiased=False, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y * p["ln_x"]["scale"].float() + p["ln_x"]["bias"].float()
    y = y.to(x.dtype) * g
    out = block_exit(torch.einsum("bshk,hkd->bsd", y, p["wo"].to(x.dtype)),
                     mesh, sp, n_tp > 1)
    if cache is None:
        return out, (x[:, -1], state)
    cache[0].copy_(x[:, -1])
    cache[1].copy_(state)
    return out, (cache[0], cache[1])


def rwkv6_channel_mix(
    params: Dict,
    x: torch.Tensor,
    cfg,
    *,
    cache: Optional[torch.Tensor] = None,   # shift state (B, d)
    mesh=None,
    sp: bool = False,
):
    """Returns (out (B, S, d), shift): the cache, written in place, when
    one is given.  On a mesh ``d_ff`` is this rank's share; with ``sp``
    x and out are this rank's rows (see the module's docstring)."""
    p = params["cm"]
    bsz, s, d = x.shape
    if sp:
        shift_state = _previous_rank_row(x, mesh)
        p = dict(p, **sp_rep({n: p[n] for n in ("mix_k", "mix_r", "wr")},
                             mesh, sp))
    elif cache is not None:
        shift_state = cache
    else:
        shift_state = torch.zeros((bsz, d), dtype=x.dtype, device=x.device)
    prev = _token_shift(x, shift_state)
    dx = prev - x
    xk = x + dx * p["mix_k"].to(x.dtype)
    xr = x + dx * p["mix_r"].to(x.dtype)
    tp = p["wk"].shape[1] != cfg.d_ff
    xk = block_enter(xk, mesh, sp, tp)
    k = torch.square(F.relu(xk @ p["wk"].to(x.dtype)))
    kv = block_exit(k @ p["wv"].to(x.dtype), mesh, sp, tp)
    r = torch.sigmoid(xr @ p["wr"].to(x.dtype))
    if cache is None:
        return r * kv, x[:, -1]
    cache.copy_(x[:, -1])
    return r * kv, cache
