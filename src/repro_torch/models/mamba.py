"""Mamba (selective SSM) mixer for the Jamba hybrid, the counterpart of
``repro.models.mamba``.

Prefill runs a chunked parallel scan: the sequence is cut into chunks of
``chunk`` steps; within a chunk an inclusive scan of the recurrence's
(decay, input) pairs under the JAX package's ``combine`` gives every
step's state (a Hillis-Steele scan: log2(chunk) whole-tensor steps, where
the JAX package calls ``jax.lax.associative_scan``), and a Python loop
over the chunks carries the state between them (the JAX package's
``lax.scan``).  A ragged last chunk is padded with steps of decay 1 and
input 0, which leave the state as it is.

Decode is the O(1) recurrent step.  Its state is the cache pair
(conv_state (B, k-1, D) in the model dtype, ssm_state (B, D, N) in f32),
both written in place.

On a mesh the inner width D is cut over ``model`` by the JAX package's
specs: the depthwise conv, ``dt_proj``, ``dt_bias``, ``a_log``,
``d_skip``, the scan and both cache states are local to a rank's share
of D.  ``x_proj`` is cut on the D it contracts, so its output (dt's low
rank, B and C) is a partial sum, summed over ``model`` (``psum_ad``:
each rank uses the sum on its own channels); ``out_proj`` is cut on its
rows and ends the block with one ``psum_rep``.  ``in_proj`` keeps the
JAX package's layout, ``(d, 2 D)`` cut on its columns as one leaf, so a
rank's columns are not its share of u and z (on 2 ranks one holds all
of u, the other all of z, where GSPMD reshards after the split): each
rank projects onto its columns and the projection is all-gathered over
``model`` (``all_gather_ad``, whose backward is a reduce-scatter), from
which a rank takes its share of u and of z.  With the sequence-parallel
residual the block takes and returns this rank's rows of the sequence
(``common.block_enter`` / ``block_exit``): the conv and the scan run on
the whole sequence after the gather.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..launch.mesh import P, all_gather_ad, psum_ad
from .common import ParamDef, block_enter, block_exit, model_shard

__all__ = ["mamba_defs", "mamba_apply"]


def _dims(cfg):
    d_in = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return d_in, dt_rank, cfg.mamba_d_state, cfg.mamba_conv


def mamba_defs(cfg) -> Dict[str, ParamDef]:
    d = cfg.d_model
    d_in, dt_rank, n, k = _dims(cfg)
    return {
        "in_proj": ParamDef((d, 2 * d_in), spec=P(None, "model")),
        "conv_w": ParamDef((k, d_in), spec=P(None, "model")),
        "conv_b": ParamDef((d_in,), "zeros", spec=P("model")),
        "x_proj": ParamDef((d_in, dt_rank + 2 * n), spec=P("model", None)),
        "dt_proj": ParamDef((dt_rank, d_in), spec=P(None, "model")),
        "dt_bias": ParamDef((d_in,), "zeros", spec=P("model")),
        "a_log": ParamDef((d_in, n), "ones", spec=P("model", None)),
        "d_skip": ParamDef((d_in,), "ones", spec=P("model")),
        "out_proj": ParamDef((d_in, d), spec=P("model", None)),
    }


def _scan(decay: torch.Tensor, inp: torch.Tensor):
    """Inclusive scan along dim 1 of (decay, input) pairs under
    combine((d1, s1), (d2, s2)) = (d1 d2, s1 d2 + s2), the earlier pair
    first: (cumulative decay, state from a zero start) at every step."""
    n = decay.shape[1]
    off = 1
    while off < n:
        decay, inp = (
            torch.cat([decay[:, :off], decay[:, :-off] * decay[:, off:]], 1),
            torch.cat([inp[:, :off], inp[:, :-off] * decay[:, off:]
                       + inp[:, off:]], 1))
        off *= 2
    return decay, inp


def _ssm_chunked(u, dt, a, b, c, *, chunk: int):
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t ;  y_t = C_t . h_t

    u, dt: (B, T, D); a: (D, N); b, c: (B, T, N).  Returns y (B, T, D)
    and the final state (B, D, N)."""
    bsz, t, dd = u.shape
    n = a.shape[1]
    chunk = min(chunk, t)
    t_orig = t
    if t % chunk:
        pad = chunk - t % chunk
        u, dt, b, c = (F.pad(z, (0, 0, 0, pad)) for z in (u, dt, b, c))
        t += pad
    h0 = torch.zeros((bsz, dd, n), dtype=u.dtype, device=u.device)
    ys = []
    for i in range(0, t, chunk):
        u_c, dt_c, b_c, c_c = (z[:, i:i + chunk] for z in (u, dt, b, c))
        decay = torch.exp(dt_c[..., None] * a)            # (B, chunk, D, N)
        inp = (dt_c * u_c)[..., None] * b_c[:, :, None, :]
        dec_cum, s_cum = _scan(decay, inp)
        h = dec_cum * h0[:, None] + s_cum                 # (B, chunk, D, N)
        ys.append(torch.einsum("btdn,btn->btd", h, c_c))
        h0 = h[:, -1]
    return torch.cat(ys, dim=1)[:, :t_orig], h0


def mamba_apply(
    params: Dict,
    x: torch.Tensor,                 # (B, S, d)
    cfg,
    *,
    cache: Optional[Tuple] = None,   # (conv_state (B,k-1,D), ssm_state (B,D,N))
    chunk: int = 128,
    mesh=None,
    sp: bool = False,
):
    """Returns (out (B, S, d), new_cache).  Prefill returns the states it
    would cache; decode writes them into ``cache`` in place and returns
    those same tensors.  On a mesh, D is this rank's share (see the
    module's docstring); with ``sp`` x and out are this rank's rows."""
    d_in, dt_rank, n, k = _dims(cfg)
    compute_dtype = x.dtype
    n_tp, r = model_shard(mesh, d_in, params["d_skip"].shape[0])
    cut_in = params["in_proj"].shape[1] != 2 * d_in
    if cut_in and n_tp == 1:
        raise ValueError(f"in_proj's {2 * d_in} columns are cut over 'model' "
                         f"and d_inner {d_in} is not")
    x = block_enter(x, mesh, sp, n_tp > 1)
    bsz, s, d = x.shape

    xz = x @ params["in_proj"].to(x.dtype)
    if cut_in:     # every rank's columns, then this rank's u and z
        xz = all_gather_ad(xz, mesh, "model", axis=xz.ndim - 1)
    u, z = xz.chunk(2, dim=-1)                 # (B, S, D) each
    if n_tp > 1:
        loc = d_in // n_tp
        u, z = u[..., r * loc:(r + 1) * loc], z[..., r * loc:(r + 1) * loc]

    conv_w = params["conv_w"].to(x.dtype)      # (k, D)
    if cache is None:
        u_pad = F.pad(u, (0, 0, k - 1, 0))
        conv_out = sum(u_pad[:, i:i + s] * conv_w[i] for i in range(k)) \
            + params["conv_b"].to(x.dtype)
        new_conv_state = u_pad[:, -(k - 1):] if k > 1 else None
    else:
        conv_state, ssm_state = cache
        window = torch.cat([conv_state.to(x.dtype), u], dim=1)
        conv_out = torch.einsum("bkd,kd->bd", window, conv_w)[:, None]
        conv_out = conv_out + params["conv_b"].to(x.dtype)
        conv_state.copy_(window[:, 1:])
    u = F.silu(conv_out)

    proj = u @ params["x_proj"].to(x.dtype)
    if n_tp > 1:   # x_proj contracts this rank's share of D
        proj = psum_ad(proj, mesh, "model")
    dt_lr, b_t, c_t = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = dt_lr @ params["dt_proj"].to(x.dtype)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())    # (D, N)

    if cache is None:
        y, h_last = _ssm_chunked(u.float(), dt, a, b_t.float(), c_t.float(),
                                 chunk=chunk)
        new_cache = (new_conv_state, h_last)
    else:
        decay = torch.exp(dt[:, 0, :, None] * a)             # (B, D, N)
        h = ssm_state * decay + (dt[:, 0] * u[:, 0].float())[..., None] \
            * b_t[:, 0, None, :].float()
        y = torch.einsum("bdn,bn->bd", h, c_t[:, 0].float())[:, None]
        ssm_state.copy_(h)
        new_cache = (conv_state, ssm_state)

    y = y.to(compute_dtype)
    y = y + u * params["d_skip"].to(compute_dtype)
    y = y * F.silu(z)
    out = y @ params["out_proj"].to(x.dtype)
    return block_exit(out, mesh, sp, n_tp > 1), new_cache
