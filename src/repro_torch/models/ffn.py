"""Dense feed-forward blocks (GLU and plain), the counterpart of
``repro.models.ffn``: tensor-parallel over ``model`` on a mesh, gate and
up column-parallel, down row-parallel with one psum over ``model``
(``b_up`` is cut with the columns; ``b_down`` is added once, after the
psum)."""
from __future__ import annotations

from typing import Dict

import torch

from ..launch.mesh import P
from .common import ParamDef, act_fn, block_enter, block_exit, sp_rep

__all__ = ["ffn_defs", "ffn_apply"]


def ffn_defs(cfg, d_ff: int | None = None) -> Dict[str, ParamDef]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.glu:
        defs = {
            "w_gate": ParamDef((d, f), spec=P(None, "model")),
            "w_up": ParamDef((d, f), spec=P(None, "model")),
            "w_down": ParamDef((f, d), spec=P("model", None)),
        }
    else:
        defs = {
            "w_up": ParamDef((d, f), spec=P(None, "model")),
            "w_down": ParamDef((f, d), spec=P("model", None)),
        }
    if cfg.mlp_bias:
        defs["b_up"] = ParamDef((f,), "zeros", spec=P("model"))
        defs["b_down"] = ParamDef((d,), "zeros", spec=P(None))
    return defs


def ffn_apply(params: Dict, x: torch.Tensor, cfg, mesh=None,
              sp: bool = False) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  On a mesh whose ``model`` axis cuts the
    hidden width ``cfg.d_ff``, x enters the block as Megatron's f and the
    row-parallel product leaves it as g; with ``sp`` x and the output are
    this rank's rows of the sequence (``common.block_enter``)."""
    tp = mesh is not None and params["w_up"].shape[1] != cfg.d_ff
    x = block_enter(x, mesh, sp, tp)
    act = act_fn(cfg.act)
    u = x @ params["w_up"].to(x.dtype)
    if cfg.mlp_bias:
        u = u + params["b_up"].to(x.dtype)
    if cfg.glu:
        g = x @ params["w_gate"].to(x.dtype)
        h = act(g) * u
    else:
        h = act(u)
    out = block_exit(h @ params["w_down"].to(x.dtype), mesh, sp, tp)
    if cfg.mlp_bias:
        out = out + sp_rep(params["b_down"], mesh, sp).to(x.dtype)
    return out
