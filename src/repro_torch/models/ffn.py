"""Dense feed-forward blocks (GLU and plain), the counterpart of
``repro.models.ffn`` (one card: no tensor-parallel specs)."""
from __future__ import annotations

from typing import Dict

import torch

from .common import ParamDef, act_fn

__all__ = ["ffn_defs", "ffn_apply"]


def ffn_defs(cfg, d_ff: int | None = None) -> Dict[str, ParamDef]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.glu:
        defs = {
            "w_gate": ParamDef((d, f)),
            "w_up": ParamDef((d, f)),
            "w_down": ParamDef((f, d)),
        }
    else:
        defs = {
            "w_up": ParamDef((d, f)),
            "w_down": ParamDef((f, d)),
        }
    if cfg.mlp_bias:
        defs["b_up"] = ParamDef((f,), "zeros")
        defs["b_down"] = ParamDef((d,), "zeros")
    return defs


def ffn_apply(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    act = act_fn(cfg.act)
    u = x @ params["w_up"].to(x.dtype)
    if cfg.mlp_bias:
        u = u + params["b_up"].to(x.dtype)
    if cfg.glu:
        g = x @ params["w_gate"].to(x.dtype)
        h = act(g) * u
    else:
        h = act(u)
    out = h @ params["w_down"].to(x.dtype)
    if cfg.mlp_bias:
        out = out + params["b_down"].to(x.dtype)
    return out
