"""Optimizers: AdamW and Adafactor, the counterpart of
``repro.train.optimizer`` with its formulas: moments in f32, parameters
updated in f32 and cast back to their dtype, decoupled weight decay on
tensors of two or more dims only, Adafactor's factored second moment and
its RMS update clipping, all after clipping the gradients by their
global norm.

The update works in place under ``torch.no_grad()``, a leaf at a time:
at full width a functional update that allocated new trees would double
the parameters and the moments (20 GB for Qwen2-1.5B), and the clipped
f32 gradient of one leaf is the only f32 copy alive.  ``update`` returns
the same parameter and state tensors it was given, so it keeps the
reference's signature ``update(grads, state, params) -> (params, state,
{"grad_norm"})``.

Optimizer state inherits each parameter's PartitionSpec (TP sharding);
with ``zero=True`` the first unsharded dimension of every state tensor
is additionally sharded over the data axes (ZeRO-1, ``zero_shard_specs``
in ``Optimizer.state_specs``).  ZeRO changes the specs and not the
numbers: on one rank ``zero=True`` trains bitwise as ``zero=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..launch.mesh import P, is_spec
from ..models.common import tree_leaves, tree_map

__all__ = ["OptConfig", "Optimizer", "make_optimizer", "zero_shard_specs"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"           # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay: float = 0.8
    min_dim_factored: int = 128
    zero: bool = False            # shard optimizer state over data axes


def _up_to(tree, like) -> list:
    """The subtrees of ``tree`` at the leaves of ``like``, whose structure
    ``tree`` extends, in ``tree_leaves`` order (``flatten_up_to``)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _up_to(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for t, l in zip(tree, like) for x in _up_to(t, l)]
    return [tree]


def _clip_by_global_norm(grads, max_norm):
    """(scale, global norm), f32 scalars: the clipped gradient of a leaf
    is ``g.float() * scale``, which the update forms a leaf at a time."""
    gnorm = None
    for g in tree_leaves(grads):
        sq = g.float().square().sum()
        gnorm = sq if gnorm is None else gnorm + sq
    gnorm = torch.sqrt(gnorm)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    return scale, gnorm


def _step(p: torch.Tensor, delta: torch.Tensor, cfg: OptConfig):
    """p <- p - lr * (delta + decoupled decay), in f32, cast back."""
    if p.ndim >= 2:  # decoupled weight decay on matrices only
        delta = delta + cfg.weight_decay * p.float()
    p.copy_(p.float() - cfg.lr * delta)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw_init(params):
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


@torch.no_grad()
def _adamw_update(grads, state, params, cfg: OptConfig, scale):
    step = state["step"].add_(1)
    t = step.float()
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t
    for g, m, v, p in zip(tree_leaves(grads), _up_to(state["m"], params),
                          _up_to(state["v"], params), tree_leaves(params)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        del g
        denom = (v / c2).sqrt_().add_(cfg.eps)
        _step(p, (m / c1).div_(denom), cfg)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------


def _factored(shape, min_dim) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def _adafactor_init(params, cfg: OptConfig):
    leaves = tree_leaves(params)

    def init_v(p):
        zeros = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
        if _factored(p.shape, cfg.min_dim_factored):
            return {"vr": zeros(p.shape[:-1]),
                    "vc": zeros(p.shape[:-2] + p.shape[-1:])}
        return {"v": zeros(p.shape)}

    return {
        "v": tree_map(init_v, params),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


@torch.no_grad()
def _adafactor_update(grads, state, params, cfg: OptConfig, scale):
    step = state["step"].add_(1)
    beta2 = 1.0 - step.float() ** (-cfg.decay)
    for g, v, p in zip(tree_leaves(grads), _up_to(state["v"], params),
                       tree_leaves(params)):
        g = g.float() * scale
        g2 = g.square() + 1e-30
        if _factored(p.shape, cfg.min_dim_factored):
            vr, vc = v["vr"], v["vc"]
            vr.mul_(beta2).add_((1 - beta2) * g2.mean(-1))
            vc.mul_(beta2).add_((1 - beta2) * g2.mean(-2))
            denom = ((vr / vr.mean(-1, keepdim=True))[..., None]
                     * vc[..., None, :])
        else:
            denom = v["v"].mul_(beta2).add_((1 - beta2) * g2)
        del g2
        pre = g * torch.rsqrt(denom + 1e-30)
        del g, denom
        # update clipping (Adafactor's d=1.0 RMS rule)
        rms = torch.sqrt(pre.square().mean() + 1e-30)
        _step(p, pre / torch.clamp_min(rms, 1.0), cfg)
    return params, state


# ---------------------------------------------------------------------------
# public factory
# ---------------------------------------------------------------------------


class Optimizer(NamedTuple):
    init: Callable            # (params) -> state
    update: Callable          # (grads, state, params) -> (params, state,
                              #  metrics)
    state_specs: Callable     # (param specs, param shapes, mesh) -> specs
    cfg: OptConfig


def zero_shard_specs(spec_tree, dp_axes=("pod", "data"), mesh=None):
    """ZeRO-1: shard the first replicated dim of each state over data axes.

    Returns ``f(spec, leaf)`` for ``tree_map`` over (specs, shapes).  Only
    applied when the dimension is divisible by the dp extent (the caller
    passes the mesh); otherwise the spec is left unchanged.
    """
    def f(spec, leaf):
        if mesh is None:
            return spec
        n_dp = 1
        for a in dp_axes:
            n_dp *= mesh.shape.get(a, 1)
        parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for i, (sp, dim) in enumerate(zip(parts, leaf.shape)):
            if sp is None and dim % n_dp == 0 and dim >= n_dp:
                parts[i] = tuple(a for a in dp_axes if a in mesh.shape)
                return P(*parts)
        return spec
    return f


def make_optimizer(cfg: OptConfig = OptConfig()) -> Optimizer:
    if cfg.name == "adamw":
        init, upd = _adamw_init, _adamw_update

        def state_specs(param_specs, params_shapes, mesh=None):
            sp = param_specs
            if cfg.zero and mesh is not None:
                sp = tree_map(zero_shard_specs(sp, mesh=mesh), param_specs,
                              params_shapes, is_leaf=is_spec)
            return {"m": sp, "v": sp, "step": P()}
    elif cfg.name == "adafactor":
        init = lambda params: _adafactor_init(params, cfg)
        upd = _adafactor_update

        def state_specs(param_specs, params_shapes, mesh=None):
            def f(spec, shape):
                if _factored(shape.shape, cfg.min_dim_factored):
                    parts = list(spec) + [None] * (len(shape.shape)
                                                   - len(spec))
                    return {"vr": P(*parts[:-1]),
                            "vc": P(*(parts[:-2] + parts[-1:]))}
                return {"v": spec}
            return {"v": tree_map(f, param_specs, params_shapes,
                                  is_leaf=is_spec),
                    "step": P()}
    else:
        raise ValueError(cfg.name)

    def update(grads, state, params):
        scale, gnorm = _clip_by_global_norm(grads, cfg.grad_clip)
        params, state = upd(grads, state, params, cfg, scale)
        return params, state, {"grad_norm": gnorm}

    return Optimizer(init, update, state_specs, cfg)
