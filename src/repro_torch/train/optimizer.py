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

On a process mesh, ``update(..., mesh=, layout=)`` takes each process's
gradient shards as autograd left them (``mesh_layout`` gives every
leaf's spec and ZeRO dim): a leaf whose spec names a data axis (the
``moe_fsdp`` experts) was summed over the data axes by its gather's
backward; every other leaf is summed here, by a reduce-scatter over the
data axes onto its ZeRO chunk, or an all-reduce where it has none.  The
global norm sums each leaf's squares over the axes its gradient is cut
on, and never over those it is replicated on.  A ZeRO leaf is updated
on its chunk (a view of the parameter) and all-gathered back.

One departure, in the layout only: ``zero_shard_specs`` (the JAX
package's rule, copied) adds the data axes to a state leaf whose
parameter spec already names them, so AdamW with ``zero=True`` gives
DeepSeek-V3's ``moe_fsdp`` experts ``P(None, "model", "data", "data")``,
which JAX's ``NamedSharding`` refuses (``DuplicateSpecError``) and so
does ``train_step.shardings_for`` (``ValueError``).  ``mesh_layout``
leaves such a leaf without a ZeRO dim: its state is already cut over
the data axes with the parameter.

Adafactor runs on any mesh, as the JAX package's does under GSPMD: its
means are over whole leaves.  A mean over a dimension a leaf is cut on
(``vr``'s over the last, ``vc``'s over the one before, the normalising
mean of ``vr``) is the local sum summed over the dimension's axes,
over the global length; the update-clipping RMS sums the local squares
over every axis the leaf is cut on, over the global count.  ``vr`` and
``vc`` take the parameter's spec less the reduced dimension (the JAX
package's ``state_specs``).  Adafactor has no ZeRO (the JAX package's
``state_specs`` ignores ``zero`` for it): its state lies as its
parameter does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..launch.mesh import P, axis_size, is_spec
from ..models.common import tree_leaves, tree_map

__all__ = ["OptConfig", "Optimizer", "make_optimizer", "zero_shard_specs",
           "LeafLayout", "mesh_layout", "spec_axes"]


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


def _clip_by_global_norm(grads, max_norm, mesh=None, layout=None):
    """(scale, global norm), f32 scalars: the clipped gradient of a leaf
    is ``g.float() * scale``, which the update forms a leaf at a time.
    On a mesh each leaf's squares are summed over the axes ``layout``
    says its gradient is cut on (one psum a set of axes)."""
    if mesh is not None:
        by_axes = {}
        for g, lay in zip(tree_leaves(grads), tree_leaves(layout)):
            sq = g.float().square().sum()
            key = lay.grad_axes
            by_axes[key] = sq if key not in by_axes else by_axes[key] + sq
        gnorm = None
        for axes in sorted(by_axes):
            sq = by_axes[axes]
            if axis_size(mesh, axes) > 1:
                sq = mesh.psum(sq.reshape(1, 1), axes)[0, 0]
            gnorm = sq if gnorm is None else gnorm + sq
        gnorm = torch.sqrt(gnorm)
        scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
        return scale, gnorm
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


def _dim_axes(lay, dim: int) -> tuple:
    """The mesh axes a leaf's dimension ``dim`` is cut on (none without a
    layout)."""
    if lay is None:
        return ()
    return spec_axes((lay.spec[dim],))


def _mean(x: torch.Tensor, dim: int, axes: tuple, mesh,
          keepdim: bool = False) -> torch.Tensor:
    """The mean over ``dim`` of the whole tensor whose shard ``x`` is, cut
    on ``dim`` over ``axes``: ``x.mean`` where it is not cut."""
    n = axis_size(mesh, axes)
    if n == 1:
        return x.mean(dim, keepdim=keepdim)
    total = x.sum(dim, keepdim=keepdim)
    return mesh.psum(total.unsqueeze(0), axes)[0] / (x.shape[dim] * n)


@torch.no_grad()
def _adafactor_update(grads, state, params, cfg: OptConfig, scale,
                      mesh=None, layout=None):
    step = state["step"].add_(1)
    beta2 = 1.0 - step.float() ** (-cfg.decay)
    lays = (tree_leaves(layout) if layout is not None
            else [None] * len(tree_leaves(params)))
    for g, v, p, lay in zip(tree_leaves(grads), _up_to(state["v"], params),
                            tree_leaves(params), lays):
        g = g.float() * scale
        g2 = g.square() + 1e-30
        if _factored(p.shape, cfg.min_dim_factored):
            vr, vc = v["vr"], v["vc"]
            rows, cols = _dim_axes(lay, -2), _dim_axes(lay, -1)
            vr.mul_(beta2).add_((1 - beta2) * _mean(g2, -1, cols, mesh))
            vc.mul_(beta2).add_((1 - beta2) * _mean(g2, -2, rows, mesh))
            denom = ((vr / _mean(vr, -1, rows, mesh, keepdim=True))[..., None]
                     * vc[..., None, :])
        else:
            denom = v["v"].mul_(beta2).add_((1 - beta2) * g2)
        del g2
        pre = g * torch.rsqrt(denom + 1e-30)
        del g, denom
        # update clipping (Adafactor's d=1.0 RMS rule), over the whole leaf
        cut = spec_axes(lay.spec) if lay is not None else ()
        rms = torch.sqrt(_mean(pre.square().reshape(-1), 0, cut, mesh)
                         + 1e-30)
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


def spec_axes(spec) -> tuple:
    """The mesh axes a spec names, in order."""
    return tuple(a for part in spec if part is not None
                 for a in ((part,) if isinstance(part, str) else part))


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """One parameter on a process mesh: its resolved ``spec``, the data
    axes ``dp``, whether the spec names one of them (``dp_cut``: its
    gradient arrives summed), and ``zero_dim``, the dim its optimizer
    state (and its gradient, for the update) is cut on over ``dp``."""
    spec: tuple
    dp: tuple
    dp_cut: bool
    zero_dim: Optional[int]

    @property
    def grad_axes(self) -> tuple:
        """The axes the gradient the update sees is cut on, sorted."""
        extra = self.dp if self.zero_dim is not None else ()
        return tuple(sorted(set(spec_axes(self.spec)) | set(extra)))

    @property
    def state_spec(self) -> P:
        if self.zero_dim is None:
            return P(*self.spec)
        parts = list(self.spec)
        parts[self.zero_dim] = self.dp
        return P(*parts)


def mesh_layout(cfg: OptConfig, param_specs, param_shapes, mesh,
                dp_axes=("pod", "data")):
    """A tree of ``LeafLayout``: the resolved ``param_specs`` with the
    dim ``zero_shard_specs`` cuts over the data axes where ``cfg.zero``
    (none for a leaf whose spec names a data axis: the departure in the
    module's docstring)."""
    dp = tuple(a for a in dp_axes if a in mesh.shape)
    zero = zero_shard_specs(param_specs, dp_axes, mesh)

    def one(spec, leaf):
        pad = (None,) * (len(leaf.shape) - len(spec))
        parts = tuple(spec) + pad
        dp_cut = bool(set(spec_axes(parts)) & set(dp))
        zero_dim = None
        if (cfg.zero and cfg.name == "adamw" and axis_size(mesh, dp) > 1
                and not dp_cut):
            cut = tuple(zero(spec, leaf))
            cut += (None,) * (len(parts) - len(cut))
            zero_dim = next((i for i, (a, b) in enumerate(zip(parts, cut))
                             if a != b), None)
        return LeafLayout(parts, dp, dp_cut, zero_dim)

    return tree_map(one, param_specs, param_shapes, is_leaf=is_spec)


def _reduce_grads(grads, layout, mesh):
    """Each gradient summed over the data axes once (see the module's
    docstring): onto its ZeRO chunk, or whole."""
    def one(g, lay):
        if lay.dp_cut or axis_size(mesh, lay.dp) == 1:
            return g
        if lay.zero_dim is not None:
            return mesh.psum_scatter(g.unsqueeze(0), lay.dp,
                                     scatter_dimension=lay.zero_dim)[0]
        return mesh.psum(g.unsqueeze(0), lay.dp)[0]

    return tree_map(one, grads, layout)


def zero_chunk(p: torch.Tensor, lay: LeafLayout, mesh) -> torch.Tensor:
    """This process's ZeRO chunk of a parameter shard (a view), or the
    shard itself where it has none."""
    if lay.zero_dim is None:
        return p
    n = axis_size(mesh, lay.dp)
    size = p.shape[lay.zero_dim] // n
    return p.narrow(lay.zero_dim, mesh.index(lay.dp) * size, size)


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

    def update(grads, state, params, *, mesh=None, layout=None):
        if mesh is None or mesh.n_ranks == 1:
            scale, gnorm = _clip_by_global_norm(grads, cfg.grad_clip)
            params, state = upd(grads, state, params, cfg, scale)
            return params, state, {"grad_norm": gnorm}
        grads = _reduce_grads(grads, layout, mesh)
        scale, gnorm = _clip_by_global_norm(grads, cfg.grad_clip, mesh,
                                            layout)
        if cfg.name == "adafactor":
            upd(grads, state, params, cfg, scale, mesh, layout)
            return params, state, {"grad_norm": gnorm}
        chunks = tree_map(lambda p, l: zero_chunk(p, l, mesh), params, layout)
        upd(grads, state, chunks, cfg, scale)
        with torch.no_grad():
            for p, c, lay in zip(tree_leaves(params), tree_leaves(chunks),
                                 tree_leaves(layout)):
                if lay.zero_dim is not None:
                    p.copy_(mesh.all_gather(c.unsqueeze(0), lay.dp,
                                            axis=lay.zero_dim)[0])
        return params, state, {"grad_norm": gnorm}

    return Optimizer(init, update, state_specs, cfg)
