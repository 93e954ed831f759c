"""Train-step factory, the counterpart of ``repro.train.train_step``:
loss -> autograd -> clip -> optimizer, with optional microbatch gradient
accumulation.  ``batch_specs`` and ``shardings_for`` give the batch's
and the state's partition specs on a mesh (spec trees: the port has no
``NamedSharding``), for the dry-run.

``make_train_step(cfg, opt, mesh=)`` runs on a process mesh: each
process passes its shards of the parameters and of the optimizer state
(``init_opt_state``) and its data shard of the batch (``shard_batch``);
the loss is the global one, and the optimizer sums each gradient over
the data axes once, with ZeRO where ``opt.cfg.zero`` (see
``optimizer``'s docstring).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..launch.mesh import P, is_spec
from ..models import transformer as T
from ..models.common import lm_mesh, tree_leaves, tree_map
from .optimizer import Optimizer, mesh_layout, spec_axes, zero_chunk

__all__ = ["make_train_step", "batch_specs", "shardings_for",
           "train_layout", "init_opt_state", "shard_batch", "state_specs"]


def batch_specs(cfg, mesh=None):
    dp = ("pod", "data")
    if mesh is not None:
        dp = tuple(a for a in dp if a in mesh.shape)
    if cfg.input_mode == "embeddings":
        return {"inputs": P(dp, None, None), "labels": P(dp, None)}
    return {"inputs": P(dp, None), "labels": P(dp, None)}


def shardings_for(cfg, mesh, opt: Optimizer):
    """(param specs, optimizer-state specs, batch specs) on ``mesh``: the
    parameters' specs resolved against their shapes.  A spec that names
    a mesh axis twice is refused with ``ValueError``, as JAX's
    ``NamedSharding`` refuses it (AdamW with ZeRO on ``moe_fsdp``
    experts: ``optimizer``'s docstring)."""
    pspecs = T.model_param_specs(cfg, mesh)
    pshapes = T.model_param_shapes(cfg)
    out = (pspecs, opt.state_specs(pspecs, pshapes, mesh=mesh),
           batch_specs(cfg, mesh))
    for spec in tree_leaves(out, is_leaf=is_spec):
        named = spec_axes(spec)
        if len(set(named)) != len(named):
            raise ValueError(f"spec {spec} names a mesh axis twice")
    return out


def train_layout(cfg, opt: Optimizer, mesh):
    """The ``optimizer.LeafLayout`` tree of ``cfg``'s parameters on
    ``mesh``."""
    return mesh_layout(opt.cfg, T.model_param_specs(cfg, mesh),
                       T.model_param_shapes(cfg), mesh)


def init_opt_state(opt: Optimizer, params, cfg, mesh=None):
    """``opt.init`` of this process's parameter shards, each state leaf
    on its ZeRO chunk where it has one."""
    mesh = lm_mesh(mesh)
    if mesh is None or mesh.n_ranks == 1:
        return opt.init(params)
    layout = train_layout(cfg, opt, mesh)
    return opt.init(tree_map(lambda p, l: zero_chunk(p, l, mesh), params,
                             layout))


def state_specs(cfg, opt: Optimizer, mesh):
    """The spec tree of ``{"params", "opt"}`` as they lie on ``mesh``
    (the optimizer state on its ZeRO chunks): what a checkpoint gathers
    and cuts by."""
    layout = train_layout(cfg, opt, mesh)
    pspecs = tree_map(lambda l: P(*l.spec), layout)
    sspecs = tree_map(lambda l: l.state_spec, layout)
    if opt.cfg.name == "adamw":
        ospecs = {"m": sspecs, "v": sspecs, "step": P()}
    else:
        ospecs = opt.state_specs(pspecs, T.model_param_shapes(cfg), mesh=mesh)
    return {"params": pspecs, "opt": ospecs}


def shard_batch(batch: Dict, mesh, cfg=None):
    """This process's data shard of a global batch (axis 0 cut over the
    data axes)."""
    mesh = lm_mesh(mesh)
    if mesh is None:
        return batch
    dp = T.dp_axes(mesh)
    return {k: mesh.shard(v, P(dp, *([None] * (v.ndim - 1))))[0]
            for k, v in batch.items()}


def _grads_of(params, batch: Dict, cfg, mesh=None):
    """(loss, metrics, grads): the loss and its gradient with respect to
    every leaf of ``params``, in the leaves' dtypes.  Autograd runs on
    detached aliases of the leaves, so the caller's tensors never carry
    ``requires_grad``; a leaf the loss does not read gets zeros, as
    ``jax.grad`` gives."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss, metrics = T.lm_loss(tree_map(lambda _: next(it), params), batch, cfg,
                              mesh=mesh)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(cfg, opt: Optimizer, *, n_microbatches: int = 1,
                    mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  The optimizer updates ``params`` and ``opt_state`` in
    place and the step returns them.  With n_microbatches > 1 the batch
    is split along axis 0 and the f32 gradients of the parts accumulate
    before one optimizer step, as the reference's ``lax.scan`` does; its
    metrics are then ``nll`` (the mean loss of the parts), ``grad_norm``
    and ``loss``.  On a process ``mesh`` every argument is this
    process's shard (see the module's docstring).
    """
    mesh = lm_mesh(mesh)
    upd_kw = {}
    if mesh is not None and mesh.n_ranks > 1:
        upd_kw = {"mesh": mesh, "layout": train_layout(cfg, opt, mesh)}

    def train_step(params, opt_state, batch):
        if n_microbatches == 1:
            loss, metrics, grads = _grads_of(params, batch, cfg, mesh)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{n_microbatches} microbatches")
            parts = {k: v.chunk(n_microbatches) for k, v in batch.items()}
            grads, loss = None, None
            for i in range(n_microbatches):
                mb_loss, _, g = _grads_of(
                    params, {k: v[i] for k, v in parts.items()}, cfg, mesh)
                g = tree_map(lambda x: x.float(), g)
                if grads is None:
                    grads, loss = g, mb_loss
                else:
                    grads = tree_map(lambda a, x: a.add_(x), grads, g)
                    loss = loss + mb_loss
                del g
            grads = tree_map(lambda g: g.div_(n_microbatches), grads)
            loss = loss / n_microbatches
            metrics = {"nll": loss}

        params, opt_state, opt_metrics = opt.update(grads, opt_state, params,
                                                    **upd_kw)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
