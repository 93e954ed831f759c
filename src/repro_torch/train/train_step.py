"""Train-step factory, the counterpart of ``repro.train.train_step``:
loss -> autograd -> clip -> optimizer, with optional microbatch gradient
accumulation.  ``batch_specs`` and ``shardings_for`` give the batch's
and the state's partition specs on a mesh (spec trees: the port has no
``NamedSharding``), for the dry-run.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..launch.mesh import P
from ..models import transformer as T
from ..models.common import tree_leaves, tree_map
from .optimizer import Optimizer

__all__ = ["make_train_step", "batch_specs", "shardings_for"]


def batch_specs(cfg, mesh=None):
    dp = ("pod", "data")
    if mesh is not None:
        dp = tuple(a for a in dp if a in mesh.shape)
    if cfg.input_mode == "embeddings":
        return {"inputs": P(dp, None, None), "labels": P(dp, None)}
    return {"inputs": P(dp, None), "labels": P(dp, None)}


def shardings_for(cfg, mesh, opt: Optimizer):
    """(param specs, optimizer-state specs, batch specs) on ``mesh``: the
    parameters' specs resolved against their shapes."""
    pspecs = T.model_param_specs(cfg, mesh)
    pshapes = T.model_param_shapes(cfg)
    return (pspecs, opt.state_specs(pspecs, pshapes, mesh=mesh),
            batch_specs(cfg, mesh))


def _grads_of(params, batch: Dict, cfg):
    """(loss, metrics, grads): the loss and its gradient with respect to
    every leaf of ``params``, in the leaves' dtypes.  Autograd runs on
    detached aliases of the leaves, so the caller's tensors never carry
    ``requires_grad``; a leaf the loss does not read gets zeros, as
    ``jax.grad`` gives."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss, metrics = T.lm_loss(tree_map(lambda _: next(it), params), batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(cfg, opt: Optimizer, *, n_microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  The optimizer updates ``params`` and ``opt_state`` in
    place and the step returns them.  With n_microbatches > 1 the batch
    is split along axis 0 and the f32 gradients of the parts accumulate
    before one optimizer step, as the reference's ``lax.scan`` does; its
    metrics are then ``nll`` (the mean loss of the parts), ``grad_norm``
    and ``loss``.
    """

    def train_step(params, opt_state, batch):
        if n_microbatches == 1:
            loss, metrics, grads = _grads_of(params, batch, cfg)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{n_microbatches} microbatches")
            parts = {k: v.chunk(n_microbatches) for k, v in batch.items()}
            grads, loss = None, None
            for i in range(n_microbatches):
                mb_loss, _, g = _grads_of(
                    params, {k: v[i] for k, v in parts.items()}, cfg)
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

        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
