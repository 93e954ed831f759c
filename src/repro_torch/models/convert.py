"""Carry parameters and caches over from the JAX package.

The JAX package's parameter tree (``repro.models.transformer.model_init``)
of any architecture of the registry (attention, MLA, MoE, Mamba and
RWKV-6 layers, DeepSeek's MTP parameters) and its serve caches, given as
numpy arrays in the same nested dicts, lists and tuples
(``jax.tree_util.tree_map(np.asarray, tree)``), become the port's
tensors.  The two packages declare the same tree, so the
carry-over is leaf for leaf; every shape is checked against the port's
declaration.  Tests use it so that both packages compute with the same
weights.  With a process ``mesh`` each process keeps its shard of every
leaf (by ``model_param_specs(cfg, mesh)``).
"""
from __future__ import annotations

import numpy as np
import torch

from .common import lm_mesh, resolve_device, shard_tree
from .transformer import (cache_shapes, model_param_shapes, model_param_specs,
                          segment_plan)

__all__ = ["params_from_numpy", "opt_state_from_numpy", "cache_from_numpy"]


def _carry(tree, expected, dev, path="tree"):
    if isinstance(expected, dict):
        if not isinstance(tree, dict) or set(tree) != set(expected):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path}: keys {got}, expected {sorted(expected)}")
        return {k: _carry(tree[k], expected[k], dev, f"{path}[{k!r}]")
                for k in sorted(expected)}
    if isinstance(expected, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(expected):
            raise ValueError(f"{path}: expected {len(expected)} children")
        return type(expected)(_carry(t, e, dev, f"{path}[{i}]")
                              for i, (t, e) in enumerate(zip(tree, expected)))
    a = np.asarray(tree)
    if tuple(a.shape) != tuple(expected.shape):
        raise ValueError(f"{path}: shape {a.shape}, expected "
                         f"{tuple(expected.shape)}")
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: no torch view
        a = a.astype(np.float32)
    return torch.tensor(a).to(device=dev, dtype=expected.dtype)


def params_from_numpy(tree, cfg, *, dtype=None, device=None, mesh=None):
    """The JAX package's parameter tree of ``cfg`` (numpy leaves) as the
    port's, in ``dtype`` (default ``cfg.dtype``) on ``device`` (default
    CUDA; a mesh's device where ``mesh`` is given), on a process ``mesh``
    this process's shards."""
    mesh = lm_mesh(mesh)
    dev = resolve_device(device) if mesh is None else mesh.device
    params = _carry(tree, model_param_shapes(cfg, dtype), dev)
    if mesh is None:
        return params
    return shard_tree(params, model_param_specs(cfg, mesh), mesh)


def opt_state_from_numpy(tree, cfg, opt, *, dtype=None, device=None):
    """The JAX package's optimizer state for the parameters of ``cfg``
    (numpy leaves; AdamW's m, v and step, or Adafactor's factored and
    unfactored second moments and step) as the port's optimizer ``opt``
    holds it, on ``device`` (default CUDA)."""
    expected = opt.init(model_param_shapes(cfg, dtype))
    return _carry(tree, expected, resolve_device(device), "opt_state")


def cache_from_numpy(tree, cfg, *, device=None):
    """A serve cache of ``cfg`` (numpy leaves; a decode cache of any
    max_len or a prefill cache) as the port's, each leaf in the dtype
    ``cache_shapes`` gives it, on ``device`` (default CUDA).  The length
    is read from the first attention or MLA cache; a model with none
    (RWKV) has no length-dependent cache."""
    first = np.asarray(tree[0][0][0])
    if first.ndim < 2:
        raise ValueError(f"cache leaf of shape {first.shape} is not "
                         "(layers, batch, ...)")
    lengths = [np.shape(tree[si][pi][0])[2]
               for si, (_, period) in enumerate(segment_plan(cfg))
               for pi, (mix, _) in enumerate(period)
               if mix in ("attention", "mla")]
    expected = cache_shapes(cfg, first.shape[1], lengths[0] if lengths else 0)
    return _carry(tree, expected, resolve_device(device), "cache")
