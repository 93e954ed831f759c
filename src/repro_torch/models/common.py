"""Shared model substrate: declarative params, norms, RoPE, activations.

The counterpart of ``repro.models.common``.  Params are declared once
(shape + init + scale + PartitionSpec) through ``ParamDef``; the
initializer, the shape tree and the spec tree derive from the same
declaration.  Mesh axis conventions (see launch/mesh.py):

  batch / sequence  -> ("pod", "data")   (data parallel)
  heads / ff hidden / experts / vocab -> "model"  (TP / EP)

One card runs every spec as replicated; the specs serve the dry-run's
per-device sizes (``launch/dryrun.py``) and a multi-rank mesh's
``Mesh.shard``.

Parameter trees are nested dicts, lists and tuples, as in the JAX
package, so a tree carried over from it (``convert.py``) has the same
structure leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..launch.mesh import P, PartitionSpec, is_spec, resolve_device

__all__ = ["ParamDef", "tree_map", "tree_leaves", "resolve_device",
           "init_params", "param_shapes", "param_specs", "resolve_spec",
           "resolve_specs", "stack_defs", "rms_norm",
           "layer_norm", "apply_norm", "norm_defs", "act_fn",
           "rope_frequencies", "apply_rope", "sinusoidal_positions",
           "cross_entropy_logits_sharded"]


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its nested dict / list / tuple structure.  Dicts
    are walked in sorted key order, as ``jax.tree_util`` walks them."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise ValueError(f"tree structures differ: {len(tree)} "
                                 f"children against {r!r:.80}")
        out = [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


# ---------------------------------------------------------------------------
# declarative parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones | scaled
    scale: float = 1.0
    dtype: Any = torch.float32
    spec: PartitionSpec = P()  # replicated unless a def says otherwise


def _is_def(x) -> bool:
    return isinstance(x, ParamDef)


def init_params(defs, generator: torch.Generator, dtype_override=None,
                device=None):
    """Materialise a tree of ParamDef into tensors on ``device`` (default
    CUDA), drawing from ``generator``, which must live on that device.

    The init rule is the JAX package's: std = scale / sqrt(shape[0]) for
    every tensor of two or more dims.  For a layer stack (``stack_defs``)
    ``shape[0]`` is the layer count, not the fan-in; it is copied as it
    is, so activations have the JAX package's scale."""
    dev = resolve_device(device)

    def one(d: ParamDef):
        dt = dtype_override or d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        fan_in = d.shape[0] if len(d.shape) > 1 else max(d.shape[-1], 1)
        std = d.scale / math.sqrt(fan_in)
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(std).to(dt)

    return tree_map(one, defs, is_leaf=_is_def)


def param_shapes(defs, dtype_override=None):
    """Tree of meta tensors (shape and dtype, no storage)."""
    return tree_map(
        lambda d: torch.empty(d.shape, dtype=dtype_override or d.dtype,
                              device="meta"),
        defs, is_leaf=_is_def)


def param_specs(defs):
    """PartitionSpec tree with the same structure."""
    return tree_map(lambda d: d.spec, defs, is_leaf=_is_def)


def resolve_spec(spec: PartitionSpec, shape: Tuple[int, ...],
                 mesh) -> PartitionSpec:
    """Drop mesh axes from dims they don't evenly divide.

    E.g. KV-head dims of 2/4/12/24 cannot shard over a 16-way 'model'
    axis: those tensors fall back to replication on that dim.  Reads
    only ``mesh.shape``.
    """
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        if part is None:
            out.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        axes = tuple(a for a in axes if a in mesh.shape)  # drop absent axes
        if not axes:
            out.append(None)
            continue
        extent = 1
        for a in axes:
            extent *= mesh.shape[a]
        if dim % extent != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return P(*out)


def resolve_specs(spec_tree, shape_tree, mesh):
    """resolve_spec over a (specs, shapes) tree pair; the shapes are
    tensors (meta or not)."""
    return tree_map(lambda sp, sh: resolve_spec(sp, tuple(sh.shape), mesh),
                    spec_tree, shape_tree, is_leaf=is_spec)


def stack_defs(defs, n: int):
    """Prepend a layer dimension of size n (replicated) to every
    ParamDef."""
    return tree_map(lambda d: dataclasses.replace(
        d, shape=(n,) + tuple(d.shape), spec=P(None, *d.spec)),
        defs, is_leaf=_is_def)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * weight.float()).to(dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dtype)


def apply_norm(x, params, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


def norm_defs(d: int, kind: str) -> Dict[str, ParamDef]:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), "ones", spec=P(None))}
    return {"scale": ParamDef((d,), "ones", spec=P(None)),
            "bias": ParamDef((d,), "zeros", spec=P(None))}


def act_fn(name: str):
    return {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
        "relu": F.relu,
        "relu2": lambda x: F.relu(x).square(),
    }[name]


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, Dh) ; positions: (..., S) int32."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)       # (Dh/2,)
    angles = positions[..., None].float() * freqs               # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """MusicGen-style sinusoidal position embeddings, computed pointwise
    from position ids (prefill ranges and decode steps alike).

    positions (..., S) int32 -> (..., S, d) float32.
    """
    pos = positions.float()[..., None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)
    angle = pos / torch.pow(10000.0, dim / d)          # (..., S, d/2)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def cross_entropy_logits_sharded(logits, labels, *, valid_mask=None):
    """logits (B, S, V), labels (B, S) -> the mean nll over the valid
    tokens, computed in f32 as logsumexp minus the label's logit.  The
    name is the JAX package's, whose V may be sharded; one card holds it
    whole."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if valid_mask is None:
        return nll.mean()
    valid = valid_mask.float()
    return (nll * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
