"""Shared model substrate: declarative params, norms, RoPE, activations.

The counterpart of ``repro.models.common``.  Params are declared once
(shape + init + scale + PartitionSpec) through ``ParamDef``; the
initializer, the shape tree and the spec tree derive from the same
declaration.  Mesh axis conventions (see launch/mesh.py):

  batch / sequence  -> ("pod", "data")   (data parallel)
  heads / ff hidden / experts / vocab -> "model"  (TP / EP)

One card runs every spec as replicated; the specs serve the dry-run's
per-device sizes (``launch/dryrun.py``) and the process mesh: there each
process holds the shard of every leaf that the resolved spec gives its
rank (``shard_tree`` / ``gather_tree``, ``init_params(..., mesh=)``),
and the layers compute on those shards with the collectives of
``launch.mesh`` (``lm_mesh`` says which meshes the LM takes).

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

from ..launch.mesh import (P, PartitionSpec, all_gather_ad, axis_size,
                           cut_rep, enter_rep, gather_rep, is_spec, pmax,
                           psum_rep, psum_scatter_ad, resolve_device)

__all__ = ["ParamDef", "tree_map", "tree_leaves", "resolve_device",
           "init_params", "param_shapes", "param_specs", "resolve_spec",
           "resolve_specs", "stack_defs", "rms_norm",
           "layer_norm", "apply_norm", "norm_defs", "act_fn",
           "rope_frequencies", "apply_rope", "sinusoidal_positions",
           "cross_entropy_logits_sharded", "embed_lookup", "lm_mesh",
           "shard_tree", "gather_tree", "model_shard", "sp_active",
           "block_enter", "block_exit", "sp_rep"]


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
                device=None, *, mesh=None, specs=None):
    """Materialise a tree of ParamDef into tensors on ``device`` (default
    CUDA), drawing from ``generator``, which must live on that device.

    The init rule is the JAX package's: std = scale / sqrt(shape[0]) for
    every tensor of two or more dims.  For a layer stack (``stack_defs``)
    ``shape[0]`` is the layer count, not the fan-in; it is copied as it
    is, so activations have the JAX package's scale.

    With ``mesh`` (and the resolved ``specs``), every process draws each
    whole leaf, as one card does, and keeps its rank's shard: leaf for
    leaf the shards of the one-card init.  Where the processes share a
    card (host-staged transport) they draw a leaf one at a time (a
    barrier between turns, the card's cache emptied after each), so the
    card never holds two whole leaves at once."""
    dev = resolve_device(device)
    if mesh is not None and specs is None:
        raise ValueError("init_params on a mesh needs the resolved specs")
    turns = (mesh is not None and mesh.n_ranks > 1
             and mesh.transport.endswith("host-staged"))

    def draw(d: ParamDef, spec):
        dt = dtype_override or d.dtype
        if d.init in ("zeros", "ones"):
            shape = d.shape if mesh is None else _shard_shape(d.shape, spec,
                                                              mesh)
            fill = torch.zeros if d.init == "zeros" else torch.ones
            return fill(shape, dtype=dt, device=dev)
        fan_in = d.shape[0] if len(d.shape) > 1 else max(d.shape[-1], 1)
        std = d.scale / math.sqrt(fan_in)
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        if mesh is not None:    # cut first: scaling is elementwise
            x = mesh.shard(x, spec)[0].clone()
        return x.mul_(std).to(dt)

    def one(d: ParamDef, spec=None):
        if not turns:
            return draw(d, spec)
        import torch.distributed as dist

        out = None
        for r in range(mesh.n_ranks):
            if r == mesh.rank:
                out = draw(d, spec)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                    torch.cuda.empty_cache()
            dist.barrier(group=mesh.group)
        return out

    if mesh is None:
        return tree_map(one, defs, is_leaf=_is_def)
    return tree_map(one, defs, specs, is_leaf=_is_def)


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


def _shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(dim // axis_size(mesh, () if p is None else p)
                 for dim, p in zip(shape, parts))


def lm_mesh(mesh):
    """The mesh the LM runs on: None (one card), a 1x1 mesh, or a process
    mesh (one rank a process).  An in-process mesh of several ranks is
    refused: its rank-axis simulation is the DBCSR schedules'."""
    if mesh is None or mesh.n_ranks == 1 or len(mesh.local_ranks) == 1:
        return mesh
    raise ValueError(
        f"the LM runs on a process mesh (one rank a process) or 1x1; this "
        f"mesh holds {len(mesh.local_ranks)} ranks in one process "
        "(launch.mesh.make_process_mesh)")


def shard_tree(tree, specs, mesh):
    """This process's shard of every leaf of a tree of whole tensors, by
    the resolved ``specs`` (a tree of the same structure)."""
    return tree_map(lambda x, sp: mesh.shard(x, sp)[0], tree, specs)


def gather_tree(tree, specs, mesh):
    """The whole value of every leaf of a tree of shards, on every
    process (``shard_tree``'s inverse)."""
    return tree_map(lambda x, sp: mesh.unshard(x.unsqueeze(0), sp), tree,
                    specs)


def model_shard(mesh, full: int, local: int) -> Tuple[int, int]:
    """(n, index) of a dimension of ``full`` entries this process holds
    ``local`` of: cut over the mesh's ``model`` axis (n > 1), or whole
    (1, 0) where its spec was resolved away."""
    if local == full:
        return 1, 0
    n = axis_size(mesh, "model")
    if full != local * n:
        raise ValueError(f"a dimension of {full} held as {local} is no cut "
                         f"over 'model' ({n})")
    return n, mesh.index("model")


# ---------------------------------------------------------------------------
# the sequence-parallel residual
# ---------------------------------------------------------------------------
#
# With ``cfg.sequence_parallel`` the JAX package constrains the residual
# stream to ``P(dp, "model", None)`` between layers and GSPMD turns each
# block's all-reduce over ``model`` into an all-gather and a
# reduce-scatter.  Here each rank holds its S / model rows of x between
# layers (``cut_rep`` after the embedding, ``gather_rep`` after the final
# norm), and every block goes through the pair below: a block whose
# width ``model`` cuts (``tp``) enters by all-gathering the rows (its
# backward reduce-scatters the cotangents that each rank computed for its
# own heads) and leaves by reduce-scattering its partial sums; a block
# every rank runs alike enters by ``gather_rep`` and leaves by
# ``cut_rep``.  Without the flag the pair is Megatron's ``enter_rep`` /
# ``psum_rep`` (or nothing, for a block every rank runs alike).
# Parameters every rank holds alike and uses on its own rows (the norms,
# a bias added after a block) pass ``sp_rep``: each rank's cotangent
# then covers its rows only, and their sum over ``model`` is the whole.


def sp_active(cfg, mesh, s: int, cache=None, collect: bool = False) -> bool:
    """The JAX package's condition for the cut residual
    (``cfg.sequence_parallel``, no cache, ``model`` > 1 dividing the
    sequence ``s``), and not a prefill that collects caches: a cache
    holds every row, so prefill and decode run as without the flag."""
    n = axis_size(mesh, "model")
    return bool(cfg.sequence_parallel and cache is None and not collect
                and n > 1 and s % n == 0)


def block_enter(x: torch.Tensor, mesh, sp: bool, tp: bool = True):
    """x (B, S or S / model, d) as a block takes it: whole on every rank
    (see above)."""
    if sp:
        return (all_gather_ad if tp else gather_rep)(x, mesh, "model",
                                                     axis=1)
    return enter_rep(x, mesh, "model") if tp else x


def block_exit(out: torch.Tensor, mesh, sp: bool, tp: bool = True):
    """A block's (B, S, d) output as the residual holds it: summed over
    ``model`` where the block is cut (``tp``), and this rank's rows
    under ``sp`` (see above)."""
    if sp:
        return (psum_scatter_ad if tp else cut_rep)(out, mesh, "model",
                                                    axis=1)
    return psum_rep(out, mesh, "model") if tp else out


def sp_rep(tree, mesh, sp: bool):
    """Parameters used on this rank's rows alone: under ``sp`` their
    cotangents are summed over ``model`` (``enter_rep``)."""
    if not sp:
        return tree
    return tree_map(lambda t: enter_rep(t, mesh, "model"), tree)


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


def embed_lookup(tokens, embedding, mesh=None, vocab=None):
    """tokens (B, S) int; embedding (V, d), on a mesh this process's rows
    of it (``P("model", None)``; ``vocab``, the whole V, says whether it
    is cut) -> (B, S, d).  With the vocabulary cut over ``model``, each
    rank gathers its own rows, sends the other ranks' tokens to 0, and
    the partials are summed over ``model`` (what the JAX package's GSPMD
    emits for its ``take``)."""
    b, s = tokens.shape
    v_loc = embedding.shape[0]
    if mesh is None or vocab is None or v_loc == vocab:
        return embedding.index_select(0, tokens.reshape(-1)).reshape(b, s, -1)
    local = tokens.reshape(-1).long() - mesh.index("model") * v_loc
    mine = (local >= 0) & (local < v_loc)
    rows = embedding.index_select(0, torch.where(mine, local, 0))
    rows = rows * mine[:, None].to(rows.dtype)
    return psum_rep(rows, mesh, "model").reshape(b, s, -1)


def cross_entropy_logits_sharded(logits, labels, *, valid_mask=None,
                                 mesh=None, vocab=None, dp=()):
    """logits (B, S, V), labels (B, S) -> the mean nll over the valid
    tokens, computed in f32 as logsumexp minus the label's logit.

    On a mesh, ``logits`` are this process's (B_loc, S, V / model) block
    of the vocabulary (``vocab``, the whole V, says whether it is cut):
    the max, the sum of exponentials and the label's logit are each
    reduced over ``model``.  The mean is over the tokens of every data
    shard: the local sum of the nll is summed over the data axes ``dp``
    and divided by the global count."""
    if mesh is not None:
        return _ce_on_mesh(logits, labels, valid_mask, mesh, vocab, dp)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if valid_mask is None:
        return nll.mean()
    valid = valid_mask.float()
    return (nll * valid).sum() / torch.clamp_min(valid.sum(), 1.0)


def _ce_on_mesh(logits, labels, valid_mask, mesh, vocab, dp):
    logits = logits.float()
    v_loc = logits.shape[-1]
    if vocab is None or v_loc == vocab:
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    else:
        m = pmax(logits.detach().amax(dim=-1), mesh, "model")
        se = (logits - m[..., None]).exp().sum(dim=-1)
        lse = psum_rep(se, mesh, "model").log() + m
        local = labels.long() - mesh.index("model") * v_loc
        mine = (local >= 0) & (local < v_loc)
        got = logits.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
        label_logit = psum_rep(got * mine, mesh, "model")
    nll = lse - label_logit
    if axis_size(mesh, dp) == 1:
        if valid_mask is None:
            return nll.mean()
        valid = valid_mask.float()
        return (nll * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
    valid = (torch.ones_like(nll) if valid_mask is None
             else valid_mask.float())
    count = psum_rep(valid.sum(), mesh, dp)
    return psum_rep((nll * valid).sum(), mesh, dp) / torch.clamp_min(count,
                                                                     1.0)
