"""Model assembly: embeddings, layer-pattern segments (stacked), LM head,
KV / latent / state caches, the multi-token-prediction parameters — the
counterpart of ``repro.models.transformer`` for serving.

Layer patterns are normalised into *segments*: (n_repeats, [period of
layer kinds]), as in the JAX package.  The parameters of each period
position are stacked over n_repeats, and so are the serve caches, so a
tree carries over from the JAX package leaf for leaf.  Where the JAX
package runs a segment under ``jax.lax.scan``, ``forward`` loops over
the stack in Python, taking each layer's parameters and cache as views
of the stacks (no copies).

Every layer kind of the registry is ported: mixers ``attention``,
``mla``, ``mamba`` and ``rwkv6``; feed-forwards ``dense``, ``moe`` and
``rwkv_cm`` (RWKV's channel mix, whose parameters live in the mixer's).
Decode writes every cache in place.  Training is ``lm_loss`` (the
next-token loss, the MoE router loss and DeepSeek's MTP loss) through
autograd, with ``cfg.remat`` mapped onto ``torch.utils.checkpoint``
(``_remat_wrap``).  The sharding helpers (``dp_axes``, ``cache_specs``,
``model_param_specs``) give the JAX package's PartitionSpecs, which the
dry-run (``launch/dryrun.py``) reads for its per-device sizes.

``forward``, ``lm_head``, ``lm_loss`` and their callers take ``mesh``:
None (one card), a 1x1 mesh (the very same operations) or a process
mesh, where each process holds its shard of every parameter (by
``model_param_specs(cfg, mesh)``: ``model_init(..., mesh=)`` or
``common.shard_tree``) and of the batch (cut over the data axes ``dp``;
``dp=()`` where every rank holds the whole batch, as the JAX package
replicates a batch its data axes do not divide).  The layers are tensor-
and expert-parallel over ``model``; the vocabulary of the embedding and
of the logits is cut over ``model`` and the loss is the mean over every
data shard's tokens.  Every layer kind runs on any such mesh: Mamba is
cut on its inner width and RWKV-6's time mix by heads, its channel mix
on ``d_ff`` (``mamba.py``, ``rwkv6.py``).  ``cache_shapes`` and
``cache_init`` with ``mesh`` give a process's shard of every cache, as
prefill leaves them.

With ``cfg.sequence_parallel`` (the JAX package's condition: no cache,
``model`` > 1 dividing the sequence) each rank keeps its S / model rows
of the residual between layers: the norms run on them, every block
gathers the rows on entry and reduce-scatters its output
(``common.block_enter`` / ``block_exit``), and the final norm's output is
gathered whole before the head.  The values do not change.  Departures:
a prefill that collects caches runs without the cut (a cache holds every
row), and MoE's partial path takes the cut like the others.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention import (attention_apply, attention_defs, effective_heads,
                        kv_heads_read)
from ..launch.mesh import P, axis_size, cut_rep, enter_rep, gather_rep
from .common import (ParamDef, apply_norm, cross_entropy_logits_sharded,
                     embed_lookup, init_params, lm_mesh, norm_defs,
                     param_shapes, param_specs, resolve_device,
                     resolve_specs, sinusoidal_positions, sp_active, sp_rep,
                     stack_defs, tree_map)
from .ffn import ffn_apply, ffn_defs
from .mamba import _dims as mamba_dims
from .mamba import mamba_apply, mamba_defs
from .mla import mla_apply, mla_defs
from .moe import moe_apply, moe_defs
from .rwkv6 import rwkv6_channel_mix, rwkv6_defs, rwkv6_time_mix

__all__ = ["segment_plan", "model_defs", "model_param_shapes", "model_init",
           "model_param_specs", "cache_shapes", "cache_specs", "cache_init",
           "dp_axes", "DP_AXES", "forward", "lm_head", "lm_loss",
           "backbone"]

DP_AXES = ("pod", "data")


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dp_axes(mesh) -> tuple:
    """Data-parallel axes present in this mesh (single-pod has no 'pod')."""
    return tuple(a for a in DP_AXES if a in mesh.shape)


# ---------------------------------------------------------------------------
# segment planning
# ---------------------------------------------------------------------------


def segment_plan(cfg) -> List[Tuple[int, List[Tuple[str, str]]]]:
    kinds = [cfg.layer_kind(l) for l in range(cfg.num_layers)]
    segments = []
    start = 0
    if cfg.first_dense_layers:
        n = cfg.first_dense_layers
        if not all(k == kinds[0] for k in kinds[:n]):
            raise ValueError(f"the first {n} layers differ in kind")
        segments.append((n, [kinds[0]]))
        start = n
    rest = kinds[start:]
    if rest:
        period = len(rest)
        for p in range(1, len(rest) + 1):
            if len(rest) % p == 0 and rest == rest[:p] * (len(rest) // p):
                period = p
                break
        segments.append((len(rest) // period, rest[:period]))
    return segments


# ---------------------------------------------------------------------------
# parameter declaration
# ---------------------------------------------------------------------------


def _mixer_defs(kind: str, cfg):
    if kind == "attention":
        return attention_defs(cfg)
    if kind == "mla":
        return mla_defs(cfg)
    if kind == "mamba":
        return mamba_defs(cfg)
    if kind == "rwkv6":
        return rwkv6_defs(cfg)       # includes the channel-mix params
    raise ValueError(kind)


def _ffn_defs(kind: str, cfg):
    if kind == "dense":
        return ffn_defs(cfg)
    if kind == "moe":
        return moe_defs(cfg)
    if kind == "rwkv_cm":
        return {}                    # lives inside rwkv6_defs
    raise ValueError(kind)


def _layer_defs(kind: Tuple[str, str], cfg) -> Dict[str, Any]:
    mix, ff = kind
    defs = {
        "norm1": norm_defs(cfg.d_model, cfg.norm),
        "norm2": norm_defs(cfg.d_model, cfg.norm),
        "mixer": _mixer_defs(mix, cfg),
    }
    ffd = _ffn_defs(ff, cfg)
    if ffd:                          # no "ffn" entry for rwkv_cm
        defs["ffn"] = ffd
    return defs


def model_defs(cfg) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {
        "embed": ParamDef((v, d), "normal", spec=P("model", None)),
        "final_norm": norm_defs(d, cfg.norm),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, v), spec=P(None, "model"))
    defs["segments"] = [
        [stack_defs(_layer_defs(kind, cfg), n_rep) for kind in period]
        for n_rep, period in segment_plan(cfg)]
    if cfg.mtp:
        # DeepSeek-V3's multi-token-prediction module (depth 1); serving
        # carries it, only the training loss reads it
        defs["mtp"] = {
            "proj": ParamDef((2 * d, d), spec=P(None, None)),
            "norm_h": norm_defs(d, cfg.norm),
            "norm_e": norm_defs(d, cfg.norm),
            "block": _layer_defs((("mla" if cfg.mixer == "mla"
                                   else "attention"), "dense"), cfg),
        }
    return defs


def model_param_specs(cfg, mesh=None):
    """PartitionSpec tree of the parameters; with ``mesh``, resolved
    against its axis sizes (``resolve_spec``)."""
    specs = param_specs(model_defs(cfg))
    if mesh is not None:
        specs = resolve_specs(specs, model_param_shapes(cfg), mesh)
    return specs


def model_param_shapes(cfg, dtype=None):
    """Tree of meta tensors: every parameter's shape and dtype."""
    return param_shapes(model_defs(cfg), dtype_override=dtype or _dtype(cfg))


def model_init(cfg, generator: torch.Generator, dtype=None, *, device=None,
               mesh=None):
    """Random parameters drawn from ``generator`` (which lives on
    ``device``; default CUDA) by the JAX package's init rule.  With a
    process ``mesh``, this process's shards of the same draws."""
    mesh = lm_mesh(mesh)
    return init_params(model_defs(cfg), generator,
                       dtype_override=dtype or _dtype(cfg), device=device,
                       mesh=mesh,
                       specs=None if mesh is None
                       else model_param_specs(cfg, mesh))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _model_cut(mesh, full: int) -> int:
    """How many parts ``model`` cuts a dimension of ``full`` into: its
    size where it divides ``full`` (as ``resolve_spec`` keeps the cut),
    else 1."""
    n = axis_size(mesh, "model")
    return n if full % n == 0 else 1


def _kv_heads_held(cfg, mesh) -> int:
    """The KV heads a rank's attention cache holds (``attention_apply``):
    its share where ``model`` cuts them, else those its query heads read."""
    h, hkv = effective_heads(cfg)
    n = _model_cut(mesh, h)
    if n == 1:
        return hkv
    if hkv % n == 0:
        return hkv // n
    r = mesh.index("model") if len(mesh.local_ranks) == 1 else 0
    lo, hi = kv_heads_read(h, hkv, h // n, r)
    return hi - lo


def _layer_cache_shape(kind: Tuple[str, str], cfg, batch: int, max_len: int,
                       mesh=None):
    """Meta tensors of one layer's serve cache (on ``mesh``, a rank's
    shard of it; ``batch`` is then the rank's)."""
    mix, _ = kind
    dt = _dtype(cfg)

    def meta(shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    if mix == "attention":
        kv = (batch, max_len, _kv_heads_held(cfg, mesh),
              cfg.resolved_head_dim)
        return (meta(kv), meta(kv))
    if mix == "mla":
        return (meta((batch, max_len, cfg.kv_lora_rank)),
                meta((batch, max_len, cfg.qk_rope_dim)))
    if mix == "mamba":
        d_in, _, n, k = mamba_dims(cfg)
        d_in //= _model_cut(mesh, d_in)
        return (meta((batch, k - 1, d_in)),
                meta((batch, d_in, n), torch.float32))
    if mix == "rwkv6":
        d, hs = cfg.d_model, cfg.rwkv_head_size
        h = d // hs
        return (meta((batch, d)),
                meta((batch, h // _model_cut(mesh, h), hs, hs),
                     torch.float32),
                meta((batch, d)))             # the channel-mix shift
    raise ValueError(mix)


def cache_shapes(cfg, batch: int, max_len: int, mesh=None):
    """Meta tensors of the serve cache for ``batch`` sequences of
    ``max_len``; with a process ``mesh``, this rank's shard (the batch cut
    over the data axes where they divide it, every rank's own KV heads,
    Mamba's inner width and RWKV-6's WKV heads cut over ``model``)."""
    if mesh is not None:
        n_dp = axis_size(mesh, dp_axes(mesh))
        if batch % n_dp == 0:
            batch //= n_dp
    out = []
    for n_rep, period in segment_plan(cfg):
        seg = []
        for kind in period:
            shapes = _layer_cache_shape(kind, cfg, batch, max_len, mesh)
            seg.append(tuple(
                torch.empty((n_rep,) + tuple(s.shape), dtype=s.dtype,
                            device="meta") for s in shapes))
        out.append(seg)
    return out


def _cache_spec_one(kind: Tuple[str, str], cfg, dp=DP_AXES,
                    seq_axes=("model",)):
    mix, _ = kind
    tp = "model"
    seq = seq_axes if len(seq_axes) > 1 else seq_axes[0]
    if mix == "attention":
        # split-KV: the sequence dim sharded over 'model' (KV heads rarely
        # divide a 16-way axis).  When the batch cannot cover the data
        # axes (long_500k: batch 1) the data axes also move onto the
        # sequence dim (``cache_specs``).
        s = P(dp, seq, None, None)
        return (s, s)
    if mix == "mla":
        return (P(dp, seq, None), P(dp, seq, None))
    if mix == "mamba":
        return (P(dp, None, tp), P(dp, tp, None))
    if mix == "rwkv6":
        return (P(dp, None), P(dp, tp, None, None), P(dp, None))
    raise ValueError(mix)


def cache_specs(cfg, mesh=None, batch=None):
    """PartitionSpec tree of the serve cache (``cache_shapes``' structure),
    unresolved; a batch the data axes do not divide moves them onto the
    sequence dim."""
    dp = dp_axes(mesh) if mesh is not None else DP_AXES
    seq_axes = ("model",)
    if batch is not None and mesh is not None:
        n_dp = 1
        for a in dp:
            n_dp *= mesh.shape[a]
        if batch % max(n_dp, 1) != 0:
            seq_axes = dp + ("model",)
            dp = ()
    out = []
    for n_rep, period in segment_plan(cfg):
        out.append([tuple(P(None, *s) for s in
                          _cache_spec_one(kind, cfg, dp, seq_axes))
                    for kind in period])
    return out


def cache_init(cfg, batch: int, max_len: int, *, device=None, mesh=None):
    """Zero caches on ``device`` (default CUDA); on a process ``mesh``
    this rank's shards (``cache_shapes``)."""
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_shapes(cfg, batch, max_len, lm_mesh(mesh)))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _apply_layer(kind, lp, x, positions, cfg, cache, cur_len, collect=False,
                 mesh=None, dp=(), sp=False):
    """One layer.  cache is None (prefill) or this layer's cache slice
    (decode), which is updated in place.  With collect=True (prefill) the
    cache the layer *would have written* is returned even when none was
    passed in.  With ``sp`` (``common.sp_active``) x is this rank's rows
    of the sequence-parallel residual; ``positions`` stay whole.
    Returns (x, aux, new_cache); aux is the MoE router loss, None for the
    other kinds (no zero tensor launched a layer)."""
    mix, ff = kind
    aux = None
    h = apply_norm(x, sp_rep(lp["norm1"], mesh, sp), cfg.norm)
    if mix in ("attention", "mla"):
        c = None if cache is None else (cache[0], cache[1], cur_len)
        apply = attention_apply if mix == "attention" else mla_apply
        out, new_c = apply(
            lp["mixer"], h, positions, cfg, cache=c,
            block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv,
            long_seq_threshold=cfg.long_seq_threshold, mesh=mesh, sp=sp)
    elif mix == "mamba":
        c = None if cache is None else (cache[0], cache[1])
        out, new_c = mamba_apply(lp["mixer"], h, cfg, cache=c, mesh=mesh,
                                 sp=sp)
    elif mix == "rwkv6":
        c = None if cache is None else (cache[0], cache[1])
        out, new_c = rwkv6_time_mix(lp["mixer"], h, cfg, cache=c, mesh=mesh,
                                    sp=sp)
    else:
        raise ValueError(mix)
    x = x + out

    h = apply_norm(x, sp_rep(lp["norm2"], mesh, sp), cfg.norm)
    if ff == "dense":
        x = x + ffn_apply(lp["ffn"], h, cfg, mesh, sp=sp)
    elif ff == "moe":
        out, aux = moe_apply(lp["ffn"], h, cfg, mesh=mesh, dp=dp, sp=sp)
        if cfg.remat == "save_moe" and torch.is_grad_enabled():
            out = _moe_out(out)
        x = x + out
    elif ff == "rwkv_cm":
        cm_cache = None if cache is None else cache[2]
        out, cm_state = rwkv6_channel_mix(lp["mixer"], h, cfg, cache=cm_cache,
                                          mesh=mesh, sp=sp)
        x = x + out
        new_c = new_c + (cm_state,)
    else:
        raise ValueError(ff)
    if cache is None and not collect:
        new_c = None
    return x, aux, new_c


@torch.library.custom_op("repro_torch::moe_out", mutates_args=())
def _moe_out(x: torch.Tensor) -> torch.Tensor:
    """The MoE layer's output under a name of its own, as the JAX
    package's ``checkpoint_name(out, "moe_out")``: ``save_moe`` saves what
    this op returns (a copy: a custom op may not return its input)."""
    return x.clone()


_moe_out.register_fake(torch.empty_like)
_moe_out.register_autograd(lambda ctx, grad: grad)


def _save_dots(ctx, func, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: save the products that have no
    batch dimension (``mm``, ``addmm``, and the ``bmm`` of batch 1 that
    ``einsum`` makes of a projection) and recompute the rest, the
    attention's batched products among them."""
    if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            func is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_moe(ctx, func, *args, **kwargs):
    """``save_only_these_names("moe_out")``: of everything a checkpointed
    period computes, keep only each MoE layer's output."""
    if func is torch.ops.repro_torch.moe_out.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {"full": None, "dots": _save_dots, "save_moe": _save_moe}


def _remat_wrap(fn, cfg):
    """``fn`` rematerialised as ``cfg.remat`` says: ``none`` runs it as it
    is; the others run it under ``torch.utils.checkpoint``, which keeps
    its inputs and recomputes it in the backward.  ``full`` saves nothing
    else, ``dots`` the products with no batch dimension (``_save_dots``)
    and ``save_moe`` each MoE layer's output (``_save_moe``).  A
    recompute runs the same operations on the same inputs, so every
    policy gives ``none``'s values bitwise."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in _POLICIES:
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    policy = _POLICIES[cfg.remat]

    def wrapped(*args):
        if policy is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: create_selective_checkpoint_contexts(
                              policy))

    return wrapped


def _unstack(tree, n: int) -> list:
    """The n layers of a stacked parameter tree, as views made by one
    ``unbind`` a leaf (whose backward stacks the layers' gradients once;
    n ``select``s would each write a zero-filled stack)."""
    parts = []

    def cut(t):
        parts.append(t.unbind(0))
        return len(parts) - 1

    where = tree_map(cut, tree)
    return [tree_map(lambda j, i=i: parts[j][i], where) for i in range(n)]


def _train_period(period, positions, cfg, mesh=None, dp=(), sp=False):
    """One repeat of a period without caches: (x, aux, [layer params]) ->
    (x, aux).  A period of several layers (Jamba's 8) checkpoints each
    layer as well when remat is on, as the JAX package nests them, so
    the period's backward holds one layer's internals at a time."""
    nested = len(period) > 1 and cfg.remat != "none"

    def run(x, aux_total, lps):
        for kind, lp in zip(period, lps):
            def layer(lp, x, kind=kind):
                x, aux, _ = _apply_layer(kind, lp, x, positions, cfg, None,
                                         None, mesh=mesh, dp=dp, sp=sp)
                return x, aux

            if nested:
                x, aux = checkpoint(layer, lp, x, use_reentrant=False)
            else:
                x, aux = layer(lp, x)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total

    return _remat_wrap(run, cfg)


def _dp(mesh, dp):
    return (dp_axes(mesh) if mesh is not None else ()) if dp is None else dp


def backbone(params: Dict, inputs: torch.Tensor, cfg, *,
             positions: Optional[torch.Tensor] = None, cache=None,
             cur_len: Optional[torch.Tensor] = None,
             collect_cache: bool = False, mesh=None, dp=None):
    """Embeddings, every layer and the final norm.  Returns (hidden,
    aux, new_cache); see ``forward``.  With autograd on and no cache
    (training), each repeat of a period runs under ``cfg.remat``.  Where
    ``common.sp_active`` holds, each rank keeps its S / model rows of the
    residual from the embedding to the final norm, whose output is
    gathered whole."""
    mesh = lm_mesh(mesh)
    dp = _dp(mesh, dp)
    dt = _dtype(cfg)
    if cfg.input_mode == "embeddings" or inputs.ndim == 3:
        x = inputs.to(dt)
    else:
        x = embed_lookup(inputs, params["embed"], mesh,
                         cfg.vocab_size).to(dt)
    b, s = x.shape[:2]
    if positions is None:
        if cur_len is not None:
            positions = cur_len.reshape(1, 1).to(torch.int32).expand(b, s)
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device).expand(b, s)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(dt)

    sp = sp_active(cfg, mesh, s, cache, collect_cache)
    if sp:
        x = cut_rep(x, mesh, "model", axis=1)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = [] if (cache is not None or collect_cache) else None
    train = cache is None and not collect_cache and torch.is_grad_enabled()
    for si, (n_rep, period) in enumerate(segment_plan(cfg)):
        per_layer = [_unstack(p, n_rep) for p in params["segments"][si]]
        if train:
            run = _train_period(period, positions, cfg, mesh, dp, sp)
            for i in range(n_rep):
                x, aux_total = run(x, aux_total, [lp[i] for lp in per_layer])
            continue
        seg_cache = cache[si] if cache is not None else None
        collected = [[] for _ in period]
        for i in range(n_rep):
            for pi, kind in enumerate(period):
                cslice = (None if seg_cache is None
                          else tuple(c[i] for c in seg_cache[pi]))
                x, aux, nc = _apply_layer(kind, per_layer[pi][i], x, positions,
                                          cfg, cslice, cur_len,
                                          collect=collect_cache, mesh=mesh,
                                          dp=dp, sp=sp)
                if aux is not None:
                    aux_total = aux_total + aux
                if nc is not None and seg_cache is None:
                    collected[pi].append(nc)
        if new_cache is not None:
            if seg_cache is not None:   # written in place, layer by layer
                new_cache.append([tuple(c) for c in seg_cache])
            else:
                new_cache.append([tuple(torch.stack(parts) for parts in
                                        zip(*layers)) for layers in collected])
    hidden = apply_norm(x, sp_rep(params["final_norm"], mesh, sp), cfg.norm)
    if sp:
        hidden = gather_rep(hidden, mesh, "model", axis=1)
    return hidden, aux_total, new_cache


def lm_head(params: Dict, hidden: torch.Tensor, cfg,
            mesh=None) -> torch.Tensor:
    """(B, S, d) -> (B, S, V) logits in the hidden dtype; on a mesh this
    rank's (B, S, V / model) block of the vocabulary (the tied head reads
    the cut embedding)."""
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    if (w.shape[0] if cfg.tie_embeddings else w.shape[1]) != cfg.vocab_size:
        hidden = enter_rep(hidden, mesh, "model")
    if cfg.tie_embeddings:
        return hidden @ w.to(hidden.dtype).T
    return hidden @ w.to(hidden.dtype)


def forward(
    params: Dict,
    inputs: torch.Tensor,           # (B, S) int32 or (B, S, d) embeddings
    cfg,
    *,
    positions: Optional[torch.Tensor] = None,
    cache=None,                     # segment-structured cache or None
    cur_len: Optional[torch.Tensor] = None,  # one-element int32 (decode)
    collect_cache: bool = False,    # prefill: return would-be caches
    mesh=None,                      # None, 1x1 or a process mesh
    dp=None,                        # data axes that cut the batch
):
    """Returns (logits, hidden, aux_loss, new_cache).

    With ``cache`` (decode), every layer writes its new K and V (or
    latents, or states) into the cache in place and ``new_cache`` holds
    the same tensors.  aux_loss is the MoE router loss summed over the
    layers (f32; 0 for a model without MoE layers).  On a mesh the logits
    are this rank's block of the vocabulary."""
    hidden, aux, new_cache = backbone(params, inputs, cfg,
                                      positions=positions, cache=cache,
                                      cur_len=cur_len,
                                      collect_cache=collect_cache,
                                      mesh=mesh, dp=dp)
    return lm_head(params, hidden, cfg, mesh), hidden, aux, new_cache


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def lm_loss(params, batch, cfg, mesh=None):
    """batch: {"inputs": (B, S) tokens or (B, S, d) embeddings, "labels":
    (B, S)} -> (loss, {"nll", "aux"[, "mtp"]}), every value an f32
    scalar: the next-token nll, plus 0.01 x the MoE router loss and
    ``cfg.mtp_weight`` x the MTP loss where the model has them.  On a
    mesh, batch is this rank's data shard and every value is the global
    one, on every rank."""
    mesh = lm_mesh(mesh)
    dp = _dp(mesh, None)
    logits, hidden, aux, _ = forward(params, batch["inputs"], cfg,
                                     mesh=mesh, dp=dp)
    loss = _ce(logits, batch["labels"], cfg, mesh, dp)
    metrics = {"nll": loss, "aux": aux}
    if cfg.moe:
        loss = loss + 0.01 * aux
    if cfg.mtp:
        mtp_loss = _mtp_loss(params, hidden, batch, cfg, mesh, dp)
        metrics["mtp"] = mtp_loss
        loss = loss + cfg.mtp_weight * mtp_loss
    return loss, metrics


def _ce(logits, labels, cfg, mesh, dp, valid_mask=None):
    if mesh is None:
        return cross_entropy_logits_sharded(logits, labels,
                                            valid_mask=valid_mask)
    return cross_entropy_logits_sharded(logits, labels, valid_mask=valid_mask,
                                        mesh=mesh, vocab=cfg.vocab_size,
                                        dp=dp)


def _mtp_loss(params, hidden, batch, cfg, mesh=None, dp=()):
    """DeepSeek-V3 multi-token prediction (depth 1, a dense-FFN block):
    from the final hidden state and the embedding of the next token,
    predict the token after it (the last position has none)."""
    mp = params["mtp"]
    tokens = batch["labels"]            # next tokens (t+1) at each position
    dt = hidden.dtype
    b, s = tokens.shape
    emb_next = embed_lookup(tokens, params["embed"], mesh,
                            cfg.vocab_size).to(dt)
    h = torch.cat([apply_norm(hidden, mp["norm_h"], cfg.norm),
                   apply_norm(emb_next, mp["norm_e"], cfg.norm)], dim=-1)
    h = h @ mp["proj"].to(dt)
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(b, s)
    kind = ("mla" if cfg.mixer == "mla" else "attention", "dense")
    h, _, _ = _apply_layer(kind, mp["block"], h, positions, cfg, None, None,
                           mesh=mesh, dp=dp)
    logits = lm_head(params, apply_norm(h, params["final_norm"], cfg.norm),
                     cfg, mesh)
    # predict t+2: labels shifted one more step
    labels2 = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    valid = torch.ones((b, s), dtype=torch.bool, device=h.device)
    valid[:, -1] = False
    return _ce(logits, labels2, cfg, mesh, dp, valid_mask=valid)
