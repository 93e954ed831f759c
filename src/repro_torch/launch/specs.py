"""Input specs (meta tensors) and step functions for every (architecture
x shape) dry-run cell, the counterpart of ``repro.launch.specs``: shapes
and dtypes only, nothing allocated on a device.

Where the JAX package returns ``ShapeDtypeStruct``s and
``NamedSharding``s for ``jax.jit(...).lower``, the port returns meta
tensors and trees of resolved ``PartitionSpec``s; the dry-run runs the
step on the meta tensors under the cost counter.  The arguments are one
rank's shards -- parameters, optimizer state, cache and batch -- and
the step runs on the mesh, collectives included: on 1x1 they are whole,
on the dry-run's ``MetaRankMesh`` (one rank of a production mesh) they
are that rank's.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import SHAPES, ModelConfig, ShapeConfig, get_config
from ..models import transformer as T
from ..models.common import shard_tree, tree_map
from ..serve import engine
from ..serve.prefill import prefill_step
from ..train import train_step as TS
from ..train.optimizer import OptConfig, make_optimizer
from .mesh import P, axis_size

__all__ = ["cell_is_supported", "opt_for", "input_specs",
           "default_microbatches", "build_cell"]


def cell_is_supported(cfg: ModelConfig,
                      shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention architecture: 500k-token KV is "
                       "quadratic-memory-infeasible; skipped per DESIGN.md §4")
    return True, ""


def opt_for(cfg: ModelConfig) -> OptConfig:
    """The JAX package's choice: factored Adafactor for DeepSeek-V3
    (f32 Adam state of 671 B parameters is 5.4 TB), AdamW with ZeRO-1
    elsewhere."""
    big = cfg.name.startswith("deepseek")
    return OptConfig(name="adafactor" if big else "adamw", zero=not big)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta tensors of the step function's *data* arguments."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "embeddings":
            inputs = _meta((b, s, cfg.d_model), getattr(torch, cfg.dtype))
        else:
            inputs = _meta((b, s), torch.int32)
        if shape.kind == "train":
            return {"inputs": inputs, "labels": _meta((b, s), torch.int32)}
        return {"inputs": inputs}
    # decode: one new token with a KV cache of seq_len
    state, tokens = engine.serve_input_specs(cfg, batch=b, kv_len=s)
    return {"state": state, "tokens": tokens}


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Split the per-device batch so checkpointed layer inputs stay
    under ~4 GiB: n_layers x (B_loc/micro) x S x d x 2B <= 4 GiB."""
    n_dp = 1
    for a in ("pod", "data"):
        n_dp *= mesh.shape.get(a, 1)
    b_loc = max(shape.global_batch // n_dp, 1)
    ckpt_bytes = cfg.num_layers * b_loc * shape.seq_len * cfg.d_model * 2
    if cfg.sequence_parallel:
        ckpt_bytes //= mesh.shape.get("model", 1)
    micro = 1
    budget = 4 * 2**30
    while ckpt_bytes / micro > budget and micro < b_loc:
        micro *= 2
    if cfg.moe:
        # the dispatch/combine tensors materialise (T_loc * top_k, d)
        # per MoE layer: bound them to ~2 GiB per microbatch
        disp = b_loc * shape.seq_len * cfg.top_k * cfg.d_model * 2
        while disp / micro > 2 * 2**30 and micro < b_loc:
            micro *= 2
    return micro


def build_cell(arch: str, shape_name, mesh, *, n_microbatches: int = 0,
               cfg=None):
    """Returns (step_fn, args, (in_specs, out_specs), donate, meta): the
    step through the port's ``make_train_step``, ``prefill_step`` or
    ``decode_step`` on ``mesh``, its arguments as meta tensors -- this
    rank's shards of the parameters, optimizer state, cache and batch --
    and the spec trees of its arguments and results.  ``mesh`` is 1x1
    (whole arguments) or one rank of a process mesh (the dry-run's
    ``MetaRankMesh``).  ``shape_name`` may be a ``ShapeConfig``."""
    if cfg is None:
        cfg = get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    ok, why = cell_is_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape.name} unsupported: {why}")
    params = T.model_param_shapes(cfg)
    dp = T.dp_axes(mesh)
    if shape.global_batch % axis_size(mesh, dp) != 0:
        dp = ()                      # the batch stays whole on every rank

    if shape.kind == "train":
        if n_microbatches == 0:
            n_microbatches = default_microbatches(cfg, shape, mesh)
        opt = make_optimizer(opt_for(cfg))
        p_sp, o_sp, b_sp = TS.shardings_for(cfg, mesh, opt)
        step = TS.make_train_step(cfg, opt, n_microbatches=n_microbatches,
                                  mesh=mesh)
        params = shard_tree(params, p_sp, mesh)
        args = (params, TS.init_opt_state(opt, params, cfg, mesh),
                TS.shard_batch(input_specs(cfg, shape), mesh))
        meta = {"kind": "train", "cfg": cfg, "shape": shape,
                "n_microbatches": n_microbatches}
        specs = ((p_sp, o_sp, b_sp), (p_sp, o_sp, None))
        return step, args, specs, (0, 1), meta

    p_sp = T.model_param_specs(cfg, mesh)
    params = shard_tree(params, p_sp, mesh)
    if shape.kind == "prefill":
        def step(params, inputs):
            return prefill_step(params, inputs, cfg, mesh, dp)

        in_spec = (P(dp, None, None) if cfg.input_mode == "embeddings"
                   else P(dp, None))
        args = (params, mesh.shard(input_specs(cfg, shape)["inputs"],
                                   in_spec)[0])
        meta = {"kind": "prefill", "cfg": cfg, "shape": shape}
        return step, args, ((p_sp, in_spec), None), (), meta

    def step(params, state, tokens):
        return engine.decode_step(params, state, tokens, cfg, mesh, dp)

    b, s = shape.global_batch, shape.seq_len
    cache = T.cache_shapes(cfg, b, s, mesh)
    state_sp = {"cache": _cache_specs(cfg, b, s, cache, mesh),
                "cur_len": P(None)}
    tokens = input_specs(cfg, shape)["tokens"]
    tok_sp = P(dp, *([None] * (tokens.ndim - 1)))
    args = (params, {"cache": cache,
                     "cur_len": torch.empty((1,), dtype=torch.int32,
                                            device="meta")},
            mesh.shard(tokens, tok_sp)[0])
    meta = {"kind": "decode", "cfg": cfg, "shape": shape}
    # next_tokens is always (B, 1) int32 (even for embedding-stub archs)
    return (step, args, ((p_sp, state_sp, tok_sp), (P(dp, None), state_sp)),
            (1,), meta)


def _cache_specs(cfg, batch: int, max_len: int, cache, mesh):
    """The spec tree of ``cache``, this rank's serve cache
    (``transformer.cache_shapes``' layout): the batch dim over the data
    axes where they cut it, a dim ``model`` cuts over ``model``; None
    for a leaf no spec names (a rank's own KV heads where ``model`` does
    not divide them)."""
    dp = T.dp_axes(mesh)
    n_dp, n_tp = axis_size(mesh, dp), axis_size(mesh, "model")

    def one(whole, local):
        parts = [None] * whole.ndim
        for i, (w, n) in enumerate(zip(whole.shape, local.shape)):
            if w == n:
                continue
            if i == 1 and w == n * n_dp:      # (repeats, batch, ...)
                parts[i] = dp
            elif w == n * n_tp:
                parts[i] = "model"
            else:
                return None
        return P(*parts)

    return tree_map(one, T.cache_shapes(cfg, batch, max_len), cache)
