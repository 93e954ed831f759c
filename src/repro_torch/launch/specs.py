"""Input specs (meta tensors) and step functions for every (architecture
x shape) dry-run cell, the counterpart of ``repro.launch.specs``: shapes
and dtypes only, nothing allocated on a device.

Where the JAX package returns ``ShapeDtypeStruct``s and
``NamedSharding``s for ``jax.jit(...).lower``, the port returns meta
tensors and trees of resolved ``PartitionSpec``s; the dry-run runs the
step on the meta tensors under the cost counter.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import SHAPES, ModelConfig, ShapeConfig, get_config
from ..models import transformer as T
from ..serve import engine
from ..serve.prefill import prefill_step
from ..train import train_step as TS
from ..train.optimizer import OptConfig, make_optimizer
from .mesh import P

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
    ``decode_step``, its arguments as meta tensors, and the spec trees
    of its arguments and results on ``mesh``.  ``shape_name`` may be a
    ``ShapeConfig``."""
    if cfg is None:
        cfg = get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    ok, why = cell_is_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape.name} unsupported: {why}")
    params = T.model_param_shapes(cfg)

    if shape.kind == "train":
        if n_microbatches == 0:
            n_microbatches = default_microbatches(cfg, shape, mesh)
        opt = make_optimizer(opt_for(cfg))
        p_sp, o_sp, b_sp = TS.shardings_for(cfg, mesh, opt)
        step = TS.make_train_step(cfg, opt, n_microbatches=n_microbatches)
        args = (params, opt.init(params), input_specs(cfg, shape))
        meta = {"kind": "train", "cfg": cfg, "shape": shape,
                "n_microbatches": n_microbatches}
        specs = ((p_sp, o_sp, b_sp), (p_sp, o_sp, None))
        return step, args, specs, (0, 1), meta

    p_sp = T.model_param_specs(cfg, mesh)
    dp = T.dp_axes(mesh)
    if shape.kind == "prefill":
        def step(params, inputs):
            return prefill_step(params, inputs, cfg)

        in_spec = (P(dp, None, None) if cfg.input_mode == "embeddings"
                   else P(dp, None))
        args = (params, input_specs(cfg, shape)["inputs"])
        meta = {"kind": "prefill", "cfg": cfg, "shape": shape}
        return step, args, ((p_sp, in_spec), None), (), meta

    def step(params, state, tokens):
        return engine.decode_step(params, state, tokens, cfg)

    sp = input_specs(cfg, shape)
    state_sp, tok_sp = engine.decode_shardings(
        cfg, mesh, batch=shape.global_batch, kv_len=shape.seq_len)
    # next_tokens is always (B, 1) int32 (even for embedding-stub archs)
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    if shape.global_batch % max(n_dp, 1) != 0:
        dp = ()
    args = (params, sp["state"], sp["tokens"])
    meta = {"kind": "decode", "cfg": cfg, "shape": shape}
    return (step, args, ((p_sp, state_sp, tok_sp), (P(dp, None), state_sp)),
            (1,), meta)
