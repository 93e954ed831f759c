"""Roofline terms of a counted step on one H100, the counterpart of
``repro.launch.roofline`` (whose constants are TPU v5e's):

  compute term    = sum over compute dtypes of FLOPs / that dtype's peak
  memory term     = HBM bytes / HBM rate
  collective term = collective bytes / NVLink rate (each way)

with the data-sheet constants of ``launch.mesh.HW`` (or ``hw_for`` the
card).  The compute term is split by dtype because the port runs bf16
GEMMs beside IEEE f32 attention products (TF32 only where
``allow_tf32`` was on when the product ran): one peak would hide the
f32 products' 15x lower rate.  The counts (``launch.cost_counter``) are
per device already.

MODEL_FLOPS is the standard 6*N*D (train) / 2*N*D (inference) with N =
active parameter count: the useful-flops numerator that exposes remat
and redundancy against the counted FLOPs.  ``param_count`` and
``model_flops`` are the JAX package's formulas, copied.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig, ShapeConfig

__all__ = ["roofline_terms", "memory_bound_s", "model_flops", "param_count",
           "step_bound_s"]


def memory_bound_s(nbytes: float, hw: Dict) -> float:
    """The memory term alone: ``nbytes`` read or written once over the
    HBM rate (a decode step's weights-only bound)."""
    return nbytes / hw["hbm_bw"]


def roofline_terms(costs, hw: Dict) -> Dict:
    """``compute_s``, ``memory_s``, ``collective_s``, ``dominant`` and
    ``roofline_fraction`` (the compute term's share of the bound) of
    ``costs`` (an ``OpCosts``) on ``hw``; ``compute_s_by_dtype`` beside
    them."""
    peaks = hw["peak_flops"]
    by_dtype = {dt: f / peaks.get(dt, peaks["float32"])
                for dt, f in costs.flops_by_dtype.items() if f}
    compute_s = sum(by_dtype.values())
    memory_s = memory_bound_s(costs.hbm_bytes, hw)
    collective_s = costs.total_collective_bytes / hw["nvlink_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, collective_s)
    terms["dominant"] = {"compute_s": "compute", "memory_s": "memory",
                         "collective_s": "collective"}[dominant]
    terms["roofline_fraction"] = compute_s / bound if bound > 0 else 0.0
    terms["compute_s_by_dtype"] = by_dtype
    return terms


def step_bound_s(costs, hw: Dict) -> float:
    """The least time the card could take for the counted work: the
    largest of the three terms."""
    t = roofline_terms(costs, hw)
    return max(t["compute_s"], t["memory_s"], t["collective_s"])


def param_count(cfg: ModelConfig, *, active_only: bool = False) -> int:
    """Analytic parameter count (embedding + per-layer, by layer kind)."""
    d, v = cfg.d_model, cfg.vocab_size
    dh = cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads

    def attn_params():
        return d * dh * (h + 2 * hkv) + h * dh * d

    def mla_params():
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv_ = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return (d * qr + qr * h * (dn + dr) + d * (kvr + dr)
                + kvr * h * dn + kvr * h * dv_ + h * dv_ * d)

    def mamba_params():
        d_in = cfg.mamba_expand * d
        dt_rank = max(1, d // 16)
        n = cfg.mamba_d_state
        return (d * 2 * d_in + cfg.mamba_conv * d_in
                + d_in * (dt_rank + 2 * n) + dt_rank * d_in
                + d_in * n + 2 * d_in + d_in * d)

    def rwkv_params():
        hs = cfg.rwkv_head_size
        nh = d // hs
        tm = (5 * d + d * 5 * 32 + 5 * 32 * d + d + d * 64 + 64 * d
              + nh * hs + 4 * d * d + 2 * d + d * d)
        cm = 2 * d + d * cfg.d_ff + d * d + cfg.d_ff * d
        return tm + cm

    def dense_ffn(f):
        return d * f * (3 if cfg.glu else 2)

    def moe_ffn(active):
        e = (cfg.top_k if active else cfg.n_experts)
        p = e * 3 * d * cfg.moe_d_ff + d * cfg.n_experts
        p += cfg.n_shared_experts * 3 * d * cfg.moe_d_ff
        return p

    total = v * d + (0 if cfg.tie_embeddings else d * v)
    for l in range(cfg.num_layers):
        mix, ff = cfg.layer_kind(l)
        total += {"attention": attn_params, "mla": mla_params,
                  "mamba": mamba_params, "rwkv6": rwkv_params}[mix]()
        if ff == "dense":
            total += dense_ffn(cfg.d_ff)
        elif ff == "moe":
            total += moe_ffn(active_only)
        total += 2 * d  # norms
    return int(total)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global MODEL_FLOPS for one step of this cell: 6*N_active*D for
    training, 2*N_active*D for inference (D = tokens processed)."""
    n_active = param_count(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1   # decode: one token per sequence
    return 2.0 * n_active * tokens
