"""Model/run configuration dataclasses + the architecture registry."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config", "ARCHS",
           "reduced_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"
    act: str = "silu"
    glu: bool = True
    qkv_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    pos_emb: str = "rope"          # rope | sinusoidal | none
    tie_embeddings: bool = False
    # layer pattern (hybrid archs)
    mixer: str = "attention"       # attention | mla | rwkv6 | mamba
    attn_every: int = 1            # jamba: attn layer when l % attn_every == attn_offset
    attn_offset: int = 0
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.0
    router: str = "softmax"
    moe_fsdp: bool = False         # FSDP-shard expert weights over data axes
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # mamba
    mamba_d_state: int = 16
    mamba_conv: int = 4
    mamba_expand: int = 2
    # rwkv
    rwkv_head_size: int = 64
    # stub frontends ([audio]/[vlm]): inputs are precomputed embeddings
    input_mode: str = "tokens"     # tokens | embeddings
    # multi-token prediction (deepseek-v3)
    mtp: bool = False
    mtp_weight: float = 0.3
    # numerics / memory policy
    dtype: str = "bfloat16"
    remat: str = "none"            # none | full | dots
    # --- beyond-paper optimization levers (EXPERIMENTS.md §Perf) ------
    sequence_parallel: bool = False  # shard residual stream seq over TP
    head_pad_factor: int = 1         # pad (q, kv) heads by an integer
                                     # factor so they shard over TP
    moe_small_t_partial: bool = True # FSDP MoE: activation-partial path
                                     # instead of weight gathers when the
                                     # token count is small (decode)
    # attention blocking (long-sequence path)
    long_seq_threshold: int = 1024
    attn_block_q: int = 2048
    attn_block_kv: int = 2048
    # which serve shapes are valid (sub-quadratic-memory archs only for 500k)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def layer_kind(self, l: int) -> Tuple[str, str]:
        """(mixer_kind, ffn_kind) of layer l."""
        if self.mixer == "rwkv6":
            return "rwkv6", "rwkv_cm"
        if self.mixer == "mla":
            mix = "mla"
        elif self.attn_every > 1:
            mix = "attention" if l % self.attn_every == self.attn_offset else "mamba"
        else:
            mix = self.mixer
        if self.moe and l >= self.first_dense_layers and \
                (l % self.moe_every == self.moe_offset):
            ff = "moe"
        else:
            ff = "dense"
        return mix, ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCHS = [
    "deepseek_v3_671b",
    "qwen3_moe_30b_a3b",
    "starcoder2_3b",
    "qwen2_1_5b",
    "granite_20b",
    "granite_34b",
    "musicgen_medium",
    "jamba_v0_1_52b",
    "rwkv6_1_6b",
    "llava_next_mistral_7b",
]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test scale: same family/structure, tiny dims."""
    def rd(x, lo, cap):
        return max(lo, min(x, cap))

    base = dict(
        num_layers=rd(cfg.num_layers, 2,
                      max(4, cfg.attn_every, cfg.moe_every * 2,
                          cfg.first_dense_layers + 2)),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        moe_d_ff=64 if cfg.moe else 0,
        n_experts=8 if cfg.moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        n_shared_experts=cfg.n_shared_experts and 1,
        # drop-free capacity at smoke scale so prefill+decode is exactly
        # teacher-forced forward (capacity drops are order-dependent)
        capacity_factor=8.0 if cfg.moe else cfg.capacity_factor,
        first_dense_layers=min(cfg.first_dense_layers, 1),
        q_lora_rank=64 if cfg.q_lora_rank else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_nope_dim=32 if cfg.qk_nope_dim else 0,
        qk_rope_dim=16 if cfg.qk_rope_dim else 0,
        v_head_dim=32 if cfg.v_head_dim else 0,
        rwkv_head_size=32,
        long_seq_threshold=cfg.long_seq_threshold,
        dtype="float32",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
