"""DeepSeek-V3 671B [arXiv:2412.19437; hf].

61L d_model=7168 128H, MLA (q_lora 1536 / kv_lora 512 / nope 128 /
rope 64 / v 128), MoE 256 routed top-8 + 1 shared (expert ff 2048),
first 3 layers dense (ff 18432), vocab 129280, MTP.  The assignment
spec "GQA kv=128" denotes MLA's 128 effective heads; d_ff=2048 is the
per-expert intermediate.  MLA's 576-wide latent KV makes long_500k
feasible (sub-quadratic memory) — see DESIGN.md §4.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=18432, vocab_size=129280,
    mixer="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    moe=True, n_experts=256, top_k=8, moe_d_ff=2048,
    n_shared_experts=1, first_dense_layers=3, router="sigmoid",
    mtp=True,
    moe_fsdp=True,   # 671B: expert weights must shard over data axes too
    supports_long_context=True,   # MLA latent KV = 576 B/token/layer
    # sequence_parallel=True was REFUTED for MoE-FSDP at this scale
    # (EXPERIMENTS.md §Perf iteration 1): the MoE shard_map boundary
    # forces per-layer re-gathers of the sequence, and micro=1
    # ballooned the (T*k, d) dispatch tensors to 7.5 GB/layer.
    remat="save_moe",  # §Perf iteration 2: no expert re-gather in bwd
)
