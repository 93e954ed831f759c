"""Plain PyTorch version of the decode-attention kernel (grouped GQA form)."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["NEG_INF", "decode_attention_ref"]

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cur_len: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hkv, R, Dh); caches (B, S, Hkv, Dh); cur_len a one-element
    int32 tensor.  Returns (B, Hkv, R, Dh) float32: attention of each
    grouped query head over the first cur_len cache entries, with scores
    at or past cur_len set to -1e30 (so cur_len = 0 gives the mean of V
    over all S).  All arithmetic in f32; TF32 is off for this call only."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    flags = torch.backends.cuda.matmul
    caller = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        s = torch.einsum("bhrd,bkhd->bhrk", q.float(), k_cache.float()) * scale
        valid = torch.arange(k_cache.shape[1], device=k_cache.device) \
            < cur_len.reshape(())
        s = torch.where(valid, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhrk,bkhd->bhrd", p, v_cache.float())
    finally:
        flags.allow_tf32 = caller
