"""Plain PyTorch version of the grouped (batched) GEMM kernel."""
from __future__ import annotations

import torch

__all__ = ["grouped_gemm_ref"]


def grouped_gemm_ref(tokens: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """tokens (E, C, d) @ weights (E, d, f) -> (E, C, f) in f32.  TF32 is
    turned off for this call only (the caller's setting is restored), so
    the product is IEEE f32 like the kernel's."""
    flags = torch.backends.cuda.matmul
    caller = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        return torch.bmm(tokens.to(torch.float32), weights.to(torch.float32))
    finally:
        flags.allow_tf32 = caller
