"""Plain PyTorch version of the tiled dense matmul kernel."""
from __future__ import annotations

import torch

__all__ = ["tiled_matmul_ref"]


def tiled_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) in f32."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))
