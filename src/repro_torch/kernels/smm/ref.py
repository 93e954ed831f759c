"""Plain PyTorch version of the smm (small-matrix-multiply stack) kernel."""
from __future__ import annotations

import torch

__all__ = ["smm_process_stack_ref"]


def smm_process_stack_ref(
    a_blocks: torch.Tensor,  # (Na, bm, bk)
    b_blocks: torch.Tensor,  # (Nb, bk, bn)
    c_blocks: torch.Tensor,  # (Nc, bm, bn) float32 accumulator
    triples: torch.Tensor,   # (S, 3|4) int32: (a_idx, b_idx, c_idx[, valid])
) -> torch.Tensor:
    """C[c] += A[a] @ B[b] for every stack entry, as gather / batched
    matmul in f32 / scatter-add.  An optional 4th triples column is a
    validity mask (the fused executor's stack padding): masked entries
    contribute zero.  ``c_blocks`` is updated in place and returned (the
    reference donates its C buffer)."""
    idx = triples.long()
    a = a_blocks.index_select(0, idx[:, 0]).to(torch.float32)
    b = b_blocks.index_select(0, idx[:, 1]).to(torch.float32)
    prod = torch.bmm(a, b)
    if triples.shape[1] > 3:
        prod = prod * triples[:, 3].to(torch.float32)[:, None, None]
    return c_blocks.index_add_(0, idx[:, 2], prod)
