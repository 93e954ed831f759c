"""The yardstick's arithmetic: the work a multiply needs, from its shapes
and block masks, and the peaks of one NVIDIA H100 SXM from NVIDIA's data
sheet (dense rates, 700 W).  Nothing here reads the port: a later change
to the program cannot move what a metric is measured against.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def block_counts(m: int, k: int, n: int, block: int,
                 a_mask: Optional[np.ndarray] = None,
                 b_mask: Optional[np.ndarray] = None):
    """``(triples, a_blocks, b_blocks, c_blocks)``: the retained block
    products of C = A @ B and the present blocks of A, B and of C's
    symbolic support, an absent mask counting as all present."""
    nm, nk, nn = m // block, k // block, n // block
    am = (np.ones((nm, nk), bool) if a_mask is None
          else np.asarray(a_mask, bool))
    bm = (np.ones((nk, nn), bool) if b_mask is None
          else np.asarray(b_mask, bool))
    a64, b64 = am.astype(np.int64), bm.astype(np.int64)
    # triples: sum over k of (present A blocks in column k) x (present B
    # blocks in row k)
    triples = int((a64.sum(axis=0) * b64.sum(axis=1)).sum())
    c_blocks = int(((a64 @ b64) > 0).sum())
    return triples, int(am.sum()), int(bm.sum()), c_blocks


def multiply_flops(m: int, k: int, n: int, block: int,
                   a_mask=None, b_mask=None) -> float:
    """Useful FLOPs of C = A @ B: 2 * block^3 a retained block triple
    (2 * m * k * n for dense operands)."""
    triples = block_counts(m, k, n, block, a_mask, b_mask)[0]
    return 2.0 * triples * block ** 3


def multiply_bytes(m: int, k: int, n: int, block: int, itemsize: int = 4,
                   a_mask=None, b_mask=None) -> float:
    """HBM bytes of C = A @ B with each present input block read once and
    each block of C's support written once."""
    _, na, nb, nc = block_counts(m, k, n, block, a_mask, b_mask)
    return float((na + nb + nc) * block * block * itemsize)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time one card could take: the larger of FLOPs over the
    f32 peak and bytes over the HBM bandwidth."""
    return max(flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
