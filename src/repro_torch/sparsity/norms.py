"""Per-block Frobenius norms of a dense DBCSR payload.

DBCSR keeps a norm per block so the multiply can drop contributions
whose norm-product bound falls below ``filter_eps`` *before* they reach
a multiplication stack (on-the-fly filtering).  Payloads are dense
tensors with absent blocks stored as zeros (core/dbcsr.py), so the
norms of a whole matrix are one blockwise reduction on the payload's
device.  The result is pulled to HOST numpy: norms are static planning
metadata exactly like the occupancy masks, and filtering decisions
happen at stack-generation time.

``product_norm_bound`` is the host-side bound on the product's block
norms.

Norms accumulate in float32 whatever the payload dtype: they gate an
approximation, and a fixed dtype keeps the engine's content-fingerprint
memo stable across payload dtypes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["compute_block_norms", "block_norms_of", "normalize_block_norms",
           "product_norm_bound", "tensor_block_norms"]


def compute_block_norms(x: torch.Tensor, block_m: int,
                        block_n: int) -> np.ndarray:
    """(rows, cols) payload -> (nbr, nbc) float32 numpy of per-block
    Frobenius norms, reduced in float32 on the payload's device."""
    r, c = x.shape
    if r % block_m or c % block_n:
        raise ValueError(
            f"shape {tuple(x.shape)} not divisible by block ({block_m},{block_n})")
    blocks = x.reshape(r // block_m, block_m, c // block_n, block_n)
    b32 = blocks.to(torch.float32)
    norms = torch.sqrt(torch.sum(b32 * b32, dim=(1, 3)))
    return norms.cpu().numpy().astype(np.float32)


def block_norms_of(x: torch.Tensor, block_m: int, block_n: int,
                   block_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """``compute_block_norms`` with the occupancy mask applied: absent
    blocks report norm 0 even if the payload carries stray nonzeros,
    so norms never resurrect a block the mask declares absent."""
    norms = compute_block_norms(x, block_m, block_n)
    if block_mask is not None:
        norms = np.where(np.asarray(block_mask, dtype=bool), norms,
                         np.float32(0.0)).astype(np.float32)
    return norms


def tensor_block_norms(
    x: torch.Tensor,
    block_sizes: Tuple[int, ...],
    block_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """N-d payload -> ``block_grid``-shaped float32 numpy of per-block
    Frobenius norms, mask-zeroed like ``block_norms_of``: one float32
    reduction on the payload's device.

    These norms are EXACT under matricization: the tensor unfold
    (repro_torch.tensor.matricize) permutes elements *within* a block
    and a Frobenius norm is permutation-invariant, so the 2D views of a
    tensor lower this cache through a pure block-grid transpose+reshape
    instead of touching device data again.
    """
    block_sizes = tuple(int(b) for b in block_sizes)
    if len(block_sizes) != x.ndim:
        raise ValueError(
            f"block_sizes names {len(block_sizes)} axes but the payload "
            f"has {x.ndim}")
    for ax, (d, bs) in enumerate(zip(x.shape, block_sizes)):
        if bs <= 0 or d % bs:
            raise ValueError(
                f"axis {ax}: dim {d} not divisible by block size {bs}")
    inter = []
    for d, bs in zip(x.shape, block_sizes):
        inter += [d // bs, bs]
    nb = tuple(d // bs for d, bs in zip(x.shape, block_sizes))
    # sum of squares over the interleaved intra-block axes: no copy
    y = x.reshape(inter).to(torch.float32)
    sq = torch.sum(y * y, dim=tuple(range(1, 2 * len(nb), 2)))
    norms = torch.sqrt(sq).reshape(nb).cpu().numpy().astype(np.float32)
    if block_mask is not None:
        norms = np.where(np.asarray(block_mask, dtype=bool), norms,
                         np.float32(0.0)).astype(np.float32)
    return norms


def normalize_block_norms(
    nbr: int,
    nbk: int,
    nbc: int,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical norm normalization, mirroring
    ``stacks.normalize_block_masks``: ``None`` means unit-norm blocks
    (the filter then degrades to thresholding the known side alone),
    anything else must be a float-coercible array of exactly the block
    grid shape."""
    an = (np.ones((nbr, nbk), dtype=np.float32) if a_norms is None
          else np.asarray(a_norms, dtype=np.float32))
    bn = (np.ones((nbk, nbc), dtype=np.float32) if b_norms is None
          else np.asarray(b_norms, dtype=np.float32))
    if an.shape != (nbr, nbk):
        raise ValueError(
            f"a_norms shape {an.shape} != block grid {(nbr, nbk)}")
    if bn.shape != (nbk, nbc):
        raise ValueError(
            f"b_norms shape {bn.shape} != block grid {(nbk, nbc)}")
    return an, bn


def product_norm_bound(a_norms: np.ndarray,
                       b_norms: np.ndarray) -> np.ndarray:
    """(nbr, nbc) upper bound on the product's block norms:
    ``||C_ij||_F <= sum_k ||A_ik||_F * ||B_kj||_F`` (submultiplicativity
    + triangle inequality).  This is what makes the post-multiply mask
    predictable *before* executing: any C block whose bound is below
    eps is guaranteed filtered."""
    an = np.asarray(a_norms, dtype=np.float64)
    bn = np.asarray(b_norms, dtype=np.float64)
    return an @ bn
