"""``filter_eps`` predicates — the single source of truth for what
"retained" means, shared by every layer of the multiply path.

The contract (see the package docstring): triple (i, k, j) is retained
iff it is present under the binary occupancy masks AND its norm-product
bound clears the threshold,

    a_mask[i, k] & b_mask[k, j]  and  a_norms[i, k] * b_norms[k, j] >= eps

``eps = 0`` retains every mask-present triple (any float product is
``>= 0``), which is why the filtered path is bit-identical to the
mask-only path at eps 0.  ``eps = None`` disables norm filtering
entirely — callers that have no norms never pay for the predicate.

Everything here is host-side numpy on block-grid-sized arrays (the same
altitude as the occupancy masks), copied from the JAX package so the
port decides retention exactly as the reference does.  The only
sizable intermediate, the (nbr, nbk, nbc) pairwise product tensor, is
chunked over k so global grids never materialise more than ``_CHUNK``
pairwise slabs at a time.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["retained_pair_presence", "count_retained_triples",
           "product_mask", "norm_filter_stats"]

# k-chunk for the pairwise (nbr, chunk, nbc) product slabs
_CHUNK = 64


def _masked_norms(am: np.ndarray, bm: np.ndarray,
                  an: np.ndarray, bn: np.ndarray):
    """Norms with mask-absent blocks forced to 0 so a single ``>= eps``
    comparison (eps > 0) folds both criteria into one; the binary masks
    are still AND-ed in separately for the eps = 0 case."""
    return (np.where(am, an.astype(np.float64), 0.0),
            np.where(bm, bn.astype(np.float64), 0.0))


def retained_pair_presence(
    am: np.ndarray, bm: np.ndarray,
    an: Optional[np.ndarray], bn: Optional[np.ndarray],
    eps: Optional[float],
) -> np.ndarray:
    """Full (nbr, nbk, nbc) retained-triple presence tensor.  Meant for
    tests and small grids; the stack generator computes the same
    predicate row-wise along its Morton traversal instead."""
    pair = am[:, :, None] & bm[None, :, :]
    if eps is None or an is None and bn is None:
        return pair
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    from .norms import normalize_block_norms

    an_, bn_ = normalize_block_norms(nbr, nbk, nbc, an, bn)
    keep = (an_.astype(np.float64)[:, :, None]
            * bn_.astype(np.float64)[None, :, :]) >= float(eps)
    return pair & keep


def count_retained_triples(
    am: np.ndarray, bm: np.ndarray,
    an: Optional[np.ndarray], bn: Optional[np.ndarray],
    eps: Optional[float],
) -> int:
    """Number of retained triples — the numerator of the norm-predicted
    occupancy the planner discounts blocked-path flops by (this replaces
    the binary mask product count when norms are available)."""
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    if eps is None or (an is None and bn is None):
        # sum_k (present a blocks in column k) * (present b blocks in row k)
        return int(am.sum(axis=0, dtype=np.int64)
                   @ bm.sum(axis=1, dtype=np.int64))
    from .norms import normalize_block_norms

    an_, bn_ = normalize_block_norms(nbr, nbk, nbc, an, bn)
    eps = float(eps)
    if eps <= 0.0 and (an_ >= 0).all() and (bn_ >= 0).all():
        # every norm product is >= 0 >= eps: the mask count
        return count_retained_triples(am, bm, None, None, None)
    an_m, bn_m = _masked_norms(am, bm, an_, bn_)
    total = 0
    for k0 in range(0, nbk, _CHUNK):
        sl = slice(k0, min(k0 + _CHUNK, nbk))
        slab = an_m[:, sl, None] * bn_m[None, sl, :]
        keep = slab >= eps
        if eps <= 0.0:
            # eps 0 retains every MASK-present triple, including ones
            # whose norms are exactly zero — fold the masks back in
            keep &= am[:, sl, None] & bm[None, sl, :]
        total += int(np.count_nonzero(keep))
    return total


def product_mask(
    am: np.ndarray, bm: np.ndarray,
    an: Optional[np.ndarray], bn: Optional[np.ndarray],
    eps: Optional[float],
) -> np.ndarray:
    """(nbr, nbc) bool: C blocks with at least one retained triple —
    the support the filtered product actually writes.  With
    ``eps=None`` (or no norms) this is the symbolic mask product
    ``(am @ bm) > 0``; under eps it is predictable *before* executing
    (the blocked executor dispatches exactly the retained triples)."""
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    if eps is None or (an is None and bn is None):
        return (am.astype(np.int64) @ bm.astype(np.int64)) > 0
    from .norms import normalize_block_norms

    an_, bn_ = normalize_block_norms(nbr, nbk, nbc, an, bn)
    an_m, bn_m = _masked_norms(am, bm, an_, bn_)
    eps = float(eps)
    out = np.zeros((nbr, nbc), dtype=bool)
    for k0 in range(0, nbk, _CHUNK):
        sl = slice(k0, min(k0 + _CHUNK, nbk))
        slab = an_m[:, sl, None] * bn_m[None, sl, :]
        keep = slab >= eps
        if eps <= 0.0:
            keep &= am[:, sl, None] & bm[None, sl, :]
        out |= keep.any(axis=1)
    return out


def norm_filter_stats(
    am: np.ndarray, bm: np.ndarray,
    an: Optional[np.ndarray], bn: Optional[np.ndarray],
    eps: Optional[float],
    flop_per_triple: int,
) -> dict:
    """Retained-vs-filtered accounting for one (global or per-step)
    triple grid: what the filter dropped and what that saved."""
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    mask_present = int((am.astype(np.int64) @ bm.astype(np.int64)).sum())
    retained = count_retained_triples(am, bm, an, bn, eps)
    return {
        "filter_eps": None if eps is None else float(eps),
        "n_dense_triples": nbr * nbk * nbc,
        "n_mask_triples": mask_present,
        "n_retained_triples": retained,
        "n_norm_filtered_triples": mask_present - retained,
        "norm_retained_fraction":
            retained / mask_present if mask_present else 1.0,
        "norm_filtered_flops": (mask_present - retained) * flop_per_triple,
    }
