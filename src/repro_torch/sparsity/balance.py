"""Costed load balancing: block-row/col permutation of the distribution.

DBCSR assigns block rows and columns to the process grid through a
*randomized* permutation because structured occupancy (banded
Hamiltonians, clustered molecular blocks) otherwise lands most retained
triples on a few ranks (arXiv:1910.04796, sec. 2).  Given the operand
masks (and optionally norms and ``filter_eps``), ``plan_rebalance``
scores the per-rank retained-triple imbalance of the identity layout
against greedy-LPT and random row/col permutations and returns the best
``RebalancePlan``.  Host-side numpy, copied from the JAX package: the
same ``np.random.RandomState(seed)`` draws pick the same permutations
byte for byte.

Permutation invariants:

* Only the M side (block rows of A and C) and the N side (block cols
  of B and C) are permuted; the K side stays identity.  Permuting K
  would reorder every C block's accumulation run and change the
  floating-point result.
* With pi_k = identity, ``C = invert(permute(A) @ permute(B))`` holds
  BITWISE for schedules whose K-step order is rank-independent (SUMMA
  panels, tall-skinny): every C element accumulates the same values in
  the same order, on a different rank.  Cannon's K rotation starts at
  ``(i + j) % pg``, so moving a block row to another rank rotates its
  accumulation order: round-trips are allclose there, not bitwise.

``permute_block_rows`` / ``permute_block_cols`` take numpy arrays or
torch tensors; a tensor is indexed with an index tensor on its own
device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .norms import normalize_block_norms

__all__ = [
    "RebalancePlan",
    "chunk_imbalance",
    "chunk_loads",
    "invert_permutation",
    "permute_block_cols",
    "permute_block_rows",
    "plan_rebalance",
    "retained_block_weights",
]


def retained_block_weights(
    a_mask: np.ndarray,
    b_mask: np.ndarray,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
    filter_eps: Optional[float] = None,
    *,
    device="cpu",
) -> np.ndarray:
    """Per-C-block retained-triple counts ``W[i, j]``: the work of the
    rank owning C block (i, j) over a full multiply (every schedule
    gives C chunk (i, j) to rank (i, j), so C-chunk sums of ``W`` are
    the per-rank retained loads).  The norm-filtered count runs on the
    torch ``device`` (the multiply passes its mesh's), one batched
    comparison of float64 norm products a k-chunk: the same IEEE
    products and counts on any device."""
    am = np.asarray(a_mask, dtype=bool)
    bm = np.asarray(b_mask, dtype=bool)
    if filter_eps is None or (a_norms is None and b_norms is None):
        # the mask product; float64 counts are exact far beyond any grid
        return (am.astype(np.float64) @ bm.astype(np.float64)).astype(
            np.int64)
    # ``retained_pair_presence(...).sum(axis=1)``, a k-chunk at a time
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    an, bn = normalize_block_norms(nbr, nbk, nbc, a_norms, b_norms)
    eps = float(filter_eps)
    if eps <= 0.0 and (an >= 0).all() and (bn >= 0).all():
        # every norm product is >= 0 >= eps: the mask product
        return retained_block_weights(am, bm)
    # mask-absent blocks at norm 0 fold the masks into one ``>= eps``
    dev = torch.device(device)
    an_t, bn_t = (torch.from_numpy(np.where(m, x.astype(np.float64), 0.0))
                  .to(dev) for m, x in ((am, an), (bm, bn)))
    if eps <= 0.0:
        am_t, bm_t = (torch.from_numpy(np.ascontiguousarray(m)).to(dev)
                      for m in (am, bm))
    step = max(1, _CHUNK_ELEMS // max(1, nbr * nbc))
    w = torch.zeros((nbr, nbc), dtype=torch.int64, device=dev)
    for k0 in range(0, nbk, step):
        sl = slice(k0, k0 + step)
        keep = an_t[:, sl, None] * bn_t[None, sl, :] >= eps
        if eps <= 0.0:
            # a product >= eps need not be mask-present: AND the masks in
            keep &= am_t[:, sl, None] & bm_t[None, sl, :]
        w += keep.sum(dim=1)
    return w.cpu().numpy()


# float64 norm products a k-chunk of ``retained_block_weights`` holds
_CHUNK_ELEMS = 1 << 25


def chunk_loads(W: np.ndarray, pr: int, pc: int) -> np.ndarray:
    """Sum ``W`` over the contiguous (pr, pc) chunk decomposition: one
    load per rank of the process grid."""
    nbr, nbc = W.shape
    if nbr % pr or nbc % pc:
        raise ValueError(
            f"weight grid ({nbr},{nbc}) not divisible by mesh {pr}x{pc}")
    return W.reshape(pr, nbr // pr, pc, nbc // pc).sum(axis=(1, 3))


def chunk_imbalance(W: np.ndarray, pr: int, pc: int) -> float:
    """max/mean per-rank load (1.0 = perfectly balanced)."""
    if pr * pc <= 1:
        return 1.0
    loads = chunk_loads(W, pr, pc).astype(np.float64)
    mean = float(loads.mean())
    return float(loads.max()) / mean if mean > 0 else 1.0


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def _index(perm: np.ndarray, x):
    """``perm`` as an index for ``x``: a long tensor on a tensor's
    device, else a numpy array."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(np.asarray(perm), dtype=torch.long,
                               device=x.device)
    return np.asarray(perm)


def permute_block_rows(x, perm: np.ndarray, block: int):
    """Reorder block rows: row block ``r`` of the result is row block
    ``perm[r]`` of the input."""
    nb = len(perm)
    shaped = x.reshape((nb, block) + tuple(x.shape[1:]))
    return shaped[_index(perm, x)].reshape(x.shape)


def permute_block_cols(x, perm: np.ndarray, block: int):
    """Reorder block columns (axis 1) the same way."""
    nb = len(perm)
    shaped = x.reshape((x.shape[0], nb, block) + tuple(x.shape[2:]))
    return shaped[:, _index(perm, x)].reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class RebalancePlan:
    """A chosen block-row/col permutation and its predicted effect."""

    perm_m: np.ndarray          # block-row permutation (A and C rows)
    perm_n: np.ndarray          # block-col permutation (B and C cols)
    imbalance_before: float
    imbalance_after: float
    method: str                 # "identity" | "greedy" | "random[i]"

    @property
    def identity(self) -> bool:
        return self.method == "identity"

    @property
    def inv_m(self) -> np.ndarray:
        return invert_permutation(self.perm_m)

    @property
    def inv_n(self) -> np.ndarray:
        return invert_permutation(self.perm_n)


def _greedy_perm(weights: np.ndarray, parts: int) -> np.ndarray:
    """LPT assignment of block weights into ``parts`` equal-cardinality
    contiguous chunks: heaviest blocks first, each into the currently
    lightest chunk with a free slot."""
    nb = len(weights)
    cap = nb // parts
    order = np.argsort(weights, kind="stable")[::-1]
    loads = np.zeros(parts, dtype=np.float64)
    counts = np.zeros(parts, dtype=np.int64)
    slots: List[List[int]] = [[] for _ in range(parts)]
    for idx in order:
        open_parts = np.flatnonzero(counts < cap)
        p = open_parts[np.argmin(loads[open_parts])]
        slots[p].append(int(idx))
        loads[p] += float(weights[idx])
        counts[p] += 1
    return np.concatenate([np.asarray(s, dtype=np.int64) for s in slots])


def plan_rebalance(
    a_mask: np.ndarray,
    b_mask: np.ndarray,
    pr: int,
    pc: int,
    *,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
    filter_eps: Optional[float] = None,
    n_random: int = 8,
    seed: int = 0,
) -> RebalancePlan:
    """Pick the best of {identity, greedy LPT, ``n_random`` random}
    row/col permutations by predicted per-rank load imbalance.

    Deterministic for a given ``seed``; ties prefer the candidate listed
    first (identity, then greedy), so a uniform pattern never pays for a
    pointless shuffle.
    """
    W = retained_block_weights(a_mask, b_mask, a_norms, b_norms, filter_eps)
    nbr, nbc = W.shape
    ident_m = np.arange(nbr, dtype=np.int64)
    ident_n = np.arange(nbc, dtype=np.int64)
    base = chunk_imbalance(W, pr, pc)
    candidates: List[Tuple[float, np.ndarray, np.ndarray, str]] = [
        (base, ident_m, ident_n, "identity")]
    if pr * pc > 1 and nbr % pr == 0 and nbc % pc == 0:
        gm = _greedy_perm(W.sum(axis=1), pr) if pr > 1 else ident_m
        gn = _greedy_perm(W.sum(axis=0), pc) if pc > 1 else ident_n
        candidates.append(
            (chunk_imbalance(W[gm][:, gn], pr, pc), gm, gn, "greedy"))
        rng = np.random.RandomState(seed)
        for r in range(n_random):
            pm = rng.permutation(nbr) if pr > 1 else ident_m
            pn = rng.permutation(nbc) if pc > 1 else ident_n
            candidates.append(
                (chunk_imbalance(W[pm][:, pn], pr, pc), pm.astype(np.int64),
                 pn.astype(np.int64), f"random[{r}]"))
    best = min(candidates, key=lambda c: c[0])
    return RebalancePlan(perm_m=best[1], perm_n=best[2],
                         imbalance_before=base, imbalance_after=best[0],
                         method=best[3])
