"""Stack generation: the Traversal / Generation / Scheduler phases.

DBCSR organises the local block-pair multiplications into *stacks*
(batches of at most ``STACK_SIZE`` = 30'000 multiplications, paper
section II).  The order of multiplications follows a cache-oblivious
(Z-Morton) traversal of the C block grid; within the Scheduler phase,
every C block's updates are contiguous in its stack (the paper
statically assigns batches with a given A row-block to one OpenMP
thread to avoid data races; the port's CUDA ``smm`` kernel gives each
contiguous C run to one thread block, which keeps the accumulator in
registers and needs no atomics).

All outputs are host-side numpy; they parameterise the smm kernel.
They are a copy of the JAX package's stack generator and must stay
byte-equal to it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .blocking import BlockLayout, morton_order

STACK_SIZE = 30_000  # paper: "each batch consists of maximum 30'000"

__all__ = ["StackPlan", "build_stacks", "normalize_block_masks",
           "pad_plans", "stack_rank_slab", "stack_statistics", "STACK_SIZE"]


def normalize_block_masks(
    nbr: int,
    nbk: int,
    nbc: int,
    a_mask: "Optional[np.ndarray]" = None,
    b_mask: "Optional[np.ndarray]" = None,
):
    """Canonical occupancy-mask normalization, shared by every layer
    (stacks / engine / multiply / dbcsr): ``None`` means dense (all
    blocks present), anything else must be a bool-coercible array of
    exactly the block-grid shape."""
    am = (np.ones((nbr, nbk), dtype=bool) if a_mask is None
          else np.asarray(a_mask, dtype=bool))
    bm = (np.ones((nbk, nbc), dtype=bool) if b_mask is None
          else np.asarray(b_mask, dtype=bool))
    if am.shape != (nbr, nbk):
        raise ValueError(f"a_mask shape {am.shape} != block grid {(nbr, nbk)}")
    if bm.shape != (nbk, nbc):
        raise ValueError(f"b_mask shape {bm.shape} != block grid {(nbk, nbc)}")
    return am, bm


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """A batch of small-GEMM triples: C[c] += A[a] @ B[b].

    ``triples`` is (S, 3) int32 with columns (a_block, b_block, c_block);
    block indices are flat indices into the row-major (nbr, nbk) /
    (nbk, nbc) / (nbr, nbc) block grids of the local operands.
    Sorted so that equal c_block entries are contiguous (see module doc).
    """

    triples: np.ndarray
    n_c_blocks: int
    block_m: int
    block_k: int
    block_n: int

    @property
    def size(self) -> int:
        return int(self.triples.shape[0])

    def flops(self) -> int:
        return 2 * self.size * self.block_m * self.block_k * self.block_n


def _pair_presence(
    nbr: int,
    nbk: int,
    nbc: int,
    i: np.ndarray,
    j: np.ndarray,
    a_mask: Optional[np.ndarray],
    b_mask: Optional[np.ndarray],
    pair_mask: Optional[np.ndarray],
) -> np.ndarray:
    """(n_c, nbk) bool: which k-updates exist for each C block, with
    rows ordered by the Morton traversal (i, j)."""
    if pair_mask is not None:
        if a_mask is not None or b_mask is not None:
            raise ValueError("pass either pair_mask or a_mask/b_mask, not both")
        pair_mask = np.asarray(pair_mask, dtype=bool)
        if pair_mask.shape != (nbr, nbk, nbc):
            raise ValueError(
                f"pair_mask shape {pair_mask.shape} != {(nbr, nbk, nbc)}")
        return pair_mask[i, :, j]
    am, bm = normalize_block_masks(nbr, nbk, nbc, a_mask, b_mask)
    return am[i] & bm[:, j].T


def _norm_keep(
    nbr: int,
    nbk: int,
    nbc: int,
    i: np.ndarray,
    j: np.ndarray,
    a_norms: Optional[np.ndarray],
    b_norms: Optional[np.ndarray],
    pair_norms: Optional[np.ndarray],
    filter_eps: float,
) -> np.ndarray:
    """(n_c, nbk) bool: which k-updates clear the norm-product threshold
    (``norm(A_ik) * norm(B_kj) >= filter_eps`` — the on-the-fly filter;
    see repro_torch.sparsity).  Rows follow the same Morton traversal as
    ``_pair_presence``, so the two AND together elementwise.  At eps 0
    every product (``>= 0``) passes, keeping the filtered enumeration
    bit-identical to the mask-only one."""
    eps = float(filter_eps)
    if pair_norms is not None:
        if a_norms is not None or b_norms is not None:
            raise ValueError(
                "pass either pair_norms or a_norms/b_norms, not both")
        pair_norms = np.asarray(pair_norms, dtype=np.float32)
        if pair_norms.shape != (nbr, nbk, nbc):
            raise ValueError(
                f"pair_norms shape {pair_norms.shape} != {(nbr, nbk, nbc)}")
        return pair_norms.astype(np.float64)[i, :, j] >= eps
    from ..sparsity.norms import normalize_block_norms

    an, bn = normalize_block_norms(nbr, nbk, nbc, a_norms, b_norms)
    return (an.astype(np.float64)[i] * bn.astype(np.float64)[:, j].T) >= eps


def build_stacks(
    a_layout: BlockLayout,
    b_layout: BlockLayout,
    stack_size: int = STACK_SIZE,
    a_mask: Optional[np.ndarray] = None,
    b_mask: Optional[np.ndarray] = None,
    pair_mask: Optional[np.ndarray] = None,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
    pair_norms: Optional[np.ndarray] = None,
    filter_eps: Optional[float] = None,
) -> List[StackPlan]:
    """Generation phase: enumerate the *present* (a, b, c) block triples
    of the local multiply, in cache-oblivious traversal order over the C
    block grid, then split into stacks of at most ``stack_size``.

    Occupancy filtering — where the block-sparse speedup comes from
    (paper section II): with ``a_mask`` ((nbr, nbk) bool) and/or
    ``b_mask`` ((nbk, nbc) bool) given, C block (i, j) only receives the
    updates k where ``a_mask[i, k] & b_mask[k, j]``; its k-run becomes
    *ragged* (possibly empty).  ``pair_mask`` ((nbr, nbk, nbc) bool)
    states the k-updates per C block directly, for callers whose
    presence structure is not a product of two factors (the distributed
    layer's shifted-union plans, multiply.py).  With no masks every
    block is present and the triple count is nbr * nbk * nbc — exactly
    the "~8 million stacks for block size 22" regime the paper measures
    for the 63'360^2 matrices; masked output with all-true masks is
    bit-identical to the dense enumeration.

    Norm filtering — DBCSR's on-the-fly filter (repro_torch.sparsity): with
    ``filter_eps`` not None and block norms given (``a_norms`` /
    ``b_norms`` (float, block-grid shapes) or a direct ``pair_norms``
    ((nbr, nbk, nbc), the distributed layer's per-step union-of-max
    products), a mask-present triple is additionally dropped when
    ``norm(A_ik) * norm(B_kj) < filter_eps``.  ``filter_eps=0.0``
    retains everything — bit-identical to the mask-only enumeration —
    while ``filter_eps=None`` skips the predicate entirely.
    """
    if a_layout.block_cols != b_layout.block_rows:
        raise ValueError("inner block dims disagree")
    if a_layout.cols != b_layout.rows:
        raise ValueError("inner dims disagree")

    nbr = a_layout.nblock_rows
    nbk = a_layout.nblock_cols
    nbc = b_layout.nblock_cols

    # Traversal phase: Z-Morton over the C block grid for locality.
    c_order = morton_order(nbr, nbc)

    # Generation phase: for each C block (i, j), the k-run of *present*
    # updates.  np.nonzero walks the (n_c, nbk) presence grid row-major,
    # so each C block's k-run stays contiguous => accumulator-friendly
    # for the smm kernel.
    i = c_order[:, 0].astype(np.int64)
    j = c_order[:, 1].astype(np.int64)
    pair = _pair_presence(nbr, nbk, nbc, i, j, a_mask, b_mask, pair_mask)
    if filter_eps is not None and (a_norms is not None or b_norms is not None
                                   or pair_norms is not None):
        pair = pair & _norm_keep(nbr, nbk, nbc, i, j, a_norms, b_norms,
                                 pair_norms, filter_eps)
    rows, ks = np.nonzero(pair)
    a_idx = i[rows] * nbk + ks
    b_idx = ks * nbc + j[rows]
    c_idx = i[rows] * nbc + j[rows]
    triples = np.stack([a_idx, b_idx, c_idx], axis=1).astype(np.int32)

    # Scheduler phase: greedily pack whole (now possibly ragged) k-runs
    # into stacks of at most ``stack_size``; never split a C block's
    # k-run across stacks (keeps revisit-contiguity inside every stack).
    # A run longer than ``stack_size`` gets a stack of its own.
    run_lens = pair.sum(axis=1).astype(np.int64)
    total = int(triples.shape[0])
    plan_slices = []
    if total and (run_lens == run_lens[0]).all():
        # uniform runs (the dense regime — millions of C blocks for the
        # paper's 63'360^2 matrices): fixed-step split, no Python loop
        # over runs, bit-identical to the historical dense scheduler.
        run = int(run_lens[0])
        step = max(1, stack_size // run) * run
        plan_slices = [(s, min(s + step, total))
                       for s in range(0, total, step)]
    elif total:
        # ragged runs: greedy packing over the non-empty run *end*
        # boundaries, O(n_stacks) iterations (not O(n_runs)) — each
        # stack takes the longest run prefix fitting stack_size, or a
        # single oversized run.
        bounds = np.concatenate([[0], np.cumsum(run_lens)])
        ends = bounds[1:][run_lens > 0]
        start = 0
        while start < total:
            fit = np.searchsorted(ends, start + stack_size, side="right") - 1
            first = np.searchsorted(ends, start, side="right")
            stop = int(ends[max(fit, first)])
            plan_slices.append((start, stop))
            start = stop

    return [
        StackPlan(
            triples=triples[start:stop],
            n_c_blocks=nbr * nbc,
            block_m=a_layout.block_rows,
            block_k=a_layout.block_cols,
            block_n=b_layout.block_cols,
        )
        for start, stop in plan_slices
    ]


def pad_plans(
    plans: List[StackPlan],
    stack_tile: int | None = None,
    sentinel_c: int | None = None,
) -> np.ndarray:
    """Pad ragged stack plans into one ``(n_stacks, stack_tile, 4)`` tensor.

    The fused executor (core/engine.py) hands every stack of a size bin
    to one kernel launch as a single flattened tensor.  Output columns
    are ``(a_idx, b_idx, c_idx, valid)``; padding rows carry
    ``(0, 0, sentinel_c, 0)``:

      * ``valid == 0`` marks the padding entry: the plain version zeroes
        its product, the CUDA kernel never visits it,
      * ``c_idx == sentinel_c`` (default: one past the last real C block,
        the executor appends a scratch block there) keeps the padding
        writes off the real C blocks AND preserves the run-contiguity
        invariant inside every padded stack — the padding rows form one
        trailing run of their own.
    """
    if not plans:
        raise ValueError("no stack plans to pad")
    n_c = plans[0].n_c_blocks
    sentinel = n_c if sentinel_c is None else sentinel_c
    tile = max(p.size for p in plans) if stack_tile is None else stack_tile
    out = np.zeros((len(plans), tile, 4), dtype=np.int32)
    out[:, :, 2] = sentinel
    for i, p in enumerate(plans):
        if p.size > tile:
            raise ValueError(f"plan of size {p.size} exceeds stack_tile {tile}")
        out[i, : p.size, :3] = p.triples
        out[i, : p.size, 3] = 1
    return out


def stack_rank_slab(
    rank_triples: List[np.ndarray],
    n_c_blocks: int,
) -> np.ndarray:
    """Stack per-rank padded triple tensors into one ``(R, S, T, 4)`` slab.

    Each rank's ``(S_r, T_r, 4)`` tensor (the single-tensor view of its
    own plan) is grown to the across-rank maxima ``S = max(S_r)`` and
    ``T = max(T_r)`` with the rows ``pad_plans`` pads with:
    ``(0, 0, n_c_blocks, 0)``, the scratch block with ``valid == 0``.  A
    rank whose plan is empty contributes an all-padding slice.  This is
    the JAX package's per-rank plan layout (one traced shape for every
    rank); the port keeps it for statistics and executes the ranks'
    concatenated triples instead (core/engine.py).
    """
    if not rank_triples:
        raise ValueError("no per-rank triple tensors to stack")
    n_stacks = max(int(t.shape[0]) for t in rank_triples)
    tile = max((int(t.shape[1]) for t in rank_triples
                if t.shape[0]), default=1)
    tile = max(tile, 1)
    out = np.zeros((len(rank_triples), max(n_stacks, 0), tile, 4),
                   dtype=np.int32)
    out[:, :, :, 2] = n_c_blocks
    for r, t in enumerate(rank_triples):
        s, w = int(t.shape[0]), int(t.shape[1])
        if w > tile or s > n_stacks:
            raise ValueError(
                f"rank {r} tensor {t.shape} exceeds slab ({n_stacks}, {tile})")
        out[r, :s, :w, :] = t
    return out


def stack_statistics(plans: List[StackPlan],
                     stack_tile: int | None = None) -> dict:
    """Summary used by benchmarks (paper quotes stack counts directly).

    With ``stack_tile`` given, also reports the padding the fused
    executor introduces (mask fill ratio of the padded stack tensor).
    """
    sizes = [p.size for p in plans]
    stats = {
        "n_stacks": len(plans),
        "n_multiplications": int(np.sum(sizes)),
        "max_stack": int(np.max(sizes)) if sizes else 0,
        "flops": int(np.sum([p.flops() for p in plans])),
    }
    if stack_tile is None and sizes:
        stack_tile = stats["max_stack"]
    if stack_tile:
        padded_total = len(plans) * stack_tile
        stats["stack_tile"] = stack_tile
        stats["n_padding"] = padded_total - stats["n_multiplications"]
        stats["fill"] = stats["n_multiplications"] / padded_total
    return stats
