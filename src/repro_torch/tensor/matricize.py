"""Matricization: unfold an N-d blocked tensor into a 2D DBCSRMatrix
view, and fold a 2D product back into the N-d output frame (the port's
copy of the JAX package's ``tensor/matricize.py``: payloads unfold on
the mesh's device by ``permute`` + ``reshape``, which copies only when
the permutation moves data, as the reference's transpose does; the
block-grid functions are byte-equal numpy copies).

The contraction ``C[a_free + b_free] = sum_k A[a_free, k] B[k, b_free]``
lowers onto ``dbcsr.multiply`` by fusing each index group into one
blocked matrix dimension.  The unfold is BLOCK-level, not element-level:
each axis ``d = nb * bs`` is first split ``(nb, bs)``, then all block
axes of a group are brought together ahead of all intra-block axes

    (nb_1, bs_1, ..., nb_N, bs_N)
        -> (nb_r..., bs_r..., nb_c..., bs_c...)   [one transpose]
        -> (R, C)                                  [one reshape]

so the fused dimension is again uniformly blocked with block size
``prod(bs_group)`` and the row-major fused block index runs over the
group's block grid.  This is what makes the lowering exact and cheap in
metadata:

  * bijection — 2D block ``(I, J)`` of the view contains exactly the
    elements of one N-d block, so an N-d block is retained iff its
    matricized image is (mask lowering is a pure block-grid
    transpose+reshape, ``unfold_grid``),
  * norm exactness — the unfold permutes elements *within* a block, and
    Frobenius norms are permutation-invariant, so the N-d norm cache
    lowers through the same grid transpose with no device work.

A ``Layout`` fixes the three free choices of the lowering: the fusion
order of the A-free group (matrix rows), of the contracted group (the
shared inner dimension — MUST match between both operands or the block
columns of the A view and block rows of the B view would disagree), of
the B-free group (matrix cols), and whether the product is computed
transposed (``swapped``: the B view is the left operand computing
``C^T``).  All of them produce the same output tensor up to float
accumulation order; they differ in 2D shape, mask geometry, per-rank
balance and copy cost — which is why layout choice is routed through
the planner (``repro_torch.planner.plan_contract``) instead of
hardcoded.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.blocking import BlockLayout
from ..core.dbcsr import DBCSRMatrix

from .einsum import ContractionSpec
from .tensor import DBCSRTensor

__all__ = ["Layout", "LayoutStats", "enumerate_layouts", "unfold_grid",
           "fold_grid", "unfold_tensor", "fold_to_tensor",
           "unfold_is_trivial", "contraction_layout_stats"]


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclasses.dataclass(frozen=True)
class Layout:
    """One legal matricization of a contraction.

    a_rows   permutation of the A-free group (row fusion order)
    k_order  permutation of the contracted group (shared inner fusion
             order — used by BOTH operand views)
    b_cols   permutation of the B-free group (col fusion order)
    swapped  compute the product transposed: the matricized B (rows =
             b_cols, cols = k) is the LEFT operand, the matricized A
             (rows = k, cols = a_rows) the right, and the 2D result
             ``C^T`` folds back through the mirrored group assignment
    """

    a_rows: Tuple[str, ...]
    k_order: Tuple[str, ...]
    b_cols: Tuple[str, ...]
    swapped: bool = False

    @property
    def label(self) -> str:
        a, k, c = ("".join(self.a_rows), "".join(self.k_order),
                   "".join(self.b_cols))
        if self.swapped:
            return f"({c}|{k})@({k}|{a})^T"
        return f"({a}|{k})@({k}|{c})"


def enumerate_layouts(con: ContractionSpec) -> Tuple[Layout, ...]:
    """Every legal matricization of ``con``: all fusion orders of the
    three index groups x the transposed variant.  The spec-order
    unswapped layout comes first (the "obvious" lowering)."""
    out = []
    for ap in itertools.permutations(con.a_free):
        for kp in itertools.permutations(con.contracted):
            for bp in itertools.permutations(con.b_free):
                for sw in (False, True):
                    out.append(Layout(ap, kp, bp, sw))
    return tuple(out)


# -- unfold / fold of payloads and block grids -------------------------

def _unfold_perm(indices: Sequence[str], rows: Sequence[str],
                 cols: Sequence[str]) -> Tuple[int, ...]:
    """Transpose permutation over the interleaved (nb_1, bs_1, ...,
    nb_N, bs_N) axes bringing the row group's block axes first, then its
    intra-block axes, then the col group's."""
    pos = {label: ax for ax, label in enumerate(indices)}
    return tuple([2 * pos[r] for r in rows]
                 + [2 * pos[r] + 1 for r in rows]
                 + [2 * pos[c] for c in cols]
                 + [2 * pos[c] + 1 for c in cols])


def unfold_is_trivial(indices: Sequence[str], rows: Sequence[str],
                      cols: Sequence[str]) -> bool:
    """True iff the unfold moves no data (the transpose is the
    identity) — exactly the 2D spec-order case, where the matricized
    view IS the tensor payload."""
    perm = _unfold_perm(indices, rows, cols)
    return perm == tuple(range(len(perm)))


def _permute(x, perm):
    """``transpose`` for a numpy array, ``permute`` for a tensor."""
    if isinstance(x, torch.Tensor):
        return x.permute(*perm)
    return x.transpose(perm)


def unfold_array(x, indices: Sequence[str], rows: Sequence[str],
                 cols: Sequence[str], block_sizes: Sequence[int]):
    """Block-level unfold of an N-d payload (tensor or numpy) into its
    (R, C) matricized view."""
    inter = []
    for d, bs in zip(x.shape, block_sizes):
        inter += [int(d) // int(bs), int(bs)]
    dims = dict(zip(indices, (int(d) for d in x.shape)))
    y = _permute(x.reshape(inter), _unfold_perm(indices, rows, cols))
    return y.reshape(_prod(dims[r] for r in rows),
                     _prod(dims[c] for c in cols))


def unfold_grid(g: np.ndarray, indices: Sequence[str],
                rows: Sequence[str], cols: Sequence[str]) -> np.ndarray:
    """Block-grid unfold (masks / norms): pure transpose+reshape on the
    host grid — the mask/norm lowering semantics of the subsystem."""
    pos = {label: ax for ax, label in enumerate(indices)}
    perm = [pos[r] for r in rows] + [pos[c] for c in cols]
    p = len(rows)
    t = np.ascontiguousarray(np.transpose(g, perm))
    return t.reshape(_prod(t.shape[:p]), _prod(t.shape[p:]))


def fold_array(x2d, out_indices: Sequence[str], rows: Sequence[str],
               cols: Sequence[str], nb: dict, bs: dict):
    """Inverse of ``unfold_array``: fold a (R, C) payload whose row/col
    groups are ``rows``/``cols`` back into the N-d frame ordered by
    ``out_indices`` (any permutation of rows + cols)."""
    p, q = len(rows), len(cols)
    shape = ([nb[r] for r in rows] + [bs[r] for r in rows]
             + [nb[c] for c in cols] + [bs[c] for c in cols])
    y = x2d.reshape(shape)
    bpos, ipos = {}, {}
    for i, r in enumerate(rows):
        bpos[r], ipos[r] = i, p + i
    for j, c in enumerate(cols):
        bpos[c], ipos[c] = 2 * p + j, 2 * p + q + j
    perm = []
    for o in out_indices:
        perm += [bpos[o], ipos[o]]
    return _permute(y, perm).reshape([nb[o] * bs[o] for o in out_indices])


def fold_grid(g2d: np.ndarray, out_indices: Sequence[str],
              rows: Sequence[str], cols: Sequence[str],
              nb: dict) -> np.ndarray:
    """Inverse of ``unfold_grid`` for block masks/norms."""
    shape = [nb[r] for r in rows] + [nb[c] for c in cols]
    y = np.asarray(g2d).reshape(shape)
    group = list(rows) + list(cols)
    perm = [group.index(o) for o in out_indices]
    return np.ascontiguousarray(np.transpose(y, perm))


def unfold_tensor(t: DBCSRTensor, indices: Sequence[str],
                  rows: Sequence[str], cols: Sequence[str], *,
                  mesh) -> DBCSRMatrix:
    """Matricize a blocked tensor into a DBCSRMatrix on the mesh's
    device, lowering its mask and (if cached) its norm cache — the
    retained-iff-image-retained contract."""
    data = unfold_array(t.data, indices, rows, cols, t.block_sizes)
    data = data.to(mesh.device)
    bs = dict(zip(indices, t.block_sizes))
    layout = BlockLayout(int(data.shape[0]), int(data.shape[1]),
                         _prod(bs[r] for r in rows),
                         _prod(bs[c] for c in cols))
    mask = norms = None
    if t.block_mask is not None:
        mask = unfold_grid(t.block_mask, indices, rows, cols)
    if t.block_norms is not None:
        norms = unfold_grid(t.block_norms, indices, rows,
                            cols).astype(np.float32)
    return DBCSRMatrix(data, layout, t.grid, mask, norms)


def fold_to_tensor(c: DBCSRMatrix, out_indices: Sequence[str],
                   rows: Sequence[str], cols: Sequence[str],
                   dims: dict, bs: dict, grid, *, mesh) -> DBCSRTensor:
    """Fold a 2D product back into the N-d output frame (the refold
    frame guarantee: the result's axis order is exactly the spec's
    output order, independent of which layout executed)."""
    nb = {o: dims[o] // bs[o] for o in out_indices}
    data = fold_array(c.data, out_indices, rows, cols, nb, bs)
    data = data.to(mesh.device)
    mask = None
    if c.block_mask is not None:
        mask = fold_grid(c.block_mask, out_indices, rows, cols, nb)
    return DBCSRTensor(data, tuple(bs[o] for o in out_indices), grid, mask)


# -- per-layout planning statistics ------------------------------------

@dataclasses.dataclass(frozen=True)
class LayoutStats:
    """Everything the planner needs to price one matricization: the 2D
    problem it induces, its (layout-invariant) retained occupancy, its
    (layout-dependent) per-rank imbalance, and the unfold/refold copy
    traffic.  Frozen + hashable: this tuple IS the contraction plan
    cache key's layout component."""

    layout: Layout
    label: str
    m: int
    k: int
    n: int
    block_m: int
    block_k: int
    block_n: int
    occupancy: float
    rank_imbalance: Optional[float]
    copy_bytes: int
    feasible: bool
    reason: str = ""


def layout_operands(con: ContractionSpec, layout: Layout):
    """Resolve which tensor matricizes to which side of the 2D product:
    returns ``(left_src, left_rows, left_cols, right_src, right_rows,
    right_cols, c_rows, c_cols)`` with src in {"a", "b"} and the C
    groups naming the 2D product's row/col index groups."""
    if layout.swapped:
        return ("b", layout.b_cols, layout.k_order,
                "a", layout.k_order, layout.a_rows,
                layout.b_cols, layout.a_rows)
    return ("a", layout.a_rows, layout.k_order,
            "b", layout.k_order, layout.b_cols,
            layout.a_rows, layout.b_cols)


def contraction_layout_stats(
    con: ContractionSpec,
    layout: Layout,
    a: DBCSRTensor,
    b: DBCSRTensor,
    *,
    mesh_shape: Tuple[int, int],
    filter_eps: Optional[float] = None,
    rank_exact=None,
    device="cpu",
) -> LayoutStats:
    """Price the geometry of one layout (no cost-model evaluation here
    — that is ``plan_contract``'s job; this computes the inputs it is
    priced on, mirroring core/multiply.py's occupancy and rank-exact
    imbalance resolution on the matricized masks).  ``device`` is where
    the norm-filtered per-rank weights are counted (the contraction
    passes its mesh's; the counts are the same on any device)."""
    from ..core.multiply import _global_occupancy

    dims = {**dict(zip(con.a_indices, a.shape)),
            **dict(zip(con.b_indices, b.shape))}
    bs = {**dict(zip(con.a_indices, a.block_sizes)),
          **dict(zip(con.b_indices, b.block_sizes))}
    lsrc, lrows, lcols, rsrc, rrows, rcols, crows, ccols = \
        layout_operands(con, layout)
    left = a if lsrc == "a" else b
    right = b if rsrc == "b" else a
    lidx = con.a_indices if lsrc == "a" else con.b_indices
    ridx = con.b_indices if rsrc == "b" else con.a_indices

    m = _prod(dims[x] for x in lrows)
    k = _prod(dims[x] for x in lcols)
    n = _prod(dims[x] for x in rcols)
    block_m = _prod(bs[x] for x in lrows)
    block_k = _prod(bs[x] for x in lcols)
    block_n = _prod(bs[x] for x in rcols)

    am = bm = an = bn = None
    if left.block_mask is not None:
        am = unfold_grid(left.block_mask, lidx, lrows, lcols)
    if right.block_mask is not None:
        bm = unfold_grid(right.block_mask, ridx, rrows, rcols)
    if filter_eps is not None:
        if left.block_norms is not None:
            an = unfold_grid(left.block_norms, lidx, lrows,
                             lcols).astype(np.float32)
        if right.block_norms is not None:
            bn = unfold_grid(right.block_norms, ridx, rrows,
                             rcols).astype(np.float32)
    occ = _global_occupancy(m, k, n, block_m, block_k, block_n,
                            am, bm, an, bn, filter_eps)

    pr, pc = mesh_shape[0], mesh_shape[1]
    nbr, nbk, nbc = m // block_m, k // block_k, n // block_n
    feasible, reason = True, ""
    if nbr % pr or nbc % pc:
        feasible = False
        reason = (f"block grid {nbr}x{nbc} not divisible by mesh "
                  f"{pr}x{pc}")

    # per-rank retained-triple imbalance of THIS layout's C-chunk
    # decomposition — the layout-dependent signal (occupancy is
    # layout-invariant: the retained triples are the same set, only
    # their arrangement over ranks changes).  Mirrors the resolution in
    # core/multiply.py so the inner multiply replans to the same answer.
    rank_imb = None
    masked = am is not None or bm is not None or filter_eps is not None
    if (feasible and rank_exact is not False and masked and pr * pc > 1):
        from ..core.stacks import normalize_block_masks
        from ..sparsity.balance import (chunk_imbalance,
                                        retained_block_weights)
        from ..sparsity.norms import normalize_block_norms

        amf, bmf = normalize_block_masks(nbr, nbk, nbc, am, bm)
        an_g = bn_g = None
        if filter_eps is not None:
            an_g, bn_g = normalize_block_norms(nbr, nbk, nbc, an, bn)
            an_g = np.where(amf, an_g, np.float32(0.0))
            bn_g = np.where(bmf, bn_g, np.float32(0.0))
        rank_imb = chunk_imbalance(
            retained_block_weights(amf, bmf, an_g, bn_g, filter_eps,
                                   device=device),
            pr, pc)

    # unfold/refold traffic: one read + one write per moved payload;
    # a trivial (identity-permutation) unfold moves nothing
    itemsize = int(left.data.element_size())
    copy = 0
    if not unfold_is_trivial(lidx, lrows, lcols):
        copy += 2 * left.data.numel()
    if not unfold_is_trivial(ridx, rrows, rcols):
        copy += 2 * right.data.numel()
    out_idx = con.out_indices
    if not unfold_is_trivial(out_idx, crows, ccols):
        copy += 2 * m * n
    return LayoutStats(
        layout=layout, label=layout.label, m=m, k=k, n=n,
        block_m=block_m, block_k=block_k, block_n=block_n,
        occupancy=float(occ),
        rank_imbalance=None if rank_imb is None else float(rank_imb),
        copy_bytes=int(copy * itemsize), feasible=feasible, reason=reason)
