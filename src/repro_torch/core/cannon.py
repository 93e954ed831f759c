"""Cannon's algorithm on a square process grid.

DBCSR's data-exchange algorithm for general matrix shapes (paper
section II): per-rank communicated data scales O(1/sqrt(P)).  Rank
(i, j) starts from the skewed chunks A(i, (i+j)%P) and B((i+j)%P, j),
multiplies, then shifts A left along its row and B up along its column,
P times.  The skew is one joint-axis ``Mesh.ppermute`` over the
flattened (row, col) axes, the shifts single-axis ones; on the one card
each is a device copy between the ranks of the rank axis
(launch/mesh.py), and on a 1x1 grid the identity.

This module is a pure *schedule builder* plus the driver call:
``build_cannon_schedule`` emits the step sequence, ``cannon_step_masks``
and ``cannon_step_norms`` emit the per-step occupancy-mask and
norm-product slices unioned over ranks, ``cannon_rank_steps`` each
rank's own (host numpy, copied from the JAX package, with the 2.5D
replication ``c_repl``), and ``schedule.execute_schedule`` runs the
loop.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from .blocking import GridSpec
from .densify import densified_local_matmul
from .schedule import (RolledSpec, Schedule, execute_schedule,
                       resolve_pipeline_depth)

__all__ = ["cannon_matmul", "build_cannon_schedule", "cannon_step_masks",
           "cannon_step_norms", "cannon_rank_steps"]


def _skew_perm(pg: int, which: str):
    """Joint-axis permutation realising the Cannon pre-skew, as
    (source, destination) pairs over the row-major flattened (row, col)
    index space: A (i, j) sends to (i, (j - i) % P), B (i, j) to
    ((i - j) % P, j)."""
    pairs = []
    for i in range(pg):
        for j in range(pg):
            if which == "a":
                pairs.append((i * pg + j, i * pg + ((j - i) % pg)))
            else:
                pairs.append((i * pg + j, ((i - j) % pg) * pg + j))
    return pairs


def _shift_perm(pg: int):
    """Single-axis circular shift by one (left/up)."""
    return [(k, (k - 1) % pg) for k in range(pg)]


def build_cannon_schedule(
    pg: int,
    *,
    mesh,
    row_axis: str,
    col_axis: str,
    skew: bool = True,
    steps: Optional[int] = None,
    empty_steps: frozenset = frozenset(),
    local_shape: Optional[tuple] = None,
    itemsize: int = 4,
) -> Schedule:
    """Schedule for Cannon's algorithm on a ``pg`` x ``pg`` grid of
    ``mesh``.  ``steps`` serves the 2.5D variant (cannon25d.py), where
    each replica runs a subset of the shifts.
    ``local_shape`` = (ml, kl, nl) of the per-rank multiply fills the
    observability byte counts."""
    n_steps = pg if steps is None else steps
    shift_a = _shift_perm(pg)
    shift_b = _shift_perm(pg)

    def prologue(a_blk, b_blk):
        if skew:
            a_blk = mesh.ppermute(a_blk, (row_axis, col_axis),
                                  _skew_perm(pg, "a"))
            b_blk = mesh.ppermute(b_blk, (row_axis, col_axis),
                                  _skew_perm(pg, "b"))
        return (a_blk, b_blk)

    def shift(carry, t):
        a_blk, b_blk = carry
        return (mesh.ppermute(a_blk, col_axis, shift_a),
                mesh.ppermute(b_blk, row_axis, shift_b))

    def rolled_shift(carry):
        return shift(carry, 0)

    step_bytes = prologue_bytes = 0
    if local_shape is not None:
        ml, kl, nl = local_shape
        step_bytes = (ml * kl + kl * nl) * itemsize
        prologue_bytes = step_bytes if skew else 0

    return Schedule(
        algorithm="cannon",
        n_steps=n_steps,
        prologue=prologue,
        shift=shift,
        empty_steps=frozenset(empty_steps),
        rolled=RolledSpec(shift=rolled_shift),
        comm_op=f"ppermute(a:{col_axis}, b:{row_axis})",
        prologue_comm_bytes=prologue_bytes,
        # the final step receives no shift: n_steps - 1 shifts total
        step_comm_bytes=tuple(
            step_bytes if t + 1 < n_steps else 0 for t in range(n_steps)),
    )


def cannon_step_masks(
    am: np.ndarray, bm: np.ndarray, pg: int, c_repl: int = 1,
) -> List[np.ndarray]:
    """Per-shift-step local pair-presence tensors for (2.5D) Cannon.

    At inner step t, rank (i, j) of replica p holds the A chunk (i, q)
    and B chunk (q, j) with q = (i + j + p*spr + t) % pg.  The
    (nbr_l, nbk_l, nbc_l) tensor for step t is the union over all
    (p, i, j) of that rank's chunk-product presence: the tightest plan
    every rank can share.
    """
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    if nbr % pg or nbk % pg or nbc % pg:
        raise ValueError(
            f"block grid ({nbr},{nbk},{nbc}) not divisible by cannon grid "
            f"side {pg}")
    if c_repl < 1 or pg % c_repl:
        raise ValueError(f"grid side {pg} not divisible by replication {c_repl}")
    lr, lk, lc = nbr // pg, nbk // pg, nbc // pg
    spr = pg // c_repl  # shift steps each replica executes
    out = []
    for t in range(spr):
        pair = np.zeros((lr, lk, lc), dtype=bool)
        for p in range(c_repl):
            off = t + p * spr
            for i in range(pg):
                for j in range(pg):
                    q = (i + j + off) % pg
                    ac = am[i * lr:(i + 1) * lr, q * lk:(q + 1) * lk]
                    if not ac.any():
                        continue
                    bc = bm[q * lk:(q + 1) * lk, j * lc:(j + 1) * lc]
                    pair |= ac[:, :, None] & bc[None, :, :]
        out.append(pair)
    return out


def cannon_step_norms(
    an: np.ndarray, bn: np.ndarray, pg: int, c_repl: int = 1,
) -> List[np.ndarray]:
    """Per-shift-step local NORM-PRODUCT tensors for (2.5D) Cannon, the
    norm twin of ``cannon_step_masks``: the per-rank MAX of
    ``norm(A_ik) * norm(B_kj)`` (union-of-max), so a triple is dropped
    only when it falls below eps on every rank."""
    nbr, nbk = an.shape
    nbc = bn.shape[1]
    if nbr % pg or nbk % pg or nbc % pg:
        raise ValueError(
            f"block grid ({nbr},{nbk},{nbc}) not divisible by cannon grid "
            f"side {pg}")
    if c_repl < 1 or pg % c_repl:
        raise ValueError(f"grid side {pg} not divisible by replication {c_repl}")
    an = np.asarray(an, dtype=np.float32)
    bn = np.asarray(bn, dtype=np.float32)
    lr, lk, lc = nbr // pg, nbk // pg, nbc // pg
    spr = pg // c_repl
    out = []
    for t in range(spr):
        pair = np.zeros((lr, lk, lc), dtype=np.float32)
        for p in range(c_repl):
            off = t + p * spr
            for i in range(pg):
                for j in range(pg):
                    q = (i + j + off) % pg
                    ac = an[i * lr:(i + 1) * lr, q * lk:(q + 1) * lk]
                    if not ac.any():
                        continue
                    bc = bn[q * lk:(q + 1) * lk, j * lc:(j + 1) * lc]
                    np.maximum(pair, ac[:, :, None] * bc[None, :, :],
                               out=pair)
        out.append(pair)
    return out


def cannon_rank_steps(
    am: np.ndarray, bm: np.ndarray, pg: int, c_repl: int = 1,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
) -> List[List[dict]]:
    """Rank-exact twin of ``cannon_step_masks``/``cannon_step_norms``:
    per step, per RANK local mask (and norm) kwargs instead of the
    union over ranks.

    ``out[t][r]`` is the mask/norm kwarg dict for the rank with flat
    index ``r = (p * pg + i) * pg + j`` (stack-major, matching
    ``cannon25d._skew25d_perm``; plain Cannon is the ``c_repl == 1``
    slice ``r = i * pg + j``) at inner shift step ``t`` — the exact A
    chunk ``(i, q)`` x B chunk ``(q, j)`` with
    ``q = (i + j + t + p*spr) % pg``.  The factored ``a_mask``/
    ``b_mask`` form is exact per rank (no cross-rank union), and the
    norms are the rank's own chunk norms — eps filtering against them
    is DBCSR's true local filter rather than the union-of-max bound.
    """
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    if nbr % pg or nbk % pg or nbc % pg:
        raise ValueError(
            f"block grid ({nbr},{nbk},{nbc}) not divisible by cannon grid "
            f"side {pg}")
    if c_repl < 1 or pg % c_repl:
        raise ValueError(f"grid side {pg} not divisible by replication {c_repl}")
    lr, lk, lc = nbr // pg, nbk // pg, nbc // pg
    spr = pg // c_repl
    if a_norms is not None:
        a_norms = np.asarray(a_norms, dtype=np.float32)
        b_norms = np.asarray(b_norms, dtype=np.float32)
    steps: List[List[dict]] = []
    for t in range(spr):
        ranks: List[dict] = []
        for p in range(c_repl):
            for i in range(pg):
                rs = slice(i * lr, (i + 1) * lr)
                for j in range(pg):
                    q = (i + j + t + p * spr) % pg
                    ks = slice(q * lk, (q + 1) * lk)
                    cs = slice(j * lc, (j + 1) * lc)
                    kw = {"a_mask": am[rs, ks], "b_mask": bm[ks, cs]}
                    if a_norms is not None:
                        kw["a_norms"] = a_norms[rs, ks]
                        kw["b_norms"] = b_norms[ks, cs]
                    ranks.append(kw)
        steps.append(ranks)
    return steps


def _default_local_matmul(precision=None):
    """The schedules' default local multiply: the densified GEMM at
    ``precision`` (the JAX package's ``_default_local_matmul``)."""
    return densified_local_matmul(precision)


def cannon_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh,
    grid: GridSpec = GridSpec(),
    local_matmul: Optional[Callable] = None,
    out_dtype: Optional[torch.dtype] = None,
    precision=None,
    pipeline_depth: Optional[int] = None,
    double_buffer: Optional[bool] = None,
    skew: bool = True,
) -> torch.Tensor:
    """C = A @ B with Cannon's algorithm on a square (row, col) grid.

    ``a`` (M, K) and ``b`` (K, N) are the global matrices on
    ``mesh.device`` (leading batch dims, a fused product batch, are
    replicated); they are cut into the rank-stacked spec (row, col) as
    ``shard_map`` cuts the JAX package's operands, and C comes back in
    the same layout.  ``local_matmul`` takes and returns rank-stacked
    blocks.  ``pipeline_depth``: 2 = overlap order (default), 1 =
    serial, 0 = rolled; ``double_buffer`` is the legacy spelling (True
    -> 2, False -> 0).
    ``precision`` (None, or "default" / "high" / "highest" in any
    case, or a ``jax.lax.Precision``-like ``.name``) reaches the default
    densified local multiply only (``core.precision``); a given
    ``local_matmul`` ignores it, as in the JAX package.
    """
    pg = grid.validate_square(mesh)
    for name, x in (("A", a), ("B", b)):
        if x.device != mesh.device:
            raise ValueError(f"{name} is on {x.device}, the mesh on {mesh.device}")
    if out_dtype is None:
        out_dtype = torch.promote_types(a.dtype, b.dtype)
    lm = local_matmul or _default_local_matmul(precision)
    depth = resolve_pipeline_depth(pipeline_depth, double_buffer)
    sched = build_cannon_schedule(
        pg, mesh=mesh, row_axis=grid.row_axis, col_axis=grid.col_axis,
        skew=skew, empty_steps=getattr(lm, "empty_steps", frozenset()))
    spec = (None,) * (a.ndim - 2) + (grid.row_axis, grid.col_axis)
    c = execute_schedule(sched, mesh.shard(a, spec), mesh.shard(b, spec),
                         local_matmul=lm, out_dtype=out_dtype,
                         pipeline_depth=depth)
    return mesh.unshard(c, spec)
