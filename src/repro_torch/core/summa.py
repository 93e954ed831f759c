"""SUMMA, the ScaLAPACK PDGEMM-style baseline DBCSR is compared against.

The paper's headline result (section IV-C) is densified DBCSR against
the PDGEMM of Cray LibSci_acc, a GPU-accelerated ScaLAPACK.  PDGEMM is
SUMMA-like: for each panel k of the contraction dimension, the owning
column of the process grid broadcasts its A panel along rows, the owning
row broadcasts its B panel along columns, and every rank accumulates a
local GEMM.

The panel broadcast comes in two forms, as in the JAX package:

  * ``bcast='psum'``   — masked all-reduce per panel (``Mesh.psum``):
    every rank adds its panel where it owns it and exact zeros where it
    does not, so each rank receives the owner's values exactly; it moves
    ~2x the optimal broadcast volume.  The baseline configuration.
  * ``bcast='gather'`` — one all-gather of all panels up front (PUMMA
    style, ``Mesh.all_gather``): volume-optimal, memory sqrt(P)x the
    local operand.

Unlike Cannon, SUMMA supports non-square process grids.  The panel loop
is the schedule engine (core/schedule.py): ``build_summa_schedule``
emits one step per panel whose ``recv`` is the masked-allreduce
broadcast (operands stay resident, ``shift`` is the identity), so at
``pipeline_depth=2`` the broadcast of panel t+1 is issued before the
local multiply of panel t.  On the one card every rank's panel is a
slice of the rank-stacked operand (launch/mesh.py), owners are per-rank
indices from ``Mesh.axis_index``, and the collectives are device copies.

The host step builders (``summa_n_panels``, ``summa_step_masks``,
``summa_step_norms``, ``summa_gather_masks``, ``summa_gather_norms``
and the rank-exact ``summa_rank_steps`` and
``summa_gather_rank_steps``) are copied from the JAX package byte for
byte.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .blocking import GridSpec
from .cannon import _default_local_matmul
from .schedule import Schedule, execute_schedule, resolve_pipeline_depth

__all__ = ["summa_matmul", "summa_n_panels", "build_summa_schedule",
           "build_summa_gather_schedule", "summa_step_masks",
           "summa_gather_masks", "summa_step_norms", "summa_gather_norms",
           "summa_rank_steps", "summa_gather_rank_steps"]


def summa_n_panels(pr: int, pc: int) -> int:
    """Contraction panel count of the psum-broadcast SUMMA on a (pr, pc)
    grid: one panel per grid column of A for square grids; the lcm for
    non-square so both the A column owner and the B row owner of every
    panel are well defined.  Exported so the blocked local-multiply
    planner (core/multiply.py) sizes per-panel stack plans consistently.
    """
    return pc if pr == pc else math.lcm(pr, pc)


def build_summa_schedule(
    pr: int,
    pc: int,
    *,
    mesh,
    row_axis: str,
    col_axis: str,
    n_panels: Optional[int] = None,
    empty_steps: frozenset = frozenset(),
    local_shape: Optional[tuple] = None,
    itemsize: int = 4,
) -> Schedule:
    """Schedule for psum-broadcast SUMMA: one step per contraction
    panel; ``recv`` slices the resident local blocks and broadcasts the
    panel pair by masked all-reduce along the perpendicular grid axes.
    ``local_shape`` = (ml, kl, nl) of one panel's local multiply fills
    the byte counts (observability).
    """
    n_panels = summa_n_panels(pr, pc) if n_panels is None else n_panels

    def owner_mask(axis, owner, x):
        """(R, 1, ...): True on the ranks whose ``axis`` index is
        ``owner``."""
        mine = mesh.axis_index(axis) == owner
        return mine.reshape((-1,) + (1,) * (x.ndim - 1))

    def recv(carry, p):
        a_blk, b_blk = carry
        # K is the LAST axis of A and second-to-last of B so the slices
        # are agnostic to leading rank and batch dims
        kl_a = a_blk.shape[-1] * pc // n_panels  # A panel width (local)
        kl_b = b_blk.shape[-2] * pr // n_panels  # B panel height (local)
        # owner coordinates of panel p
        col_owner = p * pc // n_panels
        row_owner = p * pr // n_panels
        a_off = (p % (n_panels // pc)) * kl_a if n_panels != pc else 0
        b_off = (p % (n_panels // pr)) * kl_b if n_panels != pr else 0
        a_panel = a_blk.narrow(a_blk.ndim - 1, a_off, kl_a)
        b_panel = b_blk.narrow(b_blk.ndim - 2, b_off, kl_b)
        # broadcast-by-masked-allreduce along the perpendicular axis
        zero = torch.zeros((), dtype=a_panel.dtype, device=a_panel.device)
        a_panel = torch.where(owner_mask(col_axis, col_owner, a_panel),
                              a_panel, zero)
        a_panel = mesh.psum(a_panel, col_axis)
        zero = torch.zeros((), dtype=b_panel.dtype, device=b_panel.device)
        b_panel = torch.where(owner_mask(row_axis, row_owner, b_panel),
                              b_panel, zero)
        b_panel = mesh.psum(b_panel, row_axis)
        return (a_panel, b_panel)

    step_bytes = 0
    if local_shape is not None:
        ml, klp, nl = local_shape
        # masked all-reduce moves ~2x the optimal broadcast volume
        step_bytes = 2 * (ml * klp + klp * nl) * itemsize

    return Schedule(
        algorithm="summa",
        n_steps=n_panels,
        recv=recv,
        empty_steps=frozenset(empty_steps),
        comm_op=f"bcast-psum(a:{col_axis}, b:{row_axis})",
        step_comm_bytes=tuple(
            0 if t in empty_steps else step_bytes for t in range(n_panels)),
    )


def summa_step_masks(
    am: np.ndarray, bm: np.ndarray, pr: int, pc: int, n_panels: int,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-panel (a_mask, b_mask) unions for psum-broadcast SUMMA — the
    schedule builder's per-step mask slices.

    Panel p covers the global K block range [p*nbk/n_panels, ...); the
    A-side union runs over the pr row chunks, the B-side over the pc
    column chunks.  Because the row and column ranks vary independently,
    the union of per-rank products equals the product of the factored
    unions — no 3D pair tensor needed.
    """
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    if nbr % pr or nbc % pc or nbk % n_panels:
        raise ValueError(
            f"block grid ({nbr},{nbk},{nbc}) not divisible by summa grid "
            f"{pr}x{pc} with {n_panels} panels")
    lr, lc, lkp = nbr // pr, nbc // pc, nbk // n_panels
    out = []
    for p in range(n_panels):
        ksl = slice(p * lkp, (p + 1) * lkp)
        ua = np.zeros((lr, lkp), dtype=bool)
        for i in range(pr):
            ua |= am[i * lr:(i + 1) * lr, ksl]
        ub = np.zeros((lkp, lc), dtype=bool)
        for j in range(pc):
            ub |= bm[ksl, j * lc:(j + 1) * lc]
        out.append((ua, ub))
    return out


def summa_step_norms(
    an: np.ndarray, bn: np.ndarray, pr: int, pc: int, n_panels: int,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-panel (a_norms, b_norms) max-unions for psum-broadcast SUMMA
    — the norm twin of ``summa_step_masks`` (repro.sparsity).

    SPMD union-of-max semantics: the A-side takes the elementwise MAX
    over the pr row chunks, the B-side over the pc column chunks.  The
    factored product ``max_i(an) * max_j(bn)`` upper-bounds every
    rank's norm product, so ``filter_eps`` never drops a triple some
    rank still needs — the same conservativeness as the factored mask
    union."""
    nbr, nbk = an.shape
    nbc = bn.shape[1]
    if nbr % pr or nbc % pc or nbk % n_panels:
        raise ValueError(
            f"block grid ({nbr},{nbk},{nbc}) not divisible by summa grid "
            f"{pr}x{pc} with {n_panels} panels")
    an = np.asarray(an, dtype=np.float32)
    bn = np.asarray(bn, dtype=np.float32)
    lr, lc, lkp = nbr // pr, nbc // pc, nbk // n_panels
    out = []
    for p in range(n_panels):
        ksl = slice(p * lkp, (p + 1) * lkp)
        ua = np.zeros((lr, lkp), dtype=np.float32)
        for i in range(pr):
            np.maximum(ua, an[i * lr:(i + 1) * lr, ksl], out=ua)
        ub = np.zeros((lkp, lc), dtype=np.float32)
        for j in range(pc):
            np.maximum(ub, bn[ksl, j * lc:(j + 1) * lc], out=ub)
        out.append((ua, ub))
    return out


def summa_gather_norms(
    an: np.ndarray, bn: np.ndarray, pr: int, pc: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Factored max-unions for PUMMA-style (all-gather) SUMMA — the
    norm twin of ``summa_gather_masks``: one step, A maxed over row
    chunks, B over column chunks."""
    nbr, nbk = an.shape
    nbc = bn.shape[1]
    if nbr % pr or nbc % pc:
        raise ValueError(
            f"block grid ({nbr},{nbc}) not divisible by grid {pr}x{pc}")
    an = np.asarray(an, dtype=np.float32)
    bn = np.asarray(bn, dtype=np.float32)
    lr, lc = nbr // pr, nbc // pc
    ua = np.zeros((lr, nbk), dtype=np.float32)
    for i in range(pr):
        np.maximum(ua, an[i * lr:(i + 1) * lr], out=ua)
    ub = np.zeros((nbk, lc), dtype=np.float32)
    for j in range(pc):
        np.maximum(ub, bn[:, j * lc:(j + 1) * lc], out=ub)
    return ua, ub


def summa_gather_masks(
    am: np.ndarray, bm: np.ndarray, pr: int, pc: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Factored unions for PUMMA-style (all-gather) SUMMA: the local
    multiply sees the full K extent, so there is a single step whose A
    mask unions over row chunks and B mask over column chunks."""
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    if nbr % pr or nbc % pc:
        raise ValueError(
            f"block grid ({nbr},{nbc}) not divisible by grid {pr}x{pc}")
    lr, lc = nbr // pr, nbc // pc
    ua = np.zeros((lr, nbk), dtype=bool)
    for i in range(pr):
        ua |= am[i * lr:(i + 1) * lr]
    ub = np.zeros((nbk, lc), dtype=bool)
    for j in range(pc):
        ub |= bm[:, j * lc:(j + 1) * lc]
    return ua, ub


def summa_rank_steps(
    am: np.ndarray, bm: np.ndarray, pr: int, pc: int, n_panels: int,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
) -> List[List[dict]]:
    """Rank-exact twin of ``summa_step_masks``/``summa_step_norms``:
    per panel, per RANK exact local mask (and norm) kwargs.

    ``out[p][r]`` is the kwarg dict for rank ``r = i * pc + j`` at
    panel ``p`` — its own A row chunk against the panel's K slice and
    the panel's K slice against its own B column chunk, no cross-rank
    union and no union-of-max norms.
    """
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    if nbr % pr or nbc % pc or nbk % n_panels:
        raise ValueError(
            f"block grid ({nbr},{nbk},{nbc}) not divisible by summa grid "
            f"{pr}x{pc} with {n_panels} panels")
    lr, lc, lkp = nbr // pr, nbc // pc, nbk // n_panels
    if a_norms is not None:
        a_norms = np.asarray(a_norms, dtype=np.float32)
        b_norms = np.asarray(b_norms, dtype=np.float32)
    steps: List[List[dict]] = []
    for p in range(n_panels):
        ksl = slice(p * lkp, (p + 1) * lkp)
        ranks: List[dict] = []
        for i in range(pr):
            rs = slice(i * lr, (i + 1) * lr)
            for j in range(pc):
                cs = slice(j * lc, (j + 1) * lc)
                kw = {"a_mask": am[rs, ksl], "b_mask": bm[ksl, cs]}
                if a_norms is not None:
                    kw["a_norms"] = a_norms[rs, ksl]
                    kw["b_norms"] = b_norms[ksl, cs]
                ranks.append(kw)
        steps.append(ranks)
    return steps


def summa_gather_rank_steps(
    am: np.ndarray, bm: np.ndarray, pr: int, pc: int,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
) -> List[dict]:
    """Rank-exact twin of ``summa_gather_masks``/``summa_gather_norms``
    for the single-step all-gather variant: rank ``r = i * pc + j``
    multiplies its exact A row chunk (full K) by its exact B column
    chunk."""
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    if nbr % pr or nbc % pc:
        raise ValueError(
            f"block grid ({nbr},{nbc}) not divisible by grid {pr}x{pc}")
    lr, lc = nbr // pr, nbc // pc
    if a_norms is not None:
        a_norms = np.asarray(a_norms, dtype=np.float32)
        b_norms = np.asarray(b_norms, dtype=np.float32)
    ranks: List[dict] = []
    for i in range(pr):
        rs = slice(i * lr, (i + 1) * lr)
        for j in range(pc):
            cs = slice(j * lc, (j + 1) * lc)
            kw = {"a_mask": am[rs], "b_mask": bm[:, cs]}
            if a_norms is not None:
                kw["a_norms"] = a_norms[rs]
                kw["b_norms"] = b_norms[:, cs]
            ranks.append(kw)
    return ranks


def build_summa_gather_schedule(row_axis: str, col_axis: str, *,
                                mesh, local_shape: Optional[tuple] = None,
                                itemsize: int = 4) -> Schedule:
    """PUMMA-style SUMMA as a single-step schedule: the all-gather of
    the full local row of A / column of B is the prologue, the one
    local multiply is step 0."""

    def prologue(a_blk, b_blk):
        a_row = mesh.all_gather(a_blk, col_axis, axis=1, tiled=True)
        b_col = mesh.all_gather(b_blk, row_axis, axis=0, tiled=True)
        return (a_row, b_col)

    prologue_bytes = 0
    if local_shape is not None:
        ml, kl, nl = local_shape  # gathered (full-K) local geometry
        prologue_bytes = (ml * kl + kl * nl) * itemsize

    return Schedule(
        algorithm="summa",
        n_steps=1,
        prologue=prologue,
        comm_op=f"all_gather(a:{col_axis}, b:{row_axis})",
        prologue_comm_bytes=prologue_bytes,
    )


def summa_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh,
    grid: GridSpec = GridSpec(),
    local_matmul: Optional[Callable] = None,
    out_dtype: Optional[torch.dtype] = None,
    precision=None,
    bcast: str = "psum",
    pipeline_depth: Optional[int] = None,
    double_buffer: Optional[bool] = None,
) -> torch.Tensor:
    """C = A @ B via SUMMA on the (row_axis, col_axis) grid.

    ``a`` and ``b`` are the global matrices on ``mesh.device``, cut to
    spec (row, col) (leading batch dims replicated); C comes back
    global.  ``pipeline_depth`` follows core/schedule.py: at depth 2
    the panel broadcast for step t+1 is issued before the local
    multiply of step t; depth 1 is strictly serial (the same bits).
    ``precision`` (None, or "default" / "high" / "highest" in any
    case, or a ``jax.lax.Precision``-like ``.name``) reaches the default
    densified local multiply only (``core.precision``); a given
    ``local_matmul`` ignores it, as in the JAX package.
    """
    pr, pc = grid.grid_shape(mesh)
    for name, x in (("A", a), ("B", b)):
        if x.device != mesh.device:
            raise ValueError(f"{name} is on {x.device}, the mesh on {mesh.device}")
    if out_dtype is None:
        out_dtype = torch.promote_types(a.dtype, b.dtype)
    lm = local_matmul or _default_local_matmul(precision)
    depth = resolve_pipeline_depth(pipeline_depth, double_buffer)

    if bcast == "gather":
        # the single gathered dot casts straight to out_dtype in the
        # reference: accumulate there, not in f32
        sched = build_summa_gather_schedule(grid.row_axis, grid.col_axis,
                                            mesh=mesh)
        accum = out_dtype
    elif bcast == "psum":
        sched = build_summa_schedule(
            pr, pc, mesh=mesh, row_axis=grid.row_axis,
            col_axis=grid.col_axis,
            empty_steps=getattr(lm, "empty_steps", frozenset()))
        accum = torch.float32  # per-panel f32 accumulation
    else:
        raise ValueError(bcast)

    spec = (None,) * (a.ndim - 2) + (grid.row_axis, grid.col_axis)
    c = execute_schedule(sched, mesh.shard(a, spec), mesh.shard(b, spec),
                         local_matmul=lm, out_dtype=out_dtype,
                         pipeline_depth=depth, accum_dtype=accum)
    return mesh.unshard(c, spec)
