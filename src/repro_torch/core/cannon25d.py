"""2.5D Cannon over a stack axis (from the DBCSR lineage).

Lazzaro et al. extended DBCSR with a 2.5D algorithm: keep c replicas of
A and B on c stacked process grids, let replica p execute only 1/c of
the k-shift steps (offset by p * P/c), and combine the partial C's with
one reduction over the stack axis.  Per-replica communication drops from
O(sqrt(P)) shifts to O(sqrt(P)/c) at the cost of c-fold operand
replication.

The per-replica step offset is folded into the initial skew as one
static joint-axis permutation over (stack, row, col), in that order
whatever the mesh's axis order: rank (p, i, j) starts from
A(i, (i + j + p*P/c) % P) and B((i + j + p*P/c) % P, j).  The step loop
is the schedule engine (core/schedule.py): ``build_cannon25d_schedule``
composes the Cannon shift schedule with the fused-skew prologue and the
stack-axis reduction epilogue (``Mesh.psum`` or ``Mesh.psum_scatter``;
device copies between the simulated ranks on one card).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .blocking import GridSpec
from .cannon import _default_local_matmul, build_cannon_schedule
from .schedule import Schedule, execute_schedule, resolve_pipeline_depth

__all__ = ["cannon25d_matmul", "build_cannon25d_schedule"]


def _skew25d_perm(pg: int, c_repl: int, spr: int, which: str):
    """Static permutation over flattened (stack, row, col):
    destination (p, i, j) receives
      A block (i, (i + j + p*spr) % P)  — held by source (p, i, (i+j+p*spr)%P)
      B block ((i + j + p*spr) % P, j)  — held by source (p, (i+j+p*spr)%P, j)
    (sources stay within their own replica: A/B enter replicated over
    the stack axis)."""
    flat = lambda p, i, j: (p * pg + i) * pg + j
    pairs = []
    for p in range(c_repl):
        for i in range(pg):
            for j in range(pg):
                k = (i + j + p * spr) % pg
                if which == "a":
                    pairs.append((flat(p, i, k), flat(p, i, j)))
                else:
                    pairs.append((flat(p, k, j), flat(p, i, j)))
    return pairs


def build_cannon25d_schedule(
    pg: int,
    c_repl: int,
    *,
    mesh,
    row_axis: str,
    col_axis: str,
    stack_axis: str,
    reduce: str = "all_reduce",
    empty_steps: frozenset = frozenset(),
    local_shape: Optional[tuple] = None,
    itemsize: int = 4,
) -> Schedule:
    """Schedule for 2.5D Cannon: the Cannon shift steps (1/c of them,
    replica-offset via the fused-skew prologue) plus one partial-C
    reduction over the stack axis as the epilogue.  ``local_shape`` and
    ``itemsize`` fill the byte counts, as in ``build_cannon_schedule``."""
    if pg % c_repl:
        raise ValueError(f"grid side {pg} not divisible by replication {c_repl}")
    if reduce not in ("all_reduce", "reduce_scatter"):
        raise ValueError(reduce)
    spr = pg // c_repl  # steps per replica
    base = build_cannon_schedule(
        pg, mesh=mesh, row_axis=row_axis, col_axis=col_axis, skew=False,
        steps=spr, empty_steps=empty_steps, local_shape=local_shape,
        itemsize=itemsize)
    axes3 = (stack_axis, row_axis, col_axis)

    def prologue(a_blk, b_blk):
        # fused skew + replica offset: one static joint-axis permutation
        a_blk = mesh.ppermute(a_blk, axes3,
                              _skew25d_perm(pg, c_repl, spr, "a"))
        b_blk = mesh.ppermute(b_blk, axes3,
                              _skew25d_perm(pg, c_repl, spr, "b"))
        return (a_blk, b_blk)

    def epilogue(c_partial):
        if reduce == "all_reduce":
            return mesh.psum(c_partial, stack_axis)
        return mesh.psum_scatter(c_partial, stack_axis, scatter_dimension=0,
                                 tiled=True)

    prologue_bytes = epilogue_bytes = 0
    if local_shape is not None:
        ml, kl, nl = local_shape
        prologue_bytes = (ml * kl + kl * nl) * itemsize
        # partial C's reduce in f32 over the stack axis
        epilogue_bytes = 2 * ml * nl * 4

    return dataclasses.replace(base, algorithm="cannon25d",
                               prologue=prologue, epilogue=epilogue,
                               prologue_comm_bytes=prologue_bytes,
                               epilogue_comm_bytes=epilogue_bytes)


def cannon25d_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh,
    grid: GridSpec,
    local_matmul: Optional[Callable] = None,
    out_dtype: Optional[torch.dtype] = None,
    precision=None,
    pipeline_depth: Optional[int] = None,
    double_buffer: Optional[bool] = None,
    reduce: str = "all_reduce",  # or "reduce_scatter"
) -> torch.Tensor:
    """C = A @ B, 2.5D Cannon with replication over ``grid.stack_axis``.

    A and B (global, on ``mesh.device``) enter 2D-sharded over (row,
    col) and replicated over the stack axis, spec (row, col).  C leaves
    with the same spec (all_reduce) or additionally row-sharded over the
    stack axis, ((row, stack), col) (reduce_scatter), and is put back
    into one global tensor.
    ``precision`` (None, or "default" / "high" / "highest" in any
    case, or a ``jax.lax.Precision``-like ``.name``) reaches the default
    densified local multiply only (``core.precision``); a given
    ``local_matmul`` ignores it, as in the JAX package.
    """
    if grid.stack_axis is None:
        raise ValueError("cannon25d needs grid.stack_axis (e.g. 'pod')")
    pg = grid.validate_square(mesh)
    c_repl = grid.stack_size(mesh)
    for name, x in (("A", a), ("B", b)):
        if x.device != mesh.device:
            raise ValueError(f"{name} is on {x.device}, the mesh on {mesh.device}")
    if out_dtype is None:
        out_dtype = torch.promote_types(a.dtype, b.dtype)
    lm = local_matmul or _default_local_matmul(precision)
    depth = resolve_pipeline_depth(pipeline_depth, double_buffer)
    sched = build_cannon25d_schedule(
        pg, c_repl, mesh=mesh, row_axis=grid.row_axis,
        col_axis=grid.col_axis, stack_axis=grid.stack_axis, reduce=reduce,
        empty_steps=getattr(lm, "empty_steps", frozenset()))
    spec2d = (grid.row_axis, grid.col_axis)
    if reduce == "all_reduce":
        out_spec = spec2d
    else:
        # psum_scatter chunk p of the local block goes to replica p: the
        # stack axis is the minor factor of the row partition
        out_spec = ((grid.row_axis, grid.stack_axis), grid.col_axis)
    c = execute_schedule(sched, mesh.shard(a, spec2d), mesh.shard(b, spec2d),
                         local_matmul=lm, out_dtype=out_dtype,
                         pipeline_depth=depth)
    return mesh.unshard(c, out_spec)
