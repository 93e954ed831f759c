"""Tall-and-skinny multiplication: O(1) per-process communication.

DBCSR's second data-exchange algorithm (paper section II): when one
matrix dimension is much larger than the others, Cannon's O(1/sqrt(P))
volume is beaten by an algorithm whose per-rank communication does not
depend on P.  The paper's rectangular benchmark is M = N = 1,408,
K = 1,982,464: only the contraction dimension is large.

  * ts_k: shard K over *all* P ranks (the grid axes flattened, the
    stack axis too when the grid has one), replicate M and N, multiply
    (M, K/P) @ (K/P, N) locally, and reduce the (M, N) partials once:
    ``reduce='all_reduce'`` (``Mesh.psum``, every rank gets C) or
    ``'reduce_scatter'`` (``Mesh.psum_scatter``, C row-sharded);
  * ts_m (A tall): shard M, replicate B — no communication;
  * ts_n (B wide): shard N, replicate A — no communication.

On the one card the reduction is a device copy between the simulated
ranks of the rank axis (launch/mesh.py).  The host step builders
(``ts_step_masks``, ``ts_step_norms``, the rank-exact ``ts_rank_steps``)
and ``classify_shape`` are copied from the JAX package byte for byte.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from .blocking import GridSpec
from .cannon import _default_local_matmul
from .schedule import Schedule, execute_schedule, resolve_pipeline_depth

__all__ = ["tall_skinny_matmul", "build_ts_schedule", "ts_step_masks",
           "ts_step_norms", "ts_rank_steps", "classify_shape",
           "ts_classify_ratio", "DEFAULT_TS_RATIO"]

# The historical tall/skinny threshold: the planner's fallback when its
# cost model never crosses over (planner/cost_model.ts_crossover_ratio).
DEFAULT_TS_RATIO = 8.0


def ts_classify_ratio() -> float:
    """The dominance ratio at which ``classify_shape`` switches from
    Cannon to a tall-skinny variant: a shape is ``ts_<dim>`` iff its
    largest dimension is at least this many times each other one.  It
    is the planner's cost-model crossover (tall-skinny's O(1)
    communication against Cannon's O(1/sqrt(P))) under the current
    hardware constants."""
    from ..planner.calibrate import get_hardware_model
    from ..planner.cost_model import ts_crossover_ratio

    return ts_crossover_ratio(get_hardware_model())


def classify_shape(m: int, k: int, n: int,
                   ratio: float | None = None) -> str:
    """Pick the data-exchange algorithm from the global shape.

    Mirrors DBCSR's dispatch: 'cannon' for general matrices,
    'ts_k' / 'ts_m' / 'ts_n' when one dimension dominates by at least
    ``ratio`` (default: ``ts_classify_ratio()``).
    """
    if ratio is None:
        ratio = ts_classify_ratio()
    dims = {"m": m, "k": k, "n": n}
    big = max(dims, key=dims.get)
    others = [v for kk, v in dims.items() if kk != big]
    if dims[big] >= ratio * max(others):
        return f"ts_{big}"
    return "cannon"


def build_ts_schedule(
    mode: str,
    axes,
    *,
    mesh,
    reduce: str = "reduce_scatter",
    local_shape: Optional[tuple] = None,
) -> Schedule:
    """Schedule for the tall-and-skinny variants: a single compute step
    (operands arrive pre-sharded over ``axes``), with the O(1)-in-P
    reduction of the (m, n) partial product as the epilogue (ts_k) or
    no communication at all (ts_m / ts_n).  ``local_shape`` fills the
    epilogue's byte count (f32 partials)."""
    if mode not in ("ts_k", "ts_m", "ts_n"):
        raise ValueError(mode)
    epilogue_bytes = 0
    if mode == "ts_k":
        if reduce == "all_reduce":
            def epilogue(c):
                return mesh.psum(c, axes)   # O(1): ~2*M*N per rank
        elif reduce == "reduce_scatter":
            def epilogue(c):
                return mesh.psum_scatter(
                    c, axes, scatter_dimension=0, tiled=True
                )                           # (P-1)/P * M*N per rank
        else:
            raise ValueError(reduce)
        comm_op = f"psum{'_scatter' if reduce == 'reduce_scatter' else ''}"
        if local_shape is not None:
            ml, _, nl = local_shape
            epilogue_bytes = 2 * ml * nl * 4   # f32 partial both ways
    else:
        epilogue = None
        comm_op = "none (operand pre-replicated)"

    kw = {} if epilogue is None else {"epilogue": epilogue}
    return Schedule(
        algorithm=mode,
        n_steps=1,
        comm_op=comm_op,
        epilogue_comm_bytes=epilogue_bytes,
        **kw,
    )


def ts_step_masks(mode: str, am: np.ndarray, bm: np.ndarray,
                  p_all: int) -> dict:
    """Single-step mask kwargs for the tall-and-skinny variants (the
    contraction/tall dimension is sharded over all ``p_all`` devices) —
    the schedule builder's per-step mask slice, as a union over ranks."""
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    if mode == "ts_k":
        if nbk % p_all:
            raise ValueError(f"K block grid {nbk} not divisible by {p_all}")
        lk = nbk // p_all
        pair = np.zeros((nbr, lk, nbc), dtype=bool)
        for d in range(p_all):
            ac = am[:, d * lk:(d + 1) * lk]
            if not ac.any():
                continue
            bc = bm[d * lk:(d + 1) * lk, :]
            pair |= ac[:, :, None] & bc[None, :, :]
        return {"pair_mask": pair}
    if mode == "ts_m":
        if nbr % p_all:
            raise ValueError(f"M block grid {nbr} not divisible by {p_all}")
        lr = nbr // p_all
        ua = np.zeros((lr, nbk), dtype=bool)
        for d in range(p_all):
            ua |= am[d * lr:(d + 1) * lr]
        return {"a_mask": ua, "b_mask": bm}
    if nbc % p_all:
        raise ValueError(f"N block grid {nbc} not divisible by {p_all}")
    lc = nbc // p_all
    ub = np.zeros((nbk, lc), dtype=bool)
    for d in range(p_all):
        ub |= bm[:, d * lc:(d + 1) * lc]
    return {"a_mask": am, "b_mask": ub}


def ts_step_norms(mode: str, an: np.ndarray, bn: np.ndarray,
                  p_all: int) -> dict:
    """Single-step norm kwargs for the tall-and-skinny variants — the
    norm twin of ``ts_step_masks`` under SPMD union-of-max semantics
    (repro.sparsity): where the mask builder unions presence over the
    ``p_all`` shards, the norm builder takes the elementwise MAX, so
    ``filter_eps`` never drops a triple some shard still needs."""
    nbr, nbk = an.shape
    nbc = bn.shape[1]
    an = np.asarray(an, dtype=np.float32)
    bn = np.asarray(bn, dtype=np.float32)
    if mode == "ts_k":
        if nbk % p_all:
            raise ValueError(f"K block grid {nbk} not divisible by {p_all}")
        lk = nbk // p_all
        pair = np.zeros((nbr, lk, nbc), dtype=np.float32)
        for d in range(p_all):
            ac = an[:, d * lk:(d + 1) * lk]
            if not ac.any():
                continue
            bc = bn[d * lk:(d + 1) * lk, :]
            np.maximum(pair, ac[:, :, None] * bc[None, :, :], out=pair)
        return {"pair_norms": pair}
    if mode == "ts_m":
        if nbr % p_all:
            raise ValueError(f"M block grid {nbr} not divisible by {p_all}")
        lr = nbr // p_all
        ua = np.zeros((lr, nbk), dtype=np.float32)
        for d in range(p_all):
            np.maximum(ua, an[d * lr:(d + 1) * lr], out=ua)
        return {"a_norms": ua, "b_norms": bn}
    if nbc % p_all:
        raise ValueError(f"N block grid {nbc} not divisible by {p_all}")
    lc = nbc // p_all
    ub = np.zeros((nbk, lc), dtype=np.float32)
    for d in range(p_all):
        np.maximum(ub, bn[:, d * lc:(d + 1) * lc], out=ub)
    return {"a_norms": an, "b_norms": ub}


def ts_rank_steps(mode: str, am: np.ndarray, bm: np.ndarray, p_all: int,
                  a_norms: Optional[np.ndarray] = None,
                  b_norms: Optional[np.ndarray] = None) -> List[dict]:
    """Rank-exact twin of ``ts_step_masks``/``ts_step_norms``: one
    exact mask/norm kwarg dict per device ``d`` (the joint-axes
    flattened shard index), instead of the union over shards.

    ts_k shards K: device ``d`` multiplies its A column chunk by its B
    row chunk.  ts_m shards M (its A row chunk x full B); ts_n shards
    N (full A x its B column chunk).
    """
    nbr, nbk = am.shape
    nbc = bm.shape[1]
    if a_norms is not None:
        a_norms = np.asarray(a_norms, dtype=np.float32)
        b_norms = np.asarray(b_norms, dtype=np.float32)
    ranks: List[dict] = []
    if mode == "ts_k":
        if nbk % p_all:
            raise ValueError(f"K block grid {nbk} not divisible by {p_all}")
        lk = nbk // p_all
        for d in range(p_all):
            ks = slice(d * lk, (d + 1) * lk)
            kw = {"a_mask": am[:, ks], "b_mask": bm[ks, :]}
            if a_norms is not None:
                kw["a_norms"] = a_norms[:, ks]
                kw["b_norms"] = b_norms[ks, :]
            ranks.append(kw)
        return ranks
    if mode == "ts_m":
        if nbr % p_all:
            raise ValueError(f"M block grid {nbr} not divisible by {p_all}")
        lr = nbr // p_all
        for d in range(p_all):
            rs = slice(d * lr, (d + 1) * lr)
            kw = {"a_mask": am[rs], "b_mask": bm}
            if a_norms is not None:
                kw["a_norms"] = a_norms[rs]
                kw["b_norms"] = b_norms
            ranks.append(kw)
        return ranks
    if nbc % p_all:
        raise ValueError(f"N block grid {nbc} not divisible by {p_all}")
    lc = nbc // p_all
    for d in range(p_all):
        cs = slice(d * lc, (d + 1) * lc)
        kw = {"a_mask": am, "b_mask": bm[:, cs]}
        if a_norms is not None:
            kw["a_norms"] = a_norms
            kw["b_norms"] = b_norms[:, cs]
        ranks.append(kw)
    return ranks


def tall_skinny_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh,
    grid: GridSpec = GridSpec(),
    mode: str = "ts_k",
    reduce: str = "reduce_scatter",
    local_matmul: Optional[Callable] = None,
    out_dtype: Optional[torch.dtype] = None,
    precision=None,
    pipeline_depth: Optional[int] = None,
) -> torch.Tensor:
    """C = A @ B with the tall-and-skinny algorithm on global ``a``
    (M, K) and ``b`` (K, N) on ``mesh.device``:

    mode='ts_k': A cut (None, axes), B (axes, None); C replicated
      (all_reduce) or row-sharded (reduce_scatter).
    mode='ts_m': A cut (axes, None), B replicated; C row-sharded.
    mode='ts_n': A replicated, B cut (None, axes); C col-sharded.

    ``axes`` is (row, col), or (stack, row, col) when the grid has a
    stack axis.  C comes back global.  The single compute step runs
    through the schedule engine; ``pipeline_depth`` has no overlap to
    express on one step.
    ``precision`` (None, or "default" / "high" / "highest" in any
    case, or a ``jax.lax.Precision``-like ``.name``) reaches the default
    densified local multiply only (``core.precision``); a given
    ``local_matmul`` ignores it, as in the JAX package.
    """
    axes = (grid.row_axis, grid.col_axis) if grid.stack_axis is None else (
        grid.stack_axis, grid.row_axis, grid.col_axis)
    for name, x in (("A", a), ("B", b)):
        if x.device != mesh.device:
            raise ValueError(f"{name} is on {x.device}, the mesh on {mesh.device}")
    if out_dtype is None:
        out_dtype = torch.promote_types(a.dtype, b.dtype)
    lm = local_matmul or _default_local_matmul(precision)
    depth = resolve_pipeline_depth(pipeline_depth)
    sched = build_ts_schedule(mode, axes, mesh=mesh, reduce=reduce)
    # ts_k reduces f32 partials; the zero-communication ts_m / ts_n cast
    # the one local product straight to out_dtype in the reference:
    # accumulate there, so float64 operands keep their precision
    accum = torch.float32 if mode == "ts_k" else out_dtype
    if mode == "ts_m":
        # zero communication: shard the tall output dimension
        a_spec, b_spec, c_spec = (axes, None), (None, None), (axes, None)
    elif mode == "ts_n":
        a_spec, b_spec, c_spec = (None, None), (None, axes), (None, axes)
    else:
        a_spec, b_spec = (None, axes), (axes, None)
        c_spec = (None, None) if reduce == "all_reduce" else (axes, None)
    c = execute_schedule(sched, mesh.shard(a, a_spec), mesh.shard(b, b_spec),
                         local_matmul=lm, out_dtype=out_dtype,
                         pipeline_depth=depth, accum_dtype=accum)
    return mesh.unshard(c, c_spec)
