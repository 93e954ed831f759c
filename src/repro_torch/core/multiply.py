"""Top-level distributed multiply dispatcher.

``distributed_matmul`` runs C = A @ B through a fixed data-exchange
algorithm (a schedule, core/schedule.py): Cannon, 2.5D Cannon, SUMMA
(psum or gather broadcast) or a tall-skinny variant, on a mesh whose
ranks are simulated on one device (launch/mesh.py).  Every step calls a
local multiply: 'densified' (one big GEMM — the paper's section III
optimization) or 'blocked' (stacks of small GEMMs through the smm
kernel).

Occupancy threading (blocked path): ``a_mask`` / ``b_mask`` are the
*global* block-occupancy masks of the operands (host numpy bool).  For
every data-exchange step of the chosen algorithm (each Cannon shift,
each SUMMA panel) the per-algorithm builders (``cannon_step_masks`` /
``summa_step_masks`` / ``ts_step_masks``) slice them down to the block
ranges every rank holds at that step and union them over ranks: one
plan per step serves every rank.  Plans are memoized per mask
fingerprint (core/engine.py), and a step whose mask product is empty
skips its local multiply (and, for SUMMA, its panel broadcast)
entirely.  Block norms with ``filter_eps`` ride the same slicing
(union-of-max).  The densified path ignores the masks: absent blocks
are stored as zeros, so one big GEMM is already correct.

What is left out raises ``NotImplementedError`` naming its ROADMAP queue
item: the planner (``algorithm="auto"``, ``return_plan``; A5),
rank-exact execution and rebalancing on more than one rank (A6), ABFT
verification (A8).  The reference runs masked multiplies on more than
one rank rank-exactly by default; with ``filter_eps`` None or 0 its
products are bitwise its union plan's, so the port runs the union plan,
and with ``filter_eps > 0`` on the blocked path (where each rank's own
filter would drop a different set) it raises naming A6 unless
``rank_exact=False`` asks for the union.  Telemetry (A9) does not exist
in the port yet.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .blocking import GridSpec
from .cannon import cannon_matmul, cannon_step_masks, cannon_step_norms
from .cannon25d import cannon25d_matmul
from .densify import blocked_local_matmul, densified_local_matmul
from .stacks import normalize_block_masks
from .summa import (summa_gather_masks, summa_gather_norms, summa_matmul,
                    summa_n_panels, summa_step_masks, summa_step_norms)
from .tall_skinny import tall_skinny_matmul, ts_step_masks, ts_step_norms

__all__ = ["distributed_matmul", "ALGORITHMS"]

ALGORITHMS = ("cannon", "cannon25d", "ts_k", "ts_m", "ts_n", "summa")


def _block_masks(
    m: int, k: int, n: int,
    block_m: int, block_k: int, block_n: int,
    a_mask: Optional[np.ndarray], b_mask: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """Normalise the *global* occupancy masks; a missing mask means the
    operand is dense (all blocks present)."""
    return normalize_block_masks(m // block_m, k // block_k, n // block_n,
                                 a_mask, b_mask)


def _masks_empty(mask_kwargs: dict) -> bool:
    """Host-static per-step emptiness: no mask-present triple or, under
    a ``filter_eps`` with norms, no triple whose norm-product bound
    clears eps."""
    eps = mask_kwargs.get("filter_eps")
    if "pair_mask" in mask_kwargs or "pair_norms" in mask_kwargs:
        pm = mask_kwargs.get("pair_mask")
        if pm is not None and not pm.any():
            return True
        pn = mask_kwargs.get("pair_norms")
        if eps and pn is not None:
            kept = pn if pm is None else np.where(pm, pn, 0.0)
            return not bool((kept.astype(np.float64) >= float(eps)).any())
        return False
    ua, ub = mask_kwargs["a_mask"], mask_kwargs["b_mask"]
    if not bool(np.any(ua.any(axis=0) & ub.any(axis=1))):
        return True
    un, vn = mask_kwargs.get("a_norms"), mask_kwargs.get("b_norms")
    if eps and un is not None and vn is not None:
        # max retained product per k: (max_i masked a) * (max_j masked b)
        ka = np.where(ua, un.astype(np.float64), 0.0).max(axis=0)
        kb = np.where(ub, vn.astype(np.float64), 0.0).max(axis=1)
        return not bool((ka * kb >= float(eps)).any())
    return False


def _stepwise_blocked_lm(
    ml: int, kl: int, nl: int, *, mask_steps: List[dict], **blocked_kw,
):
    """A stepwise local multiply: one fused stack executor per
    data-exchange step (plans deduplicated by mask fingerprint through
    the engine memo).  Steps whose mask product is empty carry no
    executor; the schedule driver skips them."""
    fns, empty = [], set()
    for t, mask_kwargs in enumerate(mask_steps):
        if _masks_empty(mask_kwargs):
            fns.append(None)
            empty.add(t)
        else:
            fns.append(blocked_local_matmul(ml, kl, nl, **mask_kwargs,
                                            **blocked_kw))

    def lm(a_loc: torch.Tensor, b_loc: torch.Tensor, step: int = 0):
        f = fns[step]
        return None if f is None else f(a_loc, b_loc)

    lm.stepwise = True
    lm.empty_steps = frozenset(empty)
    lm.step_executors = fns
    return lm


def distributed_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh,
    grid: GridSpec = GridSpec(),
    algorithm: str = "auto",
    densify: Optional[bool] = None,
    block_m: int = 64,
    block_k: int = 64,
    block_n: int = 64,
    stack_size: Optional[int] = None,
    align: Optional[bool] = None,
    local_kernel: Optional[str] = None,
    a_mask: Optional[np.ndarray] = None,
    b_mask: Optional[np.ndarray] = None,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
    filter_eps: Optional[float] = None,
    stack_bins: Optional[int] = None,
    rank_exact: Optional[bool] = None,
    rebalance: Optional[bool] = None,
    pipeline_depth: Optional[int] = None,
    double_buffer: Optional[bool] = None,
    verify: Optional[str] = None,
    return_plan: bool = False,
    **kw,
) -> torch.Tensor:
    """C = A @ B on the mesh; ``a`` (M, K) and ``b`` (K, N) are the
    global matrices on ``mesh.device`` and C comes back global.
    ``algorithm``:

      cannon         — Cannon's algorithm (square grids)
      cannon25d      — 2.5D Cannon over ``grid.stack_axis``
                       (``reduce="all_reduce"`` or ``"reduce_scatter"``)
      ts_k|ts_m|ts_n — the tall-and-skinny variants (``reduce=`` for
                       ts_k, default ``"reduce_scatter"``)
      summa          — the ScaLAPACK-PDGEMM-style baseline
                       (``bcast="psum"`` or ``"gather"``)

    ``densify`` picks the local path (True or None: one big GEMM,
    ``local_kernel="pallas"`` for the hand-written GEMM kernels; False:
    blocked stacks through smm, ``local_kernel="ref"`` for its plain
    version).  ``a_mask`` / ``b_mask`` are global block occupancy masks
    ((M/block_m, K/block_k) / (K/block_k, N/block_n) numpy bool); the
    blocked path plans only present triples.  With ``filter_eps`` not
    None, contributions whose block-norm bound ``norm(A_ik) *
    norm(B_kj)`` is below eps are dropped before they reach a stack;
    ``a_norms`` / ``b_norms`` default to the payloads' block norms.
    ``filter_eps=0.0`` is bit-identical to the unfiltered path.
    ``stack_size`` and ``stack_bins`` shape the stack plan (engine.py);
    ``align`` is accepted and ignored.  ``pipeline_depth``: 2 = overlap
    order, 1 = serial, 0 = rolled; all three give the same bits.
    ``rank_exact`` / ``rebalance``: see the module docstring.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims disagree: {tuple(a.shape)} @ {tuple(b.shape)}")
    if algorithm == "auto":
        raise NotImplementedError(
            "algorithm='auto' needs the planner: ROADMAP Queue A5; "
            f"pass one of {ALGORITHMS}")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if return_plan:
        raise NotImplementedError(
            "return_plan needs the planner: ROADMAP Queue A5")
    if verify is not None:
        raise NotImplementedError(
            "ABFT verification is not ported yet: ROADMAP Queue A8")
    pr, pc = grid.grid_shape(mesh)
    n_ranks = pr * pc * grid.stack_size(mesh)
    if (rank_exact or rebalance) and n_ranks > 1:
        # one rank: the reference runs the ordinary multiply (rank-exact
        # execution and its rebalance need more than one rank)
        raise NotImplementedError(
            "rank_exact / rebalance on a multi-rank mesh are not ported "
            "yet: ROADMAP Queue A6")

    filtering = filter_eps is not None
    if filtering and a_norms is None and b_norms is None:
        from ..sparsity.norms import block_norms_of

        a_norms = block_norms_of(a, block_m, block_k, a_mask)
        b_norms = block_norms_of(b, block_k, block_n, b_mask)

    masked = a_mask is not None or b_mask is not None or filtering
    am = bmk = an_g = bn_g = None
    if masked:
        am, bmk = _block_masks(m, k, n, block_m, block_k, block_n,
                               a_mask, b_mask)
        if filtering:
            # mask-absent blocks are forced to norm 0 so one >= eps
            # comparison folds both criteria per rank
            from ..sparsity.norms import normalize_block_norms

            an_g, bn_g = normalize_block_norms(
                am.shape[0], am.shape[1], bmk.shape[1], a_norms, b_norms)
            an_g = np.where(am, an_g, np.float32(0.0))
            bn_g = np.where(bmk, bn_g, np.float32(0.0))

    if densify is None:
        densify = True  # the default for a fixed algorithm
    if (not densify and masked and n_ranks > 1 and rank_exact is None
            and filtering and filter_eps > 0):
        raise NotImplementedError(
            "filter_eps > 0 on a masked multi-rank blocked multiply: the "
            "reference filters each rank by its own norms (rank-exact "
            "execution, ROADMAP Queue A6), which a union plan does not "
            "reproduce; pass rank_exact=False for the union-of-max filter")

    # ---- local multiply geometry (per schedule step) ------------------
    pg = p_all = n_panels = None
    if algorithm.startswith("ts_"):
        p_all = n_ranks
        shapes = {
            "ts_k": (m, k // p_all, n),
            "ts_m": (m // p_all, k, n),
            "ts_n": (m, k, n // p_all),
        }
        ml, kl, nl = shapes[algorithm]
    elif algorithm in ("cannon", "cannon25d"):
        # (m/pg, k/pg) @ (k/pg, n/pg) on the square grid Cannon requires
        pg = grid.validate_square(mesh)
        if (m % pg or k % pg or n % pg) and not densify:
            raise ValueError(
                f"shape ({m},{k},{n}) not divisible by grid side {pg}")
        ml, kl, nl = m // pg, k // pg, n // pg
    elif kw.get("bcast") == "gather":
        # PUMMA-style broadcast: the local multiply sees the gathered
        # full-K row of A / column of B, one geometry on any grid
        if (m % pr or n % pc) and not densify:
            raise ValueError(
                f"shape ({m},{n}) not divisible by grid {pr}x{pc}")
        ml, kl, nl = m // pr, k, n // pc
    else:
        # summa psum: every panel's local multiply is (m/pr, k/n_panels)
        # @ (k/n_panels, n/pc), one geometry for all panels
        n_panels = summa_n_panels(pr, pc)
        if (m % pr or n % pc or k % n_panels) and not densify:
            raise ValueError(
                f"shape ({m},{k},{n}) not divisible by summa grid "
                f"{pr}x{pc} with {n_panels} panels")
        ml, kl, nl = m // pr, k // n_panels, n // pc

    # ---- local multiply strategy (densified vs blocked) --------------
    if densify:
        lm = densified_local_matmul(kernel=local_kernel)
    else:
        blocked_kw = dict(
            block_m=block_m, block_k=block_k, block_n=block_n,
            stack_size=stack_size, align=align,
            kernel=local_kernel or "smm", stack_bins=stack_bins)
        if not masked:
            lm = blocked_local_matmul(ml, kl, nl, **blocked_kw)
        elif algorithm in ("cannon", "cannon25d"):
            c_repl = (grid.stack_size(mesh)
                      if algorithm == "cannon25d" else 1)
            steps = [{"pair_mask": pm}
                     for pm in cannon_step_masks(am, bmk, pg, c_repl)]
            if filtering:
                for s, pn in zip(steps, cannon_step_norms(
                        an_g, bn_g, pg, c_repl)):
                    s.update(pair_norms=pn, filter_eps=filter_eps)
            lm = _stepwise_blocked_lm(ml, kl, nl, mask_steps=steps,
                                      **blocked_kw)
        elif algorithm == "summa" and kw.get("bcast") != "gather":
            steps = [{"a_mask": ua, "b_mask": ub} for ua, ub in
                     summa_step_masks(am, bmk, pr, pc, n_panels)]
            if filtering:
                for s, (una, unb) in zip(steps, summa_step_norms(
                        an_g, bn_g, pr, pc, n_panels)):
                    s.update(a_norms=una, b_norms=unb, filter_eps=filter_eps)
            lm = _stepwise_blocked_lm(ml, kl, nl, mask_steps=steps,
                                      **blocked_kw)
        elif algorithm == "summa":
            ua, ub = summa_gather_masks(am, bmk, pr, pc)
            norm_kw = {}
            if filtering:
                una, unb = summa_gather_norms(an_g, bn_g, pr, pc)
                norm_kw = dict(a_norms=una, b_norms=unb,
                               filter_eps=filter_eps)
            lm = blocked_local_matmul(ml, kl, nl, a_mask=ua, b_mask=ub,
                                      **norm_kw, **blocked_kw)
        else:
            norm_kw = {}
            if filtering:
                norm_kw = dict(ts_step_norms(algorithm, an_g, bn_g, p_all),
                               filter_eps=filter_eps)
            lm = blocked_local_matmul(
                ml, kl, nl, **ts_step_masks(algorithm, am, bmk, p_all),
                **norm_kw, **blocked_kw)

    # ---- data-exchange algorithm (all via the schedule engine) --------
    common = dict(mesh=mesh, grid=grid, local_matmul=lm,
                  pipeline_depth=pipeline_depth)
    if algorithm == "cannon":
        return cannon_matmul(a, b, double_buffer=double_buffer, **common,
                             **kw)
    if algorithm == "cannon25d":
        return cannon25d_matmul(a, b, double_buffer=double_buffer,
                                **common, **kw)
    if algorithm.startswith("ts_"):
        return tall_skinny_matmul(a, b, mode=algorithm, **common, **kw)
    return summa_matmul(a, b, double_buffer=double_buffer, **common, **kw)
