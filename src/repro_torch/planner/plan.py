"""plan_multiply — pick (algorithm, local path, 2.5D replication,
stack params) for one distributed multiply (a copy of the JAX package's
``planner/plan.py``), ``plan_contract`` — the matricization layout of a
tensor contraction — and ``decide_verify``, the costed half of
``verify="auto"``.

This is the paper's driver behaviour made explicit: DBCSR's headline
win over vendor PDGEMM comes from choosing the right decomposition per
(shape, occupancy, mesh), and this module makes that choice the
library default (``distributed_matmul(algorithm="auto")`` and
``dbcsr.multiply`` route through here).

The planner evaluates every feasible candidate through the analytic
models in ``cost_model.py`` (constants from ``calibrate.py``), resolves
the blocked path's ``align`` / ``stack_tile`` through the
occupancy-binned autotune winners table
(``repro_torch.kernels.smm.autotune.best_params_meta``), and memoizes the
result in an LRU cache keyed on the full problem signature — a second
identical call performs ZERO cost-model evaluations (asserted by
tests/test_torch_planner.py via ``cost_model.N_EVALS``).

An empty product short-circuits to a trivial zero-cost plan *before*
any candidate is costed: the blocked-path model divides by
occupancy-derived quantities and must never see occupancy zero (the
``_masks_empty`` contract shared with core/multiply.py).  This fires
both for an empty binary-mask product AND for a norm-predicted-empty
product — eps filtering (repro_torch.sparsity) can empty a product whose
binary masks are non-empty, in which case ``_global_occupancy``
reports 0.0 and the trivial (all-steps-skipped) plan executes.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .cost_model import (BATCHED_ALGORITHMS, CandidateCost, HardwareModel,
                         Problem, algorithm_steps, batched_dispatch_cost,
                         enumerate_candidates, feasible, overlap_efficiency,
                         rebalance_cost_s, verify_overhead_s)

__all__ = ["MultiplyPlan", "BatchedMultiplyPlan", "ContractionPlan",
           "LayoutCandidate", "plan_multiply", "plan_multiply_batched",
           "plan_contract", "decide_verify", "plan_cache_info",
           "plan_cache_clear", "plan_cache_stats", "contract_cache_info",
           "contract_cache_clear", "itemsize_of", "DEFAULT_VERIFY_BUDGET"]

_PLAN_CACHE_SIZE = 512

# verify="auto" enables checksum verification only when its predicted
# overhead stays within this fraction of the plan's predicted time (the
# JAX package gates its MEASURED overhead at the same 25 %)
DEFAULT_VERIFY_BUDGET = 0.25


def itemsize_of(dtype) -> int:
    """Bytes an element of ``dtype`` (numpy or torch) occupies where the
    port computes on it: float16 is widened to float32 for the local
    multiply (``core/densify.kernel_operand``), so it is priced at 4."""
    if isinstance(dtype, torch.dtype):
        return 4 if dtype == torch.float16 else int(dtype.itemsize)
    size = int(np.dtype(dtype).itemsize)
    return 4 if np.dtype(dtype) == np.float16 else size


@dataclasses.dataclass(frozen=True)
class MultiplyPlan:
    """The planner's decision for one multiply, plus its receipts.

    ``candidates`` holds every evaluated configuration (feasible or
    not) so ``explain()`` can show *why* the winner won.  After
    execution, core/multiply.py attaches the executed blocked-path
    stack statistics as ``executor_stats`` (a ``dataclasses.replace``
    copy — cached plan objects stay stats-free).
    """

    algorithm: str
    densify: bool
    c_repl: int
    align: Optional[bool]          # blocked path only, else None
    stack_tile: Optional[int]      # blocked path only, else None
    params_source: Optional[str]   # winners-table provenance
    occupancy: float
    predicted_s: float
    trivial: bool
    candidates: Tuple[CandidateCost, ...]
    pipeline_depth: int = 1        # schedule-engine depth to execute at
    overlap_eff: float = 0.0       # calibrated overlap term of the winner
    executor_stats: Optional[dict] = None
    schedule_stats: Optional[dict] = None
    # ABFT outcome (core/multiply.py attaches post-execution, like the
    # stats above — cached plan objects stay verification-free): pricing
    # from decide_verify plus the VerificationReport when it ran
    verification: Optional[dict] = None
    # rank-exact pricing: the per-rank retained-triple
    # imbalance (max/mean) the blocked candidates were charged under,
    # and the costed permutation-pass decision (sparsity/balance.py) —
    # rebalance is selected iff the compute the flattened imbalance
    # saves exceeds the permutation's amortized cost
    rank_imbalance: float = 1.0
    rebalance: bool = False
    rebalance_saved_s: float = 0.0
    rebalance_cost_s: float = 0.0
    # tensor contractions (repro_torch.tensor): the matricization layout
    # this plan executes under, e.g. "(ij|k)@(k|l)" — None for plain 2D
    # multiplies.  plan_contract stamps it on the winning layout's plan.
    layout: Optional[str] = None

    @property
    def chosen(self) -> Optional[CandidateCost]:
        for c in self.candidates:
            if (c.algorithm == self.algorithm and c.densify == self.densify
                    and c.c_repl == self.c_repl):
                return c
        return None

    def explain(self) -> str:
        """Human-readable per-candidate predicted costs."""
        path = "densified" if self.densify else "blocked"
        head = (f"plan: {self.algorithm} + {path}"
                + (f" (c={self.c_repl})" if self.c_repl > 1 else "")
                + (f"  layout={self.layout}" if self.layout else "")
                + f"  occupancy={self.occupancy:.3g}"
                + f"  predicted={self.predicted_s * 1e3:.3g} ms")
        if self.trivial:
            return head + "  [trivial: empty mask product, nothing to do]"
        head += (f"\n  schedule: pipeline_depth={self.pipeline_depth} "
                 f"overlap_eff={self.overlap_eff:.2f} [calibrated]")
        if self.stack_tile is not None:
            head += (f"\n  stack params: align={self.align} "
                     f"stack_tile={self.stack_tile} [{self.params_source}]")
        if self.rank_imbalance > 1.0 or self.rebalance:
            verdict = ("applied" if self.rebalance else "declined")
            head += (f"\n  rank imbalance: {self.rank_imbalance:.2f} "
                     f"rebalance={verdict} "
                     f"(saves {self.rebalance_saved_s * 1e3:.3g} ms vs "
                     f"{self.rebalance_cost_s * 1e3:.3g} ms permute cost)")
        lines = [head,
                 f"  {'candidate':26s} {'comm_ms':>9s} {'compute_ms':>11s} "
                 f"{'overhead_ms':>12s} {'overlap_ms':>11s} {'total_ms':>9s} "
                 f"{'imbal':>6s}"]
        for c in sorted(self.candidates, key=lambda c: c.total_s):
            star = "*" if c is self.chosen else " "
            if c.feasible:
                lines.append(
                    f"{star} {c.label:26s} {c.comm_s * 1e3:9.3f} "
                    f"{c.compute_s * 1e3:11.3f} {c.overhead_s * 1e3:12.3f} "
                    f"{-c.overlap_s * 1e3:11.3f} {c.total_s * 1e3:9.3f} "
                    f"{c.imbalance:6.2f}")
            else:
                lines.append(f"{star} {c.label:26s} {'-':>9s} {'-':>11s} "
                             f"{'-':>12s} {'-':>11s} {'-':>9s}  "
                             f"infeasible: {c.reason}")
        return "\n".join(lines)


def _normalize_mesh_shape(mesh_shape) -> Tuple[int, int, int]:
    t = tuple(int(x) for x in mesh_shape)
    if len(t) == 2:
        return t + (1,)
    if len(t) == 3:
        return t
    raise ValueError(f"mesh_shape must be (pr, pc) or (pr, pc, c): {t}")


def _trivial_plan(prob: Problem, algorithm: Optional[str],
                  densify: Optional[bool]) -> MultiplyPlan:
    """Empty product (mask-empty, or norm-predicted-empty under a
    filter_eps): nothing will be multiplied, so return a zero-cost plan
    without costing any candidate (the blocked model would divide by
    zero occupancy).  The blocked path is preferred — its all-empty
    step plans skip every dispatch — falling back to whatever geometry
    the mesh admits."""
    if algorithm is not None:
        order = [(algorithm, densify if densify is not None else False),
                 (algorithm, True)]
    else:
        order = [(a, d) for d in (False, True)
                 for a in ("cannon25d" if prob.c_stack > 1 else "cannon",
                           "cannon", "summa", "ts_k", "ts_m", "ts_n")]
    for algo, dens in order:
        if feasible(prob, algo, dens, prob.c_stack if algo == "cannon25d"
                    else 1):
            return MultiplyPlan(
                algorithm=algo, densify=bool(dens),
                c_repl=prob.c_stack if algo == "cannon25d" else 1,
                align=None, stack_tile=None, params_source=None,
                occupancy=0.0, predicted_s=0.0, trivial=True,
                candidates=())
    # nothing fits (degenerate mesh/shape): let the executor raise its
    # own loud error; report the densified fallback
    return MultiplyPlan(algorithm=algorithm or "summa", densify=True,
                        c_repl=1, align=None, stack_tile=None,
                        params_source=None, occupancy=0.0, predicted_s=0.0,
                        trivial=True, candidates=())


def _winners_stamp():
    """Content stamp of the autotune winners table; part of the plan
    cache key so an in-process sweep (or a fresh table written by
    bench/autotune runs) invalidates plans that baked in its params."""
    import os

    from ..kernels.smm.autotune import DEFAULT_CACHE

    try:
        st = os.stat(DEFAULT_CACHE)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


@functools.lru_cache(maxsize=_PLAN_CACHE_SIZE)
def _plan_cached(
    m: int, k: int, n: int,
    block_m: int, block_k: int, block_n: int,
    pr: int, pc: int, c_stack: int,
    occupancy: float, itemsize: int,
    algorithm: Optional[str], densify: Optional[bool],
    stack_size: Optional[int], align: Optional[bool],
    hw: HardwareModel,
    winners_stamp=None,
    rank_imbalance: Optional[float] = None,
) -> MultiplyPlan:
    prob = Problem(m, k, n, block_m, block_k, block_n, occupancy,
                   itemsize, pr, pc, c_stack)

    # stack params for the blocked candidates: the occupancy-binned
    # autotune winner (and its recorded throughput, when the sweep ran
    # on this container) feeds the model; caller pins win
    from ..kernels.smm.autotune import best_params_meta

    meta = best_params_meta(block_m, block_k, block_n, fill=occupancy)
    tuned_align = align if align is not None else meta["align"]
    tuned_tile = stack_size if stack_size is not None else meta["stack_tile"]
    smm_rate = (meta["gflops"] * 1e9) if meta.get("gflops") else None

    candidates = enumerate_candidates(
        hw, prob, algorithm, densify,
        stack_tile=tuned_tile, smm_flops_per_s=smm_rate,
        rank_imbalance=rank_imbalance)
    # ``unpriced_s`` is 0 except on one rank, where it orders ties
    ranked = sorted([c for c in candidates if c.feasible],
                    key=lambda c: (c.total_s, c.unpriced_s))
    if not ranked:
        # no fully-feasible candidate: fall back to the least-bad
        # geometry-valid one (finite total = only the memory gate
        # tripped); a forced configuration is honoured regardless (the
        # executor raises its own loud error if it truly cannot run)
        ranked = sorted([c for c in candidates
                         if math.isfinite(c.total_s)],
                        key=lambda c: (c.total_s, c.unpriced_s))
    if ranked:
        best = ranked[0]
    elif algorithm is not None:
        best = candidates[0]
    else:
        reasons = "; ".join(f"{c.label}: {c.reason}" for c in candidates)
        raise ValueError(f"no feasible multiply candidate — {reasons}")

    blocked = not best.densify
    # costed permutation pass (sparsity/balance.py): flattening the
    # per-rank imbalance scales the blocked winner's max-rank compute
    # back toward the mean; apply iff the saving beats the permutation's
    # amortized cost.  Densified winners execute the full local GEMM
    # regardless of the mask layout, so there is nothing to rebalance.
    imb = max(float(rank_imbalance), 1.0) if rank_imbalance else 1.0
    rebalance = False
    saved_s = permute_s = 0.0
    if blocked and imb > 1.0 and math.isfinite(best.compute_s):
        permute_s = rebalance_cost_s(hw, prob)
        saved_s = best.compute_s * (1.0 - 1.0 / imb)
        rebalance = saved_s > permute_s
    # schedule-engine depth: double-buffer whenever the winner's
    # schedule has more than one step (depth 2 never predicts slower —
    # overlap_s >= 0); single-step schedules gain nothing from a second
    # buffer, so plans record the serial depth for them
    steps = algorithm_steps(prob, best.algorithm, best.c_repl)
    return MultiplyPlan(
        algorithm=best.algorithm,
        densify=best.densify,
        c_repl=best.c_repl,
        align=bool(tuned_align) if blocked else None,
        stack_tile=int(tuned_tile) if blocked else None,
        params_source=meta["source"] if blocked else None,
        occupancy=occupancy,
        predicted_s=best.total_s,
        trivial=False,
        candidates=candidates,
        pipeline_depth=2 if steps > 1 else 1,
        overlap_eff=overlap_efficiency(hw, best.algorithm),
        rank_imbalance=imb,
        rebalance=rebalance,
        rebalance_saved_s=saved_s,
        rebalance_cost_s=permute_s,
    )


def plan_multiply(
    m: int,
    k: int,
    n: int,
    *,
    blocks: Tuple[int, int, int] = (64, 64, 64),
    mesh_shape=(1, 1),
    occupancy: float = 1.0,
    dtype=np.float32,
    algorithm: Optional[str] = None,
    densify: Optional[bool] = None,
    stack_size: Optional[int] = None,
    align: Optional[bool] = None,
    hw: Optional[HardwareModel] = None,
    rank_imbalance: Optional[float] = None,
) -> MultiplyPlan:
    """Choose how to run C = A @ B of global shape (m, k) x (k, n).

    blocks      (block_m, block_k, block_n) of the blocked layout
    mesh_shape  (pr, pc) process grid, or (pr, pc, c) with a 2.5D
                stack/pod axis of size c
    occupancy   present-triple fraction of the dense block-triple grid
                (1.0 = dense; 0.0 = empty product -> trivial plan)
    dtype       operand dtype, numpy or torch (``itemsize_of``)
    algorithm   force a data-exchange algorithm (None = planner's pick)
    densify     force the local path (None = planner's pick)
    stack_size/align  pin the blocked path's stack params (None = the
                occupancy-binned autotune winner)
    hw          cost-model constants (None = calibrate.get_hardware_model)
    rank_imbalance  max/mean per-rank retained-triple load from the
                caller's mask decomposition (sparsity.balance): switches
                blocked compute to rank-exact max-rank pricing and arms
                the costed permutation-pass decision; None keeps the
                legacy union-plan pricing

    Results are LRU-cached on the full signature: a second identical
    call returns the cached plan with zero cost-model evaluations.
    """
    pr, pc, c_stack = _normalize_mesh_shape(mesh_shape)
    bm, bk, bn = (int(b) for b in blocks)
    occ = float(occupancy)
    if occ <= 0.0:
        return _trivial_plan(
            Problem(m, k, n, bm, bk, bn, 0.0, itemsize_of(dtype), pr, pc,
                    c_stack),
            algorithm, densify)
    if hw is None:
        from .calibrate import get_hardware_model

        hw = get_hardware_model()
    return _plan_cached(
        int(m), int(k), int(n), bm, bk, bn, pr, pc, c_stack,
        round(occ, 9), itemsize_of(dtype),
        algorithm, None if densify is None else bool(densify),
        stack_size, align, hw, _winners_stamp(),
        None if rank_imbalance is None else round(float(rank_imbalance), 6))


@dataclasses.dataclass(frozen=True)
class BatchedMultiplyPlan:
    """The planner's fuse-or-loop decision for a batch of ``n_requests``
    same-configuration multiplies, wrapping the shared per-request
    ``MultiplyPlan``.

    ``fuse`` prices one fused batched dispatch (G-fold payload, ONE
    message sequence / launch, ``padding_frac`` wasted compute rows)
    against G single dispatches (G-fold message latency and host
    dispatch cost) — ``cost_model.batched_dispatch_cost``.  After
    execution, core/multiply_batched.py attaches the fused dispatch's
    padding / cross-request plan-sharing accounting as
    ``executor_stats``.
    """

    n_requests: int
    fuse: bool
    algorithm: str
    densify: bool
    padding_frac: float            # estimated cross-request padding waste
    predicted_fused_s: float
    predicted_looped_s: float
    per_request: MultiplyPlan
    executor_stats: Optional[dict] = None

    # -- per-request plan fields the batched executor consumes ---------
    @property
    def stack_tile(self) -> Optional[int]:
        return self.per_request.stack_tile

    @property
    def align(self) -> Optional[bool]:
        return self.per_request.align

    @property
    def pipeline_depth(self) -> int:
        return self.per_request.pipeline_depth

    @property
    def trivial(self) -> bool:
        return self.per_request.trivial

    @property
    def predicted_speedup(self) -> float:
        """Looped-over-fused predicted time ratio (> 1 favours fusing)."""
        if self.predicted_fused_s <= 0.0:
            return 1.0
        return self.predicted_looped_s / self.predicted_fused_s

    def explain(self) -> str:
        head = (f"batched plan: {self.n_requests} requests -> "
                + ("FUSE" if self.fuse else "LOOP")
                + f"  fused={self.predicted_fused_s * 1e3:.3g} ms"
                + f"  looped={self.predicted_looped_s * 1e3:.3g} ms"
                + f"  padding={self.padding_frac:.3g}")
        return head + "\n" + self.per_request.explain()


def plan_multiply_batched(
    n_requests: int,
    m: int,
    k: int,
    n: int,
    *,
    blocks: Tuple[int, int, int] = (64, 64, 64),
    mesh_shape=(1, 1),
    occupancy: float = 1.0,
    dtype=np.float32,
    algorithm: Optional[str] = None,
    densify: Optional[bool] = None,
    padding_frac: float = 0.0,
    stack_size: Optional[int] = None,
    align: Optional[bool] = None,
    hw: Optional[HardwareModel] = None,
) -> BatchedMultiplyPlan:
    """Plan a batch of ``n_requests`` same-geometry multiplies.

    The per-request choice runs through the ordinary (LRU-cached)
    ``plan_multiply`` restricted to the batch-capable algorithms
    (``cost_model.BATCHED_ALGORITHMS`` — the schedules that generalize
    over a leading product dim); ``occupancy`` is the batch's MEAN
    retained-triple fraction and ``padding_frac`` the caller's estimate
    of the fused dispatch's cross-request padding waste (the
    occupancy-spread of the bucket).  An empty batch plan
    (``trivial``) always reports ``fuse=False`` — there is nothing to
    amortize.
    """
    if algorithm is not None and algorithm not in BATCHED_ALGORITHMS:
        raise ValueError(
            f"batched dispatch supports {BATCHED_ALGORITHMS}, got "
            f"{algorithm!r}")
    algos = (algorithm,) if algorithm is not None else BATCHED_ALGORITHMS
    plans = [
        plan_multiply(m, k, n, blocks=blocks, mesh_shape=mesh_shape,
                      occupancy=occupancy, dtype=dtype, algorithm=algo,
                      densify=densify, stack_size=stack_size, align=align,
                      hw=hw)
        for algo in algos
    ]
    # on one rank the algorithms' totals tie; ``unpriced_s`` orders them
    best = min(plans, key=lambda p: (
        p.predicted_s, p.chosen.unpriced_s if p.chosen else 0.0))
    g = int(n_requests)
    if best.trivial:
        return BatchedMultiplyPlan(
            n_requests=g, fuse=False, algorithm=best.algorithm,
            densify=best.densify, padding_frac=float(padding_frac),
            predicted_fused_s=0.0, predicted_looped_s=0.0,
            per_request=best)
    if hw is None:
        from .calibrate import get_hardware_model

        hw = get_hardware_model()
    chosen = best.chosen
    if chosen is not None:
        fused_s, looped_s = batched_dispatch_cost(
            hw, chosen, g, padding_frac)
    else:
        # forced configuration with no costed candidate: amortize the
        # dispatch price alone
        looped_s = g * (best.predicted_s + hw.dispatch_s)
        fused_s = g * best.predicted_s + hw.dispatch_s
    return BatchedMultiplyPlan(
        n_requests=g,
        fuse=bool(g > 1 and fused_s <= looped_s),
        algorithm=best.algorithm,
        densify=best.densify,
        padding_frac=float(padding_frac),
        predicted_fused_s=fused_s,
        predicted_looped_s=looped_s,
        per_request=best,
    )


@dataclasses.dataclass(frozen=True)
class LayoutCandidate:
    """One priced matricization of a tensor contraction: the 2D
    problem the layout induces, its copy traffic, and its best multiply
    plan's predicted time (infeasible layouts carry the reason
    instead)."""

    layout: str
    m: int
    k: int
    n: int
    occupancy: float
    rank_imbalance: float
    copy_s: float
    multiply_s: float
    total_s: float
    algorithm: str
    densify: bool
    feasible: bool
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class ContractionPlan:
    """The planner's decision for one tensor contraction: WHICH
    matricization layout to execute (the new candidate axis on top of
    the 2D algorithm/path choice), wrapping the winning layout's
    ``MultiplyPlan`` (its ``layout`` field stamped).

    ``predicted_s = copy_s + plan.predicted_s``: a layout is priced as
    its unfold/refold data movement (``cost_model.matricize_cost_s``)
    plus its own 2D multiply plan — each layout gets its own occupancy
    and per-rank imbalance estimate from the matricized masks.
    """

    spec: str
    layout: str
    copy_s: float
    predicted_s: float
    layouts: Tuple[LayoutCandidate, ...]
    plan: MultiplyPlan
    verification: Optional[dict] = None

    @property
    def algorithm(self) -> str:
        return self.plan.algorithm

    @property
    def densify(self) -> bool:
        return self.plan.densify

    @property
    def trivial(self) -> bool:
        return self.plan.trivial

    @property
    def chosen(self) -> Optional[LayoutCandidate]:
        for c in self.layouts:
            if c.layout == self.layout:
                return c
        return None

    def explain(self) -> str:
        """Per-layout predicted costs (the layout column), then the
        winning layout's full multiply-plan breakdown."""
        head = (f"contraction plan: {self.spec}  layout={self.layout}"
                f"  algorithm={self.algorithm}"
                f"  predicted={self.predicted_s * 1e3:.3g} ms")
        lines = [head,
                 f"  {'layout':26s} {'m x k x n':>18s} {'occ':>6s} "
                 f"{'imbal':>6s} {'copy_ms':>8s} {'mult_ms':>8s} "
                 f"{'total_ms':>9s}"]
        for c in sorted(self.layouts,
                        key=lambda c: (not c.feasible, c.total_s)):
            star = "*" if c.layout == self.layout else " "
            shape = f"{c.m}x{c.k}x{c.n}"
            if c.feasible:
                lines.append(
                    f"{star} {c.layout:26s} {shape:>18s} "
                    f"{c.occupancy:6.3f} {c.rank_imbalance:6.2f} "
                    f"{c.copy_s * 1e3:8.3f} {c.multiply_s * 1e3:8.3f} "
                    f"{c.total_s * 1e3:9.3f}")
            else:
                lines.append(f"{star} {c.layout:26s} {shape:>18s} "
                             f"infeasible: {c.reason}")
        return "\n".join(lines) + "\n" + self.plan.explain()


@functools.lru_cache(maxsize=_PLAN_CACHE_SIZE)
def _plan_contract_cached(
    spec: str,
    stats: tuple,
    pr: int, pc: int,
    itemsize: int,
    algorithm: Optional[str],
    densify: Optional[bool],
    hw: HardwareModel,
    winners_stamp=None,
) -> ContractionPlan:
    from .cost_model import matricize_cost_s

    cands = []
    best = None       # (total_s, LayoutCandidate, MultiplyPlan)
    for ls in stats:
        if not ls.feasible:
            cands.append(LayoutCandidate(
                layout=ls.label, m=ls.m, k=ls.k, n=ls.n,
                occupancy=ls.occupancy,
                rank_imbalance=ls.rank_imbalance or 1.0,
                copy_s=0.0, multiply_s=math.inf, total_s=math.inf,
                algorithm="-", densify=False, feasible=False,
                reason=ls.reason))
            continue
        dtype = {4: np.float32, 8: np.float64, 2: np.float16}.get(
            itemsize, np.float32)
        try:
            mp = plan_multiply(
                ls.m, ls.k, ls.n,
                blocks=(ls.block_m, ls.block_k, ls.block_n),
                mesh_shape=(pr, pc), occupancy=ls.occupancy,
                dtype=dtype, algorithm=algorithm, densify=densify,
                hw=hw, rank_imbalance=ls.rank_imbalance)
        except ValueError as e:
            cands.append(LayoutCandidate(
                layout=ls.label, m=ls.m, k=ls.k, n=ls.n,
                occupancy=ls.occupancy,
                rank_imbalance=ls.rank_imbalance or 1.0,
                copy_s=0.0, multiply_s=math.inf, total_s=math.inf,
                algorithm="-", densify=False, feasible=False,
                reason=str(e)))
            continue
        copy_s = matricize_cost_s(hw, ls.copy_bytes)
        total = copy_s + mp.predicted_s
        cand = LayoutCandidate(
            layout=ls.label, m=ls.m, k=ls.k, n=ls.n,
            occupancy=ls.occupancy,
            rank_imbalance=mp.rank_imbalance,
            copy_s=copy_s, multiply_s=mp.predicted_s, total_s=total,
            algorithm=mp.algorithm, densify=mp.densify, feasible=True)
        cands.append(cand)
        if best is None or total < best[0]:
            best = (total, cand, mp)
    if best is None:
        reasons = "; ".join(f"{c.layout}: {c.reason}" for c in cands)
        raise ValueError(f"no feasible matricization for {spec!r} on a "
                         f"{pr}x{pc} grid — {reasons}")
    total, cand, mp = best
    return ContractionPlan(
        spec=spec, layout=cand.layout, copy_s=cand.copy_s,
        predicted_s=total, layouts=tuple(cands),
        plan=dataclasses.replace(mp, layout=cand.layout))


def plan_contract(
    spec: str,
    layout_stats,
    *,
    mesh_shape=(1, 1),
    dtype=np.float32,
    algorithm: Optional[str] = None,
    densify: Optional[bool] = None,
    hw: Optional[HardwareModel] = None,
) -> ContractionPlan:
    """Choose the matricization layout (and, through ``plan_multiply``,
    the 2D algorithm + local path) for one tensor contraction.

    ``layout_stats`` is the tuple of per-layout geometry statistics
    from ``repro_torch.tensor.matricize.contraction_layout_stats`` — frozen
    and hashable, so together with the normalized spec and the mesh it
    forms the contraction signature the result is LRU-cached on: a
    second identical contraction performs ZERO cost-model evaluations
    (shared ``_PLAN_CACHE_SIZE`` budget with the multiply cache; the
    per-layout ``plan_multiply`` sub-plans land in that cache too, so
    the inner multiply of an executed contraction replans for free).
    """
    pr, pc, _ = _normalize_mesh_shape(mesh_shape)
    if hw is None:
        from .calibrate import get_hardware_model

        hw = get_hardware_model()
    return _plan_contract_cached(
        str(spec), tuple(layout_stats), pr, pc, itemsize_of(dtype),
        algorithm, None if densify is None else bool(densify),
        hw, _winners_stamp())


def contract_cache_info():
    return _plan_contract_cached.cache_info()


def contract_cache_clear() -> None:
    _plan_contract_cached.cache_clear()


def decide_verify(
    plan: Optional[MultiplyPlan],
    m: int,
    k: int,
    n: int,
    *,
    blocks: Tuple[int, int, int],
    n_ranks: int,
    itemsize: int = 4,
    budget: Optional[float] = None,
    hw: Optional[HardwareModel] = None,
) -> dict:
    """Price ABFT checksum verification against a plan — the costed
    half of ``verify="auto"`` (core/multiply.py).

    Returns ``{"auto_enabled", "predicted_overhead_s", "overhead_frac",
    "budget"}``: verification is auto-enabled when the predicted
    checksum overhead (``cost_model.verify_overhead_s`` on ``n_ranks``
    ranks) fits within ``budget`` (default ``DEFAULT_VERIFY_BUDGET``) of
    the plan's predicted multiply time.  A trivial (empty-product) plan
    reports infinite relative overhead — there is nothing worth
    verifying.
    """
    if budget is None:
        budget = DEFAULT_VERIFY_BUDGET
    budget = float(budget)
    if hw is None:
        from .calibrate import get_hardware_model

        hw = get_hardware_model()
    bm, _, bn = (int(x) for x in blocks)
    overhead = verify_overhead_s(hw, int(m), int(k), int(n), bm, bn,
                                 int(itemsize), int(n_ranks))
    base = 0.0 if plan is None else float(plan.predicted_s)
    if plan is not None and plan.trivial:
        frac = math.inf
    else:
        frac = overhead / base if base > 0.0 else math.inf
    return {
        "auto_enabled": bool(frac <= budget),
        "predicted_overhead_s": float(overhead),
        "overhead_frac": float(frac),
        "budget": budget,
    }


def plan_cache_info():
    return _plan_cached.cache_info()


def plan_cache_clear() -> None:
    _plan_cached.cache_clear()


def plan_cache_stats() -> dict:
    """Planner LRU accounting: hits / misses / evictions.

    ``evictions`` is derived as ``misses - currsize``: every miss
    inserts one entry, so entries beyond the current size must have
    been evicted.  Valid because ``plan_cache_clear`` resets the
    counters and the size together.

    A thin view over the obs metrics registry: the LRU's
    ``cache_info()`` is synced into ``planner.plan_cache.*`` gauges and
    the returned dict is read back from those gauges.
    """
    from .. import obs

    info = _plan_cached.cache_info()
    reg = obs.registry()
    synced = {
        "hits": int(info.hits),
        "misses": int(info.misses),
        "currsize": int(info.currsize),
        "maxsize": int(info.maxsize),
        "evictions": max(int(info.misses) - int(info.currsize), 0),
    }
    for key, v in synced.items():
        reg.gauge(f"planner.plan_cache.{key}").set(v)
    return {key: int(reg.gauge(f"planner.plan_cache.{key}").value)
            for key in synced}
