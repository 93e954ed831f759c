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

Rank-exact execution (the default for masked or filtered blocked
multiplies on more than one rank; ``rank_exact=False`` restores the
union): the per-rank builders (``cannon_rank_steps`` /
``summa_rank_steps`` / ``summa_gather_rank_steps`` / ``ts_rank_steps``)
emit each rank's EXACT mask and norm slices, and each step runs every
rank's own plan, all ranks' triples in one smm launch
(core/engine.py ``rank_stack_executor``).  Step emptiness is the
all-ranks-empty intersection, which equals the union's, so the comm
schedule does not depend on ``rank_exact``.  Steps whose per-rank
slices are content-identical (dense operands, uniform fill) collapse to
the union executor.  With ``filter_eps`` None or 0 the product is bitwise
the union plan's; with ``filter_eps > 0`` each rank filters by its own
norms, the exact per-triple filter.  ``rebalance=True`` adds the costed
permutation pass (sparsity/balance.py): block rows of A and C and block
columns of B and C are permuted on the device before the schedule runs
and C is permuted back, so each rank's share of the retained triples
evens out (DBCSR's randomized distribution, arXiv:1910.04796 sec. 2).

Planning (repro_torch.planner): ``algorithm="auto"`` (the default) and
``return_plan`` price every candidate (algorithm, local path, 2.5D
replication) with the cost model, on the global occupancy (norm-predicted
under ``filter_eps``) and the per-rank load imbalance of the C-chunk
decomposition; ``rebalance=None`` follows the plan's costed decision.
ABFT verification (``verify=``, repro_torch.robustness.abft) checks the
raw product against block checksums computed by a separate GEMM path,
and repairs a corrupted block by re-running the same dispatch once.

Telemetry (repro_torch.obs): with ``obs.enable()`` on, each call records
a ``multiply`` span nesting plan -> dispatch -> schedule-step ->
comm/stacks (and verify -> repair -> dispatch), and logs the plan's
predicted against its measured cost for the planner scoreboard.  The
dispatch span is the host interval of the schedule's run up to a
synchronize on the mesh's device and, on a CUDA mesh, carries
``device_s`` from a pair of CUDA events around the same run.  Off (the
default), or vetoed (torch.compile tracing, CUDA-graph capture), the
call runs the untraced path: no span, event or synchronize.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from .blocking import GridSpec
from .cannon import (build_cannon_schedule, cannon_matmul, cannon_rank_steps,
                     cannon_step_masks, cannon_step_norms)
from .cannon25d import build_cannon25d_schedule, cannon25d_matmul
from .densify import blocked_local_matmul, densified_local_matmul
from .engine import rank_stack_executor
from .precision import resolve_precision
from .schedule import resolve_pipeline_depth, schedule_step_meta
from .stacks import normalize_block_masks
from .summa import (build_summa_gather_schedule, build_summa_schedule,
                    summa_gather_masks, summa_gather_norms,
                    summa_gather_rank_steps, summa_matmul, summa_n_panels,
                    summa_rank_steps, summa_step_masks, summa_step_norms)
from .tall_skinny import (build_ts_schedule, tall_skinny_matmul,
                          ts_rank_steps, ts_step_masks, ts_step_norms)

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


def _stack_kernel(local_kernel: Optional[str]) -> str:
    """The blocked path's stack kernel for ``local_kernel``: None and
    ``"pallas"`` (the hand-written kernels, which a caller may ask for
    without knowing which local path the planner picks) run the smm
    kernel; ``"ref"`` its plain version.  The JAX package raises for
    ``"pallas"`` on the blocked path (ROADMAP Queue C)."""
    return "smm" if local_kernel in (None, "pallas") else local_kernel


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


def _global_occupancy(
    m: int, k: int, n: int,
    block_m: int, block_k: int, block_n: int,
    a_mask: Optional[np.ndarray], b_mask: Optional[np.ndarray],
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
    filter_eps: Optional[float] = None,
) -> float:
    """Retained-triple fraction of the global dense triple grid: the
    occupancy the planner discounts blocked-path flops by.  With block
    norms and a ``filter_eps`` it is the NORM-PREDICTED fraction, so an
    eps that empties a product whose masks are not empty gives 0.0,
    which the planner short-circuits to a trivial plan (the blocked cost
    model must never divide by zero occupancy)."""
    filtering = filter_eps is not None and (
        a_norms is not None or b_norms is not None)
    if a_mask is None and b_mask is None and not filtering:
        return 1.0
    from .engine import _mask_fill

    return _mask_fill(m // block_m, k // block_k, n // block_n,
                      a_mask, b_mask, None,
                      a_norms, b_norms, None, filter_eps)


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


def _collect_executor_stats(lm, densify: bool, n_ranks: int) -> Optional[dict]:
    """The executed blocked plan's statistics (None when densified):
    entries, padding, filter accounting and ``n_launches``, the smm
    launches the multiply makes on ``n_ranks`` ranks (a union plan
    launches once per bin and rank, a rank-exact step once over all
    ranks); with rank-exact steps also each rank's total entries, the
    busiest rank's and ``rank_imbalance`` (max/mean)."""
    if densify:
        return None
    if getattr(lm, "stepwise", False):
        ex = [f.executor_plan for f in lm.step_executors if f is not None]
        n_entries = sum(p.n_entries for p in ex)
        n_dense = sum(p.n_dense_triples for p in ex)
        n_padding = sum(p.n_padding for p in ex)
        n_padding_unbinned = sum(p.n_padding_unbinned for p in ex)
        n_unfiltered = sum(
            p.n_entries if p.n_unfiltered_entries is None
            else p.n_unfiltered_entries for p in ex)
        stats = {
            "n_steps": len(lm.step_executors),
            "n_empty_steps": len(lm.empty_steps),
            "n_entries": n_entries,
            "n_dense_triples": n_dense,
            "n_skipped_triples": n_dense - n_entries,
            "occupancy": n_entries / n_dense if n_dense else 1.0,
            "n_padding": n_padding,
            "n_padding_unbinned": n_padding_unbinned,
            "padding_triples_saved": n_padding_unbinned - n_padding,
            # triples the binary masks admitted but the norm filter dropped
            "n_unfiltered_triples": n_unfiltered,
            "n_norm_filtered_triples": n_unfiltered - n_entries,
            "n_launches": sum(_launches(p, n_ranks) for p in ex),
        }
        totals = _rank_totals(lm)
        if totals is not None:
            # the busiest rank's total bounds wall time; the mean is the
            # flattened load rebalancing aims for (n_entries above sums
            # the per-step busiest ranks)
            stats.update(
                rank_exact=True,
                rank_entries=[int(x) for x in totals],
                max_rank_entries=int(totals.max()),
                mean_rank_entries=float(totals.mean()),
                rank_imbalance=_rank_imbalance_of(totals),
            )
        return stats
    plan = getattr(lm, "executor_plan", None)
    if plan is None:
        return None
    stats = plan.stats()
    stats["n_launches"] = _launches(plan, n_ranks)
    if hasattr(plan, "rank_entries"):
        stats["rank_exact"] = True
    return stats


def _launches(plan, n_ranks: int) -> int:
    if hasattr(plan, "rank_entries"):
        return plan.n_launches
    return n_ranks * plan.n_launches


# ---------------------------------------------------------------------------
# schedule observability: per-step comm/compute split
# ---------------------------------------------------------------------------


def _build_meta_schedule(algorithm: str, *, grid: GridSpec, mesh,
                         local_shape, itemsize: int, empty_steps,
                         reduce_kw: dict):
    """Rebuild the executed schedule for its host-side metadata only
    (building a Schedule runs nothing, core/schedule.py)."""
    pr, pc = grid.grid_shape(mesh)
    if algorithm == "cannon":
        return build_cannon_schedule(
            pr, mesh=mesh, row_axis=grid.row_axis, col_axis=grid.col_axis,
            empty_steps=empty_steps, local_shape=local_shape,
            itemsize=itemsize)
    if algorithm == "cannon25d":
        return build_cannon25d_schedule(
            pr, grid.stack_size(mesh), mesh=mesh, row_axis=grid.row_axis,
            col_axis=grid.col_axis, stack_axis=grid.stack_axis,
            reduce=reduce_kw.get("reduce", "all_reduce"),
            empty_steps=empty_steps, local_shape=local_shape,
            itemsize=itemsize)
    if algorithm == "summa":
        if reduce_kw.get("bcast") == "gather":
            return build_summa_gather_schedule(
                grid.row_axis, grid.col_axis, mesh=mesh,
                local_shape=local_shape, itemsize=itemsize)
        return build_summa_schedule(
            pr, pc, mesh=mesh, row_axis=grid.row_axis,
            col_axis=grid.col_axis, empty_steps=empty_steps,
            local_shape=local_shape, itemsize=itemsize)
    axes = ((grid.row_axis, grid.col_axis) if grid.stack_axis is None
            else (grid.stack_axis, grid.row_axis, grid.col_axis))
    return build_ts_schedule(
        algorithm, axes, mesh=mesh,
        reduce=reduce_kw.get("reduce", "reduce_scatter"),
        local_shape=local_shape)


def _schedule_stats(algorithm: str, *, grid: GridSpec, mesh, local_shape,
                    itemsize: int, lm, densify: bool, pipeline_depth: int,
                    reduce_kw: dict, n_groups: int = 1) -> dict:
    """Per-step comm-vs-compute split of the executed schedule, priced
    with the calibrated hardware constants (host-side observability,
    attached to executed plans as ``schedule_stats`` and emitted as
    schedule-step spans by the telemetry layer).  ``n_groups`` scales
    comm bytes and dense flops for the fused batched dispatch, whose
    every step moves and computes G same-geometry products at once."""
    from ..planner.calibrate import get_hardware_model

    hw = get_hardware_model()
    empty = getattr(lm, "empty_steps", frozenset())
    sched = _build_meta_schedule(
        algorithm, grid=grid, mesh=mesh, local_shape=local_shape,
        itemsize=itemsize * n_groups, empty_steps=empty,
        reduce_kw=reduce_kw)
    meta = schedule_step_meta(sched)

    ml, kl, nl = local_shape
    dense_flops = 2.0 * ml * kl * nl * n_groups
    step_execs = getattr(lm, "step_executors", None)
    steps = []
    for t in range(meta["n_steps"]):
        comm_bytes = meta["step_comm_bytes"][t]
        plan = None
        if not densify and t not in empty:
            # stepwise executors carry .executor_plan (blocked path) or
            # .batched_plan (fused batched path); both expose n_entries
            # and the block sizes, enough to price the stack dispatch
            ex = step_execs[t] if step_execs is not None else lm
            plan = (getattr(ex, "executor_plan", None)
                    or getattr(ex, "batched_plan", None))
        if t in empty:
            flops = 0.0
            compute_s = 0.0
        elif plan is not None:
            flops = 2.0 * plan.n_entries * plan.block_m * plan.block_k \
                * plan.block_n
            compute_s = flops / hw.smm_flops_per_s \
                + plan.n_entries * hw.stack_entry_s
        else:
            flops = dense_flops
            compute_s = flops / hw.flops_per_s
        n_dense = getattr(plan, "n_dense_triples", None)
        ranked = plan is not None and hasattr(plan, "rank_entries")
        steps.append({
            "step": t,
            "skipped": t in empty,
            "comm_bytes": comm_bytes,
            "comm_s": comm_bytes / hw.bytes_per_s,
            "flops": flops,
            "compute_s": compute_s,
            "n_entries": None if plan is None else int(plan.n_entries),
            "occupancy": (plan.n_entries / n_dense
                          if plan is not None and n_dense else None),
            # rank-exact steps: the per-rank retained counts behind the
            # busiest-rank n_entries above (None on union/collapsed)
            "rank_entries": (list(map(int, plan.rank_entries))
                             if ranked else None),
            "rank_imbalance": (float(plan.rank_imbalance)
                               if ranked else None),
        })
    comm_s = sum(st["comm_s"] for st in steps)
    compute_s = sum(st["compute_s"] for st in steps)
    # at depth >= 2 the shift/broadcast feeding step t+1 hides behind
    # step t's compute: all but the first step's comm is overlappable
    overlappable = sum(st["comm_s"] for st in steps[:-1]) \
        if meta["algorithm"] in ("cannon", "cannon25d") \
        else sum(st["comm_s"] for st in steps[1:])
    overlap_bound_s = (min(overlappable, compute_s)
                       if pipeline_depth >= 2 and meta["n_steps"] > 1
                       else 0.0)
    return {
        **meta,
        "pipeline_depth": pipeline_depth,
        "steps": steps,
        "comm_s": comm_s,
        "compute_s": compute_s,
        "prologue_comm_s": meta["prologue_comm_bytes"] / hw.bytes_per_s,
        "epilogue_comm_s": meta["epilogue_comm_bytes"] / hw.bytes_per_s,
        "overlap_bound_s": overlap_bound_s,
    }


def _emit_step_spans(parent, t0: float, total_s: float, ss: dict) -> None:
    """Carve the measured dispatch interval ``[t0, t0+total_s]`` into
    synthetic schedule-step spans (prologue / step[t] {comm, stacks} /
    epilogue), each sized by the cost model's per-step weight from
    ``_schedule_stats`` and scaled so they sum exactly to the measured
    wall time.  The steps run back to back on one device queue and are
    not timed one by one, so this is the per-step attribution the
    telemetry gives; attrs carry the *exact* comm-bytes/flops/occupancy."""
    tracer = obs.get_tracer()
    if tracer is None or parent is None or total_s <= 0.0:
        return
    w_pro = ss.get("prologue_comm_s", 0.0)
    w_epi = ss.get("epilogue_comm_s", 0.0)
    steps = ss.get("steps", [])
    w_sum = w_pro + w_epi + sum(s["comm_s"] + s["compute_s"]
                                for s in steps)
    if w_sum <= 0.0:
        return
    scale = total_s / w_sum
    cur = t0
    if w_pro > 0.0:
        tracer.emit("prologue", "comm", t0=cur, dur=w_pro * scale,
                    parent=parent,
                    attrs={"comm_bytes": ss.get("prologue_comm_bytes", 0),
                           "comm_op": ss.get("comm_op")})
        cur += w_pro * scale
    for s in steps:
        sdur = (s["comm_s"] + s["compute_s"]) * scale
        srec = tracer.emit(
            f"step[{s['step']}]", "schedule-step", t0=cur, dur=sdur,
            parent=parent,
            attrs={"step": s["step"], "skipped": s["skipped"],
                   "comm_bytes": s["comm_bytes"], "flops": s["flops"],
                   "occupancy": s.get("occupancy"),
                   "n_entries": s.get("n_entries"),
                   "rank_entries": s.get("rank_entries"),
                   "rank_imbalance": s.get("rank_imbalance")})
        if s["comm_s"] > 0.0:
            tracer.emit("comm", "comm", t0=cur, dur=s["comm_s"] * scale,
                        parent=srec,
                        attrs={"comm_bytes": s["comm_bytes"],
                               "comm_op": ss.get("comm_op")})
        if s["compute_s"] > 0.0:
            tracer.emit("stacks", "compute",
                        t0=cur + s["comm_s"] * scale,
                        dur=s["compute_s"] * scale, parent=srec,
                        attrs={"flops": s["flops"],
                               "occupancy": s.get("occupancy")})
        cur += sdur
    if w_epi > 0.0:
        tracer.emit("epilogue", "comm", t0=cur, dur=w_epi * scale,
                    parent=parent,
                    attrs={"comm_bytes": ss.get("epilogue_comm_bytes", 0),
                           "comm_op": ss.get("comm_op")})


def _timed_dispatch(run, device: torch.device, attrs: dict):
    """One traced dispatch: ``run()`` inside a ``dispatch`` span whose
    interval is the host's, from a synchronized start to a synchronize
    on ``device``; on a CUDA device a pair of CUDA events around the same
    ``run()`` adds ``device_s``.  Returns ``(result, span, t0, dt)``;
    host minus device time is the dispatch's host share."""
    cuda = device.type == "cuda"
    if cuda:
        # work queued before the dispatch is not the dispatch's
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
    with obs.span("dispatch", cat="dispatch", **attrs) as dsp:
        t0 = time.perf_counter()
        if cuda:
            start.record(stream)
        c = run()
        if cuda:
            stop.record(stream)
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if cuda:
            dsp.set(device_s=start.elapsed_time(stop) / 1e3)
    return c, dsp, t0, dt


# ---------------------------------------------------------------------------
# rank-exact execution: per-rank plans + costed rebalance
# ---------------------------------------------------------------------------


def _rank_kwargs_equal(rank_kwargs: List[dict]) -> bool:
    """True when every rank's step kwargs are content-identical: the
    dense / uniform-fill collapse, where one shared plan IS every rank's
    exact plan, so the union executor already runs rank-exactly."""
    first = rank_kwargs[0]
    keys = set(first)
    for rk in rank_kwargs[1:]:
        if set(rk) != keys:
            return False
        for key in keys:
            u, v = first[key], rk[key]
            if u is None or v is None:
                if u is not v:
                    return False
            elif u.shape != v.shape or not np.array_equal(u, v):
                return False
    return True


def _rank_order(algorithm: str, grid: GridSpec, mesh) -> np.ndarray:
    """Each leading rank's index in the per-rank builders' flat order:
    cannon ``i*pg + j``; cannon25d / stacked tall-skinny stack-major
    ``(s*pr + i)*pc + j``; summa / flat tall-skinny ``i*pc + j``, read
    from the mesh's coordinates whatever its axis order."""
    stacked = (algorithm == "cannon25d"
               or (algorithm.startswith("ts_")
                   and grid.stack_axis is not None))
    axes = ((grid.stack_axis, grid.row_axis, grid.col_axis) if stacked
            else (grid.row_axis, grid.col_axis))
    return mesh.flat_index(axes)


def _single_rank_lm(ml: int, kl: int, nl: int, *, rank_kwargs: List[dict],
                    rank_order, filter_eps: Optional[float] = None,
                    **blocked_kw):
    """Rank-exact local multiply for single-plan schedules (tall-skinny,
    summa with the gather broadcast): one rank executor, or the union
    ``blocked_local_matmul`` when every rank's slice is identical."""
    if _rank_kwargs_equal(rank_kwargs):
        return blocked_local_matmul(ml, kl, nl, **rank_kwargs[0],
                                    filter_eps=filter_eps, **blocked_kw)
    return rank_stack_executor(ml, kl, nl, rank_masks=rank_kwargs,
                               rank_order=rank_order,
                               filter_eps=filter_eps, **blocked_kw)


def _stepwise_rank_blocked_lm(
    ml: int, kl: int, nl: int, *, rank_steps: List[List[dict]],
    rank_order, filter_eps: Optional[float] = None, **blocked_kw,
):
    """Rank-exact stepwise local multiply: one rank executor per
    data-exchange step.  A step is empty only when every rank's is (the
    all-ranks-empty intersection: ``max_r norm_product >= eps`` iff some
    rank retains a triple, so this is the union path's skip set and the
    comm schedule does not depend on ``rank_exact``).  A step whose
    per-rank slices are content-identical collapses to the union
    executor."""
    fns, empty = [], set()
    for t, rkw in enumerate(rank_steps):
        if all(_masks_empty({**r, "filter_eps": filter_eps}) for r in rkw):
            fns.append(None)
            empty.add(t)
        elif _rank_kwargs_equal(rkw):
            fns.append(blocked_local_matmul(
                ml, kl, nl, **rkw[0], filter_eps=filter_eps, **blocked_kw))
        else:
            fns.append(rank_stack_executor(
                ml, kl, nl, rank_masks=rkw, rank_order=rank_order,
                filter_eps=filter_eps, **blocked_kw))

    def lm(a_loc: torch.Tensor, b_loc: torch.Tensor, step: int = 0):
        f = fns[step]
        return None if f is None else f(a_loc, b_loc)

    lm.stepwise = True
    lm.empty_steps = frozenset(empty)
    lm.step_executors = fns
    return lm


def _rank_totals(lm) -> Optional[np.ndarray]:
    """Per-rank executed-entry totals over the whole multiply (summed
    across steps; collapsed/union steps charge every rank the shared
    plan's entries).  None when no step executed rank-exactly."""
    fns = getattr(lm, "step_executors", None)
    if fns is None:
        fns = [lm]
    plans = [getattr(f, "executor_plan", None)
             for f in fns if f is not None]
    ranked = [p for p in plans if hasattr(p, "rank_entries")]
    if not ranked:
        return None
    totals = np.zeros(ranked[0].n_ranks, dtype=np.int64)
    for p in plans:
        if p is None:
            continue
        if hasattr(p, "rank_entries"):
            totals += np.asarray(p.rank_entries, dtype=np.int64)
        else:
            totals += int(p.n_entries)
    return totals


def _rank_imbalance_of(totals: Optional[np.ndarray]) -> Optional[float]:
    if totals is None:
        return None
    mean = float(totals.mean())
    return float(totals.max()) / mean if mean > 0 else 1.0


def _verified_result(verify, a, b, c, rerun, *, plan, n_ranks, block_m,
                     block_k, block_n, a_mask, b_mask, a_norms, b_norms,
                     filter_eps, verify_budget, _tele: bool = False,
                     _rng: bool = False):
    """ABFT verification of a raw product (repro_torch.robustness.abft):
    price the checksum overhead against the plan (``verify="auto"``),
    screen the operands with the finite tripwires, apply any installed
    chaos hook (test-only corruption, modelling a soft error between
    compute and verification), then verify / one-shot-repair through
    ``rerun``.  Returns ``(c, verification_dict)``; the dict lands on
    the plan as ``plan.verification``.  ``_tele`` / ``_rng`` are the
    call's span and range flags."""
    from ..planner.plan import decide_verify, itemsize_of

    m, k = a.shape
    n = b.shape[1]
    pricing = decide_verify(
        plan, m, k, n, blocks=(block_m, block_k, block_n), n_ranks=n_ranks,
        itemsize=itemsize_of(torch.promote_types(a.dtype, b.dtype)),
        budget=verify_budget)
    enabled = verify == "checksum" or (verify == "auto"
                                       and pricing["auto_enabled"])
    if plan is not None and plan.trivial:
        enabled = False  # empty product: nothing executed to corrupt
    info = {"mode": verify, "enabled": enabled, **pricing, "report": None}
    if not enabled:
        return c, info
    from ..robustness import abft, chaos, guards

    def _repair_rerun():
        # a detection re-executes the deterministic dispatch once; the
        # repair span makes that second dispatch visible in the trace
        with obs.maybe_span(_tele, "repair", cat="repair", rng=_rng):
            return rerun()

    with obs.maybe_span(_tele, "verify", cat="verify", rng=_rng,
                        mode=verify) as vsp:
        guards.assert_finite(a, "A")
        guards.assert_finite(b, "B")
        c = chaos.apply_result_hook(c)
        c, report = abft.verify_and_repair(
            a, b, c, recompute=_repair_rerun,
            block_m=block_m, block_k=block_k, block_n=block_n,
            a_mask=a_mask, b_mask=b_mask, a_norms=a_norms, b_norms=b_norms,
            filter_eps=filter_eps)
        vsp.set(detected=bool(report.detected),
                repaired=bool(report.repaired),
                n_flagged_blocks=len(report.flagged_blocks))
    info["report"] = report
    return c, info


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
    precision=None,
    pipeline_depth: Optional[int] = None,
    double_buffer: Optional[bool] = None,
    verify: Optional[str] = None,
    verify_budget: Optional[float] = None,
    return_plan: bool = False,
    **kw,
) -> torch.Tensor:
    """C = A @ B on the mesh; ``a`` (M, K) and ``b`` (K, N) are the
    global matrices on ``mesh.device`` and C comes back global.
    ``algorithm``:

      auto           — the planner's pick (repro_torch.planner), with its
                       local path, stack size and pipeline depth where
                       the caller leaves them None

      cannon         — Cannon's algorithm (square grids)
      cannon25d      — 2.5D Cannon over ``grid.stack_axis``
                       (``reduce="all_reduce"`` or ``"reduce_scatter"``)
      ts_k|ts_m|ts_n — the tall-and-skinny variants (``reduce=`` for
                       ts_k, default ``"reduce_scatter"``)
      summa          — the ScaLAPACK-PDGEMM-style baseline
                       (``bcast="psum"`` or ``"gather"``)

    ``densify`` picks the local path (True, or None under a fixed
    algorithm: one big GEMM,
    ``local_kernel="pallas"`` for the hand-written GEMM kernels; False:
    blocked stacks through smm (under ``"pallas"`` too),
    ``local_kernel="ref"`` for its plain
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

    ``rank_exact`` (module docstring): None (the default) runs a masked
    or filtered blocked multiply on more than one rank from each rank's
    own plan, ``False`` from the union of the ranks' plans, ``True`` is
    the default's behaviour (steps whose ranks agree collapse to the
    union either way).  ``rebalance=True`` permutes block rows of A / C
    and block columns of B / C to even out the ranks' retained triples
    when the multiply is blocked, rank-exact and its block grid divides
    by the process grid; C comes back in the caller's order.  ``None``
    follows the plan's costed decision (``plan.rebalance``: the compute
    the flattened imbalance saves against the permutation's price) when
    a plan is made (``"auto"`` or ``return_plan``); ``False`` permutes
    nothing.  A densified multiply and a one-rank mesh ignore both.

    ``precision`` sets the densified ``torch.matmul``'s f32 mode, as
    the JAX package's reaches XLA's dot only (``core.precision``): None
    (the default) or ``"highest"`` IEEE f32, bitwise the same product;
    ``"high"`` TF32 and ``"default"`` one bf16 pass with f32
    accumulation, on the card (the CPU computes IEEE f32 for every
    name, as XLA's CPU dot does).  The names match in any case, a
    ``jax.lax.Precision``-like object by its ``.name``; anything else
    raises ``ValueError``.  The JAX signature's default is
    ``Precision.DEFAULT``; the port's is None, IEEE f32 everywhere.
    ``local_kernel="pallas"`` and the blocked path ignore it, as the
    JAX package's Pallas kernels do; ``verify``'s checksums stay IEEE.
    The caller's float32 matmul settings are unchanged after the call.

    ``return_plan=True`` returns ``(C, MultiplyPlan)``: the planner's
    decision with every candidate's predicted cost (``explain()``), the
    executed blocked plan's statistics (``executor_stats``) and the
    schedule's per-step comm / compute split (``schedule_stats``).

    ``verify`` — ABFT self-verification (repro_torch.robustness.abft):
    ``"checksum"`` verifies the raw product against block checksums
    (``S_A @ B``, ``A @ T_B`` by ``torch.matmul`` in IEEE f32) with
    norm-aware tolerances, so float accumulation order and eps filtering
    never false-positive; a corrupted block is localized and repaired
    by one re-run of the same dispatch (rank-exact plans, rebalance and
    all), bitwise equal to a clean run; corruption that survives the
    repair raises ``guards.CorruptionDetectedError``.  ``"auto"``
    verifies only when the planner's priced overhead
    (``planner.plan.decide_verify``) fits ``verify_budget`` (default
    25 %) of the plan's predicted time.  ``None`` (default) adds no work
    and is bitwise the unverified multiply.  The outcome lands on the
    plan as ``plan.verification``.

    Telemetry (repro_torch.obs): with ``obs.enable()`` on, and only
    then, the call records a ``multiply`` span nesting plan -> dispatch
    -> schedule-step -> comm/stacks (plus verify -> repair) and logs the
    plan's predicted-vs-measured cost for the planner scoreboard.  Off
    (the default), under torch.compile tracing or CUDA-graph capture
    the call adds one boolean check and the output is bit identical.
    While a ``torch.profiler`` records (``obs.ranging()``), the call
    marks its layers as ``dbcsr.*`` host ranges (multiply, plan, local,
    dispatch, pack, launch, unpack, stats, verify, repair) and does no
    other work.
    """
    c, plan = _distributed_matmul(
        a, b, mesh=mesh, grid=grid, algorithm=algorithm, densify=densify,
        block_m=block_m, block_k=block_k, block_n=block_n,
        stack_size=stack_size, align=align, local_kernel=local_kernel,
        a_mask=a_mask, b_mask=b_mask, a_norms=a_norms, b_norms=b_norms,
        filter_eps=filter_eps, stack_bins=stack_bins, rank_exact=rank_exact,
        rebalance=rebalance, precision=precision,
        pipeline_depth=pipeline_depth, double_buffer=double_buffer,
        verify=verify, verify_budget=verify_budget, return_plan=return_plan,
        **kw)
    return (c, plan) if return_plan else c


def _distributed_matmul(a: torch.Tensor, b: torch.Tensor,
                        _rng: Optional[bool] = None, **kw
                        ) -> Tuple[torch.Tensor, Optional[dict]]:
    """``_distributed_matmul_impl`` (its docstring) under the call's
    telemetry flags: untraced when ``obs.recording()`` is false, else
    inside a ``multiply`` root span; inside a ``dbcsr.multiply`` host
    range alone when only ``obs.ranging()`` holds (``_rng``, the
    caller's flag where it resolved one).  ``distributed_matmul`` and
    ``dbcsr.multiply`` enter here."""
    rng = obs.ranging() if _rng is None else _rng
    if not obs.recording():
        if not rng:
            return _distributed_matmul_impl(a, b, **kw)
        with obs.maybe_range(True, "multiply"):
            return _distributed_matmul_impl(a, b, _rng=True, **kw)
    attrs = {"algorithm": kw.get("algorithm", "auto")}
    if a.ndim == 2 and b.ndim == 2:
        attrs.update(m=int(a.shape[0]), k=int(a.shape[1]),
                     n=int(b.shape[1]))
    with obs.span("multiply", cat="multiply", **attrs):
        return _distributed_matmul_impl(a, b, _tele=True, _rng=rng, **kw)


def _distributed_matmul_impl(
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
    precision=None,
    pipeline_depth: Optional[int] = None,
    double_buffer: Optional[bool] = None,
    verify: Optional[str] = None,
    verify_budget: Optional[float] = None,
    return_plan: bool = False,
    schedule_stats: bool = True,
    _tele: bool = False,
    _rng: bool = False,
    **kw,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """``distributed_matmul`` returning ``(C, executor_stats)``: the
    executed blocked plan's statistics (``_collect_executor_stats``,
    None when densified) with the rebalance pass's outcome
    (``rebalance_applied`` and, when applied, ``rebalance_method`` and
    ``rebalance_imbalance_before`` / ``_after``).  With ``return_plan``
    it returns ``(C, plan)``, the statistics on ``plan.executor_stats``
    and, unless ``schedule_stats=False``, the schedule's per-step split
    on ``plan.schedule_stats``, and ``verify``'s outcome on
    ``plan.verification``.  ``_tele`` is the call's telemetry flag and
    ``_rng`` its range flag (``_distributed_matmul``).
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims disagree: {tuple(a.shape)} @ {tuple(b.shape)}")
    if algorithm != "auto" and algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    resolve_precision(precision)
    if verify not in (None, "checksum", "auto"):
        raise ValueError(
            f"verify must be None, 'checksum' or 'auto', got {verify!r}")
    pr, pc = grid.grid_shape(mesh)
    c_stack = grid.stack_size(mesh)
    n_ranks = pr * pc * c_stack

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
    use_rank = rank_exact is not False and masked and n_ranks > 1

    plan = None
    # telemetry forces a plan even for pinned algorithms: the planner
    # scoreboard needs predicted_s for every executed plan
    if algorithm == "auto" or return_plan or verify is not None or _tele:
        from ..planner.plan import plan_multiply

        with obs.maybe_span(_tele, "plan", cat="plan", rng=_rng) as psp:
            # the per-rank load imbalance of the C-chunk decomposition, for
            # the planner's rank-exact pricing and its rebalance decision
            rank_imb = None
            if (use_rank and am.shape[0] % pr == 0
                    and bmk.shape[1] % pc == 0):
                from ..sparsity.balance import (chunk_imbalance,
                                                retained_block_weights)

                weights = retained_block_weights(
                    am, bmk, an_g, bn_g, filter_eps, device=mesh.device)
                rank_imb = chunk_imbalance(weights, pr, pc)
                # the weights count the retained triples
                # _global_occupancy counts: one pass over the triple
                # grid, not two
                occ = float(weights.sum()) / (am.size * bmk.shape[1])
            else:
                occ = _global_occupancy(m, k, n, block_m, block_k, block_n,
                                        a_mask, b_mask, a_norms, b_norms,
                                        filter_eps)
            # a pinned summa with the PUMMA broadcast is priced by the
            # planner's "summa_gather" model (full-K gathered panels,
            # whose operand replication the memory gate must see); auto
            # never enumerates it
            plan_algorithm = None if algorithm == "auto" else algorithm
            if algorithm == "summa" and kw.get("bcast") == "gather":
                plan_algorithm = "summa_gather"
            plan = plan_multiply(
                m, k, n, blocks=(block_m, block_k, block_n),
                mesh_shape=((pr, pc) if grid.stack_axis is None
                            else (pr, pc, c_stack)),
                occupancy=occ,
                dtype=torch.promote_types(a.dtype, b.dtype),
                algorithm=plan_algorithm,
                # a fixed algorithm runs densified when densify is unset,
                # and the plan must describe what runs
                densify=(densify
                         if algorithm == "auto" or densify is not None
                         else True),
                stack_size=stack_size, align=align,
                rank_imbalance=rank_imb)
            if algorithm == "auto":
                algorithm = plan.algorithm
                if densify is None:
                    densify = plan.densify
                if not densify:
                    if stack_size is None:
                        stack_size = plan.stack_tile
                    if align is None:
                        align = plan.align
                if pipeline_depth is None and double_buffer is None:
                    pipeline_depth = plan.pipeline_depth
            psp.set(algorithm=plan.algorithm, densify=bool(plan.densify),
                    predicted_s=float(plan.predicted_s),
                    occupancy=float(plan.occupancy),
                    trivial=bool(plan.trivial))

    if densify is None:
        densify = True  # the default for a fixed algorithm

    # ---- costed rebalance: permute the block distribution -------------
    # Only block rows of A / C and block cols of B / C move; K stays the
    # identity, so every C block keeps its accumulation order.
    rb = None
    do_rebalance = (rebalance if rebalance is not None
                    else plan is not None and plan.rebalance)
    if (do_rebalance and not densify and use_rank
            and am.shape[0] % pr == 0 and bmk.shape[1] % pc == 0):
        from ..sparsity.balance import plan_rebalance

        cand = plan_rebalance(am, bmk, pr, pc, a_norms=an_g, b_norms=bn_g,
                              filter_eps=filter_eps)
        if not cand.identity:
            rb = cand
    if rb is not None:
        am, bmk = am[rb.perm_m], bmk[:, rb.perm_n]
        if an_g is not None:
            an_g, bn_g = an_g[rb.perm_m], bn_g[:, rb.perm_n]
        if obs.enabled():
            # gated, unlike the JAX package's: with telemetry off a
            # multiply adds no registry entry
            obs.counter("planner.rebalance.applied").inc()

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
    with obs.maybe_range(_rng, "local"):
        if densify:
            lm = densified_local_matmul(precision, kernel=local_kernel,
                                        ranges=_rng)
        else:
            blocked_kw = dict(
                block_m=block_m, block_k=block_k, block_n=block_n,
                stack_size=stack_size, align=align,
                kernel=_stack_kernel(local_kernel), stack_bins=stack_bins,
                ranges=_rng)
            rank_kw = {}
            if use_rank:
                rank_kw = dict(rank_order=_rank_order(algorithm, grid, mesh),
                               filter_eps=filter_eps, **blocked_kw)
            if not masked:
                lm = blocked_local_matmul(ml, kl, nl, **blocked_kw)
            elif algorithm in ("cannon", "cannon25d"):
                c_repl = (grid.stack_size(mesh)
                          if algorithm == "cannon25d" else 1)
                if use_rank:
                    lm = _stepwise_rank_blocked_lm(
                        ml, kl, nl, rank_steps=cannon_rank_steps(
                            am, bmk, pg, c_repl, a_norms=an_g, b_norms=bn_g),
                        **rank_kw)
                else:
                    steps = [{"pair_mask": pm}
                             for pm in cannon_step_masks(am, bmk, pg, c_repl)]
                    if filtering:
                        for s, pn in zip(steps, cannon_step_norms(
                                an_g, bn_g, pg, c_repl)):
                            s.update(pair_norms=pn, filter_eps=filter_eps)
                    lm = _stepwise_blocked_lm(ml, kl, nl, mask_steps=steps,
                                              **blocked_kw)
            elif algorithm == "summa" and kw.get("bcast") != "gather":
                if use_rank:
                    lm = _stepwise_rank_blocked_lm(
                        ml, kl, nl, rank_steps=summa_rank_steps(
                            am, bmk, pr, pc, n_panels, a_norms=an_g,
                            b_norms=bn_g),
                        **rank_kw)
                else:
                    steps = [{"a_mask": ua, "b_mask": ub} for ua, ub in
                             summa_step_masks(am, bmk, pr, pc, n_panels)]
                    if filtering:
                        for s, (una, unb) in zip(steps, summa_step_norms(
                                an_g, bn_g, pr, pc, n_panels)):
                            s.update(a_norms=una, b_norms=unb,
                                     filter_eps=filter_eps)
                    lm = _stepwise_blocked_lm(ml, kl, nl, mask_steps=steps,
                                              **blocked_kw)
            elif algorithm == "summa":
                if use_rank:
                    lm = _single_rank_lm(
                        ml, kl, nl, rank_kwargs=summa_gather_rank_steps(
                            am, bmk, pr, pc, a_norms=an_g, b_norms=bn_g),
                        **rank_kw)
                else:
                    ua, ub = summa_gather_masks(am, bmk, pr, pc)
                    norm_kw = {}
                    if filtering:
                        una, unb = summa_gather_norms(an_g, bn_g, pr, pc)
                        norm_kw = dict(a_norms=una, b_norms=unb,
                                       filter_eps=filter_eps)
                    lm = blocked_local_matmul(ml, kl, nl, a_mask=ua, b_mask=ub,
                                              **norm_kw, **blocked_kw)
            elif use_rank:
                lm = _single_rank_lm(
                    ml, kl, nl, rank_kwargs=ts_rank_steps(
                        algorithm, am, bmk, p_all, a_norms=an_g, b_norms=bn_g),
                    **rank_kw)
            else:
                norm_kw = {}
                if filtering:
                    norm_kw = dict(ts_step_norms(algorithm, an_g, bn_g, p_all),
                                   filter_eps=filter_eps)
                lm = blocked_local_matmul(
                    ml, kl, nl, **ts_step_masks(algorithm, am, bmk, p_all),
                    **norm_kw, **blocked_kw)

    if not densify and obs.enabled():
        imb = _rank_imbalance_of(_rank_totals(lm))
        if imb is not None:
            obs.histogram("executor.rank_imbalance").observe(imb)

    # ---- data-exchange algorithm (all via the schedule engine) --------
    common = dict(mesh=mesh, grid=grid, local_matmul=lm,
                  precision=precision, pipeline_depth=pipeline_depth)

    def _run() -> torch.Tensor:
        # one deterministic dispatch in the caller's frame: the rebalance
        # permutation and its inverse stay inside, so an ABFT repair
        # re-runs exactly this and splices blocks of the same frame
        a_x, b_x = a, b
        if rb is not None:
            from ..sparsity.balance import (permute_block_cols,
                                            permute_block_rows)

            a_x = permute_block_rows(a, rb.perm_m, block_m)
            b_x = permute_block_cols(b, rb.perm_n, block_n)
        if algorithm == "cannon":
            c = cannon_matmul(a_x, b_x, double_buffer=double_buffer,
                              **common, **kw)
        elif algorithm == "cannon25d":
            c = cannon25d_matmul(a_x, b_x, double_buffer=double_buffer,
                                 **common, **kw)
        elif algorithm.startswith("ts_"):
            c = tall_skinny_matmul(a_x, b_x, mode=algorithm, **common, **kw)
        else:
            c = summa_matmul(a_x, b_x, double_buffer=double_buffer,
                             **common, **kw)
        if rb is not None:
            c = permute_block_rows(c, rb.inv_m, block_m)
            c = permute_block_cols(c, rb.inv_n, block_n)
        return c

    from ..planner.plan import itemsize_of

    depth = resolve_pipeline_depth(pipeline_depth, double_buffer)
    sched_stats_cache = []

    def _sched_stats():
        if not sched_stats_cache:
            sched_stats_cache.append(_schedule_stats(
                algorithm, grid=grid, mesh=mesh, local_shape=(ml, kl, nl),
                itemsize=itemsize_of(torch.promote_types(a.dtype, b.dtype)),
                lm=lm, densify=densify, pipeline_depth=depth,
                reduce_kw=kw))
        return sched_stats_cache[0]

    dispatch_times: List[float] = []

    def _run_traced() -> torch.Tensor:
        # telemetry off: exactly the untraced path, no timing, no sync
        # (a profiler's range at most)
        if not _tele:
            with obs.maybe_range(_rng, "dispatch"):
                return _run()
        c, dsp, t0, dt = _timed_dispatch(
            _run, mesh.device, dict(algorithm=algorithm,
                                    densify=bool(densify),
                                    pipeline_depth=depth))
        dispatch_times.append(dt)
        try:
            with obs.maybe_range(_rng, "stats"):
                ss = _sched_stats()
        except Exception:
            ss = None  # telemetry must never break the multiply
        if ss is not None:
            dsp.set(comm_bytes=int(ss.get("total_comm_bytes", 0)))
            _emit_step_spans(dsp.rec, t0, dt, ss)
        return c

    c = _run_traced()
    verification = None
    if verify is not None:
        c, verification = _verified_result(
            verify, a, b, c, _run_traced, plan=plan, n_ranks=n_ranks,
            block_m=block_m, block_k=block_k, block_n=block_n,
            a_mask=a_mask, b_mask=b_mask, a_norms=a_norms, b_norms=b_norms,
            filter_eps=filter_eps, verify_budget=verify_budget, _tele=_tele,
            _rng=_rng)
    if _tele and plan is not None and not plan.trivial and dispatch_times:
        # predicted-vs-actual planner accounting: the first dispatch is
        # the clean run (a repair re-execution would re-measure the same
        # deterministic program)
        obs.record_plan_outcome(
            kind="multiply", algorithm=algorithm, densify=bool(densify),
            m=m, k=k, n=n, occupancy=float(plan.occupancy),
            predicted_s=float(plan.predicted_s),
            measured_s=float(dispatch_times[0]), pipeline_depth=int(depth))

    with obs.maybe_range(_rng, "stats"):
        es = _collect_executor_stats(lm, densify, mesh.n_ranks)
        if es is not None:
            es["rebalance_applied"] = rb is not None
            if rb is not None:
                es["rebalance_method"] = rb.method
                es["rebalance_imbalance_before"] = rb.imbalance_before
                es["rebalance_imbalance_after"] = rb.imbalance_after
        ss = _sched_stats() if return_plan and schedule_stats else None
    if not return_plan:
        return c, es
    return c, dataclasses.replace(plan, executor_stats=es, schedule_stats=ss,
                                  verification=verification)
