"""Product-batched distributed multiply: N block-sparse products, ONE
fused dispatch.

Many workloads (density-matrix purification over k-point batches,
ensemble propagation, batched NEGF) issue many independent block-sparse
products of the same block geometry.  Dispatching them one by one pays
the per-product price N times: plan lookups, uploads and at least one
kernel launch each, and on small products the host side dominates.

``distributed_matmul_batched`` stacks the G operand pairs as
``(G, m, k) @ (G, k, n)`` and runs ONE schedule over them:

  * the data-exchange schedule (Cannon's shifts, SUMMA's panel
    broadcasts) is shape-agnostic over a leading batch dimension, so the
    G products ride one collective sequence (G times the payload a
    message, the same message count);
  * the blocked local path fuses the per-group stack plans into one
    group-offset triple tensor (core/engine.py ``BatchedExecutorPlan``)
    run as ONE smm launch a rank;
  * the densified local path becomes one grouped GEMM
    ``(R*G, ml, kl) @ (R*G, kl, nl)`` over the ranks and products:
    ``torch.bmm``, or ONE grouped_gemm launch with
    ``local_kernel="pallas"``.

Supported algorithms: ``cannon`` and ``summa`` (psum broadcast), the two
whose schedules are batch-shape-agnostic, on any mesh whose ranks the
port simulates (launch/mesh.py): the operands carry the rank axis and
the batch axis together, ``(R, G, ml, kl)``.  ``algorithm="auto"`` (the
default) asks the planner (``plan_multiply_batched``), restricted to
those two.

Per-product occupancy masks and norms are accepted as sequences
(``a_masks[g]`` etc.); the fused plan covers every group's present
triples, and a data-exchange step is skipped only when it is empty for
EVERY group.

Bit-identity contract: at ``pipeline_depth=1`` (serial) with
``filter_eps`` in {None, 0.0}, the blocked path of the fused batch is
bit-identical to G sequential ``distributed_matmul`` calls: stack fusion
never reorders any C block's k-run and padding rows only touch the
global scratch block.  The densified path agrees to f32 rounding.

Telemetry (repro_torch.obs): with ``obs.enable()`` on, a call records a
``multiply_batched`` span nesting plan -> dispatch -> schedule-step
children (G-scaled comm bytes and flops) and logs the batched plan's
predicted against its measured fused cost; off or vetoed, the call is
the untraced path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..planner.cost_model import BATCHED_ALGORITHMS
from .blocking import GridSpec
from .cannon import cannon_matmul, cannon_step_masks, cannon_step_norms
from .densify import grouped_densified_local_matmul
from .engine import batched_stack_executor
from .multiply import (_block_masks, _emit_step_spans, _global_occupancy,
                       _masks_empty, _schedule_stats, _stack_kernel,
                       _timed_dispatch)
from .precision import resolve_precision
from .schedule import resolve_pipeline_depth
from .summa import (summa_matmul, summa_n_panels, summa_step_masks,
                    summa_step_norms)

__all__ = ["distributed_matmul_batched", "BATCHED_ALGORITHMS"]


def _per_group(seq: Optional[Sequence], g: int, n_groups: int, name: str):
    """Normalise an optional per-group sequence argument."""
    if seq is None:
        return None
    if len(seq) != n_groups:
        raise ValueError(f"{name} has {len(seq)} entries for {n_groups} "
                         f"products")
    return seq[g]


def _stepwise_batched_lm(
    n_groups: int, ml: int, kl: int, nl: int, *,
    group_mask_steps: List[List[dict]],
    filter_eps: Optional[float] = None,
    **batched_kw,
):
    """A stepwise *batched* local multiply: one fused batched executor
    per data-exchange step (``group_mask_steps[t][g]`` is group ``g``'s
    mask/norm kwargs at step ``t``).  A step is empty, and skipped by the
    schedule driver, only when every group's mask/norm product is empty
    at that step; a group that alone is empty at a non-empty step
    contributes zero stacks to the fused tensor."""
    fns, empty = [], set()
    for t, gms in enumerate(group_mask_steps):
        if all(_masks_empty(dict(gm, filter_eps=filter_eps)) for gm in gms):
            fns.append(None)
            empty.add(t)
        else:
            fns.append(batched_stack_executor(
                n_groups, ml, kl, nl, group_masks=gms,
                filter_eps=filter_eps, **batched_kw))

    def lm(a_loc: torch.Tensor, b_loc: torch.Tensor, step: int = 0):
        f = fns[step]
        return None if f is None else f(a_loc, b_loc)

    lm.stepwise = True
    lm.empty_steps = frozenset(empty)
    lm.step_executors = fns
    return lm


def _collect_batched_executor_stats(lm, densify: bool) -> Optional[dict]:
    """Aggregate the executed fused dispatch's padding and cross-request
    fusion statistics (``None`` on the densified path)."""
    if densify:
        return None
    if getattr(lm, "stepwise", False):
        plans = [f.batched_plan for f in lm.step_executors if f is not None]
        n_steps = len(lm.step_executors)
    else:
        plan = getattr(lm, "batched_plan", None)
        plans = [] if plan is None else [plan]
        n_steps = 1
    if not plans:
        return None
    n_entries = sum(p.n_entries for p in plans)
    n_padding = sum(p.n_padding for p in plans)
    total = sum(p.n_stacks * p.stack_tile for p in plans)
    return {
        "n_groups": plans[0].n_groups,
        "n_steps": n_steps,
        "n_empty_steps": len(getattr(lm, "empty_steps", frozenset())),
        "n_fused_dispatches": len(plans),
        # groups whose per-step plan hit another group's memo entry: the
        # cross-request plan-sharing win of bucketing by content
        "n_shared_plans": sum(p.n_shared_plans for p in plans),
        "n_entries": n_entries,
        "n_padding": n_padding,
        "padding_frac": n_padding / total if total else 0.0,
        "per_step": [p.stats() for p in plans],
    }


def distributed_matmul_batched(
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
    a_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    b_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    a_norms: Optional[Sequence[Optional[np.ndarray]]] = None,
    b_norms: Optional[Sequence[Optional[np.ndarray]]] = None,
    filter_eps: Optional[float] = None,
    precision=None,
    pipeline_depth: Optional[int] = None,
    double_buffer: Optional[bool] = None,
    return_plan: bool = False,
    **kw,
) -> torch.Tensor:
    """C[g] = A[g] @ B[g] for every product ``g`` of a fused batch.

    ``a``: (G, M, K) and ``b``: (G, K, N), global, on the mesh's
    device.  ``algorithm`` is ``"auto"`` (the planner's pick of the two
    below, with its local path, stack size and depth where the caller
    leaves them None), ``"cannon"`` or ``"summa"`` (psum broadcast;
    ``bcast="gather"`` is refused); ``densify`` picks the local path as
    in ``distributed_matmul`` (True or None under a fixed algorithm: one
    grouped GEMM,
    ``local_kernel="pallas"`` for the grouped_gemm kernel; False: one
    fused smm launch, under ``"pallas"`` too; ``local_kernel="ref"`` for
    its plain version).

    Per-product sparsity: ``a_masks`` / ``b_masks`` / ``a_norms`` /
    ``b_norms`` are length-G sequences (entries may be None = dense);
    ``filter_eps`` is shared by the whole batch (the batching service
    buckets requests by eps).  When filtering without explicit norms they
    are derived per product from the payloads.

    ``precision`` sets the densified ``torch.bmm``'s f32 mode as in
    ``distributed_matmul`` (``core.precision``; None, the default, is
    IEEE f32); the grouped_gemm kernel and the blocked path ignore it.
    Neither the planner nor the service's bucket key sees it, as in the
    JAX package.

    ``return_plan=True`` returns ``(C, BatchedMultiplyPlan)``: the
    planner's fuse-or-loop pricing, with the executed fused dispatch's
    padding and plan-sharing statistics as ``executor_stats``.

    With telemetry on (``obs.enable()``) the call records a
    ``multiply_batched`` span (module docstring); off, or under
    torch.compile tracing or CUDA-graph capture, it is bit identical
    with one boolean of overhead.
    """
    c, plan = _distributed_matmul_batched(
        a, b, mesh=mesh, grid=grid, algorithm=algorithm, densify=densify,
        block_m=block_m, block_k=block_k, block_n=block_n,
        stack_size=stack_size, align=align, local_kernel=local_kernel,
        a_masks=a_masks, b_masks=b_masks, a_norms=a_norms, b_norms=b_norms,
        filter_eps=filter_eps, precision=precision,
        pipeline_depth=pipeline_depth, double_buffer=double_buffer,
        return_plan=return_plan, **kw)
    return (c, plan) if return_plan else c


def _distributed_matmul_batched(a: torch.Tensor, b: torch.Tensor, **kw):
    """``_distributed_matmul_batched_impl`` under the call's telemetry
    flag: untraced when ``obs.recording()`` is false, else inside a
    ``multiply_batched`` root span.  ``distributed_matmul_batched`` and
    ``dbcsr.multiply_batched``'s fused buckets enter here."""
    if not obs.recording():
        return _distributed_matmul_batched_impl(a, b, **kw)
    attrs = {"algorithm": kw.get("algorithm", "auto")}
    if a.ndim == 3 and b.ndim == 3:
        attrs.update(n_groups=int(a.shape[0]), m=int(a.shape[1]),
                     k=int(a.shape[2]), n=int(b.shape[2]))
    with obs.span("multiply_batched", cat="multiply", **attrs):
        return _distributed_matmul_batched_impl(a, b, _tele=True, **kw)


def _distributed_matmul_batched_impl(
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
    a_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    b_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    a_norms: Optional[Sequence[Optional[np.ndarray]]] = None,
    b_norms: Optional[Sequence[Optional[np.ndarray]]] = None,
    filter_eps: Optional[float] = None,
    precision=None,
    pipeline_depth: Optional[int] = None,
    double_buffer: Optional[bool] = None,
    return_plan: bool = False,
    _tele: bool = False,
    **kw,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """``distributed_matmul_batched`` returning ``(C, executor_stats)``:
    the executed fused dispatch's padding and plan-sharing statistics
    (None on the densified path), which ``dbcsr.multiply_batched``
    reports per bucket; with ``return_plan`` ``(C, plan)``, the
    statistics on ``plan.executor_stats``.  ``_tele`` is the call's
    telemetry flag (``_distributed_matmul_batched``)."""
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"batched operands must be (G, M, K) x (G, K, N), "
                         f"got {tuple(a.shape)} x {tuple(b.shape)}")
    g_count, m, k = a.shape
    gb, k2, n = b.shape
    if gb != g_count or k != k2:
        raise ValueError(f"batched operands disagree: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if g_count < 1:
        raise ValueError("batched multiply needs at least one product")
    resolve_precision(precision)
    if kw.get("bcast") == "gather":
        raise ValueError("bcast='gather' is not supported for batched "
                         "dispatch (the all-gathered full-K row would be "
                         "replicated per product)")
    if algorithm != "auto" and algorithm not in BATCHED_ALGORITHMS:
        raise ValueError(
            f"batched dispatch supports {BATCHED_ALGORITHMS}, got "
            f"{algorithm!r} (the tall-skinny / 2.5D schedules are not "
            f"batch-shape-agnostic)")

    filtering = filter_eps is not None
    if filtering and a_norms is None and b_norms is None:
        from ..sparsity.norms import block_norms_of

        a_norms = [block_norms_of(a[gi], block_m, block_k,
                                  _per_group(a_masks, gi, g_count, "a_masks"))
                   for gi in range(g_count)]
        b_norms = [block_norms_of(b[gi], block_k, block_n,
                                  _per_group(b_masks, gi, g_count, "b_masks"))
                   for gi in range(g_count)]

    pr, pc = grid.grid_shape(mesh)
    plan = None
    # telemetry forces a plan even for pinned algorithms (the scoreboard
    # needs the predicted fused cost)
    if algorithm == "auto" or return_plan or _tele:
        from ..planner.plan import plan_multiply_batched

        with obs.maybe_span(_tele, "plan", cat="plan") as psp:
            occs = [
                _global_occupancy(
                    m, k, n, block_m, block_k, block_n,
                    _per_group(a_masks, gi, g_count, "a_masks"),
                    _per_group(b_masks, gi, g_count, "b_masks"),
                    _per_group(a_norms, gi, g_count, "a_norms"),
                    _per_group(b_norms, gi, g_count, "b_norms"),
                    filter_eps)
                for gi in range(g_count)
            ]
            occ = sum(occs) / len(occs)
            occ_max = max(occs)
            # groups pad to the largest group's stack shape: the mean / max
            # occupancy spread estimates the fused dispatch's padding waste
            plan = plan_multiply_batched(
                g_count, m, k, n, blocks=(block_m, block_k, block_n),
                mesh_shape=(pr, pc), occupancy=occ,
                dtype=torch.promote_types(a.dtype, b.dtype),
                algorithm=None if algorithm == "auto" else algorithm,
                densify=(densify if algorithm == "auto" or densify is not None
                         else True),
                padding_frac=1.0 - occ / occ_max if occ_max > 0 else 0.0,
                stack_size=stack_size, align=align)
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
            psp.set(algorithm=plan.algorithm, fuse=bool(plan.fuse),
                    densify=bool(plan.densify),
                    predicted_fused_s=float(plan.predicted_fused_s),
                    predicted_looped_s=float(plan.predicted_looped_s),
                    occupancy=float(occ), trivial=bool(plan.trivial))

    if densify is None:
        densify = True  # mirror distributed_matmul's fixed-algorithm default

    # ---- local multiply geometry ------------------------------------
    pg = n_panels = None
    if algorithm == "cannon":
        pg = grid.validate_square(mesh)
        if (m % pg or k % pg or n % pg) and not densify:
            raise ValueError(
                f"shape ({m},{k},{n}) not divisible by grid side {pg}")
        ml, kl, nl = m // pg, k // pg, n // pg
    else:
        n_panels = summa_n_panels(pr, pc)
        if (m % pr or n % pc or k % n_panels) and not densify:
            raise ValueError(
                f"shape ({m},{k},{n}) not divisible by summa grid "
                f"{pr}x{pc} with {n_panels} panels")
        ml, kl, nl = m // pr, k // n_panels, n // pc

    # ---- local multiply strategy ------------------------------------
    if densify:
        lm = grouped_densified_local_matmul(precision, kernel=local_kernel)
    else:
        batched_kw = dict(
            block_m=block_m, block_k=block_k, block_n=block_n,
            stack_size=stack_size, align=align,
            kernel=_stack_kernel(local_kernel))
        if a_masks is None and b_masks is None and not filtering:
            lm = batched_stack_executor(g_count, ml, kl, nl, **batched_kw)
        else:
            group_ab = []
            for gi in range(g_count):
                am, bmk = _block_masks(
                    m, k, n, block_m, block_k, block_n,
                    _per_group(a_masks, gi, g_count, "a_masks"),
                    _per_group(b_masks, gi, g_count, "b_masks"))
                an_g = bn_g = None
                if filtering:
                    from ..sparsity.norms import normalize_block_norms

                    an_g, bn_g = normalize_block_norms(
                        am.shape[0], am.shape[1], bmk.shape[1],
                        _per_group(a_norms, gi, g_count, "a_norms"),
                        _per_group(b_norms, gi, g_count, "b_norms"))
                    # mask-absent blocks are forced to norm 0 so one
                    # >= eps comparison folds both criteria
                    an_g = np.where(am, an_g, np.float32(0.0))
                    bn_g = np.where(bmk, bn_g, np.float32(0.0))
                group_ab.append((am, bmk, an_g, bn_g))
            if algorithm == "cannon":
                n_steps = pg
                per_group = [cannon_step_masks(am, bmk, pg)
                             for am, bmk, _, _ in group_ab]
                steps = [[{"pair_mask": per_group[gi][t]}
                          for gi in range(g_count)] for t in range(n_steps)]
                if filtering:
                    per_group_n = [cannon_step_norms(an_g, bn_g, pg)
                                   for _, _, an_g, bn_g in group_ab]
                    for t in range(n_steps):
                        for gi in range(g_count):
                            steps[t][gi]["pair_norms"] = per_group_n[gi][t]
            else:
                n_steps = n_panels
                per_group = [summa_step_masks(am, bmk, pr, pc, n_panels)
                             for am, bmk, _, _ in group_ab]
                steps = [[dict(zip(("a_mask", "b_mask"), per_group[gi][t]))
                          for gi in range(g_count)] for t in range(n_steps)]
                if filtering:
                    per_group_n = [summa_step_norms(an_g, bn_g, pr, pc,
                                                    n_panels)
                                   for _, _, an_g, bn_g in group_ab]
                    for t in range(n_steps):
                        for gi in range(g_count):
                            una, unb = per_group_n[gi][t]
                            steps[t][gi].update(a_norms=una, b_norms=unb)
            lm = _stepwise_batched_lm(
                g_count, ml, kl, nl, group_mask_steps=steps,
                filter_eps=filter_eps, **batched_kw)

    # ---- data exchange (one schedule for the whole batch) ------------
    run = cannon_matmul if algorithm == "cannon" else summa_matmul

    def _run():
        return run(a, b, mesh=mesh, grid=grid, local_matmul=lm,
                   precision=precision, pipeline_depth=pipeline_depth,
                   double_buffer=double_buffer, **kw)

    if not _tele:
        c = _run()
    else:
        from ..planner.plan import itemsize_of

        depth = resolve_pipeline_depth(pipeline_depth, double_buffer)
        c, dsp, t0, dt = _timed_dispatch(
            _run, mesh.device, dict(algorithm=algorithm,
                                    densify=bool(densify),
                                    pipeline_depth=depth,
                                    n_groups=g_count))
        try:
            # per-step spans from the single-product schedule model,
            # G-scaled (comm bytes and dense flops multiply by the group
            # count on the fused batch)
            ss = _schedule_stats(
                algorithm, grid=grid, mesh=mesh, local_shape=(ml, kl, nl),
                itemsize=itemsize_of(torch.promote_types(a.dtype, b.dtype)),
                lm=lm, densify=densify, pipeline_depth=depth, reduce_kw=kw,
                n_groups=g_count)
        except Exception:
            ss = None  # telemetry must never break the multiply
        if ss is not None:
            dsp.set(comm_bytes=int(ss.get("total_comm_bytes", 0)))
            _emit_step_spans(dsp.rec, t0, dt, ss)
        if plan is not None and not plan.trivial:
            obs.record_plan_outcome(
                kind="multiply_batched", algorithm=algorithm,
                densify=bool(densify), n_groups=g_count, m=m, k=k, n=n,
                fuse=bool(plan.fuse),
                predicted_s=float(plan.predicted_fused_s),
                measured_s=float(dt), pipeline_depth=int(depth))
    stats = _collect_batched_executor_stats(lm, densify)
    if not return_plan:
        return c, stats
    return c, dataclasses.replace(plan, executor_stats=stats)
