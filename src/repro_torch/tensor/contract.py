"""contract — execute a blocked tensor contraction on the 2D engine
(the port's copy of the JAX package's ``tensor/contract.py``).

The pipeline (one obs root span ``contract`` when telemetry is on):

  parse     einsum.parse_contraction -> (contracted, A-free, B-free)
  plan      per-layout geometry stats (matricize.contraction_layout_
            stats) -> planner.plan_contract picks the matricization
            (and, via plan_multiply per layout, the 2D algorithm/path)
  matricize unfold A and B into DBCSRMatrix views, lowering masks and
            norms (span ``matricize``)
  multiply  the existing dbcsr.multiply, pinned to the planned
            algorithm/path so the executed 2D product matches the
            priced one (nested ``multiply`` span, eps filtering, ABFT
            verify=, rank_exact= all compose here unchanged)
  fold      refold payload + retained mask into the spec's output
            frame (span ``matricize`` again)

Determinism contract: at a fixed layout the result is bitwise equal to
hand-matricizing the operands and calling ``dbcsr.multiply`` directly —
the fold is a pure element permutation.  Different layouts change the
fused accumulation ORDER, so cross-layout results agree to float
tolerance (allclose vs the dense einsum oracle), not bitwise; that is
the same caveat as the 2D algorithms themselves.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from .. import obs

from .einsum import (EinsumSpecError, parse_contraction,
                     validate_contraction_operands)
from .matricize import (Layout, contraction_layout_stats, enumerate_layouts,
                        fold_to_tensor, layout_operands, unfold_tensor)
from .tensor import DBCSRTensor

__all__ = ["contract"]


def _resolve_layouts(con, layout):
    """The candidate layout set: all of them under "auto", exactly one
    when the caller pins a ``Layout`` or its label."""
    allowed = enumerate_layouts(con)
    if layout is None or layout == "auto":
        return allowed
    if isinstance(layout, Layout):
        if layout not in allowed:
            raise EinsumSpecError(
                f"layout {layout.label} is not a legal matricization of "
                f"{con.spec!r}")
        return (layout,)
    wanted = [L for L in allowed if L.label == str(layout)]
    if not wanted:
        raise EinsumSpecError(
            f"unknown layout {layout!r} for {con.spec!r}; legal: "
            f"{[L.label for L in allowed]}")
    return (wanted[0],)


def contract(
    spec: str,
    a: DBCSRTensor,
    b: DBCSRTensor,
    *,
    mesh,
    algorithm: str = "auto",
    layout="auto",
    densify: Optional[bool] = None,
    filter_eps: Optional[float] = None,
    verify: Optional[str] = None,
    rank_exact: Optional[bool] = None,
    return_plan: bool = False,
    **kw,
):
    """C = contraction of A and B per ``spec`` (see dbcsr.contract for
    the full API documentation)."""
    con = parse_contraction(spec)
    validate_contraction_operands(con, a, b)
    if not obs.recording():
        return _contract(con, a, b, mesh=mesh, algorithm=algorithm,
                         layout=layout, densify=densify,
                         filter_eps=filter_eps, verify=verify,
                         rank_exact=rank_exact, return_plan=return_plan,
                         **kw)
    with obs.span("contract", cat="contract", spec=con.normalized,
                  algorithm=algorithm):
        return _contract(con, a, b, mesh=mesh, algorithm=algorithm,
                         layout=layout, densify=densify,
                         filter_eps=filter_eps, verify=verify,
                         rank_exact=rank_exact, return_plan=return_plan,
                         _tele=True, **kw)


def _contract(con, a, b, *, mesh, algorithm, layout, densify, filter_eps,
              verify, rank_exact, return_plan, _tele=False, **kw):
    from ..core import dbcsr
    from ..planner.plan import plan_contract

    if filter_eps is not None:
        # norms feed BOTH the per-layout occupancy/imbalance pricing
        # and (lowered through the unfold) the inner multiply's filter
        a.norms()
        b.norms()
    pr, pc = a.grid.grid_shape(mesh)
    layouts = _resolve_layouts(con, layout)
    with obs.maybe_span(_tele, "plan", cat="plan",
                        n_layouts=len(layouts)):
        stats = tuple(
            contraction_layout_stats(con, L, a, b, mesh_shape=(pr, pc),
                                     filter_eps=filter_eps,
                                     rank_exact=rank_exact,
                                     device=mesh.device)
            for L in layouts)
        cplan = plan_contract(
            con.normalized, stats, mesh_shape=(pr, pc),
            dtype=a.data.dtype,
            algorithm=None if algorithm == "auto" else algorithm,
            densify=densify)
    chosen = next(s for s in stats if s.label == cplan.layout)
    lsrc, lrows, lcols, rsrc, rrows, rcols, crows, ccols = \
        layout_operands(con, chosen.layout)
    left = a if lsrc == "a" else b
    right = b if rsrc == "b" else a
    lidx = con.a_indices if lsrc == "a" else con.b_indices
    ridx = con.b_indices if rsrc == "b" else con.a_indices
    dims = {**dict(zip(con.a_indices, a.shape)),
            **dict(zip(con.b_indices, b.shape))}
    bs = {**dict(zip(con.a_indices, a.block_sizes)),
          **dict(zip(con.b_indices, b.block_sizes))}

    t0 = time.perf_counter() if _tele else 0.0
    with obs.maybe_span(_tele, "matricize", cat="matricize",
                        layout=cplan.layout, phase="unfold"):
        ma = unfold_tensor(left, lidx, lrows, lcols, mesh=mesh)
        mb = unfold_tensor(right, ridx, rrows, rcols, mesh=mesh)
    # pinned to the contraction plan's choices so the executed 2D
    # product is exactly the priced one (densify passed explicitly:
    # a pinned algorithm with densify=None would fall back to the
    # legacy densified default, not the planner's path)
    c2d, mplan = dbcsr.multiply(
        ma, mb, mesh=mesh, algorithm=cplan.plan.algorithm,
        densify=cplan.plan.densify, filter_eps=filter_eps,
        verify=verify, rank_exact=rank_exact, return_plan=True, **kw)
    with obs.maybe_span(_tele, "matricize", cat="matricize",
                        layout=cplan.layout, phase="fold"):
        out = fold_to_tensor(c2d, con.out_indices, crows, ccols, dims, bs,
                             a.grid, mesh=mesh)
    # graft the executed stats onto the PLANNED multiply plan (whose
    # candidate table covers the full auto enumeration — the executed
    # inner plan was pinned, so its own table holds one candidate)
    executed = dataclasses.replace(
        cplan,
        plan=dataclasses.replace(
            cplan.plan, executor_stats=mplan.executor_stats,
            schedule_stats=mplan.schedule_stats,
            verification=mplan.verification),
        verification=mplan.verification)
    out.last_plan = executed
    out.verification = mplan.verification
    if _tele and not executed.trivial:
        if out.data.device.type == "cuda":
            torch.cuda.synchronize(out.data.device)
        obs.record_plan_outcome(
            kind="contract", spec=con.normalized,
            algorithm=executed.plan.algorithm, layout=executed.layout,
            densify=bool(executed.plan.densify),
            m=chosen.m, k=chosen.k, n=chosen.n,
            occupancy=float(chosen.occupancy),
            predicted_s=float(cplan.predicted_s),
            measured_s=float(time.perf_counter() - t0))
    return (out, executed) if return_plan else out
