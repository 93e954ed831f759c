"""DBCSRMatrix — the user-facing blocked matrix container.

Mirrors the DBCSR API surface (create / multiply / add / trace /
transpose) on torch tensors.  The payload of a matrix is one dense 2D
tensor on the mesh's device; the block structure is metadata
(BlockLayout) consumed by the local-multiply strategies.

Block-sparse matrices carry a static block mask (numpy bool,
(nblock_rows, nblock_cols)); absent blocks are stored as zeros in the
dense payload, and the stack generator skips them, which is where the
sparse wins come from.

``from_state`` builds the port's matrix from the numpy state of a JAX
``DBCSRMatrix`` (payload, layout, grid axis names, mask, norms), so a
matrix can move from the reference to the port.

``multiply_batched`` runs many independent products, bucketed by
``_bucket_key`` (geometry, occupancy bin, eps), one fused dispatch per
bucket (core/multiply_batched.py).

``create_tensor`` / ``contract`` are the N-d siblings (repro_torch.tensor,
after arXiv:1910.13555): blocked tensors whose einsum contractions lower
onto ``multiply`` by matricization.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import obs
from .blocking import BlockLayout, GridSpec

__all__ = ["DBCSRMatrix", "create", "from_state", "multiply",
           "multiply_batched", "multiply_vector", "add", "trace",
           "transpose", "contract", "create_tensor"]


def _expand_mask(mask: np.ndarray, block_rows: int, block_cols: int,
                 like: torch.Tensor) -> torch.Tensor:
    full = np.repeat(np.repeat(mask, block_rows, 0), block_cols, 1)
    return torch.as_tensor(full, device=like.device).to(like.dtype)


@dataclasses.dataclass
class DBCSRMatrix:
    """A blocked matrix.

    data       : (rows, cols) tensor on the mesh's device
    layout     : block structure metadata
    grid       : mesh-axis names of the process grid
    block_mask : optional (nbr, nbc) numpy bool — block-sparse occupancy
    block_norms: optional (nbr, nbc) numpy float32 — per-block Frobenius
                 norms, lazily computed and cached by ``norms()``
    """

    data: torch.Tensor
    layout: BlockLayout
    grid: GridSpec
    block_mask: Optional[np.ndarray] = None
    block_norms: Optional[np.ndarray] = None

    @property
    def shape(self):
        return self.data.shape

    @property
    def occupancy(self) -> float:
        if self.block_mask is None:
            return 1.0
        return float(self.block_mask.mean())

    def norms(self, recompute: bool = False) -> np.ndarray:
        """Per-block Frobenius norms ((nbr, nbc) float32 numpy), cached
        after the first call.  Mask-absent blocks report 0.  Pass
        ``recompute=True`` after mutating ``data`` directly."""
        if self.block_norms is None or recompute:
            from ..sparsity.norms import block_norms_of

            self.block_norms = block_norms_of(
                self.data, self.layout.block_rows, self.layout.block_cols,
                self.block_mask)
        return self.block_norms

    def filter(self, eps: float) -> "DBCSRMatrix":
        """Post-multiply filtering: drop every block with ``norm < eps``
        (blocks exactly at eps survive), zeroing the dropped blocks'
        payload.  Never resurrects a block the mask declares absent."""
        norms = self.norms()
        mask = norms >= float(eps)
        if self.block_mask is not None:
            mask &= self.block_mask
        data = self.data * _expand_mask(mask, self.layout.block_rows,
                                        self.layout.block_cols, self.data)
        new_norms = np.where(mask, norms, np.float32(0.0)).astype(np.float32)
        return DBCSRMatrix(data, self.layout, self.grid, mask, new_norms)

    def transpose(self) -> "DBCSRMatrix":
        layout = BlockLayout(self.layout.cols, self.layout.rows,
                             self.layout.block_cols, self.layout.block_rows)
        mask = None if self.block_mask is None else self.block_mask.T.copy()
        norms = (None if self.block_norms is None
                 else self.block_norms.T.copy())
        return DBCSRMatrix(self.data.T.contiguous(), layout, self.grid,
                           mask, norms)

    def trace(self) -> torch.Tensor:
        return torch.trace(self.data)

    def scale(self, alpha) -> "DBCSRMatrix":
        norms = None
        if self.block_norms is not None:
            # |alpha| rescales Frobenius norms exactly
            norms = (self.block_norms
                     * np.float32(abs(float(alpha)))).astype(np.float32)
        return dataclasses.replace(self, data=self.data * alpha,
                                   block_norms=norms)


def _x32(data: torch.Tensor) -> torch.Tensor:
    """The reference's dtype rule for host arrays (JAX without x64):
    float64 becomes float32."""
    return data.to(torch.float32) if data.dtype == torch.float64 else data


def create(
    array,
    *,
    mesh,
    grid: GridSpec = GridSpec(),
    block_size: int = 64,
    block_mask: Optional[np.ndarray] = None,
    compute_norms: bool = False,
) -> DBCSRMatrix:
    """Create a DBCSR matrix from a host array or tensor, placed on the
    mesh's device.  Absent blocks of ``block_mask`` are zeroed.
    ``compute_norms=True`` fills the norm cache eagerly.  float64 is
    stored as float32, as the reference stores it with JAX's 64-bit
    types off."""
    data = _x32(torch.as_tensor(array)).to(mesh.device)
    rows, cols = data.shape
    layout = BlockLayout(rows, cols, block_size, block_size)
    if block_mask is not None:
        block_mask = np.asarray(block_mask, dtype=bool)
        if block_mask.shape != (layout.nblock_rows, layout.nblock_cols):
            raise ValueError("block_mask shape mismatch")
        # zero out absent blocks so dense math matches sparse semantics
        data = data * _expand_mask(block_mask, block_size, block_size, data)
    out = DBCSRMatrix(data, layout, grid, block_mask)
    if compute_norms:
        out.norms()
    return out


def from_state(state: dict, *, mesh) -> DBCSRMatrix:
    """The port's matrix from a JAX ``DBCSRMatrix``'s numpy state:
    ``data``; the layout's ``rows``, ``cols``, ``block_rows``,
    ``block_cols``; the grid's ``row_axis``, ``col_axis`` (and optional
    ``stack_axis``); ``block_mask`` and ``block_norms`` (each may be
    None).  The payload goes to the mesh's device as it is: no mask is
    re-applied, so the two packages hold the same bits."""
    layout = BlockLayout(int(state["rows"]), int(state["cols"]),
                         int(state["block_rows"]), int(state["block_cols"]))
    grid = GridSpec(state["row_axis"], state["col_axis"],
                    state.get("stack_axis"))
    data = _x32(torch.tensor(np.asarray(state["data"]))).to(mesh.device)
    if tuple(data.shape) != (layout.rows, layout.cols):
        raise ValueError(f"data shape {tuple(data.shape)} does not match "
                         f"layout {(layout.rows, layout.cols)}")
    mask = state.get("block_mask")
    norms = state.get("block_norms")
    grid_shape = (layout.nblock_rows, layout.nblock_cols)
    if mask is not None:
        mask = np.array(mask, dtype=bool)
        if mask.shape != grid_shape:
            raise ValueError(f"block_mask shape {mask.shape} != {grid_shape}")
    if norms is not None:
        norms = np.array(norms, dtype=np.float32)
        if norms.shape != grid_shape:
            raise ValueError(f"block_norms shape {norms.shape} != {grid_shape}")
    return DBCSRMatrix(data, layout, grid, mask, norms)


def add(a: DBCSRMatrix, b: DBCSRMatrix,
        recompute_norms: bool = False) -> DBCSRMatrix:
    """C = A + B.  Result occupancy is the union of the operands'; when
    only one operand carries a mask the union with the dense one is
    dense (mask None).  Norms are not propagated (``||A + B||`` per
    block is only bounded by the operands'); ``recompute_norms=True``
    computes the sum's true norms eagerly."""
    mask = None
    if a.block_mask is not None and b.block_mask is not None:
        mask = a.block_mask | b.block_mask
    out = DBCSRMatrix(a.data + b.data, a.layout, a.grid, mask)
    if recompute_norms:
        out.norms()
    return out


def trace(a: DBCSRMatrix) -> torch.Tensor:
    return a.trace()


def transpose(a: DBCSRMatrix) -> DBCSRMatrix:
    return a.transpose()


def multiply_vector(a: DBCSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x."""
    return a.data @ x


def _product_mask(a: DBCSRMatrix, b: DBCSRMatrix, an, bn,
                  filter_eps: Optional[float]):
    """The result support of C = A @ B: ``(mask, needs_zeroing)`` where
    ``mask`` is the symbolic product support ``(a_mask @ b_mask) > 0``
    (None when both operands are dense and no filter applies) or, under
    ``filter_eps``, the eps-retained support, outside which the payload
    must be zeroed."""
    if (a.block_mask is None and b.block_mask is None
            and filter_eps is None):
        return None, False
    from .stacks import normalize_block_masks

    am, bm = normalize_block_masks(
        a.layout.nblock_rows, a.layout.nblock_cols,
        b.layout.nblock_cols, a.block_mask, b.block_mask)
    if filter_eps is not None:
        from ..sparsity.filter import product_mask

        return product_mask(am, bm, an, bn, filter_eps), True
    return (am.astype(np.int64) @ bm.astype(np.int64)) > 0, False


def _apply_result_mask(c_data: torch.Tensor, mask: Optional[np.ndarray],
                       needs_zeroing: bool, block_rows: int,
                       block_cols: int) -> torch.Tensor:
    """Zero the payload outside the retained support (eps path only)."""
    if mask is None or not needs_zeroing:
        return c_data
    return c_data * _expand_mask(mask, block_rows, block_cols, c_data)


def multiply(
    a: DBCSRMatrix,
    b: DBCSRMatrix,
    *,
    mesh,
    algorithm: str = "auto",
    densify: Optional[bool] = None,
    filter_eps: Optional[float] = None,
    verify: Optional[str] = None,
    return_plan: bool = False,
    **kw,
) -> DBCSRMatrix:
    """C = A @ B through ``multiply.distributed_matmul``.  With
    ``algorithm="auto"`` (the default) the cost-model planner
    (repro_torch.planner) picks the data-exchange algorithm AND the
    local path for this (shape, occupancy, mesh); a fixed ``algorithm``
    (cannon, cannon25d, summa, ts_k / ts_m / ts_n) or ``densify`` pins
    them (``densify=None`` under a fixed algorithm means densified).
    Any mesh whose ranks the port simulates on its device
    (launch/mesh.py); the matrices stay global on the mesh's device.

    Block occupancy flows end to end: the operands' masks go to the
    dispatcher (the blocked path plans only present triples), and the
    result carries the symbolic product mask ``(a_mask @ b_mask) > 0``,
    a missing operand mask counting as all-present.

    ``filter_eps`` drops product contributions with ``norm(A_ik) *
    norm(B_kj) < filter_eps`` before they reach a stack (operand norms
    from ``norms()``); the result's mask is then the retained support
    and the payload is zeroed outside it (on the densified path too).
    ``filter_eps=0.0`` gives the unfiltered result, mask and payload.

    On more than one rank a masked or filtered blocked multiply runs
    rank-exactly by default: each rank executes its own retained
    triples (under ``filter_eps > 0`` filtered by its own norms, the
    exact per-triple filter); ``rank_exact=False`` runs the union of the
    ranks' plans, bitwise the same product at eps None or 0.
    ``rebalance=True`` permutes block rows of A and block columns of B
    to even out the ranks' work and gives C back in the caller's order;
    ``rebalance=None`` follows the plan's costed decision.  On one rank,
    or densified, both are ignored (see ``multiply.distributed_matmul``).

    The product carries the executed plan as ``C.last_plan`` (a
    ``MultiplyPlan``: ``explain()`` lists every candidate's predicted
    cost; ``executor_stats`` what ran), and ``return_plan=True``
    returns ``(C, plan)``, whose plan also holds the schedule's per-step
    split (``schedule_stats``, None on ``last_plan`` otherwise).

    ``verify`` — ABFT self-verification (repro_torch.robustness):
    ``"checksum"`` verifies the raw product against block checksums
    *before* the result mask is applied (tolerances scaled by the norm
    cache and the eps-dropped mass), localizes a corrupted block,
    repairs it by one re-run of the same dispatch (bitwise equal to a
    clean run) and raises ``guards.CorruptionDetectedError`` when the
    corruption survives; operands are screened by the NaN/Inf tripwires
    first.  ``"auto"`` verifies only when the planner prices the
    checksum overhead within ``verify_budget`` (default 25 %) of the
    plan's predicted time.  ``None`` (default) adds no work: bitwise the
    unverified multiply.  The outcome is ``C.verification`` (and
    ``plan.verification``): the pricing decision and, when it ran, the
    ``VerificationReport``.
    """
    from .multiply import _distributed_matmul

    rng = obs.ranging()
    an = bn = None
    if filter_eps is not None:
        an, bn = a.norms(), b.norms()
    c_data, plan = _distributed_matmul(
        a.data, b.data, _rng=rng, mesh=mesh, grid=a.grid,
        algorithm=algorithm, densify=densify,
        block_m=a.layout.block_rows, block_k=a.layout.block_cols,
        block_n=b.layout.block_cols,
        a_mask=a.block_mask, b_mask=b.block_mask,
        a_norms=an, b_norms=bn, filter_eps=filter_eps,
        verify=verify, return_plan=True, schedule_stats=return_plan, **kw,
    )
    with obs.maybe_range(rng, "result_mask"):
        c_layout = BlockLayout(a.layout.rows, b.layout.cols,
                               a.layout.block_rows, b.layout.block_cols)
        mask, zero = _product_mask(a, b, an, bn, filter_eps)
        c_data = _apply_result_mask(c_data, mask, zero, a.layout.block_rows,
                                    b.layout.block_cols)
        c = DBCSRMatrix(c_data, c_layout, a.grid, mask)
        c.last_plan = plan
        c.verification = plan.verification
    return (c, plan) if return_plan else c


def create_tensor(array, *, mesh, grid=GridSpec(), block_sizes,
                  block_mask=None, compute_norms=False):
    """Create a blocked N-d ``DBCSRTensor`` (repro_torch.tensor) — the
    tensor analogue of ``create``: uniform per-axis blocking, an optional
    N-d block occupancy mask (absent blocks' payload zeroed) and a
    lazily cached per-block Frobenius norm tensor, on the mesh's device.
    Tensors are contracted with ``contract``."""
    from ..tensor import create_tensor as _create_tensor

    return _create_tensor(array, mesh=mesh, grid=grid,
                          block_sizes=block_sizes, block_mask=block_mask,
                          compute_norms=compute_norms)


def contract(
    spec: str,
    a,
    b,
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
    """C = contraction of two blocked tensors per an einsum ``spec``
    (``"ijk,kl->ijl"``) — the N-d sibling of ``multiply`` /
    ``multiply_batched`` (repro_torch.tensor, after arXiv:1910.13555):
    the spec is parsed into (contracted, A-free, B-free) index groups,
    the tensors are MATRICIZED — each group fused into one blocked
    matrix dimension at the block level, so masks lower by a pure
    block-grid transpose (an N-d block is retained iff its 2D image is)
    and the Frobenius norm cache lowers exactly (norms are invariant to
    the intra-block permutation) — the 2D product runs through the
    ordinary ``multiply``, and the result folds back into the spec's
    output frame as a ``DBCSRTensor`` carrying the retained N-d mask.

    ``layout`` — the matricization is a COSTED choice: every legal
    layout (fusion orders of the three index groups x the transposed
    variant) is priced by the planner as its own 2D multiply plan
    (per-layout occupancy and rank imbalance from the matricized masks)
    plus its unfold/refold copy cost (``cost_model.matricize_cost_s``).
    ``"auto"`` (default) lets ``planner.plan_contract`` pick — LRU-cached
    on the contraction signature, so a repeated contraction replans for
    free; a ``Layout`` instance or its label string (e.g.
    ``"(ij|k)@(k|l)"``) pins it.  The result carries the executed
    ``ContractionPlan`` as ``C.last_plan``, whose ``explain()`` prints
    the per-layout table above the winning layout's per-candidate
    multiply breakdown.

    ``algorithm`` / ``densify`` / ``filter_eps`` / ``verify`` /
    ``rank_exact`` and any further kwargs thread through to the
    underlying ``multiply`` with identical semantics: eps filtering uses
    the lowered norms (``filter_eps=0`` bit-identical to unfiltered),
    ABFT verification detects, localizes and repairs corruption before
    the refold (reported as ``C.verification``), and rank-exact per-rank
    plans see the matricized masks.

    At a FIXED layout the result is bitwise equal to hand-matricizing
    the operands and calling ``multiply`` directly (the fold is a pure
    element permutation); different layouts change the fused
    accumulation order and agree to float tolerance only.

    ``return_plan=True`` returns ``(C, ContractionPlan)``.
    """
    from ..tensor import contract as _contract

    return _contract(spec, a, b, mesh=mesh, algorithm=algorithm,
                     layout=layout, densify=densify,
                     filter_eps=filter_eps, verify=verify,
                     rank_exact=rank_exact, return_plan=return_plan, **kw)


def _bucket_key(a: DBCSRMatrix, b: DBCSRMatrix,
                filter_eps: Optional[float]) -> tuple:
    """The batching bucket contract: requests fuse only when they agree
    on (geometry, occupancy-bin, eps).

      geometry       operand shapes + block sizes + grid axis names:
                     everything the fused dispatch's shape depends on
      occupancy-bin  ``fill_bin`` of each operand's block-mask fill (the
                     winners table's log-spaced bins): requests in one
                     bin share stack parameters and pad little against
                     each other; finer distinctions stay per request
                     through the content-fingerprinted plan memo
      eps            the norm-filter threshold: it shapes the per-group
                     plans, so it must be bucket-uniform

    The serving layer (repro_torch.serve.multiply_service) buckets queued
    requests by this same function.  The tuple equals the JAX package's.
    """
    from ..kernels.smm.autotune import fill_bin

    return (
        tuple(a.shape), tuple(b.shape),
        a.layout.block_rows, a.layout.block_cols, b.layout.block_cols,
        a.grid.row_axis, a.grid.col_axis,
        fill_bin(a.occupancy), fill_bin(b.occupancy),
        None if filter_eps is None else float(filter_eps),
    )


def _execute_bucket(group, *, mesh, algorithm, densify, filter_eps, fused,
                    verify=None, **kw):
    """Run one bucket of same-key requests: fused (one batched dispatch)
    or looped (per-request ``multiply``), per the planner's fuse-or-loop
    pricing unless ``fused`` pins it.  ``fused=None`` fuses a bucket of
    more than one request of a batch-capable algorithm when
    ``plan_multiply_batched`` prices one fused dispatch (over the
    requests' mean occupancy, with their spread as padding) below the
    loop.  ``verify`` forces the looped path: ABFT checksums verify one
    product at a time (as in the JAX package, which has no verification
    of the fused dispatch)."""
    from .multiply import _global_occupancy
    from .multiply_batched import BATCHED_ALGORITHMS

    if verify is not None:
        if fused:
            raise ValueError(
                "verify= requires the looped path (ABFT on the fused "
                "batched dispatch is not implemented); drop fused=True")
        fused = False
    a0, b0 = group[0]
    g = len(group)
    an = bn = None
    if filter_eps is not None:
        an = [a.norms() for a, _ in group]
        bn = [b.norms() for _, b in group]
    batchable = (algorithm in ("auto",) + BATCHED_ALGORITHMS
                 and kw.get("bcast") != "gather")
    if fused and not batchable:
        raise ValueError(
            f"fused=True requires a batch-capable algorithm "
            f"{BATCHED_ALGORITHMS}, got {algorithm!r}"
            + (" with bcast='gather'" if kw.get("bcast") == "gather"
               else ""))
    plan = None
    fuse = fused
    if fuse is None:
        fuse = batchable and g > 1
        if fuse:
            from ..planner.plan import plan_multiply_batched

            occs = [
                _global_occupancy(
                    a.layout.rows, a.layout.cols, b.layout.cols,
                    a.layout.block_rows, a.layout.block_cols,
                    b.layout.block_cols, a.block_mask, b.block_mask,
                    an[i] if an else None, bn[i] if bn else None,
                    filter_eps)
                for i, (a, b) in enumerate(group)
            ]
            occ = sum(occs) / len(occs)
            occ_max = max(occs)
            plan = plan_multiply_batched(
                g, a0.layout.rows, a0.layout.cols, b0.layout.cols,
                blocks=(a0.layout.block_rows, a0.layout.block_cols,
                        b0.layout.block_cols),
                mesh_shape=a0.grid.grid_shape(mesh), occupancy=occ,
                dtype=a0.data.dtype,
                algorithm=None if algorithm == "auto" else algorithm,
                densify=densify,
                padding_frac=(1.0 - occ / occ_max if occ_max > 0 else 0.0))
            fuse = plan.fuse

    if not fuse:
        out = [multiply(a, b, mesh=mesh, algorithm=algorithm,
                        densify=densify, filter_eps=filter_eps,
                        verify=verify, **kw)
               for a, b in group]
        return out, {"fused": False, "plan": plan}

    from .multiply_batched import _distributed_matmul_batched

    a_masks = [a.block_mask for a, _ in group]
    b_masks = [b.block_mask for _, b in group]
    if all(x is None for x in a_masks):
        a_masks = None
    if all(x is None for x in b_masks):
        b_masks = None
    c_data, bplan = _distributed_matmul_batched(
        torch.stack([a.data for a, _ in group]),
        torch.stack([b.data for _, b in group]),
        mesh=mesh, grid=a0.grid, algorithm=algorithm, densify=densify,
        block_m=a0.layout.block_rows, block_k=a0.layout.block_cols,
        block_n=b0.layout.block_cols,
        a_masks=a_masks, b_masks=b_masks, a_norms=an, b_norms=bn,
        filter_eps=filter_eps, return_plan=True, **kw)
    c_layout = BlockLayout(a0.layout.rows, b0.layout.cols,
                           a0.layout.block_rows, b0.layout.block_cols)
    out = []
    for gi, (a, b) in enumerate(group):
        mask, zero = _product_mask(
            a, b, an[gi] if an else None, bn[gi] if bn else None,
            filter_eps)
        cd = _apply_result_mask(c_data[gi], mask, zero,
                                a.layout.block_rows, b.layout.block_cols)
        c = DBCSRMatrix(cd, c_layout, a.grid, mask)
        c.last_plan = bplan
        out.append(c)
    return out, {"fused": True, "plan": bplan,
                 "executor_stats": bplan.executor_stats}


def multiply_batched(
    requests,
    *,
    mesh,
    algorithm: str = "auto",
    densify: Optional[bool] = None,
    filter_eps: Optional[float] = None,
    fused: Optional[bool] = None,
    verify: Optional[str] = None,
    return_plan: bool = False,
    **kw,
):
    """Many products, one dispatch: ``requests`` is a sequence of
    ``(A, B)`` DBCSRMatrix pairs; returns their products in input order.

    Requests are bucketed by the ``(geometry, occupancy-bin, eps)`` key
    (see ``_bucket_key``) and each bucket runs either FUSED (operands
    stacked ``(G, m, k)``, ONE schedule and ONE fused dispatch for the
    whole bucket, core/multiply_batched.py) or LOOPED (per-request
    ``multiply``), whichever the planner prices cheaper
    (``plan_multiply_batched``: the fixed per-dispatch costs a loop pays
    per request against the fused dispatch's cross-request padding);
    ``fused=True`` / ``False`` pins the choice.

    Semantics match per-request ``multiply`` exactly: per-request product
    masks, eps-retained support and payload zeroing.  At
    ``pipeline_depth=1`` with ``filter_eps`` in {None, 0.0} the fused
    blocked path is bit-identical to the looped one.  Each fused result
    carries its bucket's executed ``BatchedMultiplyPlan`` as
    ``last_plan`` (a looped one its own ``MultiplyPlan``).

    ``verify``: per-request ABFT verification with the semantics of
    ``multiply(verify=...)``; it forces the looped path, so a verified
    bucket trades the fusion win for per-request detection and repair
    (``fused=True`` with ``verify`` raises ``ValueError``).

    ``return_plan=True`` returns ``(results, report)``: per bucket the
    key, request count and indices, the fuse-or-loop decision, ``"plan"``
    (the bucket's ``BatchedMultiplyPlan``; None for a looped bucket the
    planner did not price) and, for a fused bucket, the fused dispatch's
    ``executor_stats`` (padding, plan sharing; None when densified).
    """
    requests = list(requests)
    if not requests:
        return ([], {"n_requests": 0, "n_buckets": 0, "buckets": []}) \
            if return_plan else []
    buckets: dict = {}
    for i, (a, b) in enumerate(requests):
        buckets.setdefault(_bucket_key(a, b, filter_eps), []).append(i)
    results: list = [None] * len(requests)
    bucket_reports = []
    for key, idxs in buckets.items():
        out, rep = _execute_bucket(
            [requests[i] for i in idxs], mesh=mesh, algorithm=algorithm,
            densify=densify, filter_eps=filter_eps, fused=fused,
            verify=verify, **kw)
        for i, c in zip(idxs, out):
            results[i] = c
        if obs.enabled():
            # fuse-or-loop decision accounting (planner or pinned)
            obs.counter("batched.requests_fused" if rep["fused"]
                        else "batched.requests_looped").inc(len(idxs))
            obs.counter("batched.buckets").inc()
        bucket_reports.append({
            "key": key, "n_requests": len(idxs), "request_indices": idxs,
            **rep})
    if not return_plan:
        return results
    report = {
        "n_requests": len(requests),
        "n_buckets": len(buckets),
        "n_fused_requests": sum(r["n_requests"] for r in bucket_reports
                                if r["fused"]),
        "buckets": bucket_reports,
    }
    return results, report
