"""Fused stack executor — dispatch of DBCSR stack plans to the smm kernel.

The paper's Generation/Scheduler phases organise the local block
multiplications into stacks and batch them onto the accelerator
(LIBCUSMM processes whole stacks per kernel launch).  This module is
the single-process half of the JAX package's ``core/engine.py``:

  * all plans are padded into ``(n_stacks, stack_tile, 4)`` masked
    triple tensors, one per stack-size bin (``stacks.pad_plans`` —
    padding rows are ``valid=0`` and point at a scratch C block
    appended past the real blocks),
  * each bin runs as ONE smm kernel launch over its flattened stacks
    (the JAX package runs one ``lax.scan`` step per stack).  This is
    legal because every C block's k-run lies in exactly one stack, so
    the kernel gives each run to one thread block,
  * host-side plan construction is memoized on the geometry and on the
    content fingerprints of masks and norms; the plan also keeps the
    per-bin run starts the kernel needs and, per device, the uploaded
    triples and run starts, so a repeated multiply uploads nothing,
  * when the caller doesn't pin ``stack_size``, it is resolved from the
    H100 winners table (``kernels.smm.autotune.best_params_for``),
  * a batch of same-geometry products fuses its per-group plans into one
    group-offset triple tensor (``BatchedExecutorPlan``) that runs as ONE
    smm launch (``batched_stack_executor``),
  * a multi-rank step whose ranks hold different masks or norms runs
    each rank's own plan (rank-exact), all ranks' triples concatenated
    with rank offsets into ONE smm launch (``RankExecutorPlan``,
    ``rank_stack_executor``).

Sparse planning contract: block occupancy masks (``a_mask`` (nbr, nbk),
``b_mask`` (nbk, nbc) or ``pair_mask`` (nbr, nbk, nbc), host numpy
bool) and block norms with ``filter_eps`` restrict the plan to the
retained triples; operands stay dense with absent blocks zeroed.  A plan
whose product is empty has ``n_stacks == 0`` and ``execute_plan``
returns C unchanged.  The triples are byte-equal to the JAX package's.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from .blocking import BlockLayout
from .densify import from_blocks_batched, kernel_operand, to_blocks_batched
from .stacks import (StackPlan, build_stacks, pad_plans, stack_rank_slab,
                     STACK_SIZE)

__all__ = [
    "BatchedExecutorPlan",
    "ExecutorPlan",
    "RankExecutorPlan",
    "batched_stack_executor",
    "build_batched_executor_plan",
    "build_executor_plan",
    "build_rank_executor_plan",
    "execute_batched_plan",
    "execute_plan",
    "execute_plans_looped",
    "execute_rank_plan",
    "rank_stack_executor",
    "resolve_stack_bins",
    "stack_executor",
]


def _resolve_process(kernel: str):
    """Normalise the two stack processors to one call signature
    ``process(a, b, c, triples, run_starts)``."""
    if kernel == "smm":
        from ..kernels.smm.ops import smm_process_stack

        return smm_process_stack
    if kernel == "ref":
        from ..kernels.smm.ref import smm_process_stack_ref

        def process(a, b, c, t, run_starts=None):
            return smm_process_stack_ref(a, b, c, t)

        return process
    raise ValueError(f"unknown stack kernel {kernel!r}")


@dataclasses.dataclass(frozen=True)
class ExecutorPlan:
    """Static (host-side) description of one fused stack execution.

    ``bin_triples`` holds one padded ``(n_stacks_b, tile_b, 4)`` int32
    tensor of ``(a_idx, b_idx, c_idx, valid)`` rows per stack-length
    bin; dense plans collapse to a single bin.  ``bin_run_starts`` holds,
    per bin, the first row (in the bin's flattened rows) of every C run
    that has a valid row: the smm kernel's grid.  ``plans`` keeps the
    original ragged ``StackPlan``s for statistics and the looped
    dispatch.
    """

    bin_triples: Tuple[np.ndarray, ...]
    bin_run_starts: Tuple[np.ndarray, ...]
    n_c_blocks: int
    block_m: int
    block_k: int
    block_n: int
    nbr: int
    nbk: int
    nbc: int
    plans: Tuple[StackPlan, ...]
    filter_eps: Optional[float] = None
    n_unfiltered_entries: Optional[int] = None
    # device copies of (flattened triples, run starts) per bin, made on
    # first use per device and kept with the memoized plan
    _uploads: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def triples(self) -> np.ndarray:
        """The single-tensor view: every stack padded to the longest,
        ``(n_stacks, stack_tile, 4)`` (the only bin when stack sizes
        are uniform or binning is off)."""
        if len(self.bin_triples) == 1:
            return self.bin_triples[0]
        return pad_plans(list(self.plans))

    def device_bins(self, device: torch.device) -> tuple:
        """Per bin, ``(triples (S, 4) int32, run_starts (R,) int32)`` on
        ``device``, uploaded once per plan and device."""
        key = str(torch.device(device))
        cached = self._uploads.get(key)
        if cached is None:
            cached = tuple(
                (torch.tensor(t.reshape(-1, 4), device=device),
                 torch.tensor(r, device=device))
                for t, r in zip(self.bin_triples, self.bin_run_starts))
            self._uploads[key] = cached
        return cached

    @property
    def n_bins(self) -> int:
        return len(self.bin_triples)

    @property
    def n_launches(self) -> int:
        """smm kernel launches per execution: one per bin with a run."""
        return sum(1 for r in self.bin_run_starts if r.size)

    @property
    def n_stacks(self) -> int:
        return sum(int(t.shape[0]) for t in self.bin_triples)

    @property
    def stack_tile(self) -> int:
        return max(int(t.shape[1]) for t in self.bin_triples)

    @property
    def n_entries(self) -> int:
        return sum(p.size for p in self.plans)

    @property
    def n_padding(self) -> int:
        """Padding rows in the size-binned layout."""
        return sum(int(t.shape[0] * t.shape[1])
                   for t in self.bin_triples) - self.n_entries

    @property
    def n_padding_unbinned(self) -> int:
        """Padding rows if every stack were padded to the longest."""
        return self.n_stacks * self.stack_tile - self.n_entries

    @property
    def n_dense_triples(self) -> int:
        return self.nbr * self.nbk * self.nbc

    @property
    def n_skipped_triples(self) -> int:
        return self.n_dense_triples - self.n_entries

    @property
    def occupancy(self) -> float:
        dense = self.n_dense_triples
        return self.n_entries / dense if dense else 1.0

    @property
    def n_norm_filtered_triples(self) -> int:
        if self.n_unfiltered_entries is None:
            return 0
        return self.n_unfiltered_entries - self.n_entries

    @functools.cached_property
    def _stats(self) -> dict:
        """The plan's statistics, counted once: a plan never changes."""
        from .stacks import stack_statistics

        s = stack_statistics(
            list(self.plans),
            stack_tile=self.stack_tile if self.plans else None)
        s["n_entries"] = self.n_entries
        s["n_dense_triples"] = self.n_dense_triples
        s["n_skipped_triples"] = self.n_skipped_triples
        s["occupancy"] = self.occupancy
        flop_per_entry = 2 * self.block_m * self.block_k * self.block_n
        s["n_bins"] = self.n_bins
        s["n_launches"] = self.n_launches
        s["n_padding"] = self.n_padding
        s["n_padding_unbinned"] = self.n_padding_unbinned
        s["padding_triples_saved"] = self.n_padding_unbinned - self.n_padding
        s["padding_flops_saved"] = s["padding_triples_saved"] * flop_per_entry
        if self.plans:
            padded_total = self.n_entries + self.n_padding
            s["fill"] = self.n_entries / padded_total if padded_total else 1.0
        s["filter_eps"] = self.filter_eps
        if self.n_unfiltered_entries is not None:
            filtered = self.n_norm_filtered_triples
            s["n_unfiltered_triples"] = self.n_unfiltered_entries
            s["n_norm_filtered_triples"] = filtered
            s["norm_filtered_flops"] = filtered * flop_per_entry
            s["norm_retained_fraction"] = (
                self.n_entries / self.n_unfiltered_entries
                if self.n_unfiltered_entries else 1.0)
        return s

    def stats(self) -> dict:
        """A copy of the plan's statistics (scalars), published into the
        registry with telemetry on as every report is."""
        s = dict(self._stats)
        if obs.enabled():
            # publish into the process-wide registry (gated: the
            # disabled path must add zero registry entries)
            obs.counter("executor.stats_reports").inc()
            obs.counter("executor.entries").inc(s["n_entries"])
            obs.counter("executor.padding_triples_saved").inc(
                s["padding_triples_saved"])
            obs.counter("executor.norm_filtered_triples").inc(
                s.get("n_norm_filtered_triples", 0))
            obs.histogram("executor.occupancy").observe(s["occupancy"])
        return s


# Masks and norms are numpy arrays — unhashable, so the plan memo keys
# on a content fingerprint (shape, dtype, sha1(bytes)).  The arrays are
# staged here only for the duration of a build_executor_plan call.
_STAGED_MASKS: dict = {}

# bound on memoized plans (each may hold device copies of its triples)
_PLAN_CACHE_SIZE = 1024


def _array_fingerprint(arr: Optional[np.ndarray], dtype):
    """Fingerprint a private copy of a host array, so callers may mutate
    their masks/norms between multiplies."""
    if arr is None:
        return None
    m = np.array(arr, dtype=dtype, order="C")  # always a fresh copy
    fp = (m.shape, str(m.dtype), hashlib.sha1(m.tobytes()).hexdigest())
    _STAGED_MASKS.setdefault(fp, m)
    return fp


def _mask_fingerprint(mask: Optional[np.ndarray]):
    return _array_fingerprint(mask, bool)


def _norm_fingerprint(norms: Optional[np.ndarray]):
    return _array_fingerprint(norms, np.float32)


# One kernel launch runs per stack-length bin; the bin count is capped
# (``stack_bins=`` / DBCSR_STACK_BINS override the default 4).
_MAX_SIZE_BINS = 4


def resolve_stack_bins(stack_bins: Optional[int] = None) -> int:
    """The executor's size-bin cap: explicit kwarg > DBCSR_STACK_BINS
    env > the default (4).  1 disables binning."""
    if stack_bins is None:
        stack_bins = int(os.environ.get("DBCSR_STACK_BINS", _MAX_SIZE_BINS))
    stack_bins = int(stack_bins)
    if stack_bins < 1:
        raise ValueError(f"stack_bins must be >= 1, got {stack_bins}")
    return stack_bins


def build_executor_plan(
    m: int,
    k: int,
    n: int,
    block_m: int,
    block_k: int,
    block_n: int,
    stack_size: int = STACK_SIZE,
    a_mask: Optional[np.ndarray] = None,
    b_mask: Optional[np.ndarray] = None,
    pair_mask: Optional[np.ndarray] = None,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
    pair_norms: Optional[np.ndarray] = None,
    filter_eps: Optional[float] = None,
    stack_bins: Optional[int] = None,
) -> ExecutorPlan:
    """Generation + Scheduler phases for the local (m, k) x (k, n)
    multiply, memoized on the geometry and the content fingerprints of
    masks and norms.  ``filter_eps`` drops triples whose norm product is
    below eps; None disables filtering, 0.0 equals the mask-only plan.
    """
    eps = None if filter_eps is None else float(filter_eps)
    bins_cap = resolve_stack_bins(stack_bins)
    fps = (_mask_fingerprint(a_mask), _mask_fingerprint(b_mask),
           _mask_fingerprint(pair_mask), _norm_fingerprint(a_norms),
           _norm_fingerprint(b_norms), _norm_fingerprint(pair_norms))
    try:
        return _build_executor_plan_cached(
            m, k, n, block_m, block_k, block_n, stack_size, *fps,
            eps, bins_cap)
    finally:
        for fp in fps:
            if fp is not None:
                _STAGED_MASKS.pop(fp, None)


def _size_binned(plans: List[StackPlan],
                 max_bins: int = _MAX_SIZE_BINS) -> Tuple[np.ndarray, ...]:
    """Group stack plans into <= ``max_bins`` power-of-two length bins
    and pad each bin to its own longest stack.

    Uniform stack sizes (the dense regime) collapse to a single bin.
    Binning never reorders entries within a stack and never splits
    k-runs, and each C block lives in exactly one stack, so cross-bin
    execution order cannot change any result.
    """
    sizes = [p.size for p in plans]
    if len(set(sizes)) <= 1 or max_bins <= 1:
        return (pad_plans(plans),)
    # engage binning only when the single-tile layout wastes >= 25% of
    # its rows on padding
    total_unbinned = len(plans) * max(sizes)
    if 4 * (total_unbinned - sum(sizes)) < total_unbinned:
        return (pad_plans(plans),)
    keys = [max(s, 1).bit_length() for s in sizes]
    shift = 0
    while len(set(k >> shift for k in keys)) > max_bins:
        # halve the log-resolution until the bin count fits the cap
        shift += 1
    keys = [k >> shift for k in keys]
    out = []
    for key in sorted(set(keys)):
        members = [p for p, kk in zip(plans, keys) if kk == key]
        out.append(pad_plans(members))
    return tuple(out)


@functools.lru_cache(maxsize=_PLAN_CACHE_SIZE)
def _build_executor_plan_cached(
    m: int,
    k: int,
    n: int,
    block_m: int,
    block_k: int,
    block_n: int,
    stack_size: int,
    a_fp,
    b_fp,
    pair_fp,
    an_fp,
    bn_fp,
    pn_fp,
    filter_eps: Optional[float],
    stack_bins: int,
) -> ExecutorPlan:
    from ..kernels.smm.ops import stack_run_starts

    a_layout = BlockLayout(m, k, block_m, block_k)
    b_layout = BlockLayout(k, n, block_k, block_n)
    staged = lambda fp: None if fp is None else _STAGED_MASKS[fp]
    a_mask, b_mask, pair_mask = staged(a_fp), staged(b_fp), staged(pair_fp)
    a_norms, b_norms, pair_norms = staged(an_fp), staged(bn_fp), staged(pn_fp)
    filtering = filter_eps is not None and (
        a_norms is not None or b_norms is not None or pair_norms is not None)
    plans = build_stacks(
        a_layout, b_layout, stack_size,
        a_mask=a_mask, b_mask=b_mask, pair_mask=pair_mask,
        a_norms=a_norms, b_norms=b_norms, pair_norms=pair_norms,
        filter_eps=filter_eps)
    if plans:
        bins = _size_binned(plans, stack_bins)
    else:
        # empty mask/filter product: zero stacks, execute_plan is a no-op
        bins = (np.zeros((0, 1, 4), dtype=np.int32),)
    run_starts = tuple(stack_run_starts(t.reshape(-1, 4)) for t in bins)
    for arr in bins + run_starts:
        arr.setflags(write=False)  # memoized => shared; guard against mutation
    n_unfiltered = None
    if filtering:
        if pair_mask is not None:
            n_unfiltered = int(np.count_nonzero(pair_mask))
        else:
            from .stacks import normalize_block_masks

            am, bm = normalize_block_masks(
                a_layout.nblock_rows, a_layout.nblock_cols,
                b_layout.nblock_cols, a_mask, b_mask)
            n_unfiltered = int(
                (am.astype(np.int64) @ bm.astype(np.int64)).sum())
    return ExecutorPlan(
        bin_triples=bins,
        bin_run_starts=run_starts,
        n_c_blocks=a_layout.nblock_rows * b_layout.nblock_cols,
        block_m=block_m,
        block_k=block_k,
        block_n=block_n,
        nbr=a_layout.nblock_rows,
        nbk=a_layout.nblock_cols,
        nbc=b_layout.nblock_cols,
        plans=tuple(plans),
        filter_eps=filter_eps if filtering else None,
        n_unfiltered_entries=n_unfiltered,
    )


def _run_bins(plan: ExecutorPlan, a_blocks: torch.Tensor,
              b_blocks: torch.Tensor, c: torch.Tensor, kernel: str) -> None:
    """Push every bin of ``plan`` through ``kernel``, updating ``c`` in
    place.  ``c`` holds ``n_c_blocks + 1`` blocks: the last is the
    scratch block the padding rows point at (the plain version adds
    their zeroed products there; the kernel never visits them)."""
    process = _resolve_process(kernel)
    # each C block's k-run lives in exactly one stack, so bin order
    # cannot change any accumulation order (fused == looped, bitwise)
    for triples, run_starts in plan.device_bins(c.device):
        process(a_blocks, b_blocks, c, triples, run_starts)


def execute_plan(
    plan: ExecutorPlan,
    a_blocks: torch.Tensor,
    b_blocks: torch.Tensor,
    c_blocks: torch.Tensor,
    *,
    kernel: str = "smm",
) -> torch.Tensor:
    """Run every stack of ``plan`` on ``c_blocks`` (``n_c_blocks``
    blocks): one smm launch per stack-length bin.

    Returns a new tensor: a scratch block is appended for the padding
    rows and stripped from the result.  ``stack_executor`` allocates C
    with its scratch block instead and so copies nothing.  An empty
    plan returns ``c_blocks`` unchanged.
    """
    if plan.n_stacks == 0:
        return c_blocks
    scratch = torch.zeros((1,) + tuple(c_blocks.shape[1:]),
                          dtype=c_blocks.dtype, device=c_blocks.device)
    c = torch.cat([c_blocks, scratch], dim=0)
    _run_bins(plan, a_blocks, b_blocks, c, kernel)
    return c[:-1]


def execute_plans_looped(
    plans: List[StackPlan],
    a_blocks: torch.Tensor,
    b_blocks: torch.Tensor,
    c_blocks: torch.Tensor,
    *,
    kernel: str = "smm",
) -> torch.Tensor:
    """One launch per stack, uploading each stack's triples on every
    call: the baseline the fused ``execute_plan`` is checked against
    (bitwise).  Updates ``c_blocks`` in place and returns it."""
    from ..kernels.smm.ops import stack_run_starts

    process = _resolve_process(kernel)
    for p in plans:
        t = torch.tensor(p.triples, device=c_blocks.device)
        r = torch.tensor(stack_run_starts(p.triples), device=c_blocks.device)
        process(a_blocks, b_blocks, c_blocks, t, r)
    return c_blocks


def _mask_fill(
    nbr: int,
    nbk: int,
    nbc: int,
    a_mask: Optional[np.ndarray],
    b_mask: Optional[np.ndarray],
    pair_mask: Optional[np.ndarray],
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
    pair_norms: Optional[np.ndarray] = None,
    filter_eps: Optional[float] = None,
) -> float:
    """Retained-triple fraction of the dense grid (plan-free: it picks
    the occupancy-binned winners-table entry before the plan exists).
    With norms and a ``filter_eps`` it is the norm-predicted fraction."""
    filtering = filter_eps is not None and (
        a_norms is not None or b_norms is not None or pair_norms is not None)
    size = nbr * nbk * nbc
    if pair_norms is not None and filtering:
        keep = pair_norms.astype(np.float64) >= float(filter_eps)
        if pair_mask is not None:
            keep &= pair_mask
        return float(np.count_nonzero(keep)) / size
    if pair_mask is not None:
        return float(np.count_nonzero(pair_mask)) / size
    if a_mask is None and b_mask is None and not filtering:
        return 1.0
    from .stacks import normalize_block_masks

    am, bm = normalize_block_masks(nbr, nbk, nbc, a_mask, b_mask)
    if filtering:
        from ..sparsity.filter import count_retained_triples

        return count_retained_triples(am, bm, a_norms, b_norms,
                                      filter_eps) / size
    # sum_k (present a blocks in column k) * (present b blocks in row k)
    return float(am.sum(axis=0, dtype=np.int64)
                 @ bm.sum(axis=1, dtype=np.int64)) / size


def stack_executor(
    m: int,
    k: int,
    n: int,
    *,
    block_m: int,
    block_k: int,
    block_n: int,
    stack_size: Optional[int] = None,
    align: Optional[bool] = None,
    kernel: str = "smm",
    a_mask: Optional[np.ndarray] = None,
    b_mask: Optional[np.ndarray] = None,
    pair_mask: Optional[np.ndarray] = None,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
    pair_norms: Optional[np.ndarray] = None,
    filter_eps: Optional[float] = None,
    stack_bins: Optional[int] = None,
    ranges: bool = False,
):
    """Build the fused blocked local multiply ``(a, b) -> c`` (f32).

    ``a`` is ``(m, k)`` or rank-stacked ``(R, m, k)`` (the schedules'
    operands, launch/mesh.py), ``b`` likewise.  Every rank runs the same
    plan: the plan's triples are uploaded once per device, and its bins
    are launched once per rank on that rank's block arrays (views of one
    ``(R, ...)`` tensor), so a step costs ``R * plan.n_launches`` smm
    launches and no copy of the triples.

    ``stack_size`` defaults to the H100 winners table for this block
    geometry and occupancy bin (its heuristic when no sweep has been
    recorded).  ``align`` is kept so the signature matches the JAX
    package's; it is the TPU's MXU-padding knob and is ignored.

    ``ranges`` (the caller's ``obs.ranging()``) marks each call's
    packing of A and B into blocks with C's allocation as
    ``dbcsr.pack``, each rank's launches as ``dbcsr.launch`` and C's
    unpacking as ``dbcsr.unpack``.
    """
    from ..kernels.smm.autotune import best_params_for, has_winners

    fill = 1.0
    if has_winners(block_m, block_k, block_n):
        # the occupancy only picks the table's bin, so it is computed
        # only where the table holds an entry for this block geometry
        fill = _mask_fill(m // block_m, k // block_k, n // block_n,
                          a_mask, b_mask, pair_mask,
                          a_norms, b_norms, pair_norms, filter_eps)
    tuned_align, tuned_tile = best_params_for(block_m, block_k, block_n,
                                              fill=fill)
    if align is None:
        align = tuned_align
    if stack_size is None:
        stack_size = tuned_tile
    plan = build_executor_plan(m, k, n, block_m, block_k, block_n, stack_size,
                               a_mask=a_mask, b_mask=b_mask,
                               pair_mask=pair_mask, a_norms=a_norms,
                               b_norms=b_norms, pair_norms=pair_norms,
                               filter_eps=filter_eps, stack_bins=stack_bins)

    def f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if (tuple(a.shape[-2:]) != (m, k) or tuple(b.shape[-2:]) != (k, n)
                or a.ndim != b.ndim or a.ndim not in (2, 3)
                or a.shape[:-2] != b.shape[:-2]):
            raise ValueError(
                f"stack executor built for ([R,] {m},{k}) x ([R,] {k},{n}), "
                f"got {tuple(a.shape)} x {tuple(b.shape)}")
        one = a.ndim == 2    # one product: a rank axis of one
        if one:
            a, b = a[None], b[None]
        ranks = a.shape[0]
        with obs.maybe_range(ranges, "pack"):
            a_blocks = to_blocks_batched(kernel_operand(a), block_m,
                                         block_k)
            b_blocks = to_blocks_batched(kernel_operand(b), block_k,
                                         block_n)
            # every rank's C with its own scratch block (the padding
            # rows'), zeroed once
            c = torch.zeros((ranks, plan.n_c_blocks + 1, block_m, block_n),
                            dtype=torch.float32, device=a.device)
        if plan.n_stacks:
            for r in range(ranks):
                with obs.maybe_range(ranges, "launch"):
                    _run_bins(plan, a_blocks[r], b_blocks[r], c[r], kernel)
        with obs.maybe_range(ranges, "unpack"):
            out = from_blocks_batched(c[:, :-1], plan.nbr, plan.nbc)
        return out[0] if one else out

    f.executor_plan = plan
    f.align = align
    f.stack_size = stack_size
    return f


# ---------------------------------------------------------------------------
# Product-batched execution: N same-geometry products, one launch
# ---------------------------------------------------------------------------


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class BatchedExecutorPlan:
    """``ExecutorPlan``'s batched variant: one fused stack tensor for a
    *group* of N same-block-geometry products.

    Per-group plans are built through the ordinary memoized
    ``build_executor_plan`` with ``stack_bins=1`` (two requests with
    identical mask/norm content share ONE cached plan: that is the
    cross-request plan sharing ``n_shared_plans`` counts), then padded to
    a shared ``(n_groups, stack_pad, tile_pad)`` shape and fused by
    folding the group index into the block indices: group ``g``'s rows
    are offset by ``(g*n_a_blocks, g*n_b_blocks, g*n_c_blocks)`` and
    EVERY padding row, a group's own stack padding and the cross-group
    shape padding alike, points at the single global scratch block
    ``n_groups * n_c_blocks`` with ``valid=0``.  ``stack_pad`` and
    ``tile_pad`` are rounded up to powers of two.  The triples are
    byte-equal to the JAX package's.

    ``run_starts`` holds the first row (of the flattened triples) of
    every C run that has a valid row: the smm kernel's grid.  Runs made
    only of padding are never launched, so the ~30 % of padding rows a
    dense bucket carries cost upload bytes, not kernel time.
    """

    triples: np.ndarray            # (n_groups*stack_pad, tile_pad, 4) fused
    run_starts: np.ndarray         # (n_runs,) int32
    n_groups: int
    n_a_blocks: int                # per-group block counts
    n_b_blocks: int
    n_c_blocks: int
    block_m: int
    block_k: int
    block_n: int
    group_plans: Tuple[ExecutorPlan, ...]
    n_shared_plans: int            # groups that hit another group's memo entry
    filter_eps: Optional[float] = None
    # device copies of (flattened triples, run starts), made on first use
    # per device and kept with the memoized plan
    _uploads: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def device_triples(self, device: torch.device) -> tuple:
        """``(triples (S*T, 4) int32, run_starts (R,) int32)`` on
        ``device``, uploaded once per plan and device."""
        key = str(torch.device(device))
        cached = self._uploads.get(key)
        if cached is None:
            cached = (torch.tensor(self.triples.reshape(-1, 4), device=device),
                      torch.tensor(self.run_starts, device=device))
            self._uploads[key] = cached
        return cached

    @property
    def scratch_index(self) -> int:
        return self.n_groups * self.n_c_blocks

    @property
    def n_stacks(self) -> int:
        return int(self.triples.shape[0])

    @property
    def stack_tile(self) -> int:
        return int(self.triples.shape[1])

    @property
    def n_launches(self) -> int:
        """smm kernel launches per execution: one, unless no run is valid."""
        return 1 if self.run_starts.size else 0

    @property
    def n_entries(self) -> int:
        return sum(p.n_entries for p in self.group_plans)

    @property
    def n_padding(self) -> int:
        """Padding rows of the fused dispatch: per-group stack padding
        PLUS the cross-group power-of-two shape padding."""
        return self.n_stacks * self.stack_tile - self.n_entries

    @property
    def padding_frac(self) -> float:
        total = self.n_stacks * self.stack_tile
        return self.n_padding / total if total else 0.0

    def stats(self) -> dict:
        """Per-group padding and cross-request fusion accounting."""
        flop_per_entry = 2 * self.block_m * self.block_k * self.block_n
        if obs.enabled():
            obs.counter("executor.batched_stats_reports").inc()
            obs.counter("executor.batched_shared_plans").inc(
                self.n_shared_plans)
            obs.histogram("executor.batched_padding_frac").observe(
                self.padding_frac)
        return {
            "n_groups": self.n_groups,
            "n_shared_plans": self.n_shared_plans,
            "n_entries": self.n_entries,
            "n_stacks": self.n_stacks,
            "stack_tile": self.stack_tile,
            "n_padding": self.n_padding,
            "padding_frac": self.padding_frac,
            "padding_flops": self.n_padding * flop_per_entry,
            "n_launches": self.n_launches,
            "filter_eps": self.filter_eps,
            "per_group": [{"n_entries": p.n_entries, "n_stacks": p.n_stacks,
                           "occupancy": p.occupancy}
                          for p in self.group_plans],
        }


# Fused plans memoized on the identities of their per-group plans (the
# entry holds those plans, so their ids cannot be reused while it lives);
# a repeated bucket then reuses the fused triples and their device upload.
# Small bound: a dense bucket at 1,980^2 / block 22 holds 268 MB of triples.
_BATCHED_PLAN_CACHE_SIZE = 8
_BATCHED_PLANS: "collections.OrderedDict[tuple, BatchedExecutorPlan]" = \
    collections.OrderedDict()


def build_batched_executor_plan(
    m: int,
    k: int,
    n: int,
    block_m: int,
    block_k: int,
    block_n: int,
    group_masks,
    stack_size: int = STACK_SIZE,
    filter_eps: Optional[float] = None,
) -> BatchedExecutorPlan:
    """Fuse one ``ExecutorPlan`` per group into a single group-offset
    stack tensor (see ``BatchedExecutorPlan``).

    ``group_masks`` is a sequence of per-group mask/norm kwargs dicts
    (``a_mask`` / ``b_mask`` / ``pair_mask`` / ``a_norms`` / ``b_norms``
    / ``pair_norms``; an empty dict means a dense group).  Per-group
    plans are built with ``stack_bins=1``: within a batch the shape
    binning happens ACROSS groups (the power-of-two padded fused shape),
    not within one group's stack list.
    """
    group_masks = list(group_masks)
    if not group_masks:
        raise ValueError("batched plan needs at least one group")
    plans = tuple(
        build_executor_plan(m, k, n, block_m, block_k, block_n, stack_size,
                            filter_eps=filter_eps, stack_bins=1, **gm)
        for gm in group_masks)
    key = (tuple(id(p) for p in plans),
           None if filter_eps is None else float(filter_eps))
    hit = _BATCHED_PLANS.get(key)
    if hit is not None:
        _BATCHED_PLANS.move_to_end(key)
        return hit
    plan = _fuse_group_plans(plans, filter_eps)
    _BATCHED_PLANS[key] = plan
    if len(_BATCHED_PLANS) > _BATCHED_PLAN_CACHE_SIZE:
        _BATCHED_PLANS.popitem(last=False)
    return plan


def _fuse_group_plans(plans: Tuple[ExecutorPlan, ...],
                      filter_eps: Optional[float]) -> BatchedExecutorPlan:
    from ..kernels.smm.ops import stack_run_starts

    g_total = len(plans)
    base = plans[0]
    n_a = base.nbr * base.nbk
    n_b = base.nbk * base.nbc
    n_c = base.n_c_blocks
    n_shared = g_total - len({id(p) for p in plans})
    views = [p.bin_triples[0] for p in plans]  # stack_bins=1: one bin
    s_max = max(v.shape[0] for v in views)
    t_max = max(v.shape[1] for v in views)
    if s_max == 0:
        fused = np.zeros((0, 1, 4), dtype=np.int32)
    else:
        s_pad, t_pad = _next_pow2(s_max), _next_pow2(t_max)
        scratch = g_total * n_c
        fused = np.zeros((g_total, s_pad, t_pad, 4), dtype=np.int32)
        fused[..., 2] = scratch
        for g, v in enumerate(views):
            s, t = int(v.shape[0]), int(v.shape[1])
            if not s:
                continue
            valid = v[:, :, 3] != 0
            sub = fused[g, :s, :t]
            sub[:, :, 0] = np.where(valid, v[:, :, 0] + g * n_a, 0)
            sub[:, :, 1] = np.where(valid, v[:, :, 1] + g * n_b, 0)
            sub[:, :, 2] = np.where(valid, v[:, :, 2] + g * n_c, scratch)
            sub[:, :, 3] = v[:, :, 3]
        fused = fused.reshape(g_total * s_pad, t_pad, 4)
    run_starts = stack_run_starts(fused.reshape(-1, 4))
    fused.setflags(write=False)
    run_starts.setflags(write=False)
    return BatchedExecutorPlan(
        triples=fused,
        run_starts=run_starts,
        n_groups=g_total,
        n_a_blocks=n_a,
        n_b_blocks=n_b,
        n_c_blocks=n_c,
        block_m=base.block_m,
        block_k=base.block_k,
        block_n=base.block_n,
        group_plans=plans,
        n_shared_plans=n_shared,
        filter_eps=filter_eps,
    )


def _run_fused(plan: BatchedExecutorPlan, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, kernel: str) -> None:
    """One launch of the fused triples on the flattened block arrays;
    ``c`` holds ``n_groups * n_c_blocks + 1`` blocks, the last the
    scratch block, and is updated in place."""
    from ..kernels.grouped_gemm.ops import grouped_process_stack

    triples, run_starts = plan.device_triples(c.device)
    grouped_process_stack(a, b, c, triples, run_starts, kernel=kernel)


def execute_batched_plan(
    plan: BatchedExecutorPlan,
    a_blocks: torch.Tensor,   # (n_groups, n_a_blocks, bm, bk)
    b_blocks: torch.Tensor,   # (n_groups, n_b_blocks, bk, bn)
    c_blocks: torch.Tensor,   # (n_groups, n_c_blocks, bm, bn)
    *,
    kernel: str = "smm",
    align: bool = False,
) -> torch.Tensor:
    """Run every group's stacks in ONE smm launch and return the
    accumulated ``(n_groups, n_c_blocks, bm, bn)`` C blocks (a new
    tensor: the scratch block is appended and stripped;
    ``batched_stack_executor`` allocates C with it instead).  ``align``
    is the TPU's MXU-padding knob and is ignored.

    Bit-identity with the per-group ``execute_plan`` loop: each C
    block's k-run lives in exactly one stack of exactly one group, group
    offsetting never reorders entries within a stack, and padding rows
    only touch the global scratch block, so the per-block accumulation
    order is identical to the looped dispatch.
    """
    if plan.n_stacks == 0:
        return c_blocks
    g = plan.n_groups
    bm, bn = int(c_blocks.shape[-2]), int(c_blocks.shape[-1])
    a = a_blocks.reshape((g * plan.n_a_blocks,) + tuple(a_blocks.shape[-2:]))
    b = b_blocks.reshape((g * plan.n_b_blocks,) + tuple(b_blocks.shape[-2:]))
    c = c_blocks.reshape((g * plan.n_c_blocks, bm, bn))
    scratch = torch.zeros((1, bm, bn), dtype=c.dtype, device=c.device)
    c = torch.cat([c, scratch], dim=0)
    _run_fused(plan, a.contiguous(), b.contiguous(), c, kernel)
    return c[:-1].reshape((g, plan.n_c_blocks, bm, bn))


def batched_stack_executor(
    n_groups: int,
    m: int,
    k: int,
    n: int,
    *,
    block_m: int,
    block_k: int,
    block_n: int,
    stack_size: Optional[int] = None,
    align: Optional[bool] = None,
    kernel: str = "smm",
    group_masks=None,
    filter_eps: Optional[float] = None,
):
    """Build the fused batched blocked local multiply
    ``((G, m, k), (G, k, n)) -> (G, m, n)`` (f32), or the same with a
    leading rank axis ``(R, G, m, k)``: the fused plan then runs once
    per rank, ``R`` smm launches (see ``stack_executor``).

    The batched twin of ``stack_executor``: stack parameters are resolved
    ONCE per batch from the mean group fill (requests in one bucket share
    them by contract), the per-group plans go through the shared engine
    memo, and the whole batch runs as one smm launch.  Stack splitting
    never changes a block's accumulation order (runs are never split),
    so differing stack parameters between this and a looped oracle
    cannot break bit-identity.
    """
    from ..kernels.smm.autotune import best_params_for, has_winners

    if group_masks is None:
        group_masks = [{}] * n_groups
    group_masks = list(group_masks)
    if len(group_masks) != n_groups:
        raise ValueError(
            f"{len(group_masks)} mask groups for {n_groups} groups")
    nbr, nbk, nbc = m // block_m, k // block_k, n // block_n
    fill = 1.0
    if has_winners(block_m, block_k, block_n):
        # the occupancy only picks the table's bin (see stack_executor)
        fills = [
            _mask_fill(nbr, nbk, nbc,
                       gm.get("a_mask"), gm.get("b_mask"), gm.get("pair_mask"),
                       gm.get("a_norms"), gm.get("b_norms"),
                       gm.get("pair_norms"), filter_eps)
            for gm in group_masks
        ]
        fill = sum(fills) / len(fills)
    tuned_align, tuned_tile = best_params_for(block_m, block_k, block_n,
                                              fill=fill)
    if align is None:
        align = tuned_align
    if stack_size is None:
        stack_size = tuned_tile
    plan = build_batched_executor_plan(
        m, k, n, block_m, block_k, block_n, group_masks,
        stack_size=stack_size, filter_eps=filter_eps)

    def f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if (tuple(a.shape[-3:]) != (n_groups, m, k)
                or tuple(b.shape[-3:]) != (n_groups, k, n)
                or a.ndim != b.ndim or a.ndim not in (3, 4)
                or a.shape[:-3] != b.shape[:-3]):
            raise ValueError(
                f"batched executor built for ([R,] {n_groups},{m},{k}) x "
                f"([R,] {n_groups},{k},{n}), got {tuple(a.shape)} x "
                f"{tuple(b.shape)}")
        lead = tuple(a.shape[:-3])
        ranks = a.shape[0] if lead else 1
        a, b = kernel_operand(a), kernel_operand(b)
        a_blocks = to_blocks_batched(a.reshape(-1, m, k), block_m,
                                     block_k).reshape(
            ranks, n_groups * nbr * nbk, block_m, block_k)
        b_blocks = to_blocks_batched(b.reshape(-1, k, n), block_k,
                                     block_n).reshape(
            ranks, n_groups * nbk * nbc, block_k, block_n)
        # every group's C with the padding rows' scratch block appended,
        # one such array a rank
        c = torch.zeros((ranks, n_groups * nbr * nbc + 1, block_m, block_n),
                        dtype=torch.float32, device=a.device)
        if plan.n_stacks:
            for r in range(ranks):
                _run_fused(plan, a_blocks[r], b_blocks[r], c[r], kernel)
        out = from_blocks_batched(
            c[:, :-1].reshape(ranks * n_groups, nbr * nbc, block_m, block_n),
            nbr, nbc)
        return out.reshape(lead + (n_groups, m, n))

    f.batched_plan = plan
    f.align = align
    f.stack_size = stack_size
    f.n_groups = n_groups
    return f


# ---------------------------------------------------------------------------
# Rank-exact execution: every rank's own plan, all ranks in one launch
# ---------------------------------------------------------------------------

# Largest value an int32 triple index or row count may take.
_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class RankExecutorPlan:
    """Per-rank plans for one step of a multi-rank local multiply.

    ``rank_plans`` holds one memoized ``ExecutorPlan`` per rank of the
    step builder's flat order (cannon ``i*pg + j``; cannon25d and
    stacked tall-skinny ``(s*pr + i)*pc + j``; summa and flat
    tall-skinny ``i*pc + j``).  A rank executes only its own mask/norm
    retained triples, never the union over ranks.

    The JAX package runs one traced program on every rank and so pads
    every rank's plan to the busiest rank's shape: the ``(R, S, T, 4)``
    ``slab`` (``stacks.stack_rank_slab``).  The port keeps the slab for
    its statistics and builds it only when asked (at 16 ranks of 3,960^2
    in blocks of 22 it is ~300 MB a step).  It executes instead
    ``triples``: every rank of the mesh's leading rank axis
    (``rank_order[r]`` names the plan rank ``r`` runs) with its triples
    offset by ``(r*n_a, r*n_b, r*n_c)`` into the flattened rank-stacked
    block arrays, concatenated without padding.  Every rank's C blocks
    are its own and no run is split or reordered, so ONE smm launch over
    all ranks gives each C element the sums it gets when each rank runs
    its plan alone.  On a process mesh (launch/mesh.py) the leading
    rank axis is the process's own rank, ``rank_order`` has that one
    entry and ``triples`` only its rows; every rank's plan is still
    built (each process plans the whole step), so the statistics below
    are the mesh's on every process.

    The statistics follow the JAX package: ``n_entries`` is the BUSIEST
    rank's retained triples (the step's wall-time bound),
    ``rank_entries`` every rank's, ``rank_imbalance`` max/mean.
    """

    rank_plans: Tuple[ExecutorPlan, ...]
    rank_order: Tuple[int, ...]
    triples: np.ndarray            # (rows, 4) int32, every leading rank
    run_starts: np.ndarray         # (n_runs,) int32
    n_c_blocks: int
    block_m: int
    block_k: int
    block_n: int
    nbr: int
    nbk: int
    nbc: int
    filter_eps: Optional[float] = None
    # device copies of (triples, run starts) per device
    _uploads: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def device_triples(self, device: torch.device) -> tuple:
        """``(triples (rows, 4) int32, run_starts (n_runs,) int32)`` on
        ``device``, uploaded once per plan and device."""
        key = str(torch.device(device))
        cached = self._uploads.get(key)
        if cached is None:
            cached = (torch.tensor(self.triples, device=device),
                      torch.tensor(self.run_starts, device=device))
            self._uploads[key] = cached
        return cached

    @functools.cached_property
    def slab(self) -> np.ndarray:
        """The JAX package's ``(R, S, T, 4)`` per-rank slab, byte for
        byte (built on first use)."""
        slab = stack_rank_slab([p.triples for p in self.rank_plans],
                               self.n_c_blocks)
        slab.setflags(write=False)
        return slab

    @property
    def n_ranks(self) -> int:
        return len(self.rank_plans)

    @property
    def n_stacks(self) -> int:
        return max(int(p.triples.shape[0]) for p in self.rank_plans)

    @property
    def stack_tile(self) -> int:
        return max(max((int(p.triples.shape[1]) for p in self.rank_plans
                        if p.triples.shape[0]), default=1), 1)

    @property
    def n_launches(self) -> int:
        """smm kernel launches per execution: one over all ranks, unless
        no rank has a triple (the mesh's view, also where ``rank_order``
        holds only a process's own rank)."""
        return 1 if any(p.n_entries for p in self.rank_plans) else 0

    @property
    def rank_entries(self) -> Tuple[int, ...]:
        """Retained (non-padding) triples each rank executes."""
        return tuple(p.n_entries for p in self.rank_plans)

    @property
    def n_entries(self) -> int:
        """Busiest rank's retained triples (the wall-time bound)."""
        return max(self.rank_entries, default=0)

    @property
    def n_entries_mean(self) -> float:
        e = self.rank_entries
        return float(np.mean(e)) if e else 0.0

    @property
    def rank_imbalance(self) -> float:
        """max/mean retained triples over ranks (1.0 = balanced)."""
        mean = self.n_entries_mean
        return float(self.n_entries) / mean if mean > 0 else 1.0

    @property
    def n_dense_triples(self) -> int:
        return self.nbr * self.nbk * self.nbc

    @property
    def n_skipped_triples(self) -> int:
        return self.n_dense_triples - self.n_entries

    @property
    def occupancy(self) -> float:
        """Busiest rank's fraction of the dense local triple grid."""
        dense = self.n_dense_triples
        return self.n_entries / dense if dense else 1.0

    @property
    def n_padding(self) -> int:
        """Padding rows of the busiest rank's slab slice."""
        return self.n_stacks * self.stack_tile - self.n_entries

    @property
    def n_padding_unbinned(self) -> int:
        return self.n_padding

    @property
    def n_unfiltered_entries(self) -> Optional[int]:
        vals = [p.n_unfiltered_entries for p in self.rank_plans]
        if any(v is not None for v in vals):
            return max(v if v is not None else p.n_entries
                       for v, p in zip(vals, self.rank_plans))
        return None

    @property
    def n_norm_filtered_triples(self) -> int:
        return max((p.n_norm_filtered_triples for p in self.rank_plans),
                   default=0)

    @property
    def uniform(self) -> bool:
        """True when every rank's slab slice is content-identical: the
        dense / uniform-fill regime where rank-exact execution is the
        union plan."""
        return bool((self.slab == self.slab[:1]).all())

    def stats(self) -> dict:
        if obs.enabled():
            obs.histogram("executor.rank_imbalance").observe(
                self.rank_imbalance)
        return {
            "n_ranks": self.n_ranks,
            "n_stacks": self.n_stacks,
            "stack_tile": self.stack_tile,
            "n_entries": self.n_entries,
            "rank_entries": list(self.rank_entries),
            "rank_entries_mean": self.n_entries_mean,
            "rank_imbalance": self.rank_imbalance,
            "n_dense_triples": self.n_dense_triples,
            "occupancy": self.occupancy,
            "n_padding": self.n_padding,
            "n_launches": self.n_launches,
            "n_norm_filtered_triples": self.n_norm_filtered_triples,
            "filter_eps": self.filter_eps,
        }


# Concatenated plans memoized on the identities of their per-rank plans
# and the rank order (the entry holds the plans, so their ids cannot be
# reused while it lives); a repeated multiply reuses the triples and
# their device upload.  Small bound: a step of 16 ranks at 3,960^2 in
# blocks of 22 and 20 % fill holds ~300 MB of triples.
_RANK_PLAN_CACHE_SIZE = 16
_RANK_PLANS: "collections.OrderedDict[tuple, RankExecutorPlan]" = \
    collections.OrderedDict()


def build_rank_executor_plan(
    m: int,
    k: int,
    n: int,
    *,
    block_m: int,
    block_k: int,
    block_n: int,
    rank_masks,
    stack_size: int = STACK_SIZE,
    filter_eps: Optional[float] = None,
    rank_order=None,
) -> RankExecutorPlan:
    """Build one plan per rank (memoized individually: identical ranks
    share one cached ``ExecutorPlan``) and concatenate them in the
    mesh's rank order.

    ``rank_masks`` is a sequence of per-rank mask/norm kwarg dicts
    (``a_mask``/``b_mask``/``pair_mask``/``a_norms``/``b_norms``/
    ``pair_norms``) on the LOCAL geometry, in the step builder's flat
    rank order.  ``rank_order[r]`` is the builder index of the mesh's
    leading rank ``r`` (default: the identity).  Per-rank plans are
    built with ``stack_bins=1``, as the JAX package builds them for its
    slab; the concatenation has no padding to bin.  Raises when a block
    index or row count of the concatenation exceeds int32.
    """
    rank_masks = list(rank_masks)
    if not rank_masks:
        raise ValueError("rank plan needs at least one rank")
    plans = tuple(
        build_executor_plan(m, k, n, block_m, block_k, block_n, stack_size,
                            filter_eps=filter_eps, stack_bins=1, **rm)
        for rm in rank_masks)
    order = (tuple(range(len(plans))) if rank_order is None
             else tuple(int(r) for r in rank_order))
    if not order or min(order) < 0 or max(order) >= len(plans):
        raise ValueError(f"rank order {order} does not index "
                         f"{len(plans)} rank plans")
    eps = None if filter_eps is None else float(filter_eps)
    key = (tuple(id(p) for p in plans), order, eps)
    hit = _RANK_PLANS.get(key)
    if hit is not None:
        _RANK_PLANS.move_to_end(key)
        return hit
    plan = _concat_rank_plans(plans, order, eps)
    _RANK_PLANS[key] = plan
    if len(_RANK_PLANS) > _RANK_PLAN_CACHE_SIZE:
        _RANK_PLANS.popitem(last=False)
    return plan


def _concat_rank_plans(plans: Tuple[ExecutorPlan, ...],
                       order: Tuple[int, ...],
                       filter_eps: Optional[float]) -> RankExecutorPlan:
    from ..kernels.smm.ops import stack_run_starts

    base = plans[0]
    n_a, n_b, n_c = base.nbr * base.nbk, base.nbk * base.nbc, base.n_c_blocks
    ranks = len(order)
    rows = {q: (np.concatenate([s.triples for s in plans[q].plans])
                if plans[q].plans else np.zeros((0, 3), dtype=np.int32))
            for q in set(order)}
    total = sum(rows[q].shape[0] for q in order)
    if ranks * max(n_a, n_b, n_c) > _INT32_MAX or total > _INT32_MAX - 32:
        raise ValueError(
            f"{ranks} ranks of {max(n_a, n_b, n_c)} blocks and {total} "
            "triples overflow the smm kernel's int32 indices")
    triples = np.empty((total, 4), dtype=np.int32)
    triples[:, 3] = 1
    offset = np.array([n_a, n_b, n_c], dtype=np.int32)
    at = 0
    for r, q in enumerate(order):
        t = rows[q]
        triples[at:at + t.shape[0], :3] = t + r * offset
        at += t.shape[0]
    run_starts = stack_run_starts(triples)
    triples.setflags(write=False)
    run_starts.setflags(write=False)
    return RankExecutorPlan(
        rank_plans=plans,
        rank_order=order,
        triples=triples,
        run_starts=run_starts,
        n_c_blocks=n_c,
        block_m=base.block_m,
        block_k=base.block_k,
        block_n=base.block_n,
        nbr=base.nbr,
        nbk=base.nbk,
        nbc=base.nbc,
        filter_eps=filter_eps,
    )


def execute_rank_plan(
    plan: RankExecutorPlan,
    a_blocks: torch.Tensor,   # (R, n_a, bm, bk), R = len(plan.rank_order)
    b_blocks: torch.Tensor,   # (R, n_b, bk, bn)
    c_blocks: torch.Tensor,   # (R, n_c, bm, bn) float32, updated in place
    *,
    kernel: str = "smm",
) -> torch.Tensor:
    """``execute_plan``'s rank-exact twin: every rank's own triples in
    ONE launch on the flattened rank-stacked block arrays.  Updates
    ``c_blocks`` in place and returns it; a plan without a triple
    returns it untouched."""
    ranks = len(plan.rank_order)
    if a_blocks.shape[0] != ranks or b_blocks.shape[0] != ranks \
            or c_blocks.shape[0] != ranks:
        raise ValueError(
            f"rank plan for {ranks} ranks, got blocks of "
            f"{tuple(a_blocks.shape)}, {tuple(b_blocks.shape)}, "
            f"{tuple(c_blocks.shape)}")
    if not plan.run_starts.size:
        return c_blocks
    process = _resolve_process(kernel)
    triples, run_starts = plan.device_triples(c_blocks.device)
    process(a_blocks.reshape((-1,) + tuple(a_blocks.shape[2:])),
            b_blocks.reshape((-1,) + tuple(b_blocks.shape[2:])),
            c_blocks.view((-1,) + tuple(c_blocks.shape[2:])),
            triples, run_starts)
    return c_blocks


def rank_stack_executor(
    m: int,
    k: int,
    n: int,
    *,
    block_m: int,
    block_k: int,
    block_n: int,
    rank_masks,
    rank_order=None,
    stack_size: Optional[int] = None,
    align: Optional[bool] = None,
    kernel: str = "smm",
    filter_eps: Optional[float] = None,
    stack_bins: Optional[int] = None,
    ranges: bool = False,
):
    """``stack_executor``'s rank-exact twin: the local multiply of one
    schedule step on rank-stacked ``(R, m, k)`` x ``(R, k, n)``
    operands, rank ``r`` running plan ``rank_order[r]`` of
    ``rank_masks``, all ranks in one smm launch (``RankExecutorPlan``).

    ``stack_size`` / ``align`` default to the winners table at the
    BUSIEST rank's fill, so every rank runs the same tuned tile.
    ``stack_bins`` is accepted for signature parity: the concatenation
    carries no padding, so it is one launch whatever the bins.
    ``ranges`` marks pack / launch / unpack as ``stack_executor``'s do.
    """
    from ..kernels.smm.autotune import best_params_for, has_winners

    rank_masks = list(rank_masks)
    fill = 1.0
    if has_winners(block_m, block_k, block_n):
        # the occupancy only picks the table's bin (see stack_executor)
        fill = max(
            _mask_fill(m // block_m, k // block_k, n // block_n,
                       rm.get("a_mask"), rm.get("b_mask"),
                       rm.get("pair_mask"), rm.get("a_norms"),
                       rm.get("b_norms"), rm.get("pair_norms"), filter_eps)
            for rm in rank_masks)
    tuned_align, tuned_tile = best_params_for(block_m, block_k, block_n,
                                              fill=fill)
    if align is None:
        align = tuned_align
    if stack_size is None:
        stack_size = tuned_tile
    plan = build_rank_executor_plan(
        m, k, n, block_m=block_m, block_k=block_k, block_n=block_n,
        rank_masks=rank_masks, stack_size=stack_size,
        filter_eps=filter_eps, rank_order=rank_order)
    ranks = len(plan.rank_order)

    def f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if (tuple(a.shape) != (ranks, m, k)
                or tuple(b.shape) != (ranks, k, n)):
            raise ValueError(
                f"rank stack executor built for ({ranks},{m},{k}) x "
                f"({ranks},{k},{n}), got {tuple(a.shape)} x "
                f"{tuple(b.shape)}")
        with obs.maybe_range(ranges, "pack"):
            a_blocks = to_blocks_batched(kernel_operand(a), block_m,
                                         block_k)
            b_blocks = to_blocks_batched(kernel_operand(b), block_k,
                                         block_n)
            c = torch.zeros((ranks, plan.n_c_blocks, block_m, block_n),
                            dtype=torch.float32, device=a.device)
        with obs.maybe_range(ranges, "launch"):
            execute_rank_plan(plan, a_blocks, b_blocks, c, kernel=kernel)
        with obs.maybe_range(ranges, "unpack"):
            return from_blocks_batched(c, plan.nbr, plan.nbc)

    f.executor_plan = plan
    f.rank_plan = plan
    f.align = align
    f.stack_size = stack_size
    return f
