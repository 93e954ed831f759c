"""Analytic per-algorithm cost models for the multiply planner (a copy
of the JAX package's ``planner/cost_model.py``: the same formulas,
except that a one-rank mesh is charged no communication and no message
latency, which then only orders candidates whose totals tie; the
constants are the H100's own).

The paper's driver layer wins ("up to 2.5x over optimized PDGEMM for
matrices of different sizes and shapes") because it picks the right
decomposition per problem, not because any single kernel is fastest.
The communication-volume models here follow the 2.5D companion paper
(Lazzaro et al., arXiv:1705.10218, section 3) specialised to the four
data-exchange algorithms this repo implements:

  cannon      (m*k + k*n) * e / pg   bytes/device over pg shift steps
  cannon25d   cannon / c shift volume + one C reduction, at the cost of
              c-fold operand replication memory (the classic
              communication-avoiding trade; infeasible when the
              replicas do not fit ``mem_bytes``)
  summa       2*(m*k/pr + k*n/pc)*e  (masked-allreduce panel broadcast
              moves ~2x the optimal bcast volume — the baseline's
              handicap the JAX package's bench_vs_pgemm.py measures)
  ts_*        O(1) in P: one (m, n) partial reduction (ts_k) or one
              operand replication bcast (ts_m / ts_n); per the paper
              the big dimension's operand is assumed already sharded.

Local-path costs:

  densified   full 2*m*k*n flops at the big-GEMM rate (absent blocks
              are stored zeros, so occupancy does NOT discount flops)
              plus the densify/undensify copy.
  blocked     only RETAINED triples dispatch: flops are discounted by
              the triple occupancy, padded up to whole ``stack_tile``
              scan rows (the executor's real dispatch shape), plus a
              per-entry scheduling overhead.  When the operands carry
              block norms and a ``filter_eps`` (repro_torch.sparsity), the
              occupancy the caller passes is the NORM-PREDICTED
              retained-triple fraction (mask-present triples clearing
              the eps norm-product bound, core/multiply.py
              ``_global_occupancy``), not the binary mask fill — the
              on-the-fly filter's savings price into every blocked
              candidate.  Occupancy zero is a contract violation here —
              the caller (plan.py) must short-circuit an empty product
              (mask-empty OR norm-predicted-empty under eps) to a
              trivial plan *before* any candidate is costed (this is
              where the old divide-by-zero lived).

Comm/compute overlap (the schedule engine, core/schedule.py): at
``pipeline_depth >= 2`` the driver issues step t+1's ppermute / panel
broadcast while step t's stacks execute, hiding part of the
communication behind compute.  The model discounts each candidate by

    overlap_s = eff(algorithm) * min(overlappable_comm_s, compute_s)

where ``overlappable_comm_s`` is the algorithm's pipelined comm volume
(all but the un-hideable first/last transfer: Cannon shifts, SUMMA
panel broadcasts, the ts_* operand prefetch) and ``eff`` is the
per-algorithm *measured* overlap efficiency in [0, 1]
(``HardwareModel.overlap_*``, fitted by ``calibrate.measure_overlap``
from depth-1 vs depth-2 timings — this replaces the old ts-only
"prefetchable so latency-light" special case with calibrated data).

Hardware constants live in ``HardwareModel``; the defaults were
measured on an H100 by ``repro_torch.planner.calibrate`` and are
overridden by the calibration file its CLI writes.  Every candidate
evaluation bumps ``N_EVALS`` so tests (and the plan-cache contract) can
prove a cached plan re-evaluates nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = [
    "HardwareModel",
    "Problem",
    "CandidateCost",
    "DEFAULT_HARDWARE",
    "candidate_cost",
    "batched_dispatch_cost",
    "verify_overhead_s",
    "enumerate_candidates",
    "feasible",
    "rebalance_cost_s",
    "matricize_cost_s",
    "overlap_efficiency",
    "algorithm_steps",
    "ts_crossover_ratio",
    "ALGORITHMS",
    "BATCHED_ALGORITHMS",
]

# bumped once per candidate_cost evaluation; the plan cache test
# asserts this stays flat across a cache hit
N_EVALS = 0

ALGORITHMS = ("cannon", "cannon25d", "summa", "ts_k", "ts_m", "ts_n")

# algorithms whose schedules are batch-shape-agnostic and therefore
# eligible for the fused product-batched dispatch
# (core/multiply_batched.py); "summa_gather" (summa with
# bcast="gather") is priced by the model below but only when pinned —
# it never enters the auto enumeration, its sqrt(P)-fold operand
# replication makes it a niche small-K configuration
BATCHED_ALGORITHMS = ("cannon", "summa")


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Calibratable hardware constants (all SI).

    The defaults are ``micro_calibrate``'s values from one run of
    ``python -m repro_torch.planner.calibrate --mesh 4 4`` on an NVIDIA
    H100 80GB HBM3 at a 700.00 W power limit (torch 2.11, CUDA 12.8),
    each the best of five host-clock timings of a
    synchronized call at the main path's sizes:

      flops_per_s         dense-GEMM rate: torch.matmul at 3,960^2 f32
                          (TF32 off), the densified local path
      smm_flops_per_s     blocked-stack rate and ...
      stack_entry_s       ... its per-triple overhead, from two slopes of
                          the blocked local multiply's time over its
                          triples (dense against 20 % A fill) at block
                          22 (3,960^2) and block 64 (4,096^2): two
                          equations, two unknowns
      bytes_per_s         per-rank bytes over the time of one psum on a
                          simulated 4x4 mesh (device copies between
                          ranks that share the card, not NVLink)
      latency_s           marginal time of one tiny psum there
      densify_bytes_per_s bytes of one 3,960^2 f32 matrix over the time
                          of its block-layout copy (``to_blocks``)
      mem_bytes           the card's ``total_memory`` (gates 2.5D and
                          ts_* replication; simulated ranks share it)
      overlap_*           comm/compute overlap in [0, 1] at
                          pipeline_depth 2 against 1 on the simulated
                          4x4 mesh (``measure_overlap``)
      dispatch_s          host time of one tiny multiply on a 1x1 mesh:
                          the fixed price a looped dispatch pays per
                          product and a fused batched dispatch once
    """

    flops_per_s: float = 4.4473e13
    smm_flops_per_s: float = 2.8452e13
    stack_entry_s: float = 1.7308e-10
    bytes_per_s: float = 3.9056e10
    latency_s: float = 9.5562e-4
    densify_bytes_per_s: float = 6.8961e11
    mem_bytes: float = 85017493504.0
    overlap_cannon: float = 0.0
    overlap_cannon25d: float = 0.0
    overlap_summa: float = 0.0
    overlap_ts: float = 0.0
    dispatch_s: float = 2.8104e-4

    def replace(self, **kw) -> "HardwareModel":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HardwareModel":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: float(v) for k, v in d.items() if k in names})


DEFAULT_HARDWARE = HardwareModel()


@dataclasses.dataclass(frozen=True)
class Problem:
    """Static description of one distributed multiply."""

    m: int
    k: int
    n: int
    block_m: int
    block_k: int
    block_n: int
    occupancy: float        # retained-triple fraction of the dense grid
                            # (norm-predicted under a filter_eps)
    itemsize: int           # operand dtype bytes
    pr: int
    pc: int
    c_stack: int = 1        # available 2.5D replication (mesh stack axis)

    @property
    def p2d(self) -> int:
        return self.pr * self.pc

    @property
    def p_all(self) -> int:
        return self.pr * self.pc * self.c_stack


@dataclasses.dataclass(frozen=True)
class CandidateCost:
    """Predicted cost of one (algorithm, local path) candidate."""

    algorithm: str
    densify: bool
    c_repl: int
    feasible: bool
    reason: str             # infeasibility reason ("" when feasible)
    comm_s: float
    compute_s: float
    overhead_s: float       # message latency + densify copies
    overlap_s: float        # comm hidden behind compute (subtracted)
    mem_bytes: float
    total_s: float
    # rank-exact pricing: the per-rank load imbalance (max/mean retained
    # triples) the blocked compute was charged under — 1.0 when the
    # candidate is densified, imbalance-free, or priced by the legacy
    # union model
    imbalance: float = 1.0
    # one rank only: the schedule's data movement the JAX package's
    # formulas charge (comm + message latency - overlap) and the port
    # does not; it orders candidates whose totals tie (0 elsewhere)
    unpriced_s: float = 0.0

    @property
    def label(self) -> str:
        path = "densified" if self.densify else "blocked"
        c = f" c={self.c_repl}" if self.c_repl > 1 else ""
        return f"{self.algorithm}+{path}{c}"


def _infeasible(algorithm: str, densify: bool, c_repl: int,
                reason: str) -> CandidateCost:
    return CandidateCost(algorithm, densify, c_repl, False, reason,
                         math.inf, math.inf, math.inf, 0.0, math.inf,
                         math.inf)


def overlap_efficiency(hw: HardwareModel, algorithm: str) -> float:
    """The calibrated comm/compute overlap efficiency for one
    algorithm family, clamped to [0, 1]."""
    if algorithm.startswith("ts_"):
        eff = hw.overlap_ts
    else:
        eff = getattr(hw, f"overlap_{algorithm}", 0.0)
    return min(max(float(eff), 0.0), 1.0)


def algorithm_steps(prob: Problem, algorithm: str, c_repl: int = 1) -> int:
    """Data-exchange step count of the algorithm's schedule (1 for the
    tall-skinny variants); 0 when the geometry is infeasible.  Used by
    the planner to decide whether a pipeline depth > 1 buys anything."""
    reason, geom = _local_geometry(prob, algorithm, c_repl)
    return 0 if reason is not None else int(geom[3])


def _local_geometry(prob: Problem, algorithm: str,
                    c_repl: int) -> Tuple[Optional[str], tuple]:
    """Per-step local-multiply (ml, kl, nl) and step count for the
    algorithm, or an infeasibility reason."""
    m, k, n = prob.m, prob.k, prob.n
    pr, pc = prob.pr, prob.pc
    if algorithm in ("cannon", "cannon25d"):
        if pr != pc:
            return f"square grid required, got {pr}x{pc}", ()
        pg = pr
        if m % pg or k % pg or n % pg:
            return f"shape not divisible by grid side {pg}", ()
        if algorithm == "cannon25d":
            if c_repl < 2:
                return "no replication axis", ()
            if pg % c_repl:
                return f"grid side {pg} % replication {c_repl} != 0", ()
        steps = pg if algorithm == "cannon" else pg // c_repl
        return None, (m // pg, k // pg, n // pg, steps)
    if algorithm == "summa":
        n_panels = math.lcm(pr, pc)
        if m % pr or n % pc or k % n_panels:
            return (f"shape not divisible by summa grid {pr}x{pc} "
                    f"({n_panels} panels)", ())
        return None, (m // pr, k // n_panels, n // pc, n_panels)
    if algorithm == "summa_gather":
        # summa with bcast="gather" (PUMMA-style): one prologue
        # all-gather, then a SINGLE full-local-K multiply — any grid
        # shape, K never partitioned locally
        if m % pr or n % pc:
            return f"shape not divisible by gather grid {pr}x{pc}", ()
        return None, (m // pr, k, n // pc, 1)
    if algorithm in ("ts_k", "ts_m", "ts_n"):
        p = prob.p_all
        if algorithm == "ts_k":
            # reduce_scatter (the dispatcher's default) also tiles the
            # output's M over all devices
            if k % p or m % p:
                return f"k/m not divisible by {p} devices", ()
            return None, (m, k // p, n, 1)
        if algorithm == "ts_m":
            if m % p:
                return f"m not divisible by {p} devices", ()
            return None, (m // p, k, n, 1)
        if n % p:
            return f"n not divisible by {p} devices", ()
        return None, (m, k, n // p, 1)
    return f"unknown algorithm {algorithm!r}", ()


def _local_step_cost(hw: HardwareModel, prob: Problem, densify: bool,
                     ml: int, kl: int, nl: int,
                     stack_tile: Optional[int],
                     smm_flops_per_s: Optional[float],
                     union_ranks: int = 1,
                     rank_max_occ: Optional[float] = None):
    """(compute_s, overhead_s, reason) of ONE local multiply step.

    ``union_ranks`` models the legacy SPMD union-plan contract
    (core/multiply.py with ``rank_exact=False``): each data-exchange
    step executes the UNION of the present triples of every rank
    sharing the traced program, so the executed occupancy is
    ``1 - (1 - occ)^R`` for R unioned ranks — substantially above the
    global triple fill at moderate sparsity.

    ``rank_max_occ`` switches to rank-exact pricing (core/engine.py
    rank slabs): each rank executes only its own retained triples, and
    a step's wall time is bounded by the BUSIEST rank, so compute is
    charged as ``max_rank(retained_flops)`` — the mean occupancy times
    the measured per-rank imbalance, never union-inflated.
    """
    e = prob.itemsize
    if densify:
        flops = 2.0 * ml * kl * nl
        copy_bytes = (ml * kl + kl * nl + ml * nl) * e
        return (flops / hw.flops_per_s,
                copy_bytes / hw.densify_bytes_per_s, None)
    bm, bk, bn = prob.block_m, prob.block_k, prob.block_n
    if ml % bm or kl % bk or nl % bn:
        return None, None, (f"local ({ml},{kl},{nl}) not divisible by "
                            f"blocks ({bm},{bk},{bn})")
    occ = prob.occupancy
    if occ <= 0.0:
        # the divide-by-zero the trivial-plan short-circuit exists for:
        # an empty product has no blocked cost, the caller must not ask
        raise ValueError(
            "blocked-path cost undefined at zero occupancy; callers must "
            "short-circuit an empty mask product to a trivial plan")
    if rank_max_occ is not None:
        # rank-exact execution: charge the busiest rank's retained fill
        occ = min(max(float(rank_max_occ), 1e-12), 1.0)
    elif occ < 1.0 and union_ranks > 1:
        occ = 1.0 - (1.0 - occ) ** union_ranks
    dense_triples = (ml // bm) * (kl // bk) * (nl // bn)
    present = occ * dense_triples
    # occupancy discounts the blocked path's flops — only present
    # triples dispatch.  pad_plans pads stacks to the LONGEST stack (not
    # to stack_tile), and greedy whole-run packing keeps that waste
    # second-order, so padding is folded into stack_entry_s (the fitted
    # slope of dispatch time over triple count) rather than modelled as
    # whole-tile scans.  ``stack_tile`` still bounds stack count for the
    # latency-free scan (no extra charge).
    rate = smm_flops_per_s or hw.smm_flops_per_s
    flops = present * 2.0 * bm * bk * bn
    return (flops / rate + present * hw.stack_entry_s, 0.0, None)


def candidate_cost(
    hw: HardwareModel,
    prob: Problem,
    algorithm: str,
    densify: bool,
    c_repl: int = 1,
    *,
    stack_tile: Optional[int] = None,
    smm_flops_per_s: Optional[float] = None,
    pipeline_depth: int = 2,
    rank_imbalance: Optional[float] = None,
) -> CandidateCost:
    """Predicted execution cost of one candidate configuration.

    ``stack_tile`` / ``smm_flops_per_s`` let the planner thread the
    occupancy-binned autotune winner (and its recorded throughput) into
    the blocked-path model instead of the global constant.
    ``pipeline_depth`` mirrors the schedule engine's knob: depth >= 2
    applies the calibrated per-algorithm overlap discount to the
    pipelined communication (the driver's default); depth 1 predicts
    the serial loop.  ``rank_imbalance`` (max/mean per-rank retained
    triples, from the caller's mask decomposition) switches the blocked
    compute charge from the legacy union inflation to rank-exact
    max-rank pricing: ``occ * imbalance`` capped at 1.
    """
    global N_EVALS
    N_EVALS += 1
    e = prob.itemsize
    reason, geom = _local_geometry(prob, algorithm, c_repl)
    if reason is not None:
        return _infeasible(algorithm, densify, c_repl, reason)
    ml, kl, nl, steps = geom
    # ranks whose present triples are unioned into one SPMD step plan
    # (core/multiply.py mask slicing): every (replica, i, j) for cannon,
    # the factored row x column unions for summa, all shards for ts_*
    union_ranks = {"cannon": prob.pr * prob.pc,
                   "cannon25d": prob.pr * prob.pc * c_repl,
                   "summa": prob.pr * prob.pc,
                   "summa_gather": prob.pr * prob.pc}.get(algorithm,
                                                         prob.p_all)
    rank_max_occ = None
    imbalance = 1.0
    if rank_imbalance is not None and not densify:
        imbalance = max(float(rank_imbalance), 1.0)
        rank_max_occ = min(prob.occupancy * imbalance, 1.0)
    compute_1, overhead_1, reason = _local_step_cost(
        hw, prob, densify, ml, kl, nl, stack_tile, smm_flops_per_s,
        union_ranks, rank_max_occ)
    if reason is not None:
        return _infeasible(algorithm, densify, c_repl, reason)
    compute_s = steps * compute_1
    overhead_s = steps * overhead_1

    # -- communication volume & message count (bytes per device) ------
    # ``overlappable`` is the slice of comm_bytes the schedule engine's
    # double buffering can hide behind compute: everything except the
    # transfer no compute step runs beside (Cannon's last shift has no
    # next multiply; SUMMA's first broadcast has no previous one;
    # synchronizing reductions depend on the compute and cannot hide)
    if algorithm == "cannon":
        shift_bytes = (ml * kl + kl * nl) * e
        comm_bytes = steps * shift_bytes
        overlappable = (steps - 1) * shift_bytes
        messages = 2 * (steps + 1)          # skew + shifts, A and B
        mem = (ml * kl + kl * nl + ml * nl) * e
    elif algorithm == "cannon25d":
        # per-replica: 1/c of the shifts, plus one partial-C reduction
        # over the stack axis (f32 partials); paper-model accounting
        # charges the c-fold operand replication to memory
        shift_bytes = (ml * kl + kl * nl) * e
        comm_bytes = steps * shift_bytes + 2.0 * ml * nl * 4
        overlappable = (steps - 1) * shift_bytes
        messages = 2 * (steps + 1) + max(c_repl.bit_length() - 1, 1)
        mem = c_repl * (ml * kl + kl * nl) * e + ml * nl * e
    elif algorithm == "summa":
        # masked-allreduce broadcast moves ~2x the optimal panel volume
        panel_bytes = 2.0 * (ml * kl + kl * nl) * e
        comm_bytes = steps * panel_bytes
        overlappable = (steps - 1) * panel_bytes
        messages = 2 * steps
        mem = (prob.m * prob.k + prob.k * prob.n) / prob.p2d * e \
            + ml * nl * e
    elif algorithm == "summa_gather":
        # prologue all-gather: each device receives the rest of its
        # FULL-K row panel of A (over the column axis) and column panel
        # of B (over the row axis), then computes with no further
        # communication.  kl == k here, so the resident gathered panels
        # are a sqrt(P)-fold (pc-fold for A, pr-fold for B) operand
        # replication relative to the 2-D sharded layout — THAT is the
        # memory hazard the mem gate below must price (the old model
        # charged only the sharded operands and let the planner walk
        # into an OOM at scale).
        comm_bytes = (ml * kl * (1.0 - 1.0 / prob.pc)
                      + kl * nl * (1.0 - 1.0 / prob.pr)) * e
        overlappable = 0.0      # prologue: no earlier compute to hide it
        messages = max(prob.pc.bit_length() - 1, 1) \
            + max(prob.pr.bit_length() - 1, 1)
        mem = (ml * kl + kl * nl + ml * nl) * e
    elif algorithm == "ts_k":
        # one reduce_scatter of the (m, n) f32 partial product: O(1) in
        # P — a *synchronizing* collective with a data dependency on the
        # local compute, so it pays message latency and cannot hide;
        # operands reshard from the canonical P(row, col) layout to the
        # K-sharded layout (~1/P of each operand received per device),
        # which IS prefetchable ahead of the dot
        p = prob.p_all
        reshard = (prob.m * prob.k + prob.k * prob.n) * e / p
        comm_bytes = prob.m * prob.n * 4.0 + reshard
        overlappable = reshard
        messages = max(p.bit_length() - 1, 1)
        mem = (ml * kl + kl * nl + ml * nl) * e
    elif algorithm == "ts_m":
        # zero-communication compute once B is replicated; the input
        # movement is the full-B broadcast plus A's reshard (~1/P) —
        # all prefetchable ahead of the single local dot
        p = prob.p_all
        comm_bytes = prob.k * prob.n * e + prob.m * prob.k * e / p
        overlappable = comm_bytes
        messages = 1
        mem = (ml * kl + kl * nl + ml * nl) * e
    else:  # ts_n
        p = prob.p_all
        comm_bytes = prob.m * prob.k * e + prob.k * prob.n * e / p
        overlappable = comm_bytes
        messages = 1
        mem = (ml * kl + kl * nl + ml * nl) * e

    comm_s = comm_bytes / hw.bytes_per_s
    latency_s = messages * hw.latency_s
    # calibrated overlap discount: the ts_* operand prefetch applies at
    # any depth (it is not a loop property); the pipelined-loop overlap
    # of the multi-step algorithms needs the double-buffered driver
    eff = overlap_efficiency(hw, algorithm)
    if not algorithm.startswith("ts_") and (pipeline_depth < 2 or steps < 2):
        eff = 0.0
    overlap_s = eff * min(overlappable / hw.bytes_per_s, compute_s)
    unpriced_s = 0.0
    if prob.p_all == 1:
        # one rank: nothing moves between ranks, so no communication time
        # and no message latency (a departure from the JAX package's
        # formulas, which charge both on a 1x1 mesh too).  Every
        # algorithm is then the same local multiply to the model; what
        # the schedules still do on one rank (skews, shifts and
        # reductions as device copies) is kept as the tie-break
        unpriced_s = comm_s + latency_s - overlap_s
        comm_s = latency_s = overlap_s = 0.0
    overhead_s += latency_s
    total = comm_s + compute_s + overhead_s - overlap_s
    if mem > hw.mem_bytes:
        # geometry works but the replicas/shards don't fit: infeasible,
        # yet the totals stay finite so a caller with NO feasible
        # candidate can still fall back to the least-bad configuration
        return CandidateCost(
            algorithm, densify, c_repl, False,
            f"needs {mem / 1e9:.2f} GB/device > {hw.mem_bytes / 1e9:.2f} GB",
            comm_s, compute_s, overhead_s, overlap_s, mem, total,
            imbalance=imbalance, unpriced_s=unpriced_s)
    return CandidateCost(algorithm, densify, c_repl, True, "",
                         comm_s, compute_s, overhead_s, overlap_s, mem, total,
                         imbalance=imbalance, unpriced_s=unpriced_s)


def batched_dispatch_cost(
    hw: HardwareModel,
    chosen: CandidateCost,
    n_requests: int,
    padding_frac: float = 0.0,
) -> Tuple[float, float]:
    """Predicted ``(fused_s, looped_s)`` for running ``n_requests``
    same-configuration products through ONE fused batched dispatch vs a
    Python loop of single dispatches — the planner's fuse-or-loop
    decision (core/multiply_batched.py + the batching service).

    The looped dispatch pays the per-request fixed costs G times over:
    message latency / densify copies (``overhead_s``) and the host-side
    dispatch price (``dispatch_s`` — shard_map closure build, trace
    lookup, launch).  The fused dispatch moves G times the payload
    through ONE message sequence and ONE launch, so only the
    volume-proportional terms (comm, compute, their overlap) scale with
    G; its penalty is the cross-request padding of the shared stack
    shape (``padding_frac`` — wasted compute rows, see
    ``BatchedExecutorPlan.padding_frac``).  Fusing therefore pays
    exactly when the amortized fixed costs outweigh the padding waste.
    """
    g = max(int(n_requests), 1)
    pf = max(float(padding_frac), 0.0)
    per_request = chosen.comm_s + chosen.compute_s - chosen.overlap_s
    looped_s = g * (per_request + chosen.overhead_s + hw.dispatch_s)
    fused_s = g * (chosen.comm_s + chosen.compute_s * (1.0 + pf)
                   - chosen.overlap_s) + chosen.overhead_s + hw.dispatch_s
    return fused_s, looped_s


def verify_overhead_s(
    hw: HardwareModel,
    m: int,
    k: int,
    n: int,
    block_m: int,
    block_n: int,
    itemsize: int,
    n_ranks: int,
) -> float:
    """Predicted price of ABFT checksum verification of one product
    (``repro_torch.robustness.abft``) — what makes ``verify="auto"`` a
    costed decision like every other planner choice.

    Charged terms, matching what ``verify_product`` executes:

      * the augmented checksum contractions ``S_A @ B`` (block_m x k x n)
        and ``A @ T_B`` (m x k x block_n) at the dense-GEMM rate, plus
        the C row/column reductions (~2*m*n flop-equivalents),
      * one pass over each payload for the operand/result finite
        tripwires and checksum sums, priced as copy bandwidth,
      * the checksum products' cross-device reduction volume
        ``(block_m*n + m*block_n) * e`` plus a handful of collective
        latencies (residuals land on host).

    On ``n_ranks == 1`` the last term is zero: there is no other rank
    to reduce with (like ``candidate_cost``'s one-rank pricing, a
    departure from the JAX package, which charges it on a 1x1 mesh too).

    Relative to the multiply's own 2*m*k*n flops the flop overhead is
    ~(block_m/m + block_n/n): small blocks on big matrices verify for
    a few percent; tiny problems are latency-dominated and ``auto``
    correctly declines them.
    """
    flops = 2.0 * block_m * k * n + 2.0 * m * k * block_n + 2.0 * m * n
    touch_bytes = 2.0 * (m * k + k * n + m * n) * itemsize
    cost = flops / hw.flops_per_s + touch_bytes / hw.densify_bytes_per_s
    if n_ranks > 1:
        comm_bytes = (block_m * n + m * block_n) * itemsize
        cost += comm_bytes / hw.bytes_per_s
        cost += 4.0 * hw.latency_s
    return cost


def feasible(prob: Problem, algorithm: str, densify: bool,
             c_repl: int = 1) -> bool:
    """Divisibility/geometry feasibility only — no cost evaluation (and
    no ``N_EVALS`` bump), usable at zero occupancy for trivial plans."""
    reason, geom = _local_geometry(prob, algorithm, c_repl)
    if reason is not None:
        return False
    if not densify:
        ml, kl, nl = geom[0], geom[1], geom[2]
        if ml % prob.block_m or kl % prob.block_k or nl % prob.block_n:
            return False
    return True


def enumerate_candidates(
    hw: HardwareModel,
    prob: Problem,
    algorithm: Optional[str] = None,
    densify: Optional[bool] = None,
    *,
    stack_tile: Optional[int] = None,
    smm_flops_per_s: Optional[float] = None,
    pipeline_depth: int = 2,
    rank_imbalance: Optional[float] = None,
) -> Tuple[CandidateCost, ...]:
    """Cost every candidate in the (algorithm x local-path x c) space,
    optionally constrained to a forced algorithm / local path."""
    algos = ALGORITHMS if algorithm is None else (algorithm,)
    paths = (True, False) if densify is None else (bool(densify),)
    out = []
    for algo in algos:
        crs = ((prob.c_stack,) if prob.c_stack > 1 else (1,)) \
            if algo == "cannon25d" else (1,)
        for cr in crs:
            for dens in paths:
                out.append(candidate_cost(
                    hw, prob, algo, dens, cr, stack_tile=stack_tile,
                    smm_flops_per_s=smm_flops_per_s,
                    pipeline_depth=pipeline_depth,
                    rank_imbalance=rank_imbalance))
    return tuple(out)


def rebalance_cost_s(hw: HardwareModel, prob: Problem) -> float:
    """Amortized price of the load-balancing permutation pass
    (sparsity/balance.py): one block-row shuffle of A, one block-col
    shuffle of B, and the inverse row+col shuffle of C — four payload
    passes priced at the host copy bandwidth, plus one dispatch."""
    e = prob.itemsize
    passes = (prob.m * prob.k + prob.k * prob.n + 2.0 * prob.m * prob.n) * e
    return passes / hw.densify_bytes_per_s + hw.dispatch_s


def matricize_cost_s(hw: HardwareModel, copy_bytes) -> float:
    """Price of a tensor layout's unfold/refold data movement
    (``tensor.matricize.contraction_layout_stats`` reports the moved
    bytes: one read + one write per non-trivial
    unfold of A, B and refold of C), at the same host copy bandwidth as
    the densify pass.  This is the copy term a
    matricization candidate carries on top of its 2D multiply plan."""
    if copy_bytes <= 0:
        return 0.0
    return float(copy_bytes) / hw.densify_bytes_per_s


def ts_crossover_ratio(hw: Optional[HardwareModel] = None,
                       p_total: int = 16, base: int = 4096,
                       itemsize: int = 4) -> float:
    """Shape ratio at which the tall-skinny algorithm's O(1) volume
    beats Cannon's O(1/sqrt(P)) under the cost model — the planner-owned
    replacement for ``classify_shape``'s historical hardcoded 8.0.

    Scans k/m over [1, 64] for the canonical (base, r*base, base)
    problem on a sqrt(p_total) square grid and returns the first ratio
    where ts_k is predicted cheaper; clamped to [2, 64], falling back
    to the legacy constant when the model never crosses over.
    """
    if hw is None:
        from .calibrate import get_hardware_model  # no cycle: lazy

        hw = get_hardware_model()
    pg = max(int(math.isqrt(p_total)), 1)
    try:
        for r in range(1, 65):
            prob = Problem(base, r * base, base, 64, 64, 64, 1.0,
                           itemsize, pg, pg)
            ts = candidate_cost(hw, prob, "ts_k", True)
            ca = candidate_cost(hw, prob, "cannon", True)
            if ts.feasible and ca.feasible and ts.total_s < ca.total_s:
                return float(min(max(r, 2), 64))
    except Exception:
        pass
    return 8.0  # legacy constant (tall_skinny.DEFAULT_TS_RATIO)
