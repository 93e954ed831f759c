"""Huang–Abraham-style block checksums for block-sparse products (ABFT).

The classical ABFT construction augments A with a column-sum checksum
row and B with a row-sum checksum column; the product of the augmented
matrices then carries checksum rows/columns that verify C.  The port
keeps the block-granular version of exactly that invariant (the JAX
package's ``robustness/abft.py``), computed on an *independent*
arithmetic path from the multiply itself — plain ``torch.matmul`` on
the operands' device, never the hand-written smm / GEMM kernels — so a
kernel fault or an in-flight soft error shows up as a checksum residual:

  column checksums (localize the block COLUMN):
      S_A = sum_i A[i-th block row]          (block_m, k)
      sum_i C[i-th block row]  ==  S_A @ B   (block_m, n)

  row checksums (localize the block ROW):
      T_B = sum_j B[j-th block col]          (k, block_n)
      sum_j C[j-th block col]  ==  A @ T_B   (m, block_n)

A corrupted block (i, j) perturbs block row i of the row residual and
block column j of the column residual; the intersection localizes it
exactly (for multi-block corruption the cross product is a superset,
which is safe for repair — splicing a clean block over a clean block is
the identity).

The checksum products run in IEEE f32 (f64 for f64 operands) whatever
the caller's TF32 / ``set_float32_matmul_precision`` setting: under
TF32 the 1e-5 x bound tolerance below would flag clean products.

**Norm-aware tolerance.**  Checksums compare two float accumulations
with different orders, and the eps-filtered blocked path deliberately
drops sub-eps triples from C that the checksum reference still
contains.  The detection threshold therefore scales with the norm
cache:

    tol = atol + rtol * sum ||A_ik||_F * ||B_kj||_F          (roundoff)
               + sum_{dropped triples} ||A_ik||_F * ||B_kj||_F  (eps)

summed over the block row/column being tested.  NaN residuals are
flagged via ``~(res <= tol)`` so NaN never slips through a comparison.
``_dropped_mass`` and ``verification_tolerances`` are host numpy,
byte-equal to the JAX package's.

**Repair.**  The multiply pipeline is deterministic at a fixed config,
so a transient fault is repaired by re-running the same closure once
and splicing only the flagged blocks — the result is bitwise equal to a
clean run.  If the recheck still fails, the fault is persistent and
:class:`~repro_torch.robustness.guards.CorruptionDetectedError` is
raised.

Scope: checksums verify that C is consistent with the *given* A and B;
corrupted inputs are the domain of ``guards``' tripwires.  With
telemetry on (``obs.enable()``) verification publishes the
``abft.verifications`` / ``abft.detections`` and ``abft.repairs`` /
``abft.repair_failures`` counters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import obs
from . import guards
from ..core.precision import float32_matmul
from ..sparsity.norms import block_norms_of, normalize_block_norms

__all__ = [
    "DEFAULT_RTOL",
    "VerificationReport",
    "checksum_residuals",
    "verification_tolerances",
    "verify_product",
    "splice_blocks",
    "verify_and_repair",
]

# Margin over float32 accumulation roundoff relative to the (loose)
# norm-product bound: far above honest roundoff, far below any
# exponent-level corruption.
DEFAULT_RTOL = 1e-5

# Exact dropped-mass accounting builds an (nbr, nbk, nbc) tensor; above
# this entry count fall back to the conservative per-block bound
# nbk * eps (every dropped triple is < eps by definition).
_EXACT_DROP_LIMIT = 64_000_000


@dataclasses.dataclass(frozen=True)
class VerificationReport:
    """Outcome of one ABFT verification (and optional repair) pass."""

    detected: bool
    flagged_rows: Tuple[int, ...]
    flagged_cols: Tuple[int, ...]
    flagged_blocks: Tuple[Tuple[int, int], ...]
    row_residual: np.ndarray
    col_residual: np.ndarray
    row_tol: np.ndarray
    col_tol: np.ndarray
    repair_attempted: bool = False
    repaired: bool = False
    n_recomputed_blocks: int = 0


def checksum_residuals(a, b, c, block_m: int,
                       block_n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host numpy ``(row_residual (nbr,), col_residual (nbc,))``: per
    block row / block column, the max-abs discrepancy between C's
    checksums and the independently contracted references, reduced on
    the operands' device."""
    a, b, c = (torch.as_tensor(x) for x in (a, b, c))
    dt = (torch.float64 if torch.float64 in (a.dtype, b.dtype, c.dtype)
          else torch.float32)
    a = a.to(dt)
    b, c = b.to(a.device, dt), c.to(a.device, dt)
    m, k = a.shape
    n = b.shape[1]
    nbr, nbc = m // block_m, n // block_n
    with float32_matmul("highest"):
        # column checksums: sum of C's block rows vs S_A @ B
        s_a = a.reshape(nbr, block_m, k).sum(dim=0)
        col_ref = s_a @ b
        col_sum = c.reshape(nbr, block_m, n).sum(dim=0)
        d_col = (col_sum - col_ref).abs().reshape(block_m, nbc, block_n)
        col_res = d_col.amax(dim=(0, 2))
        # row checksums: sum of C's block columns vs A @ T_B
        t_b = b.reshape(k, nbc, block_n).sum(dim=1)
        row_ref = a @ t_b
        row_sum = c.reshape(m, nbc, block_n).sum(dim=1)
        d_row = (row_sum - row_ref).abs().reshape(nbr, block_m, block_n)
        row_res = d_row.amax(dim=(1, 2))
    return (row_res.cpu().numpy().astype(np.float64),
            col_res.cpu().numpy().astype(np.float64))


def _dropped_mass(an: np.ndarray, bn: np.ndarray,
                  filter_eps: Optional[float]) -> np.ndarray:
    """(nbr, nbc) norm mass of triples the eps filter may drop from C
    but which the checksum reference still contains."""
    nbr, nbk = an.shape
    nbc = bn.shape[1]
    if filter_eps is None or filter_eps <= 0.0:
        return np.zeros((nbr, nbc), dtype=np.float64)
    if nbr * nbk * nbc <= _EXACT_DROP_LIMIT:
        prod = (an.astype(np.float64)[:, :, None]
                * bn.astype(np.float64)[None, :, :])
        return np.where(prod < filter_eps, prod, 0.0).sum(axis=1)
    return np.full((nbr, nbc), float(nbk) * float(filter_eps))


def verification_tolerances(
    a_norms: np.ndarray,
    b_norms: np.ndarray,
    *,
    rtol: float = DEFAULT_RTOL,
    atol: float = 0.0,
    filter_eps: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-block-row / per-block-column detection thresholds from the
    norm cache: roundoff scaled by the norm-product bound plus the
    eps-filtered dropped mass."""
    bound = a_norms.astype(np.float64) @ b_norms.astype(np.float64)
    dropped = _dropped_mass(a_norms, b_norms, filter_eps)
    row_tol = atol + rtol * bound.sum(axis=1) + dropped.sum(axis=1)
    col_tol = atol + rtol * bound.sum(axis=0) + dropped.sum(axis=0)
    return row_tol, col_tol


def verify_product(
    a,
    b,
    c,
    *,
    block_m: int,
    block_k: int,
    block_n: int,
    a_mask: Optional[np.ndarray] = None,
    b_mask: Optional[np.ndarray] = None,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
    filter_eps: Optional[float] = None,
    rtol: float = DEFAULT_RTOL,
    atol: float = 0.0,
) -> VerificationReport:
    """Verify ``c == a @ b`` blockwise via checksum residuals.

    Norms are taken from the norm cache when supplied and recomputed
    from the payloads (mask-applied) otherwise.  ``flagged_blocks`` is
    the cross product of flagged rows and columns (exact for
    single-block corruption).
    """
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    m, k = a.shape
    n = b.shape[1]
    nbr, nbk, nbc = m // block_m, k // block_k, n // block_n
    if a_norms is None:
        a_norms = block_norms_of(a, block_m, block_k, a_mask)
    if b_norms is None:
        b_norms = block_norms_of(b, block_k, block_n, b_mask)
    a_norms, b_norms = normalize_block_norms(
        nbr, nbk, nbc, a_norms, b_norms)
    row_res, col_res = checksum_residuals(a, b, c, block_m, block_n)
    row_tol, col_tol = verification_tolerances(
        a_norms, b_norms, rtol=rtol, atol=atol, filter_eps=filter_eps)
    # ~(res <= tol) instead of (res > tol): NaN residuals must flag.
    row_bad = ~(row_res <= row_tol)
    col_bad = ~(col_res <= col_tol)
    rows = tuple(int(i) for i in np.nonzero(row_bad)[0])
    cols = tuple(int(j) for j in np.nonzero(col_bad)[0])
    if rows and cols:
        blocks = tuple((i, j) for i in rows for j in cols)
    elif rows:  # conservative: residual cancelled in one direction
        blocks = tuple((i, j) for i in rows for j in range(nbc))
    elif cols:
        blocks = tuple((i, j) for i in range(nbr) for j in cols)
    else:
        blocks = ()
    if obs.enabled():
        # gated telemetry counters: the disabled path publishes nothing
        obs.counter("abft.verifications").inc()
        if blocks:
            obs.counter("abft.detections").inc()
    return VerificationReport(
        detected=bool(blocks),
        flagged_rows=rows,
        flagged_cols=cols,
        flagged_blocks=blocks,
        row_residual=row_res,
        col_residual=col_res,
        row_tol=row_tol,
        col_tol=col_tol,
    )


def splice_blocks(c, c_fresh, blocks, block_m: int, block_n: int):
    """Replace only the flagged blocks of ``c`` with ``c_fresh``'s, on
    ``c``'s device (one ``(nbr, nbc)`` selector, no full-size mask).

    Unflagged blocks keep their original bits — together with a
    deterministic recompute this makes repair bitwise-exact."""
    c = torch.as_tensor(c)
    if not blocks:
        return c
    m, n = c.shape
    nbr, nbc = m // block_m, n // block_n
    sel = np.zeros((nbr, nbc), dtype=bool)
    for i, j in blocks:
        sel[i, j] = True
    sel = torch.from_numpy(sel).to(c.device)[:, None, :, None]
    fresh = torch.as_tensor(c_fresh).to(c.device)
    return torch.where(sel, fresh.reshape(nbr, block_m, nbc, block_n),
                       c.reshape(nbr, block_m, nbc, block_n)).reshape(m, n)


def verify_and_repair(
    a,
    b,
    c,
    *,
    recompute: Callable[[], torch.Tensor],
    block_m: int,
    block_k: int,
    block_n: int,
    a_mask: Optional[np.ndarray] = None,
    b_mask: Optional[np.ndarray] = None,
    a_norms: Optional[np.ndarray] = None,
    b_norms: Optional[np.ndarray] = None,
    filter_eps: Optional[float] = None,
    rtol: float = DEFAULT_RTOL,
    atol: float = 0.0,
):
    """Verify ``c``; on detection recompute once, splice the flagged
    blocks, and recheck.  Returns ``(c, VerificationReport)``.

    Raises :class:`~repro_torch.robustness.guards.CorruptionDetectedError`
    when the spliced result still fails — the one-shot repair budget is
    exhausted and the fault is persistent.
    """
    kw = dict(block_m=block_m, block_k=block_k, block_n=block_n,
              a_mask=a_mask, b_mask=b_mask,
              a_norms=a_norms, b_norms=b_norms,
              filter_eps=filter_eps, rtol=rtol, atol=atol)
    report = verify_product(a, b, c, **kw)
    if not report.detected:
        return c, report
    fresh = recompute()
    c = splice_blocks(c, fresh, report.flagged_blocks, block_m, block_n)
    recheck = verify_product(a, b, c, **kw)
    report = dataclasses.replace(
        report,
        repair_attempted=True,
        repaired=not recheck.detected,
        n_recomputed_blocks=len(report.flagged_blocks),
    )
    if obs.enabled():
        obs.counter("abft.repairs" if report.repaired
                    else "abft.repair_failures").inc()
    if recheck.detected:
        raise guards.CorruptionDetectedError(
            f"corruption persisted after one-shot repair: blocks "
            f"{recheck.flagged_blocks} still exceed tolerance",
            report=dataclasses.replace(
                recheck, repair_attempted=True, repaired=False,
                n_recomputed_blocks=len(report.flagged_blocks)))
    return c, report
