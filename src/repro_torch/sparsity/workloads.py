"""Sparsity-evolving workloads: density-matrix purification.

This is THE workload norm-based filtering exists for (CP2K's
linear-scaling SCF, the main user of DBCSR): McWeeny purification
iterates

    P  <-  3 P^2 - 2 P^3

from an initial guess built by scaling a (banded, gapped) Hamiltonian
into [0, 1].  Every iterate is a pair of block-sparse multiplies whose
*operands' sparsity evolves*: squaring spreads the band, convergence
toward the spectral projector drives spurious far-band weight to zero,
and ``filter_eps`` prunes it — occupancy rises for an iteration or
two, then decays monotonically toward the converged density's support.

``banded_hamiltonian`` and ``initial_density`` are host numpy and
byte-equal to the JAX package's; ``mcweeny_purify`` runs the iteration
through the port's ``dbcsr.multiply(filter_eps=...)`` on a mesh, and
measures the idempotency on the payloads' device in float64.  See
``repro_torch.examples.purification`` for the end-to-end run.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import obs

__all__ = ["banded_hamiltonian", "initial_density", "mcweeny_purify"]


def banded_hamiltonian(
    n: int,
    block_size: int,
    *,
    half_bandwidth: int = 4,
    gap: float = 2.0,
    coupling: float = 0.3,
    decay: float = 0.4,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """A gapped block-banded "insulator" Hamiltonian (H, block_mask).

    Orbitals alternate between an occupied level (-gap/2, even global
    index) and a virtual level (+gap/2, odd); block distance d in
    [1, half_bandwidth] carries symmetric random coupling of Frobenius
    norm ``coupling * decay**(d-1)`` that only connects SAME-parity
    orbitals (occupied-occupied / virtual-virtual — the couplings
    commute with the occupation structure, like a Hamiltonian expressed
    in a molecular-orbital-aligned basis).  Gershgorin keeps the two
    level clusters separated as long as the total coupling radius stays
    below gap/2, so the exact density matrix theta(-H) is EXACTLY the
    diagonal parity projector: every off-diagonal block of the
    purification iterate lives in the quadratically-annihilated
    (occ-occ / virt-virt) sectors and decays below any ``filter_eps``
    as the iteration converges.  The result is the canonical
    purification trace: occupancy rises for an iteration or two (the
    band spreads through P^2 / P^3), then decays monotonically to the
    diagonal.
    """
    if n % block_size:
        raise ValueError(f"n={n} not divisible by block_size={block_size}")
    if block_size % 2:
        raise ValueError("block_size must be even (parity structure)")
    nb = n // block_size
    rng = np.random.RandomState(seed)
    H = np.zeros((n, n), dtype=np.float64)
    # alternating two-level diagonal: eigenvalues cluster at +-gap/2
    levels = np.where(np.arange(n) % 2 == 0, -gap / 2.0, gap / 2.0)
    H[np.diag_indices(n)] = levels
    # same-parity entries of a block at any distance: (r + c) even
    # within the block, since global parity == local parity (bs even)
    parity = ((np.arange(block_size)[:, None]
               + np.arange(block_size)[None, :]) % 2) == 0
    mask = np.eye(nb, dtype=bool)
    for d in range(1, min(half_bandwidth, nb - 1) + 1):
        scale = coupling * decay ** (d - 1)
        for i in range(nb - d):
            blk = rng.randn(block_size, block_size) * parity
            blk *= scale / max(np.linalg.norm(blk), 1e-300)
            r = slice(i * block_size, (i + 1) * block_size)
            c = slice((i + d) * block_size, (i + d + 1) * block_size)
            H[r, c] = blk
            H[c, r] = blk.T  # keep H symmetric
            mask[i, i + d] = mask[i + d, i] = True
    return H, mask


def initial_density(H: np.ndarray, mu: float = 0.0) -> np.ndarray:
    """McWeeny's linear initial guess: map H's spectrum into [0, 1]
    with occupied states (eigenvalues below ``mu``) above 1/2,

        P0 = 1/2 I - (H - mu I) / (2 lambda),

    where ``lambda`` bounds the spectral radius of ``H - mu I``
    (Gershgorin discs — no eigensolve).  Purification then drives every
    eigenvalue to 0 or 1, i.e. P0 -> the density matrix theta(mu - H).
    """
    n = H.shape[0]
    radii = np.abs(H).sum(axis=1) - np.abs(np.diag(H))
    diag = np.diag(H)
    lam = max(float(np.max(diag + radii - mu)),
              float(np.max(mu - (diag - radii))), 1e-12)
    return 0.5 * np.eye(n) - (H - mu * np.eye(n)) / (2.0 * lam)


def mcweeny_purify(
    P0,
    *,
    mesh,
    n_iter: int = 10,
    filter_eps: Optional[float] = 1e-6,
    multiply_kw: Optional[dict] = None,
) -> Tuple[object, List[dict]]:
    """Run ``n_iter`` McWeeny iterations of ``P <- 3 P^2 - 2 P^3``
    entirely through ``dbcsr.multiply(filter_eps=...)``.

    ``P0`` is a DBCSRMatrix (``repro_torch.core.dbcsr.create`` of
    ``initial_density``'s output, with the Hamiltonian's band mask).
    Each iteration performs two filtered multiplies (P^2 = P @ P and
    P^3 = P^2 @ P), combines them with add/scale, and applies the
    post-multiply ``filter(eps)`` pass (re-deriving the mask from the
    fresh iterate's actual block norms — DBCSR's behaviour in CP2K).

    Returns ``(P, trace)`` where ``trace`` has one dict per iteration,
    with the JAX package's keys: ``occupancy`` (retained-block fraction
    after filtering), ``n_blocks``, ``n_retained_triples`` /
    ``n_norm_filtered_triples`` (summed over the two multiplies, when
    the blocked path executed), ``retained_flops`` / ``filtered_flops``,
    ``max_rank_entries`` (the busiest rank's executed triples) and
    ``rank_imbalance`` on rank-exact runs, ``idempotency`` (the
    Frobenius norm ||P^2 - P||, the convergence measure, reduced in
    float64 on the payloads' device: no host copy of P) and ``trace_P``
    (electron-count conservation).  With telemetry enabled
    (``obs.enable()``) each iteration also sets the
    ``purification.occupancy`` and ``purification.idempotency`` gauges,
    whose sample history is the sparsity-evolution curve.
    """
    from ..core import dbcsr

    kw = dict(multiply_kw or {})
    P = P0
    trace = []
    for it in range(n_iter):
        P2, plan2 = dbcsr.multiply(P, P, mesh=mesh, filter_eps=filter_eps,
                                   return_plan=True, **kw)
        P3, plan3 = dbcsr.multiply(P2, P, mesh=mesh, filter_eps=filter_eps,
                                   return_plan=True, **kw)
        Pn = dbcsr.add(P2.scale(3.0), P3.scale(-2.0))
        if filter_eps is not None:
            Pn = Pn.filter(filter_eps)

        idem = float(torch.linalg.vector_norm(
            P2.data.to(torch.float64) - P.data.to(torch.float64)))
        entry = {
            "iteration": it,
            "occupancy": Pn.occupancy,
            "n_blocks": (int(Pn.block_mask.sum())
                         if Pn.block_mask is not None
                         else Pn.layout.nblocks),
            "idempotency": idem,
            "trace_P": float(Pn.trace()),
        }
        retained = filtered = busiest = 0
        flop = 2 * (P.layout.block_rows * P.layout.block_cols
                    * P.layout.block_cols)
        have_stats = False
        rank_imbs = []
        for plan in (plan2, plan3):
            st = getattr(plan, "executor_stats", None)
            if st:
                have_stats = True
                retained += st.get("n_entries", 0)
                filtered += st.get("n_norm_filtered_triples", 0)
                # rank-exact runs: the busiest rank's own executed
                # triples (== n_entries on union/collapsed plans)
                busiest += st.get("max_rank_entries",
                                  st.get("n_entries", 0))
                if st.get("rank_imbalance") is not None:
                    rank_imbs.append(st["rank_imbalance"])
        if have_stats:
            entry["n_retained_triples"] = retained
            entry["n_norm_filtered_triples"] = filtered
            entry["retained_flops"] = retained * flop
            entry["filtered_flops"] = filtered * flop
            entry["max_rank_entries"] = busiest
            if rank_imbs:
                entry["rank_imbalance"] = max(rank_imbs)
        if obs.enabled():
            # the canonical sparsity-evolution signal as gauge samples:
            # occupancy rises for a step or two, then decays to the
            # converged support (gauge history renders the curve)
            obs.gauge("purification.occupancy").set(entry["occupancy"])
            obs.gauge("purification.idempotency").set(entry["idempotency"])
        trace.append(entry)
        P = Pn
    return P, trace
