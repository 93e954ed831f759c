"""Density-matrix purification — the sparsity-evolving workload
norm-based filtering exists for (CP2K's linear-scaling SCF on DBCSR),
the port's counterpart of ``examples/purification.py``.

McWeeny's iteration  P <- 3 P^2 - 2 P^3  runs end to end through
``dbcsr.multiply(filter_eps=1e-6)`` on a simulated 4x4 mesh, on the
blocked path (the smm kernel on the card, its plain version on the
CPU).  The printed trace is the canonical purification signature:
occupancy RISES for an iteration or two, then DECAYS monotonically to
the converged density's support (the diagonal) while ||P^2 - P|| falls
to zero and tr(P) stays at the electron count n/2.

The trajectory runs twice, with the union-of-ranks plans
(``rank_exact=False``) and rank-exact (the default), and the busiest
rank's executed triples are compared: on the banded support the union
plan makes every rank execute every rank's band chunks, so rank-exact
execution must shrink the busiest rank's load on every sparse
iteration.  The rank-exact run is traced (``obs.enable()``): every
multiply leaves a span tree, and the ``purification.occupancy`` gauge's
sample history must equal the trace's occupancy curve.

    PYTHONPATH=src python -m repro_torch.examples.purification --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs
from repro_torch.core import dbcsr
from repro_torch.core.blocking import GridSpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.sparsity.workloads import (banded_hamiltonian,
                                            initial_density, mcweeny_purify)

FILTER_EPS = 1e-6


def purification_checks(trace, union_trace, n: int) -> dict:
    """The example's three properties of a rank-exact ``trace`` and its
    union twin: occupancy decays monotonically after its peak and ends
    below the initial guess's; tr(P) ends within 0.5 of n/2; the busiest
    rank's executed triples shrink against the union's on every
    iteration that ran the blocked path."""
    occs = [t["occupancy"] for t in trace]
    peak = occs.index(max(occs))
    shrunk = [tr["max_rank_entries"] < tu["max_rank_entries"]
              for tu, tr in zip(union_trace, trace)
              if tu.get("max_rank_entries") and tr.get("max_rank_entries")]
    return {
        "peak": peak,
        "monotone": all(occs[i + 1] <= occs[i] + 1e-12
                        for i in range(peak, len(occs) - 1)),
        "decayed": occs[-1] < occs[0],
        "electrons": abs(trace[-1]["trace_P"] - n // 2) < 0.5,
        "shrunk": bool(shrunk) and all(shrunk),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    n, bs = args.n, args.block

    H, mask = banded_hamiltonian(n, bs)
    P0_host = initial_density(H)
    mesh = make_mesh((4, 4), ("data", "model"), device=args.device)
    P0 = dbcsr.create(P0_host.astype(np.float32), mesh=mesh,
                      grid=GridSpec("data", "model"), block_size=bs,
                      block_mask=mask)
    nb = P0.layout.nblock_rows
    print(f"== McWeeny purification: {n}x{n}, {nb}x{nb} blocks of {bs}, "
          f"4x4 mesh on {args.device}, filter_eps={FILTER_EPS:g} ==")
    print(f"initial guess: occupancy {P0.occupancy:.4f} "
          f"({int(mask.sum())}/{nb * nb} blocks), "
          f"tr(P0) = {float(P0.trace()):.2f} (electrons: {n // 2})")

    base_kw = dict(densify=False,
                   local_kernel="ref" if args.device == "cpu" else "smm")
    _, union_trace = mcweeny_purify(
        P0, mesh=mesh, n_iter=args.iters, filter_eps=FILTER_EPS,
        multiply_kw=dict(base_kw, rank_exact=False))
    gauge = obs.gauge("purification.occupancy")
    n_before = len(gauge.samples)
    t0 = time.perf_counter()
    obs.enable()
    try:
        _, trace = mcweeny_purify(P0, mesh=mesh, n_iter=args.iters,
                                  filter_eps=FILTER_EPS,
                                  multiply_kw=base_kw)
    finally:
        obs.disable()
    dt = time.perf_counter() - t0

    print(f"{'iter':>4s} {'occupancy':>10s} {'blocks':>7s} "
          f"{'retained':>9s} {'filtered':>9s} {'MFLOP_kept':>10s} "
          f"{'idempotency':>12s} {'tr(P)':>8s}")
    for t in trace:
        print(f"{t['iteration']:4d} {t['occupancy']:10.4f} "
              f"{t['n_blocks']:7d} {t.get('n_retained_triples', 0):9d} "
              f"{t.get('n_norm_filtered_triples', 0):9d} "
              f"{t.get('retained_flops', 0) / 1e6:10.2f} "
              f"{t['idempotency']:12.3e} {t['trace_P']:8.2f}")
    print(f"{args.iters} rank-exact iterations in {dt:.2f} s (traced)")
    samples = gauge.samples[n_before:]
    print("occupancy as telemetry gauge samples "
          "(obs.gauge('purification.occupancy')): "
          + " ".join(f"{x:.4f}" for x in samples))
    assert samples == [t["occupancy"] for t in trace], \
        "gauge samples should mirror the trace"

    print(f"{'iter':>4s} {'union/rank':>10s} {'busiest':>8s} "
          f"{'shrink':>7s} {'imbalance':>9s}")
    for tu, tr in zip(union_trace, trace):
        u, r = tu.get("max_rank_entries", 0), tr.get("max_rank_entries", 0)
        if u and r:
            print(f"{tr['iteration']:4d} {u:10d} {r:8d} {u / r:6.2f}x "
                  f"{tr.get('rank_imbalance', 1.0):9.2f}")
    ok = purification_checks(trace, union_trace, n)
    occs = [t["occupancy"] for t in trace]
    print(f"occupancy peaks at iteration {ok['peak']} "
          f"({occs[ok['peak']]:.4f}), converges to {occs[-1]:.4f}")
    assert ok["monotone"] and ok["decayed"], \
        "purification occupancy did not decay monotonically after the peak"
    assert ok["electrons"], "electron count drifted"
    assert ok["shrunk"], \
        "rank-exact busiest-rank load did not shrink vs the union plan"
    print("purification trace OK; rank-exact shrank the busiest rank's "
          "load on every iteration")


if __name__ == "__main__":
    main()
