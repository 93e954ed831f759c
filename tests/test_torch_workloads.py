"""The purification workload of the port (repro_torch.sparsity.workloads,
repro_torch.examples.purification) against the JAX package's, on the
CPU.

* Byte-equal copies: ``banded_hamiltonian``, ``initial_density``,
  ``product_norm_bound``, ``ceil_div`` and ``pad_to_multiple`` give the
  reference's bytes.
* McWeeny purification at n 256 in blocks of 16, 6 iterations, eps 1e-6,
  blocked path (the smm kernel's plain version on both sides): on 1x1
  in process (the planner's pick), and on 2x2 with Cannon pinned
  against the reference run in one subprocess with 4 host devices,
  union (``rank_exact=False``) and rank-exact, one subprocess each,
  started with the module so they run beside the 1x1 comparison.
  Cannon is pinned there
  because on 2x2 the planner picks ts_m, whose rank-exact executor's
  statistics in the JAX package omit the norm-filtered triple count
  (``RankExecutorPlan.stats``), so its trace records 0 where the port
  counts the busiest rank's filtered triples; Cannon's stepwise
  statistics carry the count in both packages.  Per
  iteration the block and triple counts must be equal; occupancy to
  1e-12 (a ratio of equal counts); tr(P) to 1e-4 absolute and the
  idempotency ||P^2 - P|| to 1e-4 absolute + 1e-4 relative (f32 sums
  of entries <= 1 in two orders over 256^2 entries: about 256 x 2 ulp(1)
  = 3e-5 of Frobenius norm).
* The reference's decay test (tests/test_filtering.py) on the port.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC
from torch_threads import one_thread  # noqa: F401

from repro.core import blocking as jblocking
from repro.sparsity import norms as jnorms
from repro.sparsity import workloads as jworkloads

from repro_torch.core import blocking, dbcsr
from repro_torch.examples import purification
from repro_torch.launch.mesh import make_mesh
from repro_torch.sparsity import norms, workloads
from repro_torch.sparsity.workloads import (banded_hamiltonian,
                                            initial_density, mcweeny_purify)

N, BS, ITERS, EPS = 256, 16, 6, 1e-6
COUNTS = ("n_blocks", "n_retained_triples", "n_norm_filtered_triples",
          "max_rank_entries")


@pytest.mark.parametrize("n, bs, kw", [
    (256, 16, {}),
    (128, 16, dict(half_bandwidth=3)),
    (96, 8, dict(half_bandwidth=1, gap=1.0, coupling=0.2, decay=0.7,
                 seed=5)),
    (64, 32, dict(half_bandwidth=6)),
])
def test_hamiltonian_and_initial_density_are_byte_equal(n, bs, kw):
    H, mask = banded_hamiltonian(n, bs, **kw)
    jH, jmask = jworkloads.banded_hamiltonian(n, bs, **kw)
    assert H.dtype == jH.dtype and H.tobytes() == jH.tobytes()
    assert mask.dtype == jmask.dtype and mask.tobytes() == jmask.tobytes()
    for mu in (0.0, 0.3):
        P0, jP0 = initial_density(H, mu=mu), jworkloads.initial_density(
            jH, mu=mu)
        assert P0.tobytes() == jP0.tobytes()


@pytest.mark.parametrize("shape", [(4, 5, 3), (1, 1, 1), (7, 2, 9)])
def test_product_norm_bound_is_byte_equal(shape):
    rng = np.random.RandomState(sum(shape))
    an = rng.rand(*shape[:2]).astype(np.float32)
    bn = rng.rand(*shape[1:]).astype(np.float32)
    got = norms.product_norm_bound(an, bn)
    want = jnorms.product_norm_bound(an, bn)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_ceil_div_and_pad_to_multiple_are_equal():
    for a in range(-7, 40):
        for b in (1, 2, 3, 7, 16):
            assert blocking.ceil_div(a, b) == jblocking.ceil_div(a, b)
            assert (blocking.pad_to_multiple(a, b)
                    == jblocking.pad_to_multiple(a, b))


def test_workloads_exports_match_the_reference():
    assert workloads.__all__ == jworkloads.__all__
    from repro_torch import sparsity
    for name in ("banded_hamiltonian", "initial_density", "mcweeny_purify",
                 "product_norm_bound"):
        assert name in sparsity.__all__


def _assert_same_trace(got, want, where):
    assert len(got) == len(want), where
    for g, w in zip(got, want):
        it = (where, g["iteration"])
        assert set(g) == set(w), it
        for key in COUNTS:
            assert g[key] == w[key], (it, key)
        assert g["occupancy"] == pytest.approx(w["occupancy"], abs=1e-12)
        assert g["trace_P"] == pytest.approx(w["trace_P"], abs=1e-4), it
        assert g["idempotency"] == pytest.approx(
            w["idempotency"], rel=1e-4, abs=1e-4), it
        if "rank_imbalance" in w:
            assert g["rank_imbalance"] == pytest.approx(
                w["rank_imbalance"], rel=1e-12), it


def _port_trace(shape, rank_exact=None, **extra):
    H, mask = banded_hamiltonian(N, BS)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    P0 = dbcsr.create(initial_density(H).astype(np.float32), mesh=mesh,
                      block_size=BS, block_mask=mask)
    kw = dict(densify=False, local_kernel="ref", **extra)
    if rank_exact is not None:
        kw["rank_exact"] = rank_exact
    _, trace = mcweeny_purify(P0, mesh=mesh, n_iter=ITERS, filter_eps=EPS,
                              multiply_kw=kw)
    return trace


def test_purification_1x1_matches_jax():
    from repro.compat import make_mesh as jmake_mesh
    from repro.core import dbcsr as jdbcsr

    H, mask = jworkloads.banded_hamiltonian(N, BS)
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    P0 = jdbcsr.create(jworkloads.initial_density(H).astype(np.float32),
                       mesh=jmesh, block_size=BS, block_mask=mask)
    _, want = jworkloads.mcweeny_purify(
        P0, mesh=jmesh, n_iter=ITERS, filter_eps=EPS,
        multiply_kw=dict(densify=False, local_kernel="ref"))
    _assert_same_trace(_port_trace((1, 1)), want, "1x1")


REFERENCE_2X2 = f"""
import json, sys
import numpy as np
from repro.compat import make_mesh
from repro.core import dbcsr
from repro.sparsity.workloads import (banded_hamiltonian, initial_density,
                                      mcweeny_purify)
H, mask = banded_hamiltonian({N}, {BS})
mesh = make_mesh((2, 2), ("data", "model"))
P0 = dbcsr.create(initial_density(H).astype(np.float32), mesh=mesh,
                  block_size={BS}, block_mask=mask)
extra = dict(rank_exact=False) if sys.argv[1] == "union" else {{}}
_, trace = mcweeny_purify(P0, mesh=mesh, n_iter={ITERS}, filter_eps={EPS},
                          multiply_kw=dict(algorithm="cannon", densify=False,
                                           local_kernel="ref", **extra))
print("JSON" + json.dumps(trace))
"""
RUNS = ("union", "rank_exact")


@pytest.fixture(scope="module", autouse=True)
def _reference_2x2_procs():
    """The reference's 2x2 trajectories, one subprocess each with 4 host
    devices, started before the module's first test."""
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {run: subprocess.Popen(
        [sys.executable, "-c", REFERENCE_2X2, run], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for run in RUNS}
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference_2x2(_reference_2x2_procs):
    out = {}
    for run, proc in _reference_2x2_procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-4000:]
        line = [ln for ln in stdout.splitlines() if ln.startswith("JSON")][-1]
        out[run] = json.loads(line[4:])
    return out


@pytest.mark.parametrize("run", RUNS)
def test_purification_2x2_matches_jax(reference_2x2, run):
    got = _port_trace((2, 2), rank_exact=False if run == "union" else None,
                      algorithm="cannon")
    _assert_same_trace(got, reference_2x2[run], f"2x2 {run}")


@pytest.mark.parametrize("algorithm", ["auto", "cannon"])
def test_purification_2x2_rank_exact_shrinks_the_busiest_rank(algorithm):
    """The example's assertions on the port's 2x2 trajectories."""
    union = _port_trace((2, 2), rank_exact=False, algorithm=algorithm)
    exact = _port_trace((2, 2), algorithm=algorithm)
    ok = purification.purification_checks(exact, union, N)
    assert ok["monotone"] and ok["decayed"] and ok["electrons"], ok
    assert ok["shrunk"], ok


def test_mcweeny_purification_occupancy_decays():
    """tests/test_filtering.py's decay test, on the port."""
    n, bs = 128, 16
    H, mask = banded_hamiltonian(n, bs, half_bandwidth=3)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    P0 = dbcsr.create(initial_density(H).astype(np.float32), mesh=mesh,
                      block_size=bs, block_mask=mask)
    P, trace = mcweeny_purify(
        P0, mesh=mesh, n_iter=8, filter_eps=1e-6,
        multiply_kw=dict(densify=False, local_kernel="ref"))
    occs = [t["occupancy"] for t in trace]
    peak = occs.index(max(occs))
    assert all(occs[i + 1] <= occs[i] + 1e-12
               for i in range(peak, len(occs) - 1)), occs
    assert occs[-1] < occs[0], occs  # net sparsification
    assert trace[-1]["idempotency"] < 1e-4  # converged to a projector
    assert abs(trace[-1]["trace_P"] - n // 2) < 0.5  # electrons conserved
    # the filter actually dropped work somewhere along the run
    assert any(t.get("n_norm_filtered_triples", 0) > 0 for t in trace)
    assert isinstance(P.data, torch.Tensor)


def test_idempotency_is_the_float64_norm_of_the_host_copies():
    """The device float64 idempotency equals the reference's formula
    (``np.linalg.norm`` of float64 host copies) to 1e-12 relative."""
    H, mask = banded_hamiltonian(64, 16)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    P0 = dbcsr.create(initial_density(H).astype(np.float32), mesh=mesh,
                      block_size=16, block_mask=mask)
    _, trace = mcweeny_purify(P0, mesh=mesh, n_iter=1, filter_eps=None,
                              multiply_kw=dict(densify=False,
                                               local_kernel="ref"))
    P2 = dbcsr.multiply(P0, P0, mesh=mesh, densify=False, local_kernel="ref")
    want = float(np.linalg.norm(P2.data.numpy().astype(np.float64)
                                - P0.data.numpy().astype(np.float64)))
    assert trace[0]["idempotency"] == pytest.approx(want, rel=1e-12)


def test_purification_example_runs_on_the_cpu(capsys):
    purification.main(["--device", "cpu", "--n", "256", "--block", "16",
                       "--iters", "6"])
    assert "purification trace OK" in capsys.readouterr().out
