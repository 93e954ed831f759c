"""The port's MultiplyService (continuous batching over
``dbcsr.multiply_batched``) and its metrics registry, on the CPU:
the JAX package's service scenarios with ``fused=True`` and a fake
clock, and the degradation ladder held to the JAX service's counters
under the same fault injector.

Tolerances: results against numpy ``A @ B`` to 1e-3 absolute (f32 sums
over k = 128, as the JAX package's tests use); a retried or degraded
bucket must deliver the same bits as a clean run (bitwise); histogram
percentiles equal numpy's linear interpolation to 1e-12."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dbcsr as jdbcsr
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.obs import metrics as jmetrics
from repro.robustness import chaos
from repro.serve.multiply_service import MultiplyService as JaxService

from repro_torch import obs
from repro_torch.core import dbcsr
from repro_torch.launch.mesh import make_mesh
from repro_torch.robustness import guards
from repro_torch.serve import (MultiplyService, TicketPendingError,
                               UnknownTicketError)

from torch_threads import one_thread  # noqa: F401

EXEC_KW = dict(algorithm="cannon", densify=False, pipeline_depth=1)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def _with_data(matrix, data):
    return dataclasses.replace(matrix, data=data)


def _requests(mesh, geoms, rng, block_size=64, jmesh=None):
    """Seeded DBCSR operand pairs, and ``A @ B`` in numpy; with ``jmesh``
    also the same operands as JAX matrices."""
    reqs, refs, jreqs = [], [], []
    for m, k, n in geoms:
        a = rng.randn(m, k).astype(np.float32)
        b = rng.randn(k, n).astype(np.float32)
        reqs.append((dbcsr.create(a, mesh=mesh, block_size=block_size),
                     dbcsr.create(b, mesh=mesh, block_size=block_size)))
        refs.append(a @ b)
        if jmesh is not None:
            jreqs.append((jdbcsr.create(a, mesh=jmesh, block_size=block_size),
                          jdbcsr.create(b, mesh=jmesh, block_size=block_size)))
    return reqs, refs, jreqs


def test_multiply_service(mesh):
    clk = FakeClock()
    svc = MultiplyService(mesh, slo_s=1.0, max_batch=4, clock=clk,
                          fused=True, **EXEC_KW)
    reqs, refs, _ = _requests(mesh, [(128, 128, 128)] * 6,
                              np.random.RandomState(0))
    tickets = [svc.submit(a, b) for a, b in reqs]
    # the full bucket (max_batch=4) fires at once; 2 wait on the SLO
    done = svc.poll()
    assert sorted(done) == tickets[:4]
    assert svc.n_pending == 2
    clk.t = 0.5
    assert svc.poll() == []          # inside the SLO window: keep waiting
    clk.t = 1.01
    assert sorted(svc.poll()) == tickets[4:]
    assert svc.n_pending == 0
    for t, ref in zip(tickets, refs):
        np.testing.assert_allclose(svc.result(t).data.numpy(), ref, atol=1e-3)
    st = svc.stats()
    assert st["n_requests"] == 6 and st["n_dispatches"] == 2
    assert st["n_fused_requests"] == 6 and st["n_looped_requests"] == 0
    assert st["latency_p99_s"] >= st["latency_p50_s"] >= 0.0
    assert [b["stage"] for b in st["buckets"]] == ["fused", "fused"]
    # flush drains regardless of SLO; result() pops
    t7 = svc.submit(*reqs[0])
    assert svc.flush() == [t7]
    svc.result(t7)
    with pytest.raises(KeyError):
        svc.result(t7)


def test_multiply_service_bucketing(mesh):
    svc = MultiplyService(mesh, slo_s=0.0, max_batch=8, clock=FakeClock(),
                          fused=True, **EXEC_KW)
    reqs, _, _ = _requests(mesh, [(64, 64, 64), (64, 64, 128), (64, 64, 64)],
                           np.random.RandomState(1), block_size=32)
    for a, b in reqs:
        svc.submit(a, b)
    # slo_s=0: everything is due on the first poll, but in TWO dispatches
    # (two geometry buckets)
    assert sorted(svc.poll()) == [0, 1, 2]
    assert svc.stats()["n_dispatches"] == 2


def test_fused_none_needs_the_planner(mesh):
    """``fused=None`` (the default) raised until the planner was ported;
    now each drained bucket is fused or looped as the planner prices it,
    and the products are bitwise ``multiply_batched``'s with the same
    choice."""
    svc = MultiplyService(mesh, clock=FakeClock(), **EXEC_KW)
    reqs, refs, _ = _requests(mesh, [(128, 128, 128)] * 3,
                              np.random.RandomState(3))
    tickets = [svc.submit(a, b) for a, b in reqs]
    assert sorted(svc.flush()) == tickets
    (bucket,) = svc.stats()["buckets"]
    plan = bucket["report"]["buckets"][0]["plan"]
    assert plan.n_requests == 3 and plan.fuse == bucket["fused"]
    pinned = dbcsr.multiply_batched(reqs, mesh=mesh, fused=plan.fuse,
                                    **EXEC_KW)
    for t, c, ref in zip(tickets, pinned, refs):
        got = svc.result(t)
        assert torch.equal(got.data, c.data)
        np.testing.assert_allclose(got.data.numpy(), ref, atol=1e-3)
    with pytest.raises(ValueError):
        MultiplyService(mesh, fused=True, max_batch=0)


def test_ticket_states(mesh):
    svc = MultiplyService(mesh, fused=True, clock=FakeClock(), **EXEC_KW)
    reqs, _, _ = _requests(mesh, [(64, 64, 64)], np.random.RandomState(2),
                           block_size=32)
    t = svc.submit(*reqs[0])
    with pytest.raises(TicketPendingError):
        svc.result(t)
    with pytest.raises(UnknownTicketError):
        svc.result(t + 100)
    svc.flush()
    svc.result(t)
    with pytest.raises(UnknownTicketError):
        svc.result(t)
    assert issubclass(TicketPendingError, KeyError)
    assert issubclass(UnknownTicketError, KeyError)


def _ladder_run(svc_cls, mesh, reqs, injector, slept, **kw):
    svc = svc_cls(mesh, slo_s=0.0, max_batch=8, fused=True,
                  clock=FakeClock(), sleep=slept.append, max_retries=2,
                  backoff_s=0.05, fault_injector=injector, **EXEC_KW, **kw)
    tickets = [svc.submit(a, b) for a, b in reqs]
    done = svc.poll()
    assert sorted(done) == tickets   # poll() never loses tickets
    delivered, errors = {}, {}
    for t in tickets:
        try:
            delivered[t] = np.asarray(svc.result(t).data)
        except Exception as exc:     # error tickets re-raise their error
            errors[t] = type(exc).__name__
    st = svc.stats()
    counters = {k: st[k] for k in (
        "n_requests", "n_completed", "n_dispatches", "n_fused_requests",
        "n_looped_requests", "n_retries", "n_degradations",
        "n_error_tickets", "n_nonfinite_quarantined")}
    return counters, [b["stage"] for b in st["buckets"]], delivered, errors


@pytest.mark.parametrize("injector", [
    dict(fail_first=2),                       # retried, then fused
    dict(fail_first=3),                       # retries spent: looped rung
    dict(fail_stages=("fused",)),             # persistent: looped rung
    dict(fail_stages=("fused", "looped")),    # per-request isolation
])
def test_ladder_matches_jax_service(mesh, injector):
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    reqs, refs, jreqs = _requests(mesh, [(64, 64, 64)] * 4,
                                  np.random.RandomState(3), block_size=32,
                                  jmesh=jmesh)
    # one poison request: a NaN operand makes a non-finite product
    poison = reqs[2][0].data.clone()
    poison[0, 0] = float("nan")
    reqs[2] = (_with_data(reqs[2][0], poison), reqs[2][1])
    jpoison = jreqs[2][0].data.at[0, 0].set(float("nan"))
    jreqs[2] = (_with_data(jreqs[2][0], jpoison), jreqs[2][1])
    slept, jslept = [], []
    got = _ladder_run(MultiplyService, mesh, reqs,
                      chaos.DispatchFaultInjector(**injector), slept)
    # the JAX side runs its smm kernel's plain version (no Pallas
    # interpret mode), as the JAX package's own service tests do
    want = _ladder_run(JaxService, jmesh, jreqs,
                       chaos.DispatchFaultInjector(**injector), jslept,
                       local_kernel="ref")
    assert got[0] == want[0]              # every counter
    assert got[1] == want[1]              # the rung each bucket ended on
    assert got[3] == want[3] == {2: "NonFiniteResultError"}
    assert slept == jslept                # the same backoff schedule
    assert sorted(got[2]) == sorted(want[2]) == [0, 1, 3]
    clean = dbcsr.multiply_batched(
        [reqs[i] for i in (0, 1, 3)], mesh=mesh, fused=False, **EXEC_KW)
    for i, c in zip((0, 1, 3), clean):
        # a degraded or retried bucket delivers a clean run's bits
        np.testing.assert_array_equal(got[2][i], c.data.numpy())
        np.testing.assert_allclose(got[2][i], want[2][i], rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(got[2][i], refs[i], atol=1e-3)


def test_nonfinite_tripwire(mesh):
    svc = MultiplyService(mesh, fused=True, clock=FakeClock(), **EXEC_KW)
    reqs, _, _ = _requests(mesh, [(64, 64, 64)] * 2, np.random.RandomState(4),
                           block_size=32)
    inf_b = reqs[1][1].data.clone()
    inf_b[3, 5] = float("inf")
    t_ok = svc.submit(*reqs[0])
    t_bad = svc.submit(reqs[1][0], _with_data(reqs[1][1], inf_b))
    svc.flush()
    svc.result(t_ok)
    with pytest.raises(guards.NonFiniteResultError):
        svc.result(t_bad)
    st = svc.stats()
    assert st["n_nonfinite_quarantined"] == 1 and st["n_error_tickets"] == 1
    assert st["n_completed"] == 1
    # off, the tripwire lets the product through
    loose = MultiplyService(mesh, fused=True, check_finite=False,
                            clock=FakeClock(), **EXEC_KW)
    t = loose.submit(reqs[1][0], _with_data(reqs[1][1], inf_b))
    loose.flush()
    assert not guards.all_finite(loose.result(t).data)
    with pytest.raises(guards.NonFiniteOperandError):
        guards.assert_finite(inf_b, "B")
    guards.assert_finite(torch.arange(4))  # integer tensors are finite


def test_service_validates_at_submit(mesh):
    svc = MultiplyService(mesh, fused=True, **EXEC_KW)
    reqs, _, _ = _requests(mesh, [(64, 64, 64), (96, 64, 64)],
                           np.random.RandomState(5), block_size=32)
    a, b = reqs[0]
    bad = _with_data(b, b.data)
    bad.block_mask = np.ones((5, 5), dtype=bool)
    with pytest.raises(guards.MaskConsistencyError):
        svc.submit(a, bad)      # rejected at once, no ticket burned
    with pytest.raises(guards.ShapeMismatchError):
        svc.submit(a, reqs[1][0])
    assert svc.stats()["n_requests"] == 0
    loose = MultiplyService(mesh, fused=True, validate=False, **EXEC_KW)
    assert isinstance(loose.submit(a, bad), int)


def test_guards_taxonomy_matches_jax():
    from repro.robustness import guards as jguards

    for name in guards.__all__:
        ours, theirs = getattr(guards, name), getattr(jguards, name)
        if isinstance(ours, type):
            assert [c.__name__ for c in ours.__mro__] == \
                [c.__name__ for c in theirs.__mro__], name


@pytest.mark.parametrize("n", [1, 2, 7, 100])
def test_histogram_percentiles(n):
    values = np.random.RandomState(n).exponential(size=n)
    ours = obs.MetricsRegistry().histogram("lat", service="x")
    theirs = jmetrics.MetricsRegistry().histogram("lat", service="x")
    for v in values:
        ours.observe(v)
        theirs.observe(v)
    for p in (0, 25, 50, 90, 99, 100):
        want = float(np.percentile(values, p))
        assert abs(ours.percentile(p) - want) <= 1e-12
        assert ours.percentile(p) == theirs.percentile(p)
    assert ours.count == theirs.count == n
    assert ours.sum == pytest.approx(theirs.sum)


def test_metrics_registry_matches_jax():
    ours, theirs = obs.MetricsRegistry(), jmetrics.MetricsRegistry()
    for reg in (ours, theirs):
        reg.counter("service.requests", service="a").inc(3)
        reg.counter("service.requests", service="b").inc()
        reg.gauge("occupancy").set(0.25)
        reg.histogram("service.latency_s", service="a").observe(0.5)
    assert ours.snapshot() == theirs.snapshot()
    assert "occupancy" in ours and len(ours) == 4
    with pytest.raises(ValueError):
        ours.counter("service.requests", service="a").inc(-1)
    ours.clear()
    assert len(ours) == 0
