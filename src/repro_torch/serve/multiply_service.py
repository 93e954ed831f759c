"""Continuous-batching request layer over ``dbcsr.multiply_batched``.

The batched executor (core/multiply_batched.py) turns N
same-configuration products into one dispatch — but somebody has to
FIND those N products.  In a serving setting (property evaluations,
k-point workers, ensemble members issuing multiplies independently)
they arrive one at a time; this module is the accumulation layer that
turns the stream into fused batches:

  * ``submit(a, b)`` validates the request structurally
    (repro_torch.robustness.guards — a malformed request is rejected
    synchronously with a typed error, never at drain time), enqueues
    it, and returns a ticket id — nothing executes yet;
  * requests accumulate in buckets keyed by the batching contract
    ``(geometry, occupancy-bin, eps)`` (the same ``_bucket_key`` as
    ``dbcsr.multiply_batched`` — only key-identical requests can share
    a fused dispatch);
  * a bucket drains — ONE fused dispatch for its whole contents —
    when it reaches ``max_batch`` requests OR its oldest request's
    latency SLO expires (``slo_s`` seconds after submission),
    whichever comes first.  The SLO bounds the latency cost of waiting
    for batch-mates: a request never waits longer than ``slo_s`` past
    submission before its bucket is dispatched (modulo the caller
    actually pumping ``poll``).

Robustness (the degradation ladder).  A dispatch failure must never
lose tickets or let one poison request kill its batch-mates, so
``_dispatch`` walks a ladder and never raises:

  1. **fused** (or the planner's choice) — retried up to ``max_retries``
     times with exponential backoff on any failure (transient backend
     errors, injected chaos faults);
  2. **looped** — the bucket re-executes as per-request dispatches
     sharing one call (cheap, still batched at the Python level);
  3. **per-request isolation** — each request executes alone inside
     its own try/except: a poison request becomes an *error ticket*
     (its exception is stored and re-raised by ``result()``) while
     every healthy batch-mate completes normally — bit-identical to a
     clean run (the fused/looped bit-identity contract).

Delivered results additionally pass a NaN/Inf tripwire
(``check_finite``): a non-finite product is quarantined as an error
ticket (``NonFiniteResultError``) instead of poisoning downstream
iterations.  ``result()`` distinguishes the ticket states with a typed
taxonomy (all ``KeyError`` subclasses for backwards compatibility):
``TicketPendingError`` (still queued — pump ``poll()``),
``UnknownTicketError`` (never submitted, or already retrieved), and
errored tickets re-raise their stored exception.  ``stats()`` reports
retry / degradation / error-ticket counters next to the fusion
accounting.

The service is deliberately SYNCHRONOUS (no threads): draining happens
inside ``poll()`` / ``flush()`` on the caller's thread, so the caller
controls when device work runs, and it is testable with injected
``clock`` / ``sleep`` / ``fault_injector``.

With ``fused=None`` (the default) the planner prices each drained
bucket (``plan_multiply_batched``: fuse when one fused dispatch is
predicted cheaper than the loop); ``True`` / ``False`` pin the choice.

Typical pump loop::

    svc = MultiplyService(mesh, slo_s=0.005, max_batch=32)
    tickets = [svc.submit(a, b) for (a, b) in stream]
    svc.flush()                      # or poll() inside the loop
    results = [svc.result(t) for t in tickets]
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional

from .. import obs
from ..core.dbcsr import (DBCSRMatrix, _bucket_key, multiply,
                          multiply_batched)
from ..robustness import guards

__all__ = ["MultiplyService", "PendingRequest", "TicketPendingError",
           "UnknownTicketError"]

# Per-process instance ids so each service's metrics are isolated under a
# ``service=svc-<n>`` label in the shared obs registry.
_SERVICE_IDS = itertools.count()


class TicketPendingError(KeyError):
    """The ticket exists but its bucket has not drained yet — pump
    ``poll()`` / ``flush()`` first."""


class UnknownTicketError(KeyError):
    """The ticket was never submitted, or its result/error was already
    retrieved (results pop exactly once)."""


@dataclasses.dataclass
class PendingRequest:
    """One queued multiply: operands plus its SLO accounting."""

    ticket: int
    a: DBCSRMatrix
    b: DBCSRMatrix
    submit_t: float

    def deadline(self, slo_s: float) -> float:
        return self.submit_t + slo_s


class MultiplyService:
    """Accumulate multiply requests and drain them as fused batches.

    Parameters
    ----------
    mesh        the device mesh every request executes on
    slo_s       latency SLO: a bucket is dispatched no later than the
                first ``poll()`` after its OLDEST request has waited
                ``slo_s`` seconds (0 = dispatch every request on the
                next poll — batching only among same-poll arrivals)
    max_batch   dispatch a bucket as soon as it holds this many
                requests, SLO notwithstanding
    filter_eps  norm-filter threshold applied to every request (part of
                the bucket key — a service instance is eps-uniform)
    fused       the fuse-or-loop choice per bucket: ``None`` (the
                planner's pricing per bucket), ``True`` (one fused
                dispatch per bucket) or ``False`` (the ladder starts at
                its looped rung)
    validate    structural request validation at ``submit()`` time
                (guards.validate_multiply_request — reject malformed
                requests synchronously with a typed
                ``DbcsrValidationError``)
    check_finite  NaN/Inf tripwire on every delivered result: a
                non-finite product becomes an error ticket
                (``NonFiniteResultError``) instead of a poisoned result
    max_retries number of retries of the first ladder rung before
                degrading (transient-failure budget)
    backoff_s   base of the exponential retry backoff
                (``backoff_s * 2**attempt`` between attempts)
    clock       injectable time source (``time.monotonic``-like), for
                deterministic tests
    sleep       injectable backoff sleep (``time.sleep``-like)
    fault_injector  chaos hook: ``check(stage=..., attempt=...)`` is
                called before every dispatch attempt and may raise
    **kw        forwarded to ``dbcsr.multiply_batched`` and, on the
                per-request rung, to ``dbcsr.multiply`` (algorithm,
                densify, local_kernel, pipeline_depth, verify, ...);
                ``verify=`` (ABFT) reaches every request on every rung
                and runs it looped: the fused rung then raises under
                ``fused=True`` and the ladder degrades to the looped one

    ``stats()`` reports request/dispatch counters, per-bucket fusion
    accounting, retry/degradation/error-ticket counts, and
    completion-latency percentiles (p50/p99 of ``completion - submit``
    over finished requests).
    """

    def __init__(
        self,
        mesh,
        *,
        slo_s: float = 0.01,
        max_batch: int = 32,
        filter_eps: Optional[float] = None,
        fused: Optional[bool] = None,
        validate: bool = True,
        check_finite: bool = True,
        max_retries: int = 2,
        backoff_s: float = 0.05,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        fault_injector=None,
        **kw,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.mesh = mesh
        self.slo_s = float(slo_s)
        self.max_batch = int(max_batch)
        self.filter_eps = filter_eps
        self.fused = fused
        self.validate = bool(validate)
        self.check_finite = bool(check_finite)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.clock = clock
        self.sleep = sleep
        self.fault_injector = fault_injector
        self.kw = kw
        self._next_ticket = 0
        self._queues: Dict[tuple, List[PendingRequest]] = {}
        self._results: Dict[int, DBCSRMatrix] = {}
        self._errors: Dict[int, BaseException] = {}
        self._pending_tickets: set = set()
        self._bucket_reports: List[dict] = []
        # All counters/latencies live in the process-wide obs metrics
        # registry (one source of truth), isolated per instance by the
        # ``service=`` label; ``stats()`` is a thin view over it.
        self.service_id = f"svc-{next(_SERVICE_IDS)}"

    # -- metrics (registry-backed; ``stats()`` reads these back) -------
    def _counter(self, name: str) -> obs.Counter:
        return obs.counter(f"service.{name}", service=self.service_id)

    def _latency_hist(self) -> obs.Histogram:
        return obs.histogram("service.latency_s", service=self.service_id)

    # -- request side --------------------------------------------------
    def submit(self, a: DBCSRMatrix, b: DBCSRMatrix) -> int:
        """Enqueue C = A @ B; returns a ticket for ``result()``.

        The request is validated structurally FIRST (``validate=True``):
        block-geometry / grid / mask / norm-cache inconsistencies raise
        a typed ``DbcsrValidationError`` here, synchronously, instead of
        failing the whole bucket at drain time.  Nothing executes here —
        the request waits for batch-mates until its bucket fills
        (``max_batch``) or its SLO expires, both checked by
        ``poll()``/``flush()``.
        """
        if self.validate:
            guards.validate_multiply_request(a, b)
        ticket = self._next_ticket
        self._next_ticket += 1
        self._counter("requests").inc()
        key = _bucket_key(a, b, self.filter_eps)
        self._queues.setdefault(key, []).append(
            PendingRequest(ticket, a, b, self.clock()))
        self._pending_tickets.add(ticket)
        return ticket

    def poll(self) -> List[int]:
        """Dispatch every bucket that is due (full, or oldest request
        past its SLO deadline); returns the tickets settled by this
        call (results AND error tickets — both are retrievable via
        ``result()``).  Buckets still inside their SLO window keep
        waiting for batch-mates.  ``_dispatch`` never raises: a failed
        request becomes an error ticket, never a lost one.

        On a process mesh every process must dispatch the same buckets
        (their collectives pair up), so the deadline decision is rank
        0's (``mesh.agree``): the buckets whose first request after the
        full batches is past its deadline on rank 0's clock."""
        now = self.clock()
        due = self.mesh.agree([
            i for i, q in enumerate(self._queues.values())
            if len(q) % self.max_batch
            and q[len(q) - len(q) % self.max_batch].deadline(self.slo_s)
            <= now])
        done: List[int] = []
        for i, key in enumerate(list(self._queues)):
            q = self._queues[key]
            while len(q) >= self.max_batch:
                batch = q[:self.max_batch]
                del q[:self.max_batch]
                done += self._dispatch(key, batch)
            if q and i in due:
                batch = list(q)
                q.clear()
                done += self._dispatch(key, batch)
            if not q:
                self._queues.pop(key, None)
        return done

    def flush(self) -> List[int]:
        """Dispatch everything queued regardless of SLO/size."""
        done: List[int] = []
        for key in list(self._queues):
            done += self._dispatch(key, self._queues.pop(key))
        return done

    def result(self, ticket: int) -> DBCSRMatrix:
        """Pop a settled ticket: returns the product, or re-raises the
        stored exception for an errored ticket.  Raises
        ``TicketPendingError`` while the ticket is still queued
        (``poll()``/``flush()`` first) and ``UnknownTicketError`` for a
        ticket that was never submitted or was already retrieved (both
        are ``KeyError`` subclasses)."""
        if ticket in self._results:
            return self._results.pop(ticket)
        if ticket in self._errors:
            raise self._errors.pop(ticket)
        if ticket in self._pending_tickets:
            raise TicketPendingError(
                f"ticket {ticket} is still queued; call poll()/flush()")
        raise UnknownTicketError(
            f"ticket {ticket} was never submitted or already retrieved")

    @property
    def n_pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # -- dispatch ------------------------------------------------------
    def _check_fault(self, stage: str, attempt: int) -> None:
        if self.fault_injector is not None:
            self.fault_injector.check(stage=stage, attempt=attempt)

    def _deliver(self, key: tuple, batch: List[PendingRequest], results,
                 report, *, fused: bool, stage: str, n_errors: int = 0):
        """Record one drained bucket: results (finite-screened), bucket
        report, counters, latencies."""
        t_done = self.clock()
        self._counter("dispatches").inc()
        for r, c in zip(batch, results):
            if c is None:
                continue  # error ticket already recorded by the caller
            if self.check_finite and not guards.all_finite(c.data):
                self._set_error(r.ticket, guards.NonFiniteResultError(
                    f"request {r.ticket}: product contains NaN/Inf "
                    f"(result tripwire)"))
                self._counter("nonfinite_quarantined").inc()
                n_errors += 1
                continue
            self._results[r.ticket] = c
            self._pending_tickets.discard(r.ticket)
            self._latency_hist().observe(t_done - r.submit_t)
        if fused:
            self._counter("fused_requests").inc(len(batch))
        else:
            self._counter("looped_requests").inc(len(batch))
        self._bucket_reports.append({
            "key": key, "n_requests": len(batch), "fused": fused,
            "stage": stage, "n_errors": n_errors, "report": report})

    def _set_error(self, ticket: int, exc: BaseException) -> None:
        self._errors[ticket] = exc
        self._pending_tickets.discard(ticket)
        self._counter("error_tickets").inc()

    def _dispatch(self, key: tuple, batch: List[PendingRequest]) -> List[int]:
        """Drain one bucket through the degradation ladder.  NEVER
        raises: every ticket in ``batch`` ends settled — with a result
        or with a retrievable error."""
        pairs = [(r.a, r.b) for r in batch]
        # ladder rungs above per-request isolation: the pinned or planned
        # batched dispatch first (retried — transient failures), then
        # the looped bucket (skipped when fused=False already IS the
        # first rung)
        stages = []
        if self.fused is not False:
            stages.append(("fused", self.fused))
        stages.append(("looped", False))
        for si, (stage, fused_arg) in enumerate(stages):
            attempts = 1 + (self.max_retries if si == 0 else 0)
            for attempt in range(attempts):
                try:
                    self._check_fault(stage, attempt)
                    results, report = multiply_batched(
                        pairs, mesh=self.mesh, filter_eps=self.filter_eps,
                        fused=fused_arg, return_plan=True, **self.kw)
                except Exception:
                    if attempt + 1 < attempts:
                        self._counter("retries").inc()
                        self.sleep(self.backoff_s * (2 ** attempt))
                    continue
                fused = bool(report["buckets"]
                             and all(b["fused"] for b in report["buckets"]))
                self._deliver(key, batch, results, report,
                              fused=fused, stage=stage)
                return [r.ticket for r in batch]
            self._counter("degradations").inc()
        # final rung: per-request isolation — a poison request is
        # quarantined with its own error ticket, batch-mates complete
        results: List[Optional[DBCSRMatrix]] = []
        n_errors = 0
        for r in batch:
            try:
                self._check_fault("per_request", 0)
                results.append(multiply(
                    r.a, r.b, mesh=self.mesh, filter_eps=self.filter_eps,
                    **self.kw))
            except Exception as exc:
                self._set_error(r.ticket, exc)
                results.append(None)
                n_errors += 1
        self._deliver(key, batch, results, None, fused=False,
                      stage="per_request", n_errors=n_errors)
        return [r.ticket for r in batch]

    # -- observability -------------------------------------------------
    def stats(self) -> dict:
        """Legacy stats dict, now a thin view over the obs metrics
        registry (``service.*`` metrics labeled with this instance's
        ``service=`` id).  Keys and values are unchanged; the histogram
        percentiles match ``np.percentile(..., 'linear')`` exactly."""
        lat = self._latency_hist()
        return {
            "n_requests": int(self._counter("requests").value),
            "n_pending": self.n_pending,
            "n_completed": lat.count,
            "n_dispatches": int(self._counter("dispatches").value),
            "n_fused_requests": int(self._counter("fused_requests").value),
            "n_looped_requests": int(self._counter("looped_requests").value),
            "n_retries": int(self._counter("retries").value),
            "n_degradations": int(self._counter("degradations").value),
            "n_error_tickets": int(self._counter("error_tickets").value),
            "n_nonfinite_quarantined": int(
                self._counter("nonfinite_quarantined").value),
            "latency_p50_s": lat.percentile(50),
            "latency_p99_s": lat.percentile(99),
            "buckets": list(self._bucket_reports),
        }
