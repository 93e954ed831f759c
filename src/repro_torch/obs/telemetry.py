"""Structured spans and the predicted-vs-actual plan-outcome log (the
port's copy of the JAX package's ``obs/telemetry.py``).

A :class:`Tracer` records :class:`SpanRecord` rows — host-side timed
intervals with parent/child nesting — for the multiply pipeline:

    multiply                       (root, one per dbcsr.multiply)
      plan                         planner decision
      dispatch                     the schedule's run, up to a synchronize
                                   on the mesh's device; on a CUDA mesh
                                   it also carries ``device_s`` (a pair
                                   of CUDA events around the same run)
        prologue / step[t] / epilogue   schedule model, scaled to fit
          comm, stacks                  the measured dispatch wall time
      verify                       ABFT checksum verification
        repair                     re-execution after a detection
          dispatch ...

Telemetry is OFF by default and the contract is *zero overhead, bit
identical results* when off: every entry point resolves one per-call
flag, ``recording()`` (``enabled()`` and not ``vetoed()``: torch.compile
tracing the caller, or a CUDA graph capturing the current stream, where
the JAX package tests for a ``jax.core.Tracer`` operand), and skips
every span, timing, CUDA event and synchronize when it is false.
``span()`` returns a shared no-op object when disabled, so stray call
sites cost one attribute check.

Host ranges.  While a ``torch.profiler`` is recording, every span also
opens a host range ``dbcsr.<name>`` on the profiler's clock, so the
card's idle gaps in a device trace fall under the port's own layers.
A multiply resolves a second per-call flag, ``ranging()`` (a profiler
is recording and the call is not vetoed), and with it alone, telemetry
off, it opens ranges and nothing else: no ``SpanRecord``, no timing,
synchronize or registry entry.  ``maybe_range`` marks the layers below
the span tree (``local``, ``pack``, ``launch``, ``unpack``, ``stats``,
``result_mask``) and ``maybe_span(..., rng=)`` a span site whose span
is off.  A range is a ``_RecordFunctionFast`` (~0.6 us a range while
recording); with no profiler neither is constructed.

``enable(log_dir=...)`` additionally appends every completed trace to
``<log_dir>/events.jsonl`` and every plan outcome (predicted vs
measured cost per executed plan) to ``<log_dir>/plan_outcomes.jsonl``
— the file ``planner.calibrate --check-drift`` consumes.

This module imports nothing from ``repro_torch.core`` /
``repro_torch.planner`` (they import us), and torch only inside
``vetoed()``, ``ranging()`` and the range itself.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Dict, List, Optional

__all__ = [
    "SpanRecord", "Tracer", "enable", "disable", "enabled",
    "recording", "vetoed", "get_tracer", "span", "maybe_span", "event",
    "last_trace",
    "record_plan_outcome", "plan_outcomes", "clear_plan_outcomes",
    "EVENTS_LOG", "PLAN_OUTCOMES_LOG",
]

EVENTS_LOG = "events.jsonl"
PLAN_OUTCOMES_LOG = "plan_outcomes.jsonl"
RANGE_PREFIX = "dbcsr."


@dataclasses.dataclass
class SpanRecord:
    """One timed interval.  ``t0`` is ``time.perf_counter()`` seconds;
    ``dur`` is seconds (synthetic schedule-step spans get explicit
    ``t0``/``dur`` carved out of the measured dispatch interval)."""

    name: str
    cat: str
    span_id: int
    parent_id: Optional[int]
    trace_id: int
    t0: float
    dur: float = -1.0
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name, "cat": self.cat, "span_id": self.span_id,
            "parent_id": self.parent_id, "trace_id": self.trace_id,
            "t0": self.t0, "dur": self.dur, "attrs": dict(self.attrs),
        }

    @staticmethod
    def from_dict(d: dict) -> "SpanRecord":
        return SpanRecord(
            name=d["name"], cat=d.get("cat", "span"),
            span_id=int(d["span_id"]), parent_id=d.get("parent_id"),
            trace_id=int(d.get("trace_id", d["span_id"])),
            t0=float(d["t0"]), dur=float(d["dur"]),
            attrs=dict(d.get("attrs") or {}))


class _ActiveSpan:
    """Context manager for an open span; ``set()`` attaches attrs.
    ``rng`` is the span's host range while a profiler records, else
    None."""

    __slots__ = ("_tracer", "rec", "_rng")

    def __init__(self, tracer: "Tracer", rec: SpanRecord, rng=None):
        self._tracer = tracer
        self.rec = rec
        self._rng = rng

    def set(self, **attrs) -> None:
        self.rec.attrs.update(attrs)

    def __enter__(self) -> "_ActiveSpan":
        if self._rng is not None:
            self._rng.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.rec.attrs.setdefault("error", exc_type.__name__)
        self._tracer.end(self.rec)
        if self._rng is not None:
            self._rng.__exit__(exc_type, exc, tb)
        return False


class _Range:
    """A host range ``dbcsr.<name>`` on the profiler's clock, with the
    span interface (``set()`` does nothing, ``rec`` is None)."""

    __slots__ = ("_rf",)
    rec = None

    def __init__(self, name: str):
        from torch._C._profiler import _RecordFunctionFast

        self._rf = _RecordFunctionFast(RANGE_PREFIX + name)

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Range":
        self._rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._rf.__exit__(exc_type, exc, tb)
        return False


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()
    rec = None

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Collects spans; nesting follows an explicit begin/end stack."""

    def __init__(self, log_dir: Optional[str] = None):
        self.spans: List[SpanRecord] = []
        self.log_dir = log_dir
        self._stack: List[SpanRecord] = []
        self._ids = itertools.count(1)
        self._root_ids: List[int] = []

    # -- core span lifecycle -------------------------------------------
    def begin(self, name: str, cat: str = "span", **attrs) -> SpanRecord:
        parent = self._stack[-1] if self._stack else None
        sid = next(self._ids)
        rec = SpanRecord(
            name=name, cat=cat, span_id=sid,
            parent_id=parent.span_id if parent else None,
            trace_id=parent.trace_id if parent else sid,
            t0=time.perf_counter(), attrs=dict(attrs))
        self._stack.append(rec)
        return rec

    def end(self, rec: SpanRecord) -> None:
        rec.dur = time.perf_counter() - rec.t0
        # tolerate a stack skew from an exception mid-span: pop to rec
        while self._stack:
            top = self._stack.pop()
            if top is rec:
                break
        self.spans.append(rec)
        if rec.parent_id is None:
            self._root_ids.append(rec.span_id)
            self._flush_trace(rec)

    def emit(self, name: str, cat: str, *, t0: float, dur: float,
             parent: Optional[SpanRecord] = None,
             attrs: Optional[dict] = None) -> SpanRecord:
        """Append a synthetic (already-timed) span, e.g. schedule-step
        intervals carved out of a measured dispatch."""
        rec = SpanRecord(
            name=name, cat=cat, span_id=next(self._ids),
            parent_id=parent.span_id if parent is not None else None,
            trace_id=(parent.trace_id if parent is not None
                      else next(self._ids)),
            t0=float(t0), dur=float(dur), attrs=dict(attrs or {}))
        self.spans.append(rec)
        return rec

    def span(self, name: str, cat: str = "span", **attrs) -> _ActiveSpan:
        rng = _Range(name) if ranging() else None
        return _ActiveSpan(self, self.begin(name, cat, **attrs), rng)

    def current(self) -> Optional[SpanRecord]:
        return self._stack[-1] if self._stack else None

    # -- trace queries -------------------------------------------------
    def trace(self, trace_id: int) -> List[SpanRecord]:
        out = [s for s in self.spans if s.trace_id == trace_id]
        out.sort(key=lambda s: (s.t0, s.span_id))
        return out

    def last_trace(self) -> List[SpanRecord]:
        if not self._root_ids:
            return []
        return self.trace(self._root_ids[-1])

    def clear(self) -> None:
        self.spans.clear()
        self._stack.clear()
        self._root_ids.clear()

    # -- JSONL event log -----------------------------------------------
    def _flush_trace(self, root: SpanRecord) -> None:
        if not self.log_dir:
            return
        path = os.path.join(self.log_dir, EVENTS_LOG)
        with open(path, "a") as f:
            for s in self.trace(root.trace_id):
                f.write(json.dumps(s.to_dict()) + "\n")


# -- module state ------------------------------------------------------
_ENABLED = False
_TRACER: Optional[Tracer] = None
_LOG_DIR: Optional[str] = None
_PLAN_OUTCOMES: List[dict] = []


def enable(log_dir: Optional[str] = None, *, reset: bool = True) -> Tracer:
    """Turn telemetry on.  ``log_dir`` additionally streams completed
    traces and plan outcomes to JSONL files there.  ``reset=False``
    keeps an existing tracer's spans across enable/disable cycles."""
    global _ENABLED, _TRACER, _LOG_DIR
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    _LOG_DIR = log_dir
    if _TRACER is None or reset:
        _TRACER = Tracer(log_dir=log_dir)
    else:
        _TRACER.log_dir = log_dir
    _ENABLED = True
    return _TRACER


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def vetoed() -> bool:
    """True while the caller cannot be recorded: ``torch.compile`` is
    tracing it, or the current CUDA stream is capturing a graph (a span
    there would time the capture, not a run, and a synchronize would
    break it).  The JAX package's veto is a ``jax.core.Tracer``
    operand."""
    import torch

    if torch.compiler.is_compiling():
        return True
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def recording() -> bool:
    """The per-call telemetry flag every entry point resolves once:
    telemetry is on and the call is not vetoed.  With telemetry off it
    costs one bool test."""
    return _ENABLED and not vetoed()


def ranging() -> bool:
    """The per-call range flag: a torch profiler is recording and the
    call is not vetoed.  With no profiler it costs two C calls (~0.1
    us); ``torch.compile`` tracing the caller stops at the first."""
    import torch

    return (not torch.compiler.is_compiling()
            and torch._C._autograd._profiler_enabled() and not vetoed())


def maybe_range(cond: bool, name: str):
    """A ``dbcsr.<name>`` host range gated on the per-call range flag
    (``ranging()``): no span, only the profiler's range; the shared
    no-op span when ``cond`` is false."""
    return _Range(name) if cond else NOOP_SPAN


def get_tracer() -> Optional[Tracer]:
    return _TRACER if _ENABLED else None


def span(name: str, cat: str = "span", **attrs):
    """Open a span on the active tracer; no-op when disabled."""
    if not _ENABLED or _TRACER is None:
        return NOOP_SPAN
    return _TRACER.span(name, cat, **attrs)


def maybe_span(cond: bool, name: str, cat: str = "span", *,
               rng: bool = False, **attrs):
    """``span()`` gated on a call-site flag (the per-call ``_tele``
    bool from ``recording()``; the span opens its own range while a
    profiler records); with it false, the span's host range alone when
    ``rng`` (the per-call ``ranging()`` flag), else the shared no-op
    span."""
    if not cond:
        return _Range(name) if rng else NOOP_SPAN
    return span(name, cat, **attrs)


def event(name: str, cat: str = "event", **attrs) -> None:
    """Zero-duration marker attached to the innermost open span."""
    if not _ENABLED or _TRACER is None:
        return
    t = time.perf_counter()
    _TRACER.emit(name, cat, t0=t, dur=0.0, parent=_TRACER.current(),
                 attrs=attrs)


def last_trace() -> List[SpanRecord]:
    return _TRACER.last_trace() if _TRACER is not None else []


# -- predicted-vs-actual planner accounting ----------------------------
def record_plan_outcome(**fields) -> None:
    """Log one executed plan: ``algorithm``, ``predicted_s``,
    ``measured_s`` plus free-form context (geometry, densify,
    occupancy).  Feeds the planner scoreboard and
    ``planner.calibrate --check-drift``."""
    if not _ENABLED:
        return
    rec = dict(fields)
    _PLAN_OUTCOMES.append(rec)
    if _LOG_DIR:
        path = os.path.join(_LOG_DIR, PLAN_OUTCOMES_LOG)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def plan_outcomes() -> List[dict]:
    return list(_PLAN_OUTCOMES)


def clear_plan_outcomes() -> None:
    _PLAN_OUTCOMES.clear()
