"""repro_torch.obs — telemetry: spans, metrics, traces, scoreboard (the
port's copy of the JAX package's ``obs``).

  spans      ``span("multiply")`` nesting plan -> dispatch ->
             schedule-step -> comm/stacks, plus verify -> repair, and
             ``contract`` -> plan / matricize / multiply for tensor
             contractions, with comm-bytes/flops/occupancy attributes
             from the schedule and executor metadata; a dispatch on a
             CUDA mesh also carries its CUDA-event time ``device_s``
             (telemetry.py)
  metrics    process-wide registry of counters/gauges/histograms that
             the ``stats()`` dicts are thin views over (metrics.py)
  exporters  Chrome-trace/Perfetto JSON per multiply, JSONL event log,
             and ``python -m repro_torch.obs report`` (export.py,
             report.py)
  scoreboard predicted-vs-actual planner cost per executed algorithm,
             consumed by ``planner.calibrate --check-drift``
             (scoreboard.py)

Contract: telemetry is OFF by default, and when off the multiply paths
are bit-identical and add zero registry entries — instrumented call
sites check one per-call bool (``recording()``: enabled and neither
compiled by torch.compile nor captured into a CUDA graph) and skip all
timing/span/synchronize work.  Explicit publishers (service counters,
``plan_cache_stats()``) use the registry as their storage even when
tracing is off; that is their data living in one place, not overhead.
While a ``torch.profiler`` records, the spans and the layers below them
show as ``dbcsr.*`` host ranges (``ranging()``, telemetry.py), with
telemetry on or off.

Typical use::

    from repro_torch import obs
    obs.enable(log_dir="artifacts/obs")
    c, plan = dbcsr.multiply(a, b, mesh=mesh, return_plan=True)
    obs.write_chrome_trace("artifacts/obs/trace.json", obs.last_trace())
    print(obs.render_scoreboard(
        obs.planner_scoreboard(obs.plan_outcomes())))

This package imports nothing from ``repro_torch.core`` /
``repro_torch.planner`` (they import us).
"""
from .telemetry import (  # noqa: F401
    SpanRecord, Tracer, NOOP_SPAN, enable, disable, enabled, recording,
    vetoed, get_tracer, span, maybe_span, event, last_trace, ranging,
    maybe_range, RANGE_PREFIX,
    record_plan_outcome, plan_outcomes, clear_plan_outcomes, EVENTS_LOG,
    PLAN_OUTCOMES_LOG,
)
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, REGISTRY, registry,
    counter, gauge, histogram, metrics_snapshot, clear_metrics,
)
from .export import (  # noqa: F401
    to_chrome_trace, write_chrome_trace, validate_chrome_trace,
    write_jsonl, read_jsonl,
)
from .scoreboard import (  # noqa: F401
    planner_scoreboard, render_scoreboard, check_drift,
)
from .report import (  # noqa: F401
    category_breakdown, render_breakdown, render_timeline,
)

__all__ = [
    "SpanRecord", "Tracer", "NOOP_SPAN", "enable", "disable", "enabled",
    "recording", "vetoed",
    "get_tracer", "span", "maybe_span", "event", "last_trace",
    "record_plan_outcome", "plan_outcomes", "clear_plan_outcomes",
    "EVENTS_LOG", "PLAN_OUTCOMES_LOG",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "registry", "counter", "gauge", "histogram", "metrics_snapshot",
    "clear_metrics",
    "to_chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "write_jsonl", "read_jsonl",
    "planner_scoreboard", "render_scoreboard", "check_drift",
    "category_breakdown", "render_breakdown", "render_timeline",
]
