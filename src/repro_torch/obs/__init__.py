"""Observability: the process-wide metrics registry (counters, gauges,
histograms), a copy of the JAX package's ``obs.metrics``.  The
``MultiplyService`` keeps its counters and latencies here.  Spans,
trace export and the planner scoreboard are ROADMAP Queue A9.
"""
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      clear_metrics, counter, gauge, histogram,
                      metrics_snapshot, registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "registry", "counter", "gauge", "histogram", "metrics_snapshot",
           "clear_metrics"]
