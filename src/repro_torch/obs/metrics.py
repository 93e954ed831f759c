"""Process-wide metrics registry: counters, gauges, histograms.

One source of truth for every number the library already reports
through ad-hoc ``stats()`` dicts — plan-cache hits, service
retries/degradations, ABFT detections, fused-vs-looped dispatch
decisions, request latency percentiles.  Publishers call
``counter(name, **labels).inc()`` etc.; the legacy ``stats()`` views
read the same objects back so callers keep their old dict shapes.

Metrics are keyed on ``(kind, name, sorted(labels))`` so the same
name may carry different label sets (e.g. one counter per
``MultiplyService`` instance via ``service=<name>``).

The port's copy of the JAX package's ``obs/metrics.py`` (pure Python,
imported by neither package from the other).  It imports nothing from
``repro_torch.core``, and nothing heavyweight.  Like the rest of the
library it is single-threaded by design: no locks.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "registry", "counter", "gauge", "histogram", "metrics_snapshot",
    "clear_metrics",
]

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, object]) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count (events, bytes, flops)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelsKey):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name!r}: negative inc {v}")
        self.value += v


class Gauge:
    """Last-set value, with a bounded sample history so callers can
    render decay curves (e.g. purification occupancy per iteration)."""

    __slots__ = ("name", "labels", "value", "samples", "max_samples")

    def __init__(self, name: str, labels: LabelsKey, max_samples: int = 4096):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self.samples: List[float] = []
        self.max_samples = max_samples

    def set(self, v: float) -> None:
        self.value = float(v)
        self.samples.append(self.value)
        if len(self.samples) > self.max_samples:
            del self.samples[: len(self.samples) - self.max_samples]


class Histogram:
    """Stored-sample histogram with exact percentiles.

    Sample counts here are small (per-request latencies, per-plan
    occupancies), so we keep raw values rather than buckets; the
    percentile math matches ``np.percentile(..., interpolation=
    'linear')`` so the service's legacy p50/p99 stay bit-identical.
    """

    __slots__ = ("name", "labels", "values", "max_samples", "_n_dropped")

    def __init__(self, name: str, labels: LabelsKey,
                 max_samples: int = 65536):
        self.name = name
        self.labels = labels
        self.values: List[float] = []
        self.max_samples = max_samples
        self._n_dropped = 0

    def observe(self, v: float) -> None:
        if len(self.values) >= self.max_samples:
            self._n_dropped += 1
            return
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values) + self._n_dropped

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    def percentile(self, p: float) -> float:
        """Linear-interpolation percentile (numpy-compatible)."""
        if not self.values:
            return 0.0
        vals = sorted(self.values)
        if len(vals) == 1:
            return vals[0]
        rank = (p / 100.0) * (len(vals) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(vals) - 1)
        frac = rank - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac


class MetricsRegistry:
    """Keyed store of Counter/Gauge/Histogram instances.

    ``counter()``/``gauge()``/``histogram()`` are get-or-create: the
    first call mints the metric, later calls return the same object,
    so publishers never need registration boilerplate.
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, str, LabelsKey], object] = {}

    def _get(self, kind: str, cls, name: str, labels: Dict[str, object],
             **kw):
        key = (kind, name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[2], **kw)
            self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        return any(k[1] == name for k in self._metrics)

    def clear(self) -> None:
        self._metrics.clear()

    def snapshot(self) -> Dict[str, dict]:
        """JSON-ready dump: ``{kind: {"name{a=b}": summary}}``."""
        out: Dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for (kind, name, labels), m in sorted(self._metrics.items()):
            label_s = ",".join(f"{k}={v}" for k, v in labels)
            full = f"{name}{{{label_s}}}" if label_s else name
            if kind == "counter":
                out["counters"][full] = m.value
            elif kind == "gauge":
                out["gauges"][full] = {"value": m.value,
                                       "samples": list(m.samples)}
            else:
                out["histograms"][full] = {
                    "count": m.count, "sum": m.sum,
                    "p50": m.percentile(50), "p99": m.percentile(99),
                }
        return out


# the process-wide registry every publisher shares
REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return REGISTRY


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def metrics_snapshot() -> Dict[str, dict]:
    return REGISTRY.snapshot()


def clear_metrics() -> None:
    REGISTRY.clear()
