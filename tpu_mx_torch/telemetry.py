"""Runtime telemetry: the counter/gauge/histogram subset the port calls.

A copy of the registry core of ``tpu_mx/telemetry.py`` (stdlib only, so
copied rather than imported — importing ``tpu_mx`` would import jax).
Metric names are the reference's (``serve.*``), so a dashboard reads
both packages alike.  The sliding windows, the JSONL exporter, the
Prometheus exposition and the profiler bridge are not ported yet
(ROADMAP queue A, runtime planes).
"""
from __future__ import annotations

import math
import threading

from .base import refuse_unported

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "get", "reset"]

_lock = threading.Lock()
_metrics = {}


def _labels_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    __slots__ = ("name", "labels")
    kind = None

    def __init__(self, name, labels):
        self.name = name
        self.labels = labels


class Counter(_Metric):
    """Monotonically increasing count (resets only with the process)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = 0

    def inc(self, n=1):
        with _lock:
            self.value += n
        return self


class Gauge(_Metric):
    """Last-written value (e.g. tokens/sec)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = 0.0

    def set(self, value):
        with _lock:
            self.value = float(value)
        return self


class Histogram(_Metric):
    """Count, sum, min and max of the observed values.  Non-finite
    samples are dropped and counted (``dropped_nonfinite``), as in the
    reference: they have no honest bucket and would poison the sum."""

    __slots__ = ("count", "sum", "min", "max", "dropped_nonfinite", "unit")
    kind = "histogram"

    def __init__(self, name, labels, buckets=None, unit="seconds"):
        super().__init__(name, labels)
        refuse_unported("Histogram", "A15 (telemetry windows)",
                        buckets=(buckets, None))
        self.unit = unit
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.dropped_nonfinite = 0

    def observe(self, value):
        value = float(value)
        with _lock:
            if not math.isfinite(value):
                self.dropped_nonfinite += 1
                return self
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
        return self


def _get_or_make(cls, name, labels, **kwargs):
    key = (name, _labels_key(labels))
    with _lock:
        m = _metrics.get(key)
        if m is None:
            m = _metrics[key] = cls(name, key[1], **kwargs)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        return m


def counter(name, **labels):
    """Create-or-fetch the Counter ``name`` (labels make distinct series)."""
    return _get_or_make(Counter, name, labels)


def gauge(name, **labels):
    """Create-or-fetch the Gauge ``name``."""
    return _get_or_make(Gauge, name, labels)


def histogram(name, buckets=None, unit="seconds", **labels):
    """Create-or-fetch the Histogram ``name`` (``buckets``, the
    reference's quantile buckets, must stay None: not ported yet)."""
    return _get_or_make(Histogram, name, labels, buckets=buckets, unit=unit)


def get(name, **labels):
    """The already-registered metric, or None (no create side effect)."""
    with _lock:
        return _metrics.get((name, _labels_key(labels)))


def reset():
    """Drop every metric (test hook)."""
    with _lock:
        _metrics.clear()
