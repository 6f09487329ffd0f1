"""Process-wide metrics registry: counters, gauges, bounded histograms.

Copied from ``tpudl/obs/metrics.py`` (the ``Counter``/``Gauge``/
``Histogram`` types, the registry and its module-level accessors), minus
the JSONL sink and the lock sanitizer hooks, which later ports bring.
Names follow the reference's dotted ``layer.component.metric``
convention, so ``lm.embed.rows`` means the same in both packages.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "counter", "gauge", "histogram", "snapshot",
           "timed", "percentile"]

DEFAULT_SAMPLE_CAP = 4096


def percentile(sorted_xs, q: float):
    """Nearest-rank percentile of an ascending-sorted sequence (``None``
    when empty)."""
    if not sorted_xs:
        return None
    return sorted_xs[min(len(sorted_xs) - 1, int(q * len(sorted_xs)))]


class Counter:
    """Monotonic counter (float increments allowed)."""

    kind = "counter"
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0):
        a = float(amount)
        with self._lock:
            self.value += a

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-value gauge with running mean/max over every ``set``."""

    kind = "gauge"
    __slots__ = ("value", "count", "total", "max", "_lock")

    def __init__(self):
        self.value = None
        self.count = 0
        self.total = 0.0
        self.max = None
        self._lock = threading.Lock()

    def set(self, value: float):
        v = float(value)
        with self._lock:
            self.value = v
            self.count += 1
            self.total += v
            self.max = v if self.max is None else max(self.max, v)

    def to_dict(self) -> dict:
        with self._lock:
            return {"type": "gauge", "value": self.value,
                    "count": self.count, "max": self.max,
                    "mean": (self.total / self.count) if self.count else None}


class Histogram:
    """Bounded-memory sample distribution: the last ``cap`` samples for
    percentiles, running count/sum/min/max over all of them."""

    kind = "histogram"
    __slots__ = ("samples", "count", "total", "min", "max", "_lock")

    def __init__(self, cap: int = DEFAULT_SAMPLE_CAP):
        self.samples: deque = deque(maxlen=max(1, int(cap)))
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._lock = threading.Lock()

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            self.samples.append(v)
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def to_dict(self) -> dict:
        with self._lock:
            ring = sorted(self.samples)
            return {
                "type": "histogram", "count": self.count,
                "sum": self.total, "min": self.min, "max": self.max,
                "mean": (self.total / self.count) if self.count else None,
                "p50": percentile(ring, 0.50),
                "p95": percentile(ring, 0.95),
                "p99": percentile(ring, 0.99),
            }


class MetricsRegistry:
    """Thread-safe name → metric map; a name pins its kind."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(**kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  cap: int = DEFAULT_SAMPLE_CAP) -> Histogram:
        return self._get(name, Histogram, cap=cap)

    def snapshot(self, prefix=None) -> dict:
        with self._lock:
            items = [(name, m) for name, m in self._metrics.items()
                     if prefix is None or name.startswith(prefix)]
        return {name: m.to_dict() for name, m in sorted(items)}


_REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, cap: int = DEFAULT_SAMPLE_CAP) -> Histogram:
    return _REGISTRY.histogram(name, cap=cap)


def snapshot(prefix=None) -> dict:
    return _REGISTRY.snapshot(prefix=prefix)


@contextlib.contextmanager
def timed(name: str):
    """Histogram-observe the enclosed block's wall seconds."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _REGISTRY.histogram(name).observe(time.perf_counter() - t0)
