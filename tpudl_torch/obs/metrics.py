"""Process-wide metrics registry: counters, gauges, bounded histograms.

Port of ``tpudl/obs/metrics.py`` (with its lock sanitizer's hooks).
Every layer (the executor, the image reads, the stages, HPO, UDFs, the
trainer, the serve plane) publishes into ONE thread-safe registry, so a
run's numbers come out of one ``snapshot()``. Opt-in JSONL sink: with
``TPUDL_METRICS_FILE`` set, snapshots stream to that file (throttled to
one per ``TPUDL_METRICS_FLUSH_S`` seconds, default 60) plus one ``final``
line at exit, in the schema tpudl's ``tools/validate_metrics.py`` checks.

Names follow tpudl's dotted ``layer.component.metric`` convention
(``frame.map_batches.runs``, ``imageio.files_read``,
``train.step_seconds``), so a name means the same in both packages. One
metric update is a lock and a few scalar ops.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import time
from collections import deque

from tpudl_torch.testing import tsan as _tsan

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "counter", "gauge", "histogram", "snapshot",
           "flush_metrics", "Meter", "timed", "percentile"]

# per-histogram/gauge retained samples; running aggregates keep
# mean/max exact over ALL samples no matter the cap
DEFAULT_SAMPLE_CAP = 4096


# copied from tpudl/obs/metrics.py:percentile
def percentile(sorted_xs, q: float):
    """Nearest-rank percentile of an ASCENDING-sorted sequence
    (``None`` when empty) — THE percentile for every obs/serve
    consumer: histograms, the serve load generator, the SLO window.
    One definition so a load generator's p99 and an obs p99 can never disagree by
    implementation."""
    if not sorted_xs:
        return None
    return sorted_xs[min(len(sorted_xs) - 1, int(q * len(sorted_xs)))]


# copied from tpudl/obs/metrics.py:_env_float
def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# copied from tpudl/obs/metrics.py:Counter
class Counter:
    """Monotonic counter (float increments allowed: seconds/bytes
    accumulate through the same type)."""

    kind = "counter"
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = _tsan.named_lock("obs.metrics.counter")

    def inc(self, amount: float = 1.0):
        a = float(amount)  # numpy scalars would poison the JSON sink
        with self._lock:
            self.value += a

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}


# copied from tpudl/obs/metrics.py:Gauge
class Gauge:
    """Last-value gauge with running mean/max over every ``set``."""

    kind = "gauge"
    __slots__ = ("value", "count", "total", "max", "_lock")

    def __init__(self):
        self.value = None
        self.count = 0
        self.total = 0.0
        self.max = None
        self._lock = _tsan.named_lock("obs.metrics.gauge")

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


# copied from tpudl/obs/metrics.py:Histogram
class Histogram:
    """Bounded-memory sample distribution.

    Keeps the last ``cap`` samples (ring) for percentiles, plus running
    count/sum/min/max so mean and extremes stay exact over ALL samples —
    a long streaming run can observe forever in O(cap) memory.
    """

    kind = "histogram"
    __slots__ = ("samples", "count", "total", "min", "max", "_lock")

    def __init__(self, cap: int = DEFAULT_SAMPLE_CAP):
        self.samples: deque = deque(maxlen=max(1, int(cap)))
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._lock = _tsan.named_lock("obs.metrics.histogram")

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            self.samples.append(v)
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    def _percentile(self, sorted_ring: list, q: float):
        return percentile(sorted_ring, q)

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


# copied from tpudl/obs/metrics.py:MetricsRegistry
class MetricsRegistry:
    """Thread-safe name → metric map with an opt-in JSONL sink.

    ``counter``/``gauge``/``histogram`` get-or-create by name (a name
    pins its kind — asking for the same name as a different kind
    raises: silent kind aliasing would corrupt the emission schema).
    ``snapshot()`` returns a plain-dict view of everything. The sink
    (``TPUDL_METRICS_FILE``) appends one JSON line per flush; periodic
    flushes piggyback on metric updates, throttled to one per
    ``TPUDL_METRICS_FLUSH_S`` (default 60) seconds, and ``atexit``
    writes a ``final`` line.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = _tsan.named_lock("obs.metrics.registry")
        self._next_flush = 0.0  # monotonic deadline; 0 = resolve lazily
        self._atexit_registered = False

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                if _tsan.ENABLED:
                    _tsan.check_guarded("obs.metrics.registry",
                                        "metrics registry name map",
                                        lock=self._lock)
                m = self._metrics[name] = cls(**kw)
                self._register_atexit()
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
        """Get-or-create by name. ``cap`` is a CREATION-time parameter:
        the first call for a name fixes its sample ring; later calls
        return the existing histogram regardless of ``cap`` (running
        aggregates are exact either way — only percentile window width
        is at stake)."""
        return self._get(name, Histogram, cap=cap)

    def snapshot(self, prefix=None) -> dict:
        """Plain-dict view of the registry. ``prefix`` (a string or a
        tuple of strings, as for ``str.startswith``) filters INSIDE the
        lock so per-tick readers — the 1 Hz status writer, the SLO
        engine — copy and serialize only the names they render instead
        of the whole registry."""
        with self._lock:
            items = [(name, m) for name, m in self._metrics.items()
                     if prefix is None or name.startswith(prefix)]
        return {name: m.to_dict() for name, m in sorted(items)}

    def reset(self):
        """Drop every metric (tests; a process restart equivalent)."""
        with self._lock:
            self._metrics.clear()
            self._next_flush = 0.0

    # -- sink --------------------------------------------------------------
    def _register_atexit(self):
        if not self._atexit_registered:
            self._atexit_registered = True
            atexit.register(self.flush, event="final")

    def sink_path(self) -> str | None:
        # read per flush attempt (flushes are throttled) so tests and
        # late `export TPUDL_METRICS_FILE=...` both take effect
        return os.environ.get("TPUDL_METRICS_FILE") or None

    def maybe_flush(self):
        """Throttled periodic flush — call from update paths that want
        long runs to stream snapshots without owning a timer thread.
        The deadline check-and-set is lock-guarded so two threads
        passing the throttle together cannot both append (duplicate or
        interleaved snapshot lines)."""
        now = time.monotonic()
        if now < self._next_flush:  # cheap unlocked fast path
            return False
        with self._lock:
            if now < self._next_flush:
                return False
            self._next_flush = now + _env_float("TPUDL_METRICS_FLUSH_S",
                                                60.0)
        return self.flush(event="snapshot")

    def flush(self, event: str = "snapshot") -> bool:
        """Append one JSONL line (the validate_metrics.py schema) to the
        sink; no-op without ``TPUDL_METRICS_FILE``. Never raises — a
        full disk must not take down the pipeline being observed."""
        path = self.sink_path()
        if not path:
            return False
        line = {"ts": time.time(), "event": event, "pid": os.getpid(),
                "metrics": self.snapshot()}
        try:
            with open(path, "a") as f:
                f.write(json.dumps(line) + "\n")
            return True
        except (OSError, TypeError, ValueError):
            # full disk or an unserializable stray value: the pipeline
            # being observed must not die for its observer
            return False


_REGISTRY = MetricsRegistry()


# copied from tpudl/obs/metrics.py:get_registry
def get_registry() -> MetricsRegistry:
    return _REGISTRY


# copied from tpudl/obs/metrics.py:counter
def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


# copied from tpudl/obs/metrics.py:gauge
def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


# copied from tpudl/obs/metrics.py:histogram
def histogram(name: str, cap: int = DEFAULT_SAMPLE_CAP) -> Histogram:
    return _REGISTRY.histogram(name, cap=cap)


# copied from tpudl/obs/metrics.py:snapshot
def snapshot(prefix=None) -> dict:
    return _REGISTRY.snapshot(prefix=prefix)


# copied from tpudl/obs/metrics.py:flush_metrics
def flush_metrics(event: str = "snapshot") -> bool:
    return _REGISTRY.flush(event=event)


# copied from tpudl/obs/metrics.py:timed
@contextlib.contextmanager
def timed(name: str):
    """Histogram-observe the enclosed block's wall seconds (and give the
    periodic sink a chance to flush — instrumented call sites need no
    extra plumbing for long-run streaming)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _REGISTRY.histogram(name).observe(time.perf_counter() - t0)
        _REGISTRY.maybe_flush()


# copied from tpudl/obs/metrics.py:Meter
class Meter:
    """Throughput/latency meter for the executor hot loop.

    ``with meter.batch(n):`` around each device call; ``meter.report()``
    yields {examples, seconds, examples_per_sec, examples_per_sec_per_chip}.
    Warmup batches (compile) can be excluded via ``skip`` — report both
    cold and warm numbers, never silently drop the compile cost.

    Edge cases are clamped, not silent: a negative
    ``skip`` counts everything; ``skip >= len(batches)`` keeps the LAST
    batch (an all-warmup report claiming 0 examples hid real runs), and
    the report surfaces ``skipped`` so the clamp is visible.
    """

    def __init__(self, n_chips: int = 1, skip: int = 0):
        self.n_chips = max(1, int(n_chips))
        self.skip = int(skip)
        self._batches: list[tuple[int, float]] = []

    @contextlib.contextmanager
    def batch(self, n_examples: int):
        t0 = time.perf_counter()
        yield
        self._batches.append((int(n_examples), time.perf_counter() - t0))

    def _effective_skip(self) -> int:
        n = len(self._batches)
        skip = min(max(0, self.skip), n)
        if n and skip == n:
            skip = n - 1  # keep at least one measured batch
        return skip

    def report(self) -> dict:
        skip = self._effective_skip()
        counted = self._batches[skip:]
        ex = sum(n for n, _ in counted)
        secs = sum(t for _, t in counted)
        all_ex = sum(n for n, _ in self._batches)
        all_secs = sum(t for _, t in self._batches)
        eps = ex / secs if secs > 0 else 0.0
        return {
            "examples": ex,
            "seconds": round(secs, 4),
            "examples_per_sec": round(eps, 2),
            "examples_per_sec_per_chip": round(eps / self.n_chips, 2),
            "cold_examples_per_sec": round(all_ex / all_secs, 2)
            if all_secs > 0 else 0.0,
            "batches": len(self._batches),
            "skipped": skip,
        }

    def json_line(self, metric: str, baseline: float | None = None,
                  extra: dict | None = None) -> str:
        r = self.report()
        value = r["examples_per_sec_per_chip"]
        out = {
            "metric": metric,
            "value": value,
            "unit": "images/sec/chip",
            "vs_baseline": round(value / baseline, 3) if baseline else None,
        }
        if extra:
            out.update(extra)
        return json.dumps(out)
