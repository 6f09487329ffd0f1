"""Windowed SLO engine for the serve plane.

Port of ``tpudl/obs/slo.py`` (with its lock sanitizer's hooks). It
keeps a bounded ring of ``(monotonic_t, latency_ms)`` stamps, one per
completed request, and computes over sliding windows:

- **short window** (``TPUDL_SERVE_SLO_WINDOW_S``, default 30 s): recent
  p50/p99, availability against the objective
  (``TPUDL_SERVE_SLO_P99_MS``, default 500), and the fast burn rate;
- **long window** (10× short): the slow burn rate.

``burn = (fraction of windowed requests over the objective) / 0.01``:
burn 1.0 spends the p99 objective's 1% error budget exactly as fast as
it accrues. A completed request slower than ``TPUDL_SERVE_SLO_TAIL_K`` ×
the cached windowed median is a **tail exemplar**: it lands in the
flight recorder's error ring with its segment breakdown
(queue_wait/batching/prefill/decode, :mod:`tpudl_torch.serve.reqtrace`),
which ``obs doctor``'s ``slo_burn`` rule reads. Gauges (``serve.slo.*``)
are published outside the engine's lock, throttled.
"""

from __future__ import annotations

import os
import time

from collections import deque

from tpudl_torch.obs import metrics as _metrics
from tpudl_torch.obs.metrics import percentile as _percentile
from tpudl_torch.testing import tsan as _tsan

__all__ = ["SloEngine", "get_slo_engine", "reset_slo_engine",
           "ERROR_BUDGET"]

# a p99 objective tolerates 1% of requests over target — the error
# budget every burn rate is normalized against
ERROR_BUDGET = 0.01

# stamp ring bound (matches the histogram sample cap: windows are
# honest up to this many requests per long window)
_RING_CAP = 4096

# gauge publication throttle: windows move slowly; per-request gauge
# math would be pure overhead
_PUBLISH_EVERY_S = 0.25

# tail of short-window samples exported in the status section so a
# multi-process `obs top` can merge a REAL fleet p99 (bounded: the
# status file stays a HUD, not a dump)
_STATUS_SAMPLE_TAIL = 64


# copied from tpudl/obs/slo.py:_env_float
def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# copied from tpudl/obs/slo.py:SloEngine
class SloEngine:
    """Sliding-window latency objective tracker for one process's
    serve plane. ``record()`` per completed request (hot path);
    ``compute()``/``status_section()`` for readers; ``publish()`` for
    the ``serve.slo.*`` gauges."""

    def __init__(self):
        self.target_ms = _env_float("TPUDL_SERVE_SLO_P99_MS", 500.0)
        self.window_s = max(1.0,
                            _env_float("TPUDL_SERVE_SLO_WINDOW_S", 30.0))
        self.long_window_s = 10.0 * self.window_s
        self.tail_k = max(1.0, _env_float("TPUDL_SERVE_SLO_TAIL_K", 4.0))
        self._lock = _tsan.named_lock("obs.slo.engine")
        self._stamps: deque = deque(maxlen=_RING_CAP)
        self._median_ms: float | None = None  # cached (exemplar gate)
        self._next_publish = 0.0

    # -- hot path ----------------------------------------------------------
    def record(self, req) -> None:
        """One completed request: append its stamp, capture a tail
        exemplar if it dwarfs the cached windowed median, maybe
        publish. The lock covers only the append + median read."""
        if req.latency_s is None:
            return
        lat_ms = float(req.latency_s) * 1000.0
        now = time.monotonic()
        with self._lock:
            self._stamps.append((now, lat_ms))
            median = self._median_ms
        if median and lat_ms > self.tail_k * median:
            self._exemplar(req, lat_ms, median)
        self.publish(now=now)

    def _exemplar(self, req, lat_ms: float, median: float) -> None:
        # the error ring is the forensic store: descriptors only —
        # trace id, segment milliseconds, never prompt content
        from tpudl_torch.obs import flight as _flight

        trace = getattr(req, "trace", None)
        segs = trace.segments() if trace is not None else None
        ctx = {
            "trace_id": trace.trace_id if trace is not None else None,
            "model": str(req.model),
            "latency_ms": round(lat_ms, 3),
            "window_median_ms": round(median, 3),
            "tail_k": self.tail_k,
        }
        dominant = None
        if segs:
            for name, v in segs.items():
                ctx[f"{name}_ms"] = round(v * 1000.0, 3)
            dominant = max(segs.items(), key=lambda kv: kv[1])[0]
        ctx["dominant_segment"] = dominant
        _flight.record_error(
            "serve.slo.exemplar",
            f"tail request {lat_ms:.0f}ms > {self.tail_k:g}x windowed "
            f"median {median:.0f}ms"
            + (f" (dominant segment: {dominant})" if dominant else ""),
            **ctx)
        _metrics.counter("serve.slo.exemplars").inc()

    # -- window math -------------------------------------------------------
    def _windowed(self, now: float):
        """Short- and long-window latency lists (arrival order), under
        the caller's lock."""
        t_short = now - self.window_s
        t_long = now - self.long_window_s
        short: list = []
        long_: list = []
        for t, ms in self._stamps:
            if t >= t_long:
                long_.append(ms)
                if t >= t_short:
                    short.append(ms)
        return short, long_

    @staticmethod
    def _burn(window: list, target_ms: float):
        if not window:
            return None
        over = sum(1 for ms in window if ms > target_ms)
        return (over / len(window)) / ERROR_BUDGET

    def compute(self, now: float | None = None) -> dict:
        """The full windowed view (and refresh of the cached median).
        Pure host math — safe from any thread."""
        now = time.monotonic() if now is None else now
        with self._lock:
            short, long_ = self._windowed(now)
            short_sorted = sorted(short)
            self._median_ms = _percentile(short_sorted, 0.50)
        n = len(short)
        avail = (sum(1 for ms in short if ms <= self.target_ms) / n
                 if n else None)
        return {
            "target_ms": self.target_ms,
            "window_s": self.window_s,
            "long_window_s": self.long_window_s,
            "window_n": n,
            "window_qps": round(n / self.window_s, 3),
            "window_p50_ms": _percentile(short_sorted, 0.50),
            "window_p99_ms": _percentile(short_sorted, 0.99),
            "availability": avail,
            "burn_short": self._burn(short, self.target_ms),
            "burn_long": self._burn(long_, self.target_ms),
            "window_samples_ms": [round(ms, 3)
                                  for ms in short[-_STATUS_SAMPLE_TAIL:]],
        }

    # -- publication -------------------------------------------------------
    def publish(self, force: bool = False,
                now: float | None = None) -> dict | None:
        """Refresh the ``serve.slo.*`` gauges (throttled unless
        ``force``); returns the computed view when it ran."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if not force and now < self._next_publish:
                return None
            self._next_publish = now + _PUBLISH_EVERY_S
        view = self.compute(now)
        # gauges OUTSIDE the engine lock (locks.py rank discipline)
        _metrics.gauge("serve.slo.target_ms").set(self.target_ms)
        if view["window_n"]:
            _metrics.gauge("serve.slo.window_p50_ms").set(
                view["window_p50_ms"])
            _metrics.gauge("serve.slo.window_p99_ms").set(
                view["window_p99_ms"])
            _metrics.gauge("serve.slo.availability").set(
                view["availability"])
            _metrics.gauge("serve.slo.burn_short").set(
                view["burn_short"])
        if view["burn_long"] is not None:
            _metrics.gauge("serve.slo.burn_long").set(view["burn_long"])
        return view

    def status_section(self) -> dict | None:
        """The ``serve.slo`` block for the live status file (``None``
        until the first request — no empty sections in the HUD)."""
        with self._lock:
            empty = not self._stamps
        if empty:
            return None
        return self.compute()


_ENGINE = SloEngine()


# copied from tpudl/obs/slo.py:get_slo_engine
def get_slo_engine() -> SloEngine:
    return _ENGINE


# copied from tpudl/obs/slo.py:reset_slo_engine
def reset_slo_engine() -> SloEngine:
    """Fresh engine re-reading the env (tests monkeypatch
    ``TPUDL_SERVE_SLO_*`` then reset)."""
    global _ENGINE
    _ENGINE = SloEngine()
    return _ENGINE
