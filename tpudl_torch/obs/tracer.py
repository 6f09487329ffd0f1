"""Host-span tracer: thread-aware wall-clock spans in a bounded ring.

Port of ``tpudl/obs/tracer.py`` (the same ring, clock model and Chrome
trace-event schema). Any layer wraps work in ``obs.span("stage",
**attrs)`` and the span lands in a process-wide ring with its thread id
and name and its attributes. ``export_chrome_trace`` writes the ring as
Chrome trace-event JSON, the format ``torch.profiler`` exports too, so
``python -m tpudl_torch.obs trace <dir>`` merges the host spans with the
card's kernel lanes into one timeline (:mod:`tpudl_torch.obs.trace`).

Clock model: durations come from ``time.perf_counter()``; each span's
start is stamped in epoch microseconds from a live ``time.time()`` read
at span end, so exports line up with wall-clock windows
(``obs.profile`` records its capture window the same way). A device
trace carries its own time base; the merge normalizes each stream to its
own start.

Recording a span is two ``perf_counter`` reads and a locked deque
append; the ring (``TPUDL_TRACE_RING`` spans, default 65536) never grows
past its cap, so tracing can stay on.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

from tpudl_torch.testing import tsan as _tsan

__all__ = ["Span", "Tracer", "get_tracer", "span", "export_chrome_trace"]

_DEFAULT_RING = 65536


# copied from tpudl/obs/tracer.py:Span
class Span:
    """One completed host span (times in epoch microseconds)."""

    __slots__ = ("name", "ts_us", "dur_us", "tid", "thread_name", "attrs")

    def __init__(self, name, ts_us, dur_us, tid, thread_name, attrs):
        self.name = name
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.tid = tid
        self.thread_name = thread_name
        self.attrs = attrs

    def to_event(self, pid: int) -> dict:
        e = {"ph": "X", "name": self.name, "pid": pid, "tid": self.tid,
             "ts": self.ts_us, "dur": self.dur_us}
        if self.attrs:
            e["args"] = dict(self.attrs)
        return e


# copied from tpudl/obs/tracer.py:Tracer
class Tracer:
    """Bounded, thread-safe span ring.

    ``with tracer.span("decode", batch=3):`` records one span on exit;
    raising inside the block still records it (the failing span is
    usually the interesting one) with ``error`` set in its attrs.
    """

    def __init__(self, ring: int | None = None):
        if ring is None:
            try:
                ring = int(os.environ.get("TPUDL_TRACE_RING", "")
                           or _DEFAULT_RING)
            except ValueError:
                ring = _DEFAULT_RING
        self._spans: deque[Span] = deque(maxlen=max(1, int(ring)))
        self._lock = _tsan.named_lock("obs.tracer.ring")
        self.dropped = 0  # spans pushed out of the ring
        # (start_us, end_us) of the most recent obs.profile capture —
        # set by tpudl.obs.trace.profile so exports can window to it
        self.last_profile_window: tuple[float, float] | None = None

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t0 = time.perf_counter()
        try:
            yield
        except BaseException as e:
            attrs = dict(attrs)
            attrs["error"] = type(e).__name__
            raise
        finally:
            dur_us = (time.perf_counter() - t0) * 1e6
            # epoch stamp taken LIVE at span end (duration still from
            # the monotonic clock): a frozen import-time anchor would
            # drift from profile()'s time.time() window across suspend
            # or NTP steps, silently emptying window="profile" exports
            ts_us = time.time() * 1e6 - dur_us
            th = threading.current_thread()
            s = Span(name, ts_us, dur_us, th.ident or 0, th.name,
                     attrs or None)
            with self._lock:
                if len(self._spans) == self._spans.maxlen:
                    self.dropped += 1
                self._spans.append(s)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def to_events(self, window: tuple[float, float] | None = None,
                  ) -> list[dict]:
        """Chrome trace-event list: process/thread metadata + one "X"
        event per span, epoch-µs timestamps. ``window=(start_us,
        end_us)`` keeps only spans overlapping it — the ring outlives
        any one capture, and merging a device trace against
        pre-capture spans would mis-attribute overlap."""
        pid = os.getpid()
        spans = self.spans()
        if window is not None:
            w0, w1 = window
            spans = [s for s in spans
                     if s.ts_us + s.dur_us >= w0 and s.ts_us <= w1]
        events = [{"ph": "M", "pid": pid, "name": "process_name",
                   "args": {"name": "tpudl host"}}]
        seen_tids = {}
        for s in spans:
            if s.tid not in seen_tids:
                seen_tids[s.tid] = s.thread_name
        for tid, tname in sorted(seen_tids.items()):
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": tname}})
        events.extend(s.to_event(pid) for s in spans)
        return events

    def export_chrome_trace(self, path: str,
                            window: object = None) -> str:
        """Write the ring as ``{"traceEvents": [...]}`` JSON. Name the
        file ``*.host.trace.json`` so the CLI's directory scan finds it
        next to the profiler's ``*.trace.json.gz``.

        ``window="profile"`` keeps only spans overlapping the most
        recent ``obs.profile`` capture (the merged-timeline workflow —
        without it a long-lived process exports its whole ring and the
        merge attributes overlap to pre-capture spans); an explicit
        ``(start_us, end_us)`` tuple windows arbitrarily; None exports
        everything."""
        if window == "profile":
            window = self.last_profile_window
        payload = {"traceEvents": self.to_events(window=window),
                   "displayTimeUnit": "ms",
                   "metadata": {"tpudl": "host-span-tracer",
                                "dropped_spans": self.dropped}}
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


_TRACER = Tracer()


# copied from tpudl/obs/tracer.py:get_tracer
def get_tracer() -> Tracer:
    return _TRACER


# copied from tpudl/obs/tracer.py:span
def span(name: str, **attrs):
    """``with obs.span("ml.Featurizer.transform", rows=n):`` — record a
    host span on the process-wide tracer."""
    return _TRACER.span(name, **attrs)


# copied from tpudl/obs/tracer.py:export_chrome_trace
def export_chrome_trace(path: str, window: object = None) -> str:
    return _TRACER.export_chrome_trace(path, window=window)
