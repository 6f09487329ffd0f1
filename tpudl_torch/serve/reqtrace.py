"""Request-scoped lifecycle traces for the serve plane.

Copied from ``tpudl/serve/reqtrace.py`` (host only): every
:class:`~tpudl_torch.serve.queue.ServeRequest` carries one
:class:`ReqTrace`, a trace id plus a bounded list of ``(event,
monotonic_t)`` stamps, one per lifecycle transition (submit, admit or
typed reject, queue-wait end, rung pack, slot insert, first token, every
N-th decoded token, complete or fail). The stamps decompose a request into
the four segments an operator reasons in, which sum to its end-to-end
latency:

- ``queue_wait``: submit → taken off the admission queue;
- ``batching``: taken → rung chosen and the prompt packed;
- ``prefill``: rung pack → first token (the TTFT tail);
- ``decode``: first token → terminal stamp.

A stamp is a plain list append on the thread that owns the request at
that phase, so no trace lock exists. ``TPUDL_SERVE_TRACE=0`` makes
:func:`new_trace` return ``None``; ``TPUDL_SERVE_TRACE_EVENTS`` bounds the
stamps and ``TPUDL_SERVE_TRACE_CADENCE`` sets the decode stride.
:func:`request_record` gives lengths, ids and millisecond segments, never
prompt tokens; the serve loop files one per completed request in the
flight recorder's request ring.
"""

from __future__ import annotations

import itertools
import os
import time

__all__ = ["ReqTrace", "new_trace", "trace_armed", "decode_cadence",
           "request_record", "SEGMENTS"]

# the four segments every request decomposes into, in lifecycle order
SEGMENTS = ("queue_wait", "batching", "prefill", "decode")

# room reserved below the event cap so complete/fail always fits even
# after a long decode's cadence stamps
_TERMINAL_RESERVE = 4

_TRACE_SEQ = itertools.count(1)


# copied from tpudl/serve/reqtrace.py:_env_int
def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except (TypeError, ValueError):
        return default


# copied from tpudl/serve/reqtrace.py:trace_armed
def trace_armed() -> bool:
    """Tracing is on unless ``TPUDL_SERVE_TRACE=0`` (cheap enough to
    default on — the overhead guard pins the cost)."""
    return os.environ.get("TPUDL_SERVE_TRACE", "1") != "0"


# copied from tpudl/serve/reqtrace.py:decode_cadence
def decode_cadence() -> int:
    """Stamp every N-th decoded token (``TPUDL_SERVE_TRACE_CADENCE``)."""
    return max(1, _env_int("TPUDL_SERVE_TRACE_CADENCE", 16))


# copied from tpudl/serve/reqtrace.py:ReqTrace
class ReqTrace:
    """One request's bounded stamp list. Appends only — segment math
    happens off the hot path (:meth:`segments`, harvest time)."""

    __slots__ = ("trace_id", "events", "_cap")

    def __init__(self):
        self.trace_id = f"{os.getpid()}-{next(_TRACE_SEQ)}"
        self.events: list = []  # [(name, monotonic_t), ...]
        self._cap = max(8, _env_int("TPUDL_SERVE_TRACE_EVENTS", 64))

    def stamp(self, name: str, force: bool = False) -> None:
        # cadence stamps leave _TERMINAL_RESERVE slots so the terminal
        # stamp (force=True) always lands inside the cap
        if force:
            if len(self.events) < self._cap:
                self.events.append((name, time.monotonic()))
        elif len(self.events) < self._cap - _TERMINAL_RESERVE:
            self.events.append((name, time.monotonic()))

    def t(self, name: str):
        """Monotonic time of the LAST stamp called ``name`` (a
        requeued request stamps queue_wait_end twice; the last wait is
        the one that fed the slot it completed in)."""
        for n, ts in reversed(self.events):
            if n == name:
                return ts
        return None

    def segments(self):
        """``{segment: seconds}`` or ``None`` when any cut point is
        missing (rejected/unfinished requests don't decompose)."""
        t_submit = self.t("submit")
        t_qend = self.t("queue_wait_end")
        t_pack = self.t("rung_pack")
        t_first = self.t("first_token")
        t_end = self.t("complete")
        if t_end is None:
            t_end = self.t("fail")
        cuts = (t_submit, t_qend, t_pack, t_first, t_end)
        if any(c is None for c in cuts):
            return None
        return {
            "queue_wait": t_qend - t_submit,
            "batching": t_pack - t_qend,
            "prefill": t_first - t_pack,
            "decode": t_end - t_first,
        }


# copied from tpudl/serve/reqtrace.py:new_trace
def new_trace():
    """A fresh :class:`ReqTrace`, or ``None`` when tracing is
    disarmed — every stamp site gates on ``trace is not None``."""
    return ReqTrace() if trace_armed() else None


# copied from tpudl/serve/reqtrace.py:request_record
def request_record(req) -> dict:
    """The flight-ring descriptor for a terminal request: ids, sizes
    and millisecond timings — NEVER prompt content."""
    tr = getattr(req, "trace", None)
    segs = tr.segments() if tr is not None else None
    rec = {
        "ts": time.time(),
        "trace_id": tr.trace_id if tr is not None else None,
        "model": str(req.model),
        "prompt_len": int(req.prompt.shape[-1]),
        "max_new": int(req.max_new),
        "outcome": ("complete" if req.error is None
                    else type(req.error).__name__),
        "ttft_ms": (round(req.ttft_s * 1000.0, 3)
                    if req.ttft_s is not None else None),
        "latency_ms": (round(req.latency_s * 1000.0, 3)
                       if req.latency_s is not None else None),
        "events": len(tr.events) if tr is not None else 0,
        "segments": ({k: round(v * 1000.0, 3) for k, v in segs.items()}
                     if segs else None),
    }
    return rec
