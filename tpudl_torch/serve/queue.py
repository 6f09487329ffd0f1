"""Admission-controlled request queue with per-request deadlines.

Copied from ``tpudl/serve/queue.py`` (host only). The serve plane's front
door: every request passes one admission decision, queue depth against
``TPUDL_SERVE_QUEUE_CAP`` (64) and queued prompt bytes against the
optional ``TPUDL_SERVE_HBM_MB`` budget, and is either accepted
(``serve.requests``) or rejected with a typed :class:`AdmissionError`
(``serve.rejects``). Deadlines are absolute, stamped at submit
(``TPUDL_SERVE_DEADLINE_S`` fills an unset one): an expired request is
shed at ``take``, before any device work is spent on it, with a typed
:class:`DeadlineExceeded` (``serve.deadline_sheds``); the server also
sheds mid-decode under the same type.

The instance lock is tpudl's ``serve.queue`` named lock
(:mod:`tpudl_torch.testing.tsan`). A request
captures its submitter's attribution scope (``ServeRequest.scope``), and
an admitted prompt charges ``tokens_in`` to it. Metrics publish outside
the lock.
``ServeRequest(rng=)`` is an int seed or a ``torch.Generator`` for
sampled decode (:class:`~tpudl_torch.serve.slots.SlotDecoder` reads it),
not a JAX key.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

import numpy as np

from tpudl_torch.obs import attribution as _attr
from tpudl_torch.obs import metrics as _metrics
from tpudl_torch.serve import reqtrace as _reqtrace
from tpudl_torch.testing import tsan as _tsan

__all__ = ["AdmissionError", "DeadlineExceeded", "Evicted",
           "RequestQueue", "ServeRequest"]


# copied from tpudl/serve/queue.py:_env_int
def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# copied from tpudl/serve/queue.py:_env_float
def _env_float(name: str) -> float | None:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else None
    except ValueError:
        return None


# copied from tpudl/serve/queue.py:AdmissionError
class AdmissionError(RuntimeError):
    """Typed admission reject. ``reason`` is machine-checkable:
    ``queue_full`` (depth at cap), ``hbm_budget`` (queued payload bytes
    past ``TPUDL_SERVE_HBM_MB``), or ``slots_full`` (direct engine
    insert with no free slot)."""

    def __init__(self, message: str, *, reason: str):
        super().__init__(message)
        self.reason = reason


# copied from tpudl/serve/queue.py:DeadlineExceeded
class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it completed — shed in the
    queue (before dispatch) or evicted mid-decode."""


# copied from tpudl/serve/queue.py:Evicted
class Evicted(RuntimeError):
    """The request's slot was evicted before completion (explicit
    cancel, or a supervised retry discarding in-flight work that was
    NOT requeued)."""


# copied from tpudl/serve/queue.py:ServeRequest
class ServeRequest:
    """One in-flight generation request and its result mailbox.

    The submitting client holds the object and waits on
    :meth:`result`; the server thread fills ``tokens``/``error`` and
    sets the event. ``deadline`` is an absolute ``time.monotonic``
    stamp (or ``None``); ``rng`` the seed of a sampled request's draws
    (an int or a ``torch.Generator``; None draws from seed 0)."""

    __slots__ = ("prompt", "max_new", "model", "rng", "submitted",
                 "deadline", "tokens", "error", "ttft_s", "latency_s",
                 "done", "trace", "scope")

    def __init__(self, prompt, max_new: int, *, model: str = "default",
                 deadline_s: float | None = None, rng=None):
        self.prompt = np.asarray(prompt, dtype=np.int32)
        if self.prompt.ndim == 1:
            self.prompt = self.prompt[None, :]
        if self.prompt.ndim != 2 or self.prompt.shape[0] != 1:
            raise ValueError(
                f"prompt must be [plen] or [1, plen], got shape "
                f"{self.prompt.shape}")
        self.max_new = int(max_new)
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        self.model = str(model)
        self.rng = rng
        self.submitted = time.monotonic()
        self.deadline = (self.submitted + float(deadline_s)
                         if deadline_s is not None else None)
        self.tokens: np.ndarray | None = None
        self.error: BaseException | None = None
        self.ttft_s: float | None = None
        self.latency_s: float | None = None
        self.done = threading.Event()
        # lifecycle trace (None when TPUDL_SERVE_TRACE=0); stamps are
        # lock-free appends on whichever thread owns the request at
        # that phase (reqtrace.py)
        self.trace = _reqtrace.new_trace()
        if self.trace is not None:
            self.trace.stamp("submit")
        # attribution scope captured on the CLIENT thread: the loop
        # thread serves many tenants per tick, so per-request charges
        # (completions, tokens, SLO samples) follow the submitter's
        # scope, not the loop's (tpudl.obs.attribution)
        self.scope = _attr.current_scope()

    @property
    def nbytes(self) -> int:
        return int(self.prompt.nbytes)

    def expired(self, now: float | None = None) -> bool:
        if self.deadline is None:
            return False
        return (now if now is not None else time.monotonic()) \
            >= self.deadline

    def finish(self, tokens) -> None:
        self.tokens = np.asarray(tokens, dtype=np.int32)
        self.latency_s = time.monotonic() - self.submitted
        if self.trace is not None:
            self.trace.stamp("complete", force=True)
        self.done.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.latency_s = time.monotonic() - self.submitted
        if self.trace is not None:
            self.trace.stamp("fail", force=True)
        self.done.set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Block for completion; raise the typed failure if the server
        shed/evicted/errored the request, raise ``TimeoutError`` if the
        wait itself times out (the zero-hangs contract: a client is
        never parked forever on a dead server)."""
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"serve request not completed within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.tokens


# copied from tpudl/serve/queue.py:RequestQueue
class RequestQueue:
    """Bounded FIFO of :class:`ServeRequest` with admission control.

    ``cap`` defaults to ``TPUDL_SERVE_QUEUE_CAP``; ``hbm_budget_mb``
    (default ``TPUDL_SERVE_HBM_MB``, unset = off) bounds the SUM of
    queued prompt payload bytes — the no-unbounded-growth guarantee
    holds in rows and in bytes. An unset per-request deadline inherits
    ``TPUDL_SERVE_DEADLINE_S`` at submit."""

    def __init__(self, cap: int | None = None, *,
                 hbm_budget_mb: float | None = None):
        self.cap = (int(cap) if cap is not None
                    else _env_int("TPUDL_SERVE_QUEUE_CAP", 64))
        budget = (hbm_budget_mb if hbm_budget_mb is not None
                  else _env_float("TPUDL_SERVE_HBM_MB"))
        self.budget_bytes = (int(float(budget) * (1 << 20))
                             if budget else None)
        self._default_deadline_s = _env_float("TPUDL_SERVE_DEADLINE_S")
        self._lock = _tsan.named_lock("serve.queue")
        self._items: deque[ServeRequest] = deque()
        self._bytes = 0
        _metrics.gauge("serve.queue_cap").set(self.cap)
        _metrics.gauge("serve.queue_depth").set(0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def depth(self) -> int:
        return len(self)

    def submit(self, req: ServeRequest) -> ServeRequest:
        """Admit or reject ``req``. Raises :class:`AdmissionError` on
        reject (typed, immediate — load shedding is an ANSWER, not a
        hang); returns the request on admit."""
        if req.deadline is None and self._default_deadline_s:
            req.deadline = req.submitted + self._default_deadline_s
        reject = None
        with self._lock:
            if len(self._items) >= self.cap:
                reject = AdmissionError(
                    f"queue at capacity ({self.cap}); raise "
                    f"TPUDL_SERVE_QUEUE_CAP or add serving capacity",
                    reason="queue_full")
            elif self.budget_bytes is not None \
                    and self._bytes + req.nbytes > self.budget_bytes:
                reject = AdmissionError(
                    f"queued payload budget exceeded "
                    f"({self._bytes + req.nbytes} > "
                    f"{self.budget_bytes} bytes; TPUDL_SERVE_HBM_MB)",
                    reason="hbm_budget")
            else:
                self._items.append(req)
                self._bytes += req.nbytes
                depth = len(self._items)
        # metrics/stamps OUTSIDE the lock (locks.py: publication never
        # nests under a serve lock)
        if reject is not None:
            if req.trace is not None:
                req.trace.stamp(f"reject:{reject.reason}")
            _metrics.counter("serve.rejects").inc()
            raise reject
        if req.trace is not None:
            req.trace.stamp("admit")
        _metrics.counter("serve.requests").inc()
        _metrics.gauge("serve.queue_depth").set(depth)
        # attribution: prompt tokens entering the serve plane, charged
        # to the submitter's captured scope (rejects charge nothing)
        _attr.charge("tokens_in", int(req.prompt.shape[1]),
                     key=req.scope.key if req.scope is not None
                     else None)
        return req

    def take(self, k: int, *, model: str | None = None) -> list:
        """Pop up to ``k`` live requests (optionally only for
        ``model``), shedding every EXPIRED request encountered on the
        way — a dead-on-arrival request must cost zero device work.
        Shed requests are failed typed; the count publishes as
        ``serve.deadline_sheds``."""
        now = time.monotonic()
        taken: list[ServeRequest] = []
        shed: list[ServeRequest] = []
        with self._lock:
            kept: deque[ServeRequest] = deque()
            while self._items:
                req = self._items.popleft()
                if req.expired(now):
                    shed.append(req)
                    self._bytes -= req.nbytes
                elif len(taken) < int(k) and (model is None
                                              or req.model == model):
                    taken.append(req)
                    self._bytes -= req.nbytes
                else:
                    kept.append(req)
            self._items = kept
            depth = len(self._items)
        for req in taken:
            if req.trace is not None:
                req.trace.stamp("queue_wait_end")
        for req in shed:
            req.fail(DeadlineExceeded(
                f"deadline passed {now - req.deadline:.3f}s before "
                f"dispatch (queued {now - req.submitted:.3f}s)"))
        if shed:
            _metrics.counter("serve.deadline_sheds").inc(len(shed))
        _metrics.gauge("serve.queue_depth").set(depth)
        return taken

    def requeue_front(self, reqs) -> None:
        """Return in-flight requests to the FRONT of the queue (oldest
        first) — the supervised whole-attempt retry path: a degraded
        re-run serves them again from their prompts, bitwise-honest.
        Bypasses admission: these rows were already admitted once."""
        reqs = list(reqs)
        with self._lock:
            for req in reversed(reqs):
                self._items.appendleft(req)
                self._bytes += req.nbytes
            depth = len(self._items)
        _metrics.gauge("serve.queue_depth").set(depth)

    def fail_all(self, error: BaseException) -> int:
        """Fail every queued request with ``error`` (server teardown on
        an unrecoverable fault): clients unblock with the typed cause
        instead of hanging on a dead server."""
        with self._lock:
            drained = list(self._items)
            self._items.clear()
            self._bytes = 0
        for req in drained:
            req.fail(error)
        _metrics.gauge("serve.queue_depth").set(0)
        return len(drained)
