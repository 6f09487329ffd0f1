"""The serve loop: admission → prefill → slot decode → completions.

Port of ``tpudl/serve/server.py``. One server owns one
:class:`~tpudl_torch.serve.registry.ModelRegistry` and one
:class:`~tpudl_torch.serve.queue.RequestQueue` and runs the
continuous-batching loop: each tick sheds expired work (queued and
mid-decode), admits queued requests into free slots up to the admission
width, dispatches ONE decode step across every active slot per model (a
CUDA-graph replay on the card) and harvests completions. An unrecoverable
error fails every pending request typed, so a dead server never parks a
client.

``serve.latency_ms`` and ``serve.ttft_s`` histograms carry p50/p99, and
every completion feeds the SLO engine (:mod:`tpudl_torch.obs.slo`: the
windowed p50/p99, burn rates and tail exemplars), charges its submitter's
attribution scope ``serve_completed``, ``slo_samples`` and ``tokens_out``,
and files its descriptor in the flight recorder's request ring; the loop
beats a ``serve.loop`` watchdog heartbeat every tick. The
session's :class:`~tpudl_torch.obs.pipeline.PipelineReport` (``config
["serve"]``, the ``dispatch`` stage, ``tokens``, the ``queue_depth`` and
``slot_occupancy`` gauges) publishes ``serve.batch_occupancy`` and
``serve.tokens_per_s`` when the session ends.

Under ``supervise=True`` (or ``TPUDL_FRAME_DEGRADE=1``) the whole session
runs as a supervised attempt (:mod:`tpudl_torch.frame.supervisor`): a
classified fault sends the in-flight requests back to the FRONT of the
queue with their partial tokens dropped (the retry decodes them again
from the prompt, so the streams are a healthy run's) and re-runs with the
ladder's overrides, ``dispatch_depth`` narrowing the admission width.
Each tick fires tpudl's ``serve.dispatch`` fault point.
"""

from __future__ import annotations

import threading
import time

from tpudl_torch.obs import attribution as _attr
from tpudl_torch.obs import flight as _flight
from tpudl_torch.obs import metrics as _metrics
from tpudl_torch.obs import pipeline as _pipeline
from tpudl_torch.obs import slo as _slo
from tpudl_torch.obs import watchdog as _watchdog
from tpudl_torch.serve import reqtrace as _reqtrace
from tpudl_torch.serve.queue import DeadlineExceeded, RequestQueue, \
    ServeRequest
from tpudl_torch.testing import faults as _faults

__all__ = ["Server"]


class Server:
    """Continuous-batching server over a model registry.

    Run synchronously (``run(max_ticks=...)`` — deterministic, the
    tests' mode) or threaded (``start_async()`` + ``close()``, the load
    generator's mode)."""

    # copied from tpudl/serve/server.py:Server.__init__
    def __init__(self, registry, queue: RequestQueue | None = None, *,
                 supervise=None):
        self.registry = registry
        self.queue = queue if queue is not None else RequestQueue()
        self._supervise = supervise
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._sup = None
        self._max_ticks: int | None = None
        self.summary: dict | None = None

    # -- client surface ----------------------------------------------------
    # copied from tpudl/serve/server.py:Server.submit
    def submit(self, prompt, max_new: int, *, model: str = "default",
               deadline_s: float | None = None, rng=None) -> ServeRequest:
        """Admit one request (typed reject on queue/budget pressure).
        The model name is validated HERE so an unknown name is an
        immediate ``KeyError``, never a request parked forever."""
        self.registry.get(model)  # raises KeyError for unknown names
        req = ServeRequest(prompt, max_new, model=model,
                           deadline_s=deadline_s, rng=rng)
        return self.queue.submit(req)

    # -- lifecycle ---------------------------------------------------------
    # copied from tpudl/serve/server.py:Server.start_async
    def start_async(self) -> "Server":
        """Run the serve session on a daemon thread (the generic name
        ``start`` is deliberately avoided: concurrency.py resolves
        attribute calls by bare name, and every ``t.start()`` in the
        tree would inherit this loop's blocking closure)."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(target=self._run_guarded,
                                        name="tpudl-serve",
                                        daemon=True)
        self._thread.start()
        return self

    # copied from tpudl/serve/server.py:Server.close
    def close(self, timeout: float = 120.0) -> dict:
        """Drain (finish queued + in-flight work), stop, and return the
        session summary; re-raises the loop's error if it died."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"serve loop did not drain within {timeout}s")
            self._thread = None
        if self._error is not None:
            raise self._error
        return self.summary or {}

    # copied from tpudl/serve/server.py:Server._run_guarded
    def _run_guarded(self):
        try:
            self.summary = self.run()
        except BaseException as e:
            self._error = e
            self._fail_pending(e)

    # copied from tpudl/serve/server.py:Server._fail_pending
    def _fail_pending(self, error: BaseException):
        """Unblock every waiting client with the typed cause."""
        self.queue.fail_all(error)
        for entry in self.registry.entries():
            entry.engine.evict_all(error)

    # -- the session -------------------------------------------------------
    # copied from tpudl/serve/server.py:Server.run
    def run(self, max_ticks: int | None = None) -> dict:
        """Run the serve session to drain (or ``max_ticks``), under the
        degradation ladder when armed."""
        from tpudl_torch.frame import supervisor as _supmod

        self._max_ticks = max_ticks
        if _supmod.enabled(self._supervise):
            sup = _supmod.Supervisor()
            self._sup = sup
            try:
                return sup.supervise(self._attempt)
            finally:
                self._sup = None
        return self._attempt({})

    # copied from tpudl/serve/server.py:Server._requeue_inflight
    def _requeue_inflight(self):
        """A retry attempt starts clean: in-flight occupants go back to
        the queue FRONT (oldest first) with partial tokens discarded —
        the surviving attempt re-decodes them from the prompt, so its
        outputs are exactly a healthy run's."""
        for entry in self.registry.entries():
            reqs = entry.engine.evict_all()
            for req in reqs:
                req.tokens = None
            if reqs:
                self.queue.requeue_front(reqs)

    def _attempt(self, overrides: dict) -> dict:
        """One serve session, or one supervised attempt of it: the
        ladder's ``dispatch_depth`` override is the admission width (by
        default every slot)."""
        entries = self.registry.entries()
        width_default = sum(e.engine.slots for e in entries) or 1
        max_active = int(overrides.get("dispatch_depth")
                         or width_default)
        report = _pipeline.PipelineReport()
        report.config.update({
            "serve": True,
            "dispatch_depth": max_active,
            "queue_cap": self.queue.cap,
            "models": len(entries),
        })
        if self._sup is not None:
            self._sup.note_report(report)
        _pipeline.set_last_pipeline(report)
        self._requeue_inflight()
        t0 = time.perf_counter()
        tick = completed = admitted = 0
        with _watchdog.heartbeat("serve.loop",
                                 models=len(entries)) as hb:
            while True:
                tick += 1
                _faults.fire("serve.dispatch", tick=tick)
                self._shed_expired(entries)
                admitted += self._admit(entries, max_active, report)
                stepped = 0
                for entry in entries:
                    if entry.engine.active():
                        with report.stage("dispatch"):
                            stepped += entry.engine.step()
                if stepped:
                    report.count("tokens", stepped)
                completed += self._harvest(entries, report)
                depth = self.queue.depth()
                active = sum(len(e.engine.active()) for e in entries)
                report.gauge("queue_depth", depth)
                report.gauge("slot_occupancy",
                             active / max(width_default, 1))
                hb.beat(tick=tick, depth=depth, active=active)
                if self._max_ticks is not None \
                        and tick >= self._max_ticks:
                    break
                if depth == 0 and active == 0:
                    if self._stop.is_set():
                        break
                    time.sleep(0.0005)  # idle poll, clients may appear
        wall = time.perf_counter() - t0
        report.finish(wall)
        # final gauge refresh so a post-run snapshot or status read shows
        # the session's closing window, not a stale throttled view
        _slo.get_slo_engine().publish(force=True)
        return {"ticks": tick, "completed": completed,
                "admitted": admitted, "wall_s": round(wall, 4),
                "models": len(entries),
                "degraded_to": report.config.get("degraded_to")}

    # copied from tpudl/serve/server.py:Server._shed_expired
    def _shed_expired(self, entries) -> int:
        """Mid-decode deadline sweep: an expired occupant is evicted
        typed — its slot goes to a request that can still make its
        deadline instead of finishing tokens nobody will read."""
        now = time.monotonic()
        shed = 0
        for entry in entries:
            for slot, req in entry.engine.occupants():
                if req.expired(now):
                    entry.engine.evict(slot, DeadlineExceeded(
                        f"deadline passed {now - req.submitted:.3f}s "
                        f"after submit, mid-decode"))
                    shed += 1
        if shed:
            _metrics.counter("serve.deadline_sheds").inc(shed)
        return shed

    # copied from tpudl/serve/server.py:Server._admit
    def _admit(self, entries, max_active: int, report) -> int:
        """Move queued requests into free slots, bounded by the
        CURRENT admission width (the degradation ladder shrinks it via
        ``dispatch_depth``)."""
        total_active = sum(len(e.engine.active()) for e in entries)
        budget = max_active - total_active
        admitted = 0
        for entry in entries:
            if budget <= 0:
                break
            nfree = min(len(entry.engine.free()), budget)
            if nfree <= 0:
                continue
            for req in self.queue.take(nfree, model=entry.name):
                with report.stage("dispatch"):
                    entry.engine.insert(req)
                req.ttft_s = time.monotonic() - req.submitted
                _metrics.histogram("serve.ttft_s").observe(req.ttft_s)
                budget -= 1
                admitted += 1
        return admitted

    # copied from tpudl/serve/server.py:Server._harvest
    def _harvest(self, entries, report) -> int:
        done = 0
        slo = _slo.get_slo_engine()
        for entry in entries:
            for req, toks in entry.engine.pop_completed():
                req.finish(toks)
                _metrics.histogram("serve.latency_ms").observe(
                    req.latency_s * 1000.0)
                _metrics.counter("serve.completed").inc()
                # attribution: the loop thread serves every tenant, so
                # per-request charges follow the scope captured at
                # submit — paired 1:1 with serve.completed and the
                # latency observe above (the reconciliation contract)
                skey = (req.scope.key if req.scope is not None
                        else None)
                _attr.charge("serve_completed", key=skey)
                _attr.charge("slo_samples", key=skey)
                _attr.charge("tokens_out",
                             int(getattr(req.tokens, "size", 0)),
                             key=skey)
                # windowed SLO stamp + tail-exemplar check, then the
                # flight recorder's request ring (descriptor only)
                slo.record(req)
                _flight.get_recorder().record_request(
                    _reqtrace.request_record(req))
                report.progress(1)
                done += 1
        return done
