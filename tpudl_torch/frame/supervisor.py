"""Fault-contained executor supervision: taxonomy + degradation ladder.

Port of ``tpudl/frame/supervisor.py``.

1. **Taxonomy** — :func:`classify_exception` sorts an executor-stage
   exception into a kind: device OOM (``torch.cuda.OutOfMemoryError``, the
   CUDA allocator's ``CUDA out of memory`` text, and tpudl's
   ``RESOURCE_EXHAUSTED`` text, so that one table of exceptions sorts
   alike in both packages), transfer (the ``h2d`` stage, or an IO-shaped
   error), recompile storm, stage, or fatal (the shared retry contract:
   ``tpudl_fatal``, programming errors, interpreter shutdown). The typed
   exceptions (:class:`DeviceOOM`, :class:`TransferError`,
   :class:`RecompileStorm`, :class:`StageFault`, :class:`Fatal`) are what a
   supervised run raises when recovery is exhausted, always chained to the
   original error.
2. **Degradation ladder** — a :class:`Supervisor` re-runs the whole run
   under an ordered, bounded sequence of rungs: a device OOM first evicts
   every unpinned entry of the device cache (``evict_hbm``,
   :meth:`~tpudl_torch.data.device_cache.DeviceBatchCache.evict_unpinned`);
   transient transfer faults retry through the one shared
   :func:`~tpudl_torch.jobs.retry.io_policy`; repeated stage faults halve
   ``dispatch_depth`` down to 1, then drop ``fuse_steps`` to 1, then turn
   donation off, then fall back to the serial arm (the
   ``TPUDL_MESH_FAST_PATH=0`` shape: no prefetch, no window, no fusion, no
   residency). Every rung re-runs the same kernels: a degraded run returns
   the bytes of a healthy run, only slower. Rungs are bounded by
   ``TPUDL_FRAME_DEGRADE_MAX_RUNGS``; exhaustion writes a flight dump and
   raises the typed error of the last fault.

Supervision is off by default (``TPUDL_FRAME_DEGRADE=1`` or
``map_batches(supervise=True)`` / ``Server(supervise=True)`` arms it): a
retry re-executes user code, so the owner of the process opts in.

The recompile-storm signal has two sources. As tpudl does, the
supervisor samples the trace sentinel's ``traceck.storms`` around an
attempt (:mod:`tpudl_torch.testing.traceck`, ``TPUDL_TRACECK=1``: a
capture identity past its threshold during the attempt). Beside it, the
program store's capture misses: an attempt that failed after the store
captured a new program for that attempt counts as a storm, armed
sentinel or not. The misses are the attempt's own
(:func:`tpudl_torch.compile.store.counting_misses`, a context variable
set around the attempt), never the process's ``compile.misses``: another
thread missing the store meanwhile does not turn a stage fault into a
storm. A storm counts ``compile.storms`` and files a ``compile.storm``
event in the flight recorder's error ring, which the port's ``obs
doctor`` reads. Without the store armed nothing misses.

Every rung files a ``frame.degraded`` event in the flight recorder's
error ring and counts ``frame.degraded.rungs``; recovery lands
``degraded_to`` and ``recovered_batches`` on the ``PipelineReport``;
exhaustion counts ``frame.degraded.exhausted`` and leaves a
``tpudl-dump-*`` that tpudl's ``obs doctor`` classifies as
``degraded_run``. One watchdog heartbeat (``frame.supervisor``) spans the
supervised run, the parent of each attempt's executor heartbeat: every
attempt, rung and backoff slice beats it, so a deliberate retry pause
never reads as a stall. Each rung charges the caller's attribution scope
one ``degradations``.
"""

from __future__ import annotations

import logging
import os
import time

from tpudl_torch.jobs import retry as _retry

__all__ = ["FaultError", "DeviceOOM", "TransferError", "RecompileStorm",
           "StageFault", "Fatal", "Supervisor", "classify_exception",
           "enabled", "LADDER"]

log = logging.getLogger("tpudl_torch.frame.supervisor")

# the ordered ladder: generic stage faults walk these rungs top to
# bottom; "dispatch_depth" repeats (halving) until depth is 1
LADDER = ("dispatch_depth", "fuse_steps", "donate", "serial")

# covers evict_hbm + depth 8 -> 1 (3 halvings) + fuse + donate; the
# serial rung is guaranteed ONE attempt even past this budget (the
# last resort is never left untried), so total rungs <= max_rungs + 1
DEFAULT_MAX_RUNGS = 6


# -- the typed taxonomy ------------------------------------------------------
# copied from tpudl/frame/supervisor.py:FaultError
class FaultError(RuntimeError):
    """Base of the executor fault taxonomy, raised by a supervised run
    when the ladder is exhausted, always ``raise ... from`` the original
    exception. ``stage`` is the executor stage the last fault escaped
    from (the ``tpudl_stage`` tag), ``rungs`` the rungs that were
    tried."""

    kind = "stage"

    def __init__(self, message: str, *, stage: str | None = None,
                 rungs=()):
        super().__init__(message)
        self.stage = stage
        self.rungs = tuple(rungs)


# copied from tpudl/frame/supervisor.py:DeviceOOM
class DeviceOOM(FaultError):
    """Device memory exhausted: recovery evicts unpinned device-cache
    entries and retries; shrinking rungs follow if it recurs."""

    kind = "oom"


# copied from tpudl/frame/supervisor.py:TransferError
class TransferError(FaultError):
    """Host→device transfer / IO fault at the infeed edge: transient
    ones ride the shared RetryPolicy; a persistent one degrades and
    eventually raises this."""

    kind = "transfer"


# copied from tpudl/frame/supervisor.py:RecompileStorm
class RecompileStorm(FaultError):
    """The failed attempt was capturing programs instead of computing:
    recovery pins fuse_steps down to stop the program-shape churn."""

    kind = "recompile_storm"


# copied from tpudl/frame/supervisor.py:StageFault
class StageFault(FaultError):
    """An executor stage failed for no more specific reason — the
    generic ladder (depth, fusion, donation, serial) handles it."""

    kind = "stage"


# copied from tpudl/frame/supervisor.py:Fatal
class Fatal(FaultError):
    """Not recoverable by ANY rung (programming error, preemption,
    interpreter shutdown). ``tpudl_fatal`` keeps every retry layer —
    this one, gang restarts, trial retries — from fighting it."""

    kind = "fatal"
    tpudl_fatal = True


_TYPE_FOR = {"oom": DeviceOOM, "transfer": TransferError,
             "recompile_storm": RecompileStorm, "stage": StageFault,
             "fatal": Fatal}

# tpudl's device-OOM anchor: jaxlib's grpc-style status name
_OOM_STATUS = "RESOURCE_EXHAUSTED"
# the CUDA caching allocator's text, which torch raises as
# torch.cuda.OutOfMemoryError (older releases as a bare RuntimeError)
_CUDA_OOM = "CUDA out of memory"
# exception kinds that never benefit from a retry at ANY rung: the
# shared contract with tpudl_torch.jobs.retry (PROGRAMMING_ERRORS,
# tpudl_fatal and the interpreter-shutdown set), plus schema errors the
# executor raises before any batch runs (unknown columns)
_SETUP_ERRORS = (KeyError,)


def _is_oom(exc: BaseException, msg: str) -> bool:
    import torch

    return (isinstance(exc, torch.cuda.OutOfMemoryError)
            or _OOM_STATUS in msg or msg.startswith(_CUDA_OOM)
            or (type(exc).__name__ == "XlaRuntimeError"
                and "out of memory" in msg.lower()))


def classify_exception(exc: BaseException, *, stage: str | None = None,
                       storm: bool = False) -> str:
    """One executor-attempt exception → a taxonomy kind (``oom`` /
    ``transfer`` / ``recompile_storm`` / ``stage`` / ``fatal``).
    ``stage`` is the ``tpudl_stage`` tag the innermost
    :meth:`PipelineReport.stage` block left on the exception; ``storm``
    says whether the attempt captured new programs (its own store misses)
    or the traceck sentinel counted new storms during it. A user ``fn`` that
    raises some other library's "out of memory" wording mid-message
    stays a stage fault, as in tpudl: only the allocator's own error
    evicts the device cache."""
    if (_retry.is_fatal(exc)
            or isinstance(exc, _retry.PROGRAMMING_ERRORS)
            or isinstance(exc, _SETUP_ERRORS)):
        return "fatal"
    if _is_oom(exc, str(exc)):
        return "oom"
    if storm:
        return "recompile_storm"
    # the transfer edge: either the fault escaped the h2d stage, or it
    # is IO-shaped per the ONE retry classifier's transient default
    if stage == "h2d" or isinstance(
            exc, (OSError, ConnectionError, TimeoutError,
                  InterruptedError)):
        return "transfer"
    return "stage"


# copied from tpudl/frame/supervisor.py:enabled
def enabled(kwarg=None) -> bool:
    """Is supervision armed for this run? The explicit ``supervise=``
    kwarg wins; else ``TPUDL_FRAME_DEGRADE`` (default OFF — arming
    changes which exception TYPE a failing run raises and re-executes
    user code on retry, so the process owner opts in)."""
    if kwarg is not None:
        return bool(kwarg)
    return os.environ.get("TPUDL_FRAME_DEGRADE", "0") == "1"


# copied from tpudl/frame/supervisor.py:_storms
def _storms() -> float:
    """Current traceck storm count (0 when the sentinel is unarmed —
    the counter simply never moves)."""
    from tpudl_torch.obs import metrics as _m

    return float(_m.counter("traceck.storms").value)


class Supervisor:
    """One supervised run's ladder state. Single-consumer: the supervise
    loop, classification and rung bookkeeping all run on the thread that
    called ``map_batches`` (or the serve loop), so no lock is needed."""

    def __init__(self, *, max_rungs: int | None = None):
        self.max_rungs = (int(max_rungs) if max_rungs is not None
                          else max(1, _retry._env_int(
                              "TPUDL_FRAME_DEGRADE_MAX_RUNGS",
                              DEFAULT_MAX_RUNGS)))
        self.rungs: list[str] = []      # applied rung labels, in order
        self.overrides: dict = {}       # kwargs for the next attempt
        self.recovered_batches = 0
        self.transfer_attempts = 0      # shared-RetryPolicy budget used
        self.hbm_evicted = False        # the OOM evict rung fired
        self._ladder_pos = 0            # index into LADDER
        self._report = None             # current attempt's PipelineReport
        self._hb = None                 # the supervised run's heartbeat

    # -- executor hooks ------------------------------------------------------
    # copied from tpudl/frame/supervisor.py:Supervisor.note_report
    def note_report(self, report) -> None:
        """Called by the executor once per attempt, right after the
        attempt's PipelineReport config is resolved — the ladder reads
        the RESOLVED knob values (env/autotune included) to know what
        to halve, and recovery stamps its outcome onto this report."""
        self._report = report
        if self.rungs:
            report.config["degraded_to"] = self.degraded_to

    @property
    def degraded_to(self) -> str | None:
        """The deepest rung applied so far (what the run degraded TO),
        e.g. ``dispatch_depth=1``, ``serial``."""
        return self.rungs[-1] if self.rungs else None

    # -- the supervise loop --------------------------------------------------
    def supervise(self, attempt):
        """Run ``attempt(overrides)`` under the ladder: classified
        recoverable faults apply a rung and re-run; fatal faults and
        ladder exhaustion re-raise (typed). The whole-run retry keeps
        recovery bit for bit: a failed attempt's partial outputs are
        dropped, and the surviving attempt's outputs are what a healthy
        run of that config produces."""
        from tpudl_torch.compile import store as _store
        from tpudl_torch.obs import watchdog as _watchdog

        attempt_no = 0
        # one heartbeat for the whole supervised run, the parent of each
        # attempt's executor heartbeat (nested registration): every
        # attempt start, rung and backoff slice re-arms it, so a stage
        # the supervisor is retrying is never double-flagged as a stall
        with _watchdog.heartbeat("frame.supervisor",
                                 max_rungs=self.max_rungs) as hb:
            self._hb = hb
            while True:
                attempt_no += 1
                hb.beat(attempt=attempt_no, rungs=len(self.rungs))
                storms0 = _storms()
                with _store.counting_misses() as misses:
                    try:
                        result = attempt(dict(self.overrides))
                    except BaseException as e:
                        failed = e
                    else:
                        failed = None
                if failed is not None:
                    stage = getattr(failed, "tpudl_stage", None)
                    kind = classify_exception(
                        failed, stage=stage,
                        storm=misses[0] > 0 or _storms() > storms0)
                    if kind == "fatal":
                        raise failed
                    if kind == "recompile_storm" and misses[0]:
                        self._record_storm(failed, stage, misses[0])
                    self._on_fault(failed, kind, attempt_no)  # raises
                    continue                                 # or rung'd
                if self.rungs:
                    # only a rung'd run records recovery: a transfer
                    # retry changed no knob and already left its
                    # retry.* trail
                    self._record_recovery()
                return result

    @staticmethod
    def _record_storm(exc: BaseException, stage: str | None,
                      misses: int) -> None:
        """The port's storm evidence for ``obs doctor``:
        ``compile.storms`` and a ``compile.storm`` error-ring event with
        the attempt's own capture misses."""
        try:
            from tpudl_torch.obs import flight as _flight
            from tpudl_torch.obs import metrics as _m

            _m.counter("compile.storms").inc()
            _flight.record_error("compile.storm", exc, stage=stage,
                                 misses=int(misses))
        # tpudl: ignore[swallowed-except] — the observer must never
        # take down the recovery it narrates
        except Exception:
            pass

    # -- fault handling ------------------------------------------------------
    # copied from tpudl/frame/supervisor.py:Supervisor._on_fault
    def _on_fault(self, exc: BaseException, kind: str,
                  attempt_no: int) -> None:
        """Pick and apply the next rung for ``kind`` — or, when the
        ladder is exhausted, dump the black box and raise the typed
        error chained to ``exc``."""
        stage = getattr(exc, "tpudl_stage", None)
        if kind == "transfer" and self._retry_transfer(exc, stage):
            return
        if (kind == "oom" and not self.hbm_evicted
                and len(self.rungs) < self.max_rungs):
            # budget-checked like every ladder rung, so the documented
            # "total rungs <= max_rungs + 1" bound holds (only the
            # guaranteed serial attempt may exceed the budget)
            self.hbm_evicted = True
            freed = self._evict_hbm()
            self._apply_rung("evict_hbm", exc, stage, attempt_no,
                             freed_bytes=freed)
            return
        if kind == "recompile_storm" and "fuse_steps" not in [
                r.split("=")[0] for r in self.rungs]:
            # stop the program-shape churn first: one fused variant
            # fewer per retrace beats shrinking the window
            if self._ladder_pos < 1:
                self._ladder_pos = 1  # skip ahead to the fuse rung
        over_budget = len(self.rungs) >= self.max_rungs
        label = None if over_budget else self._next_ladder_rung()
        if label is None:
            # out of budget, or out of intermediate rungs: the
            # conservative serial arm is the documented LAST RESORT
            # and always gets its one attempt before the typed raise —
            # an eviction or a deep halving sequence consuming the
            # budget must not leave the rung most likely to survive
            # untried
            if "serial" in self.rungs:
                self._exhausted(exc, kind, stage)
            label = self._jump_to_serial()
        self._apply_rung(label, exc, stage, attempt_no)

    # copied from tpudl/frame/supervisor.py:Supervisor._cfg
    def _cfg(self, key, default):
        """The knob value the NEXT attempt will run: an override this
        ladder already applied wins over the last attempt's resolved
        report config (consecutive halvings must see each other)."""
        if key in self.overrides:
            return self.overrides[key]
        cfg = self._report.config if self._report is not None else {}
        v = cfg.get(key)
        return default if v is None else v

    # copied from tpudl/frame/supervisor.py:Supervisor._next_ladder_rung
    def _next_ladder_rung(self) -> str | None:
        """The next applicable rung label, advancing ``_ladder_pos``
        past rungs the current config makes a no-op (depth already 1,
        fusion already off, ...)."""
        while self._ladder_pos < len(LADDER):
            rung = LADDER[self._ladder_pos]
            if rung == "dispatch_depth":
                depth = int(self._cfg("dispatch_depth", 1))
                if depth > 1:
                    half = max(1, depth // 2)
                    self.overrides["dispatch_depth"] = half
                    return f"dispatch_depth={half}"  # stay on this rung
                self._ladder_pos += 1
            elif rung == "fuse_steps":
                self._ladder_pos += 1
                if int(self._cfg("fuse_steps", 1)) > 1:
                    self.overrides["fuse_steps"] = 1
                    self.overrides["autotune"] = False
                    return "fuse_steps=1"
            elif rung == "donate":
                self._ladder_pos += 1
                if bool(self._cfg("donate", False)):
                    self.overrides["donate"] = False
                    return "donate=off"
            else:  # serial: the conservative arm, always applicable once
                return self._jump_to_serial()
        return None

    # copied from tpudl/frame/supervisor.py:Supervisor._jump_to_serial
    def _jump_to_serial(self) -> str:
        """Apply the last-resort rung (the ``TPUDL_MESH_FAST_PATH=0``
        shape) and close the ladder behind it."""
        self._ladder_pos = len(LADDER)
        self.overrides.update(
            prefetch=False, fuse_steps=1, dispatch_depth=1,
            donate=False, autotune=False, device_cache=False)
        return "serial"

    def _retry_transfer(self, exc: BaseException,
                        stage: str | None) -> bool:
        """Route one transfer/IO fault through the ONE shared
        RetryPolicy (:func:`~tpudl_torch.jobs.retry.io_policy`). True = a
        retry attempt was paid for (no knob change); False = the
        policy's budget is spent and the fault falls through to the
        ladder."""
        pol = _retry.io_policy()
        self.transfer_attempts += 1
        if self.transfer_attempts >= pol.max_attempts:
            return False
        delay = pol.backoff_s(self.transfer_attempts)
        # a retry is not a degradation: no knob changed, so it touches
        # neither frame.degraded.* nor the frame.degraded ring; the
        # policy's record() files retry.frame.transfer instead
        pol.record("frame.transfer", exc,
                   attempt=self.transfer_attempts, backoff_s=delay)
        log.warning(
            "frame.supervisor: transfer fault %s in stage %s — retry "
            "%d/%d via the shared io_policy (backoff %.3fs)",
            type(exc).__name__, stage or "?", self.transfer_attempts,
            pol.max_attempts - 1, delay)
        self._sleep_with_beats(delay)
        return True

    # copied from tpudl/frame/supervisor.py:Supervisor._sleep_with_beats
    def _sleep_with_beats(self, seconds: float) -> None:
        """Backoff that stays visibly alive: slept in slices with a
        heartbeat beat per slice, so the watchdog never flags a
        supervised retry's deliberate pause as a stall."""
        deadline = time.monotonic() + max(0.0, float(seconds))
        while True:
            if self._hb is not None:
                self._hb.beat(backing_off=True)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            time.sleep(min(0.05, remaining))

    def _evict_hbm(self) -> int:
        """The OOM rung's action: evict every unpinned device-cache
        entry, freeing card memory for the retry (pinned entries — an
        in-flight dispatch of another run still reads them — stay)."""
        try:
            from tpudl_torch.data import device_cache as _dc

            _n, freed = _dc.get_device_cache().evict_unpinned()
            return freed
        # best-effort recovery action: a cache that cannot evict just
        # means the retry runs against the same memory pressure, and
        # the ladder's shrinking rungs still follow
        except Exception:
            return 0

    # copied from tpudl/frame/supervisor.py:Supervisor._apply_rung
    def _apply_rung(self, label: str, exc: BaseException,
                    stage: str | None, attempt_no: int, **extra) -> None:
        self.rungs.append(label)
        self._record_rung(label, exc, stage, attempt=attempt_no,
                          **extra)

    def _record_rung(self, label: str, exc: BaseException,
                     stage: str | None, **extra) -> None:
        """One degradation event: flight error ring (kind
        ``frame.degraded``) + ``frame.degraded.rungs`` + a warning —
        recovery is silent for the caller, loud for the operator."""
        try:
            from tpudl_torch.obs import flight as _flight
            from tpudl_torch.obs import metrics as _m

            from tpudl_torch.obs import attribution as _attr

            _m.counter("frame.degraded.rungs").inc()
            # the attribution pairing of frame.degraded.rungs
            _attr.charge("degradations")
            _flight.record_error(
                "frame.degraded", exc, rung=label, stage=stage,
                rungs_applied=len(self.rungs), **extra)
        # tpudl: ignore[swallowed-except] — the observer must never
        # take down the recovery it narrates
        except Exception:
            pass
        log.warning(
            "frame.supervisor: %s after %s in stage %s — retrying "
            "(rung %d/%d)", label, type(exc).__name__, stage or "?",
            len(self.rungs), self.max_rungs)

    def _record_recovery(self) -> None:
        """The run survived on a degraded rung: stamp the outcome onto
        the surviving attempt's report + the process-wide counters."""
        batches = 0
        if self._report is not None:
            calls = self._report.report().get("stage_calls") or {}
            batches = int(calls.get("dispatch", 0))
            if self.degraded_to is not None:
                self._report.config["degraded_to"] = self.degraded_to
            self._report.config["recovered_batches"] = batches
        self.recovered_batches = batches
        from tpudl_torch.obs import metrics as _m

        _m.counter("frame.degraded.recovered_batches").inc(batches)

    def _exhausted(self, exc: BaseException, kind: str,
                   stage: str | None) -> None:
        """Out of rungs: file the counters, write the black box, and
        raise the TYPED error chained to the original — a supervised
        run recovers bit for bit or exits typed with a dump, never with
        a raw pool-unwind error and never by hanging."""
        try:
            from tpudl_torch.obs import flight as _flight
            from tpudl_torch.obs import metrics as _m

            _m.counter("frame.degraded.exhausted").inc()
            # ctx key is fault_kind, NOT kind: record_error's first
            # positional is already named kind
            _flight.record_error(
                "frame.degraded.exhausted", exc, fault_kind=kind,
                stage=stage, rungs=",".join(self.rungs) or None)
            _flight.dump(reason="degraded_exhausted", error=exc)
        # tpudl: ignore[swallowed-except] — forensics are best-effort;
        # the typed raise below must happen regardless
        except Exception:
            pass
        cls = _TYPE_FOR.get(kind, StageFault)
        raise cls(
            f"map_batches fault not recoverable after "
            f"{len(self.rungs)} degradation rung(s) "
            f"({', '.join(self.rungs) or 'none applicable'}): "
            f"{type(exc).__name__}: {exc}",
            stage=stage, rungs=self.rungs) from exc
