"""Flight recorder: the always-on black box that explains a dead run.

Port of ``tpudl/obs/flight.py``. A process-wide :class:`FlightRecorder`
keeps bounded rings of recent evidence:

- **batch descriptors** (shapes, dtypes, a cheap fingerprint, never the
  data) that the frame executor files for every prepared batch;
- **errors** (injected faults, decode errors, corrupt shards, retries,
  supervisor rungs, SLO tail exemplars, any layer's ``record_error``)
  with type, message and context;
- **stall events** from :mod:`tpudl_torch.obs.watchdog`, each with every
  Python thread's stack at detection time;
- **restarts** (gang restarts of ``HorovodRunner``), **requests**,
  lifecycle **events** and **metric ticks**.

``dump()`` writes those rings, the metrics snapshot, the pipeline-report
ring, the host-span tracer's tail, the watchdog's live heartbeats, the
attribution ledger with its reconciliation and an env/backend snapshot into ONE self-contained
``tpudl-dump-<pid>.json.gz`` (``tpudl-dump-host<idx>-<pid>.json.gz`` for
a rank of a ``torch.distributed`` group), atomically (tmp +
``os.replace``), in tpudl's schema (:data:`DUMP_SCHEMA`, version
:data:`DUMP_VERSION`), so tpudl's ``obs doctor`` reads a dump of the
port. The backend section names torch, its CUDA version and the card
where jax's facts stood; the rank of an initialized group is the
process index.

``install()`` arms the automatic triggers: unhandled exceptions (a
``sys.excepthook`` chain), SIGTERM and SIGQUIT (earlier handlers chained
after the dump, default semantics kept), and with ``TPUDL_FAULTHANDLER=1``
the stdlib ``faulthandler`` writing native-crash stacks to
``tpudl-fault-<pid>.log`` beside the dumps.

"""

from __future__ import annotations

import gzip
import itertools
import json
import os
import signal
import sys
import threading
import time
import traceback
import zlib
from collections import deque

from tpudl_torch.testing import tsan as _tsan

__all__ = ["FlightRecorder", "get_recorder", "record_error",
           "record_batch", "record_request", "dump", "install",
           "DUMP_SCHEMA", "DUMP_VERSION", "dump_path_for"]

DUMP_SCHEMA = "tpudl-flight-dump"
DUMP_VERSION = 3

_DUMP_SEQ = itertools.count()  # tmp-name uniqueness across dump writers

# ring bounds (env-overridable at recorder construction)
_DEFAULT_BATCHES = 32
_DEFAULT_ERRORS = 64
_DEFAULT_STALLS = 16
_DEFAULT_TICKS = 32
_DEFAULT_REQUESTS = 64
_DEFAULT_SPAN_TAIL = 512
# env prefixes worth keeping in a dump — a full os.environ copy could
# leak credentials into an artifact that gets attached to bug reports
_ENV_PREFIXES = ("TPUDL_", "CUDA_", "NCCL_", "PYTORCH_", "TORCH_")


# copied from tpudl/obs/flight.py:_env_int
def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _backend_info() -> dict:
    """torch, CUDA and process facts, each best-effort and without
    initializing CUDA: a dump from a dying process must not bring a card
    up."""
    torch = sys.modules.get("torch")
    info: dict = {"torch_loaded": torch is not None}
    if torch is None:
        return info
    info["version"] = getattr(torch, "__version__", None)
    try:
        info["cuda"] = torch.version.cuda
        if torch.cuda.is_initialized():
            info["device_count"] = int(torch.cuda.device_count())
            info["device"] = torch.cuda.get_device_name(
                torch.cuda.current_device())
            info["backend"] = "cuda"
        else:
            info["backend"] = "cpu"
    # tpudl: ignore[swallowed-except] — best-effort probe of a possibly
    # wedged runtime; a missing key IS the evidence
    except Exception:
        pass
    try:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            info["process_index"] = int(dist.get_rank())
            info["process_count"] = int(dist.get_world_size())
    # tpudl: ignore[swallowed-except] — as above: a process group that
    # cannot answer leaves its keys out of the dump
    except Exception:
        pass
    return info


# copied from tpudl/obs/flight.py:batch_fingerprint
def batch_fingerprint(arrays) -> str | None:
    """Cheap content identity of one prepared batch: crc32 over the
    first KB of each column's raw bytes + total size. Identifies a
    repeating/poisoned batch across dumps without ever storing pixel
    data (the descriptor contract: shapes/dtypes/fingerprints, never
    values). None when a column can't expose raw bytes (object
    arrays)."""
    try:
        crc = 0
        total = 0
        for arr in arrays:
            dt = getattr(arr, "dtype", None)
            if dt is None or dt == object:
                return None
            total += int(arr.nbytes)
            if getattr(arr, "flags", None) is not None \
                    and arr.flags.c_contiguous:
                # reshape of a contiguous array is a VIEW; tobytes on
                # the 256-element slice is O(1KB) no matter the batch
                head_bytes = arr.reshape(-1)[:256].tobytes()
            else:
                # non-contiguous (strided/transposed pack output):
                # reshape would copy the WHOLE array — sample via the
                # flat iterator instead (256 element reads, no copy)
                import numpy as _np

                head_bytes = _np.asarray(
                    [x for _, x in zip(range(256), arr.flat)],
                    dtype=arr.dtype).tobytes()
            crc = zlib.crc32(head_bytes, crc)
        return f"{crc & 0xFFFFFFFF:08x}-{total}"
    except Exception:
        return None


class FlightRecorder:
    """Bounded in-memory black box + atomic gzip dump writer."""

    def __init__(self):
        self._lock = _tsan.named_lock("obs.flight.recorder")
        self._batches: deque = deque(
            maxlen=max(1, _env_int("TPUDL_FLIGHT_BATCHES",
                                   _DEFAULT_BATCHES)))
        self._errors: deque = deque(
            maxlen=max(1, _env_int("TPUDL_FLIGHT_ERRORS", _DEFAULT_ERRORS)))
        self._stalls: deque = deque(
            maxlen=max(1, _env_int("TPUDL_FLIGHT_STALLS", _DEFAULT_STALLS)))
        self._ticks: deque = deque(
            maxlen=max(1, _env_int("TPUDL_FLIGHT_TICKS", _DEFAULT_TICKS)))
        self._requests: deque = deque(
            maxlen=max(1, _env_int("TPUDL_FLIGHT_REQUESTS",
                                   _DEFAULT_REQUESTS)))
        self._restarts: list = []  # train gang restarts: small + precious,
        self._events: deque = deque(maxlen=64)  # lifecycle breadcrumbs
        self._installed = False    # never ring-evicted
        self._prev_excepthook = None
        self._prev_signal: dict = {}
        self._fault_file = None
        self.dumped_paths: list[str] = []

    # -- recording (hot-path safe) ----------------------------------------
    def record_batch(self, stage: str, index: int, arrays, **info):
        """One prepared batch's descriptor: shapes/dtypes/fingerprint
        only. Called by the frame executor per batch — must stay a
        dict-build + deque append."""
        try:
            desc = {"ts": time.time(), "stage": str(stage),
                    "index": int(index),
                    "shapes": [list(getattr(a, "shape", ())) for a in arrays],
                    "dtypes": [str(getattr(a, "dtype", type(a).__name__))
                               for a in arrays],
                    "fingerprint": batch_fingerprint(arrays)}
            desc.update(info)
        # tpudl: ignore[swallowed-except] — per-batch hot-path hook:
        # the observer must never take down the pipeline, and there is
        # no cheaper breadcrumb channel than this recorder itself
        except Exception:
            return
        with self._lock:
            if _tsan.ENABLED:
                _tsan.check_guarded("obs.flight.recorder",
                                    "flight-recorder batch ring",
                                    lock=self._lock)
            self._batches.append(desc)

    # copied from tpudl/obs/flight.py:FlightRecorder.record_error
    def record_error(self, kind: str, error, **ctx):
        """One failure event (decode error, shard corruption, restart
        cause ...). ``error`` may be an exception or a message string;
        context keys must be JSON-scalar."""
        if isinstance(error, BaseException):
            entry = {"type": type(error).__name__,
                     "message": str(error)[:500]}
        else:
            entry = {"type": None, "message": str(error)[:500]}
        entry.update({"ts": time.time(), "kind": str(kind)})
        for k, v in ctx.items():
            entry[k] = v if isinstance(
                v, (int, float, str, bool, type(None))) else repr(v)[:200]
        with self._lock:
            self._errors.append(entry)

    # copied from tpudl/obs/flight.py:FlightRecorder.record_restart
    def record_restart(self, attempt: int, error, step: float | None = None,
                       max_restarts: int | None = None):
        """One gang restart: the triggering exception + the step count
        at failure, so ``max_restarts`` exhaustion explains WHY (the
        ``train.restarts`` counter only says how often)."""
        entry = {"ts": time.time(), "attempt": int(attempt),
                 "step": step, "max_restarts": max_restarts,
                 "error_type": type(error).__name__
                 if isinstance(error, BaseException) else None,
                 "error": str(error)[:500],
                 "traceback": "".join(traceback.format_exception(
                     error))[-2000:]
                 if isinstance(error, BaseException) else None}
        with self._lock:
            self._restarts.append(entry)
            del self._restarts[:-64]  # bounded even under a crash loop
        self.record_error("train.restart", error, attempt=attempt,
                          step=step)

    # copied from tpudl/obs/flight.py:FlightRecorder.record_request
    def record_request(self, rec: dict):
        """One TERMINAL serve request's descriptor (trace id, segment
        milliseconds, outcome — built by
        :func:`tpudl.serve.reqtrace.request_record`; NEVER prompt
        content, per the validate_dump contract). Serve hot path: must
        stay a lock + deque append."""
        with self._lock:
            self._requests.append(rec)

    # copied from tpudl/obs/flight.py:FlightRecorder.record_stall
    def record_stall(self, stall: dict):
        """Filed by the watchdog: one no-progress event with thread
        stacks at detection time."""
        with self._lock:
            self._stalls.append(stall)

    # copied from tpudl/obs/flight.py:FlightRecorder.record_event
    def record_event(self, kind: str, **fields):
        """Small lifecycle breadcrumb (distributed init, install,
        dump)."""
        entry = {"ts": time.time(), "kind": str(kind)}
        entry.update(fields)
        with self._lock:
            self._events.append(entry)

    def record_metrics_tick(self):
        """Periodic registry snapshot into the tick ring: a dump then
        shows the metric trajectory, not just the final totals."""
        try:
            from tpudl_torch.obs import metrics as _m

            snap = _m.snapshot()
        # tpudl: ignore[swallowed-except] — periodic tick: a broken
        # metrics registry just means a sparser trajectory in the dump
        except Exception:
            return
        with self._lock:
            self._ticks.append({"ts": time.time(), "metrics": snap})

    # -- dump assembly ------------------------------------------------------
    def snapshot(self, reason: str = "manual", error=None) -> dict:
        """The full dump payload as a plain dict (the schema tpudl's
        ``tools/validate_dump.py`` audits)."""
        binfo = _backend_info()
        payload: dict = {
            "schema": DUMP_SCHEMA,
            "version": DUMP_VERSION,
            "reason": str(reason),
            "ts": time.time(),
            "pid": os.getpid(),
            "process_index": int(binfo.get("process_index", 0) or 0),
            "process_count": int(binfo.get("process_count", 1) or 1),
            "argv": list(sys.argv),
            "python": sys.version.split()[0],
            "backend": binfo,
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith(_ENV_PREFIXES)},
        }
        if error is not None:
            if isinstance(error, BaseException):
                payload["error"] = {
                    "type": type(error).__name__,
                    "message": str(error)[:2000],
                    "traceback": "".join(
                        traceback.format_exception(error))[-8000:]}
            else:
                payload["error"] = {"type": None,
                                    "message": str(error)[:2000]}
        else:
            payload["error"] = None
        with self._lock:
            payload["batches"] = list(self._batches)
            payload["errors"] = list(self._errors)
            payload["stalls"] = list(self._stalls)
            payload["metric_ticks"] = list(self._ticks)
            payload["requests"] = list(self._requests)
            payload["restarts"] = list(self._restarts)
            payload["events"] = list(self._events)
        # the rest of obs contributes its own rings (each best-effort:
        # a dump from a dying interpreter takes what it can get)
        try:
            from tpudl_torch.obs import metrics as _m

            payload["metrics"] = _m.snapshot()
        # tpudl: ignore[swallowed-except] — dying-interpreter dump
        # takes what it can get; the empty default marks the gap
        except Exception:
            payload["metrics"] = {}
        try:
            from tpudl_torch.obs import pipeline as _p

            payload["pipeline_reports"] = _p.pipeline_reports()
        # tpudl: ignore[swallowed-except] — dying-interpreter dump
        # takes what it can get; the empty default marks the gap
        except Exception:
            payload["pipeline_reports"] = {}
        try:
            from tpudl_torch.obs import tracer as _t

            spans = _t.get_tracer().spans()[-_env_int(
                "TPUDL_FLIGHT_SPANS", _DEFAULT_SPAN_TAIL):]
            payload["spans"] = [
                {"name": s.name, "ts_us": s.ts_us, "dur_us": s.dur_us,
                 "tid": s.tid, "thread": s.thread_name,
                 "attrs": dict(s.attrs) if s.attrs else None}
                for s in spans]
        # tpudl: ignore[swallowed-except] — dying-interpreter dump
        # takes what it can get; the empty default marks the gap
        except Exception:
            payload["spans"] = []
        try:
            from tpudl_torch.obs import watchdog as _w

            payload["heartbeats"] = _w.get_registry().describe()
        # tpudl: ignore[swallowed-except] — dying-interpreter dump
        # takes what it can get; the empty default marks the gap
        except Exception:
            payload["heartbeats"] = {}
        try:
            from tpudl_torch.obs import attribution as _attr

            led = _attr.ledger_snapshot()
            # the verdict is computed against THIS dump's metrics copy,
            # so the pair in the artifact is self-consistent even if
            # counters kept moving after the snapshot above
            led["reconcile"] = _attr.reconcile(payload.get("metrics")
                                               or None)
            payload["ledger"] = led
        # tpudl: ignore[swallowed-except] — dying-interpreter dump
        # takes what it can get; the None default marks the gap
        except Exception:
            payload["ledger"] = None
        return payload

    # copied from tpudl/obs/flight.py:FlightRecorder.dump
    def dump(self, reason: str = "manual", error=None,
             path: str | None = None,
             timeout: float | None = None) -> str | None:
        """Write one self-contained gzip dump atomically; returns the
        path, or None when even best-effort writing failed (a dying
        process must never die harder because of its black box).

        ``timeout`` assembles the dump on a worker thread and gives up
        after that many seconds — required from signal handlers, where
        an inline snapshot could deadlock on a lock the interrupted
        frame holds."""
        if timeout is not None:
            result: dict = {}
            t = threading.Thread(
                target=lambda: result.update(
                    path=self._dump_inner(reason, error, path)),
                daemon=True, name="tpudl-flight-dump")
            t.start()
            t.join(timeout)
            return result.get("path")
        return self._dump_inner(reason, error, path)

    # copied from tpudl/obs/flight.py:FlightRecorder._dump_inner
    def _dump_inner(self, reason: str, error, path: str | None,
                    ) -> str | None:
        tmp = None
        try:
            payload = self.snapshot(reason=reason, error=error)
            out = path or dump_path_for(
                payload["process_index"], payload["process_count"])
            # unique per writer: an abandoned timeout-dump worker may
            # still be finishing when a second dump runs — pid alone
            # would collide their tmp files and fail both replaces
            tmp = (f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
                   f".{next(_DUMP_SEQ)}")
            with gzip.open(tmp, "wt", encoding="utf-8") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, out)
            with self._lock:
                self.dumped_paths.append(out)
            self.record_event("dump", reason=str(reason), path=out)
            return out
        except Exception:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            return None

    # -- triggers -----------------------------------------------------------
    def install(self, dump_dir: str | None = None,
                signals=(signal.SIGTERM,
                         getattr(signal, "SIGQUIT", None)),
                excepthook: bool = True) -> "FlightRecorder":
        """Arm automatic dumping. Idempotent; earlier handlers are
        chained, not replaced — after the dump the previous Python
        handler runs, and a default-disposition signal is raised again
        with its default handler restored, so exit codes stay.

        ``TPUDL_FAULTHANDLER=1`` also enables the stdlib
        ``faulthandler`` on fatal native signals, writing Python stacks
        to ``tpudl-fault-<pid>.log`` in the dump directory: a crash in
        a CUDA library happens below the interpreter, where no
        excepthook runs."""
        if dump_dir:
            os.environ["TPUDL_FLIGHT_DIR"] = str(dump_dir)
        if self._installed:
            return self
        self._installed = True
        if excepthook:
            self._prev_excepthook = sys.excepthook

            def hook(exc_type, exc, tb):
                # top of a unwound stack: no obs lock can still be
                # held by this thread, so an inline dump is safe here
                self.dump(reason="exception", error=exc)
                (self._prev_excepthook or sys.__excepthook__)(
                    exc_type, exc, tb)

            sys.excepthook = hook
        for sig in signals:
            if sig is None:
                continue
            try:
                prev = signal.getsignal(sig)

                # tpudl: ignore[signal-handler, signal-lock] — THE
                # forensics handler: dump() assembles on a bounded
                # WORKER thread (timeout=10) so an interrupted frame
                # holding an obs lock can't deadlock it (the worker,
                # not the handler frame, takes the recorder/metrics/
                # report locks), then chains/re-raises for default
                # exit semantics
                def handler(signum, frame, _prev=prev):
                    self.dump(reason=f"signal:{signum}", timeout=10.0)
                    if callable(_prev):
                        _prev(signum, frame)
                    elif _prev != signal.SIG_IGN:
                        signal.signal(signum, signal.SIG_DFL)
                        os.kill(os.getpid(), signum)

                signal.signal(sig, handler)
                self._prev_signal[sig] = prev
            except (ValueError, OSError):
                pass  # not the main thread / exotic platform
        if os.environ.get("TPUDL_FAULTHANDLER", "0") == "1":
            try:
                import faulthandler

                fault_path = os.path.join(
                    _dump_dir(), f"tpudl-fault-{os.getpid()}.log")
                self._fault_file = open(fault_path, "w")  # noqa: SIM115
                # the fd stays open for the process lifetime: the
                # handler writes from the crashed state
                faulthandler.enable(file=self._fault_file,
                                    all_threads=True)
                self.record_event("faulthandler", path=fault_path)
            # tpudl: ignore[swallowed-except] — opt-in extra: an
            # unwritable fault log must not break install(); the reset
            # to None records that it is off
            except Exception:
                self._fault_file = None
        self.record_event("install")
        return self

    # -- tests --------------------------------------------------------------
    def reset(self):
        """Drop recorded evidence (tests; the trigger installation
        stays)."""
        with self._lock:
            for ring in (self._batches, self._errors, self._stalls,
                         self._ticks, self._requests, self._events):
                ring.clear()
            del self._restarts[:]
            del self.dumped_paths[:]


# copied from tpudl/obs/flight.py:_dump_dir
def _dump_dir() -> str:
    d = os.environ.get("TPUDL_FLIGHT_DIR") or os.getcwd()
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        d = os.getcwd()
    return d


# copied from tpudl/obs/flight.py:dump_path_for
def dump_path_for(proc_index: int = 0, proc_count: int = 1) -> str:
    """The per-process dump file path: single-host runs get
    ``tpudl-dump-<pid>.json.gz``; gang members key by process index
    (``tpudl-dump-host<idx>-<pid>.json.gz``) so every host's black box
    lands distinctly in a shared dir for the doctor to merge."""
    name = (f"tpudl-dump-host{int(proc_index)}-{os.getpid()}.json.gz"
            if int(proc_count) > 1
            else f"tpudl-dump-{os.getpid()}.json.gz")
    return os.path.join(_dump_dir(), name)


_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _RECORDER


def record_error(kind: str, error, **ctx):
    _RECORDER.record_error(kind, error, **ctx)


def record_batch(stage: str, index: int, arrays, **info):
    _RECORDER.record_batch(stage, index, arrays, **info)


def record_request(rec: dict):
    _RECORDER.record_request(rec)


def dump(reason: str = "manual", error=None, path: str | None = None,
         timeout: float | None = None) -> str | None:
    """Write the black box now (explicit trigger). Pass ``timeout`` when
    calling from a signal handler (see :meth:`FlightRecorder.dump`)."""
    return _RECORDER.dump(reason=reason, error=error, path=path,
                          timeout=timeout)


def install(dump_dir: str | None = None, **kw) -> FlightRecorder:
    """Arm exception/signal dumping (see :meth:`FlightRecorder.install`)."""
    return _RECORDER.install(dump_dir=dump_dir, **kw)
