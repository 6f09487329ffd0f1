"""Stall watchdog: heartbeat registry and the no-progress daemon.

Port of ``tpudl/obs/watchdog.py`` (with its lock sanitizer's hooks).
A hung infeed and a slow run look alike from outside; the watchdog tells
them apart while the process is alive:

- instrumented layers hold a :class:`Heartbeat` while they own work and
  ``beat()`` on every unit of progress — the executor on every stage
  event (prepare, h2d, dispatch, d2h), ``Trainer.fit`` every step, the
  serve loop every tick, UDF calls and HPO trials per invocation;
- a daemon thread (:class:`Watchdog`) scans the active heartbeats every
  ``interval`` seconds; one that has not beaten for
  ``TPUDL_WATCHDOG_STALL_S`` seconds is STALLED: the event (name, the
  last beat's info, which stages are in flight, its age, and every
  Python thread's stack) lands in the flight recorder's stall ring,
  ``obs.watchdog.stalls`` counts it, and a warning is logged. One event
  per stall episode (re-armed by the next beat).

The daemon starts lazily on the first ``heartbeat(...)`` when
``TPUDL_WATCHDOG_STALL_S`` is set (> 0), or through
:func:`start_watchdog`. A heartbeat's registration also arms the live
status writer (:mod:`tpudl_torch.obs.live`). Beating is a lock and two
attribute writes.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback

from tpudl_torch.testing import tsan as _tsan

__all__ = ["Heartbeat", "HeartbeatRegistry", "Watchdog", "get_registry",
           "heartbeat", "start_watchdog", "stop_watchdog",
           "thread_stacks"]

log = logging.getLogger("tpudl.obs.watchdog")

DEFAULT_STALL_S = 30.0


# copied from tpudl/obs/watchdog.py:_env_stall_s
def _env_stall_s() -> float:
    try:
        return float(os.environ.get("TPUDL_WATCHDOG_STALL_S", "") or 0.0)
    except ValueError:
        return 0.0


# copied from tpudl/obs/watchdog.py:thread_stacks
def thread_stacks(limit: int = 40) -> dict[str, list[str]]:
    """Every live Python thread's current stack, formatted — the "where
    is everyone frozen" snapshot a stall event carries. Keys are
    ``"<tid>:<thread name>"``."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        stack = traceback.format_stack(frame, limit=limit)
        out[f"{tid}:{names.get(tid, '?')}"] = [ln.rstrip()
                                               for ln in stack]
    return out


# copied from tpudl/obs/watchdog.py:Heartbeat
class Heartbeat:
    """One unit of supervised work. Use as a context manager::

        with watchdog.heartbeat("train.fit", steps=100) as hb:
            for step in ...:
                hb.beat(step=step)

    While the block is active and not beating, the daemon counts its
    age; leaving the block deregisters it (finished work can't stall).

    Two refinements matter for honest attribution:

    - **parent re-arm** — a heartbeat created while another is active
      on the same thread records it as its parent, and every beat
      re-arms the whole parent chain. An outer coarse heartbeat (a UDF
      call, an HPO trial) with one beat per invocation therefore never
      false-flags while its inner executor/trainer heartbeats are
      making progress — it only stalls when EVERYTHING under it does;
    - **in-flight stages** — ``stage_enter``/``stage_exit`` (used by
      ``PipelineReport.stage``) track which stages are currently
      ENTERED and for how long. A stall's suspect is the oldest
      in-flight stage, not the most recent beat: a wedged dispatch
      stays in flight while the prepare pool's final beats come and
      go, so it cannot be mis-blamed on the input side.
    """

    __slots__ = ("name", "info", "started", "last_beat", "beats",
                 "stalled", "parent", "_registry", "_inflight",
                 "_iflock")

    def __init__(self, name: str, registry: "HeartbeatRegistry",
                 parent: "Heartbeat | None" = None, **info):
        self.name = str(name)
        self.info = dict(info)
        self.started = time.monotonic()
        self.last_beat = self.started
        self.beats = 0
        self.stalled = False
        self.parent = parent
        self._registry = registry
        self._inflight: dict[str, list] = {}  # stage -> [count, t0]
        # one lock per heartbeat covers the beat fields AND the
        # in-flight stage map: the watchdog daemon and the status
        # writer snapshot both while beat()/stage_enter() mutate them
        self._iflock = _tsan.named_lock("obs.watchdog.heartbeat")

    def beat(self, **info):
        """Progress happened. ``info`` overlays the heartbeat's info
        (e.g. ``stage="prepare"``) so a later stall names the exact
        stage that beat LAST; the parent chain is re-armed too.

        Guarded by ``_iflock``: the daemon and the status writer copy
        ``info`` concurrently, and a dict mutated mid-copy raises
        RuntimeError in the READER (tests/test_concurrency.py pins the
        regression). Parent locks are taken one at a time AFTER
        releasing our own — per-heartbeat locks share a rank and must
        never nest (tpudl/analysis/locks.py)."""
        now = time.monotonic()
        with self._iflock:
            self.last_beat = now
            self.beats += 1
            self.stalled = False  # re-arm: one event per stall episode
            if info:
                self.info.update(info)
        p = self.parent
        while p is not None:  # child progress IS parent progress
            with p._iflock:
                p.last_beat = now
                p.stalled = False
            p = p.parent

    def stage_enter(self, stage: str):
        """A named stage began (and beat): it stays IN FLIGHT until
        ``stage_exit``, so a freeze inside it is attributable even
        after other stages beat afterwards."""
        self.beat(stage=stage)
        with self._iflock:
            ent = self._inflight.setdefault(stage, [0, 0.0])
            if ent[0] == 0:
                ent[1] = time.monotonic()
            ent[0] += 1

    def stage_exit(self, stage: str):
        self.beat()
        with self._iflock:
            ent = self._inflight.get(stage)
            if ent is not None:
                ent[0] -= 1
                if ent[0] <= 0:
                    self._inflight.pop(stage, None)

    def inflight(self, now: float | None = None) -> dict:
        """``{stage: {count, age_s}}`` of currently-entered stages —
        the stall event's suspect material."""
        now = now if now is not None else time.monotonic()
        with self._iflock:
            # a stage_enter() can land between the caller's `now` and
            # this snapshot — clamp like describe(): never negative
            return {k: {"count": v[0],
                        "age_s": round(max(0.0, now - v[1]), 3)}
                    for k, v in self._inflight.items()}

    def age(self, now: float | None = None) -> float:
        return (now if now is not None else time.monotonic()) \
            - self.last_beat

    def mark_stalled(self):
        """Daemon-side: flag this heartbeat's stall episode (re-armed
        by the next beat)."""
        with self._iflock:
            self.stalled = True

    def describe(self, now: float | None = None) -> dict:
        now = now if now is not None else time.monotonic()
        with self._iflock:
            # a beat can land between the caller's `now` and this
            # snapshot — clamp: an age is never negative
            snap = {"name": self.name, "info": dict(self.info),
                    "beats": self.beats,
                    "age_s": round(max(0.0, now - self.last_beat), 3),
                    "alive_s": round(now - self.started, 3),
                    "stalled": self.stalled}
        # sequential second acquisition (inflight takes the same
        # non-reentrant lock) — never nested
        snap["in_flight"] = self.inflight(now)
        return snap

    def __enter__(self) -> "Heartbeat":
        return self

    def __exit__(self, *exc):
        self._registry._remove(self)
        return False


# copied from tpudl/obs/watchdog.py:HeartbeatRegistry
class HeartbeatRegistry:
    """Thread-safe set of active heartbeats (the watchdog's scan
    list). A per-thread stack links nested heartbeats (parent re-arm,
    see :class:`Heartbeat`)."""

    def __init__(self):
        self._lock = _tsan.named_lock("obs.watchdog.registry")
        self._active: set[Heartbeat] = set()
        self._tls = threading.local()

    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def start(self, name: str, **info) -> Heartbeat:
        stack = self._stack()
        parent = stack[-1] if stack else None
        hb = Heartbeat(name, self, parent=parent, **info)
        with self._lock:
            if _tsan.ENABLED:
                _tsan.check_guarded("obs.watchdog.registry",
                                    "heartbeat registry active set",
                                    lock=self._lock)
            self._active.add(hb)
        stack.append(hb)
        return hb

    def _remove(self, hb: Heartbeat):
        with self._lock:
            self._active.discard(hb)
        # normally a LIFO pop on the creating thread; an exit from
        # another thread just leaves a harmless dead parent link
        s = getattr(self._tls, "stack", None)
        if s and hb in s:
            s.remove(hb)

    def active(self) -> list[Heartbeat]:
        with self._lock:
            return list(self._active)

    def describe(self) -> dict:
        """``{name: descriptor}`` of every active heartbeat — what a
        flight dump records so the doctor sees who was mid-work at
        death (duplicate names keep the oldest-beat entry: the stuck
        one is the interesting one)."""
        now = time.monotonic()
        out: dict[str, dict] = {}
        for hb in sorted(self.active(), key=lambda h: h.last_beat):
            out.setdefault(hb.name, hb.describe(now))
        return out

    def clear(self):
        with self._lock:
            self._active.clear()
        s = getattr(self._tls, "stack", None)
        if s:
            del s[:]


# copied from tpudl/obs/watchdog.py:Watchdog
class Watchdog:
    """The no-progress daemon. ``stall_s`` is the flag threshold;
    ``interval`` the scan period (default ``stall_s / 4``, floored at
    50 ms so tests with sub-second thresholds stay responsive)."""

    def __init__(self, registry: HeartbeatRegistry,
                 stall_s: float | None = None,
                 interval: float | None = None):
        self.registry = registry
        self.stall_s = float(stall_s if stall_s is not None
                             else (_env_stall_s() or DEFAULT_STALL_S))
        self.interval = float(interval if interval is not None
                              else max(0.05, self.stall_s / 4.0))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpudl-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.scan()
            except Exception:  # the observer never kills the observed
                log.debug("watchdog scan failed", exc_info=True)

    def scan(self) -> list[dict]:
        """One pass over the active heartbeats; returns the stall
        events it flagged (tests drive this directly for determinism).
        Also feeds the flight recorder's metric-tick ring, so a dump
        carries the metric trajectory sampled at watchdog cadence."""
        from tpudl_torch.obs import flight as _flight
        from tpudl_torch.obs import metrics as _metrics

        now = time.monotonic()
        flagged = []
        for hb in self.registry.active():
            if hb.stalled or hb.age(now) <= self.stall_s:
                continue
            hb.mark_stalled()  # one event per episode
            # describe() snapshots info/beats/in_flight under the
            # heartbeat's lock — reading the live dicts here raced
            # beat()'s mutations (the Heartbeat.beat regression test)
            desc = hb.describe(now)
            event = {"ts": time.time(), "name": hb.name,
                     "info": desc["info"], "beats": desc["beats"],
                     "age_s": desc["age_s"],
                     "stall_s": self.stall_s,
                     "in_flight": desc["in_flight"],
                     "active": sorted(h.name
                                      for h in self.registry.active()),
                     "stacks": thread_stacks()}
            flagged.append(event)
            _metrics.counter("obs.watchdog.stalls").inc()
            _flight.get_recorder().record_stall(event)
            log.warning(
                "watchdog: %r made no progress for %.1fs (> %.1fs) — "
                "last info %s; thread stacks recorded in the flight "
                "recorder", hb.name, desc["age_s"], self.stall_s,
                desc["info"])
        _flight.get_recorder().record_metrics_tick()
        return flagged


_REGISTRY = HeartbeatRegistry()
_WATCHDOG: Watchdog | None = None
_WATCHDOG_LOCK = _tsan.named_lock("obs.watchdog.daemon")


# copied from tpudl/obs/watchdog.py:get_registry
def get_registry() -> HeartbeatRegistry:
    return _REGISTRY


# copied from tpudl/obs/watchdog.py:heartbeat
def heartbeat(name: str, **info) -> Heartbeat:
    """Register supervised work on the process-wide registry (and
    lazily start the daemon when ``TPUDL_WATCHDOG_STALL_S`` is set).
    Use as a context manager; call ``.beat()`` on progress.

    Registering also arms the live status writer
    (:mod:`tpudl.obs.live`, ``TPUDL_STATUS_DIR``): any layer that
    supervises work is by definition work worth watching in
    ``obs top``, so the one registrar covers executor/trainer/UDF/HPO
    without per-layer plumbing."""
    _maybe_autostart()
    try:
        from tpudl_torch.obs import live as _live

        _live.ensure_status_writer()
    # tpudl: ignore[swallowed-except] — the observer never kills the
    # observed: a broken status writer just means no obs top
    except Exception:
        pass
    return _REGISTRY.start(name, **info)


# copied from tpudl/obs/watchdog.py:_maybe_autostart
def _maybe_autostart():
    if _WATCHDOG is None and _env_stall_s() > 0:
        start_watchdog()


# copied from tpudl/obs/watchdog.py:start_watchdog
def start_watchdog(stall_s: float | None = None,
                   interval: float | None = None) -> Watchdog:
    """Start (or return) the process-wide daemon. Explicit args win
    over ``TPUDL_WATCHDOG_STALL_S``."""
    global _WATCHDOG
    with _WATCHDOG_LOCK:
        if _WATCHDOG is None:
            _WATCHDOG = Watchdog(_REGISTRY, stall_s=stall_s,
                                 interval=interval)
            _WATCHDOG.start()
        return _WATCHDOG


# copied from tpudl/obs/watchdog.py:stop_watchdog
def stop_watchdog():
    """Stop and forget the daemon (tests)."""
    global _WATCHDOG
    with _WATCHDOG_LOCK:
        if _WATCHDOG is not None:
            _WATCHDOG.stop()
            _WATCHDOG = None
