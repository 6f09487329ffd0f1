"""tpudl_torch.testing.tsan — the opt-in runtime lock sanitizer.

The dynamic half of the concurrency contract (CONCURRENCY.md; the
static half is :mod:`tpudl_torch.analysis.concurrency`). Product code creates
every shared lock through :func:`named_lock`, keyed by its declaration
in the lock registry (:mod:`tpudl_torch.analysis.locks`). Unarmed — the
default — the factory hands back a plain ``threading.Lock`` and the
hot path pays NOTHING per acquisition (the <5% overhead guard in
tests/test_concurrency.py pins the whole unarmed surface); the only
other unarmed cost is the ``if tsan.ENABLED:`` flag check in front of
each :func:`check_guarded` call site.

``TPUDL_TSAN=1`` arms the sanitizer. Every named lock becomes a
:class:`_TsanLock` recording, per thread:

- **acquisition order** — an online lock-order graph (edges by lock
  NAME, so per-instance locks of one class collapse into one rank, the
  classic lock-ranking view). Acquiring B while holding A when the
  graph already shows a B→…→A path is an ACTUAL observed inversion —
  the ABBA pair really interleaved in this process, not just a static
  possibility. Reported once per edge pair.
- **deadlocks** — armed acquisition is a timed loop
  (``TPUDL_TSAN_DEADLOCK_S`` slices); a thread that times out walks the
  wait-for graph (thread → wanted lock → owner thread → …) and, on a
  cycle, files a deadlock finding, dumps the report, and raises
  :class:`DeadlockError` so the wedged process dies loudly instead of
  silently (subsequent timed-out waiters raise too — once the
  sanitizer has concluded the process is deadlocked, nobody keeps
  waiting politely).
- **locksets** — :func:`check_guarded` at a shared structure's
  mutation points (the flight-recorder rings, the pipeline-report
  ring, the metrics registry, the heartbeat registry) asserts the
  declaring thread actually holds the structure's guard lock.
- **hold times** — max/total held seconds per lock name, in the exit
  report (a lock held for seconds is a stall risk the static
  ``lock-held-blocking`` rule approximates; this is the measurement).
- **declared order** — the registry's rank column is a contract:
  acquiring a lower-ranked lock while holding a higher-ranked one is
  recorded as a ``declared-order`` finding even before any inversion
  is observed.

Findings publish as ``tsan.*`` metrics and flight-recorder error-ring
entries (both best-effort — the sanitizer never takes down the
sanitized), and an armed process writes ``tpudl-tsan-<pid>.json``
(atomic, into ``TPUDL_FLIGHT_DIR`` or cwd) at exit.

Stdlib-only at import (this module is imported by the lowest layers —
metrics, the flight recorder — so it must not drag tpudl_torch.obs or jax in
at module load; registry/metrics/flight lookups happen lazily inside
reporting paths).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
import traceback

__all__ = ["ENABLED", "named_lock", "check_guarded", "DeadlockError",
           "arm", "disarm", "enabled", "findings", "report",
           "write_report", "report_path", "reset"]

#: armed at import when TPUDL_TSAN=1 (the subprocess path tests and CI
#: use); :func:`arm`/:func:`disarm` flip it in-process for unit tests —
#: locks created while DISARMED stay plain forever (document: arm
#: before constructing the structures under test).
ENABLED = os.environ.get("TPUDL_TSAN", "0") == "1"

_DEFAULT_DEADLOCK_S = 10.0


class DeadlockError(RuntimeError):
    """Raised by an armed acquisition that is part of (or gated on) a
    detected wait-for cycle."""


def _deadlock_s() -> float:
    try:
        v = float(os.environ.get("TPUDL_TSAN_DEADLOCK_S", "") or
                  _DEFAULT_DEADLOCK_S)
    except ValueError:
        return _DEFAULT_DEADLOCK_S
    return max(0.05, v)


class _State:
    """All armed-mode bookkeeping, one instance per arm() epoch (reset
    drops it wholesale)."""

    def __init__(self):
        # the sanitizer's own internals use RAW locks: instrumenting
        # them would recurse into this very bookkeeping
        self.lock = threading.Lock()
        self.edges: dict[tuple[str, str], dict] = {}   # (a, b) -> witness
        self.succ: dict[str, set[str]] = {}            # a -> {b}
        self.findings: list[dict] = []
        self.reported: set = set()       # dedup keys
        self.owners: dict[int, tuple[int, str]] = {}   # id(lock) -> (tid, name)
        self.waiting: dict[int, tuple[int, str]] = {}  # tid -> (id(lock), name)
        self.hold: dict[str, dict] = {}  # name -> {max_s, total_s, n}
        self.known: set[str] = set()     # names constructed as TsanLock
        self.deadlocked = False
        self.tls = threading.local()

    def held(self) -> list:
        h = getattr(self.tls, "held", None)
        if h is None:
            h = self.tls.held = []
        return h


_ST = _State() if ENABLED else None
_ATEXIT_DONE = False


def enabled() -> bool:
    """Is the sanitizer armed right now? (bench.py's judged rounds
    assert this is False and record it on the summary line)."""
    return ENABLED


def arm():
    """Arm in-process (tests). Locks created from now on are
    instrumented; pre-existing plain locks stay plain."""
    global ENABLED, _ST
    ENABLED = True
    if _ST is None:
        _ST = _State()
    _register_atexit()


def disarm():
    """Disarm in-process (tests). Existing TsanLocks keep working but
    stop recording (their fast path re-checks ENABLED)."""
    global ENABLED
    ENABLED = False


def reset():
    """Drop every recorded edge/finding (tests)."""
    global _ST
    if _ST is not None or ENABLED:
        _ST = _State()


def _state() -> _State:
    global _ST
    if _ST is None:
        # tpudl: ignore[daemon-shared-write] — production arms at
        # import (before any thread exists); arm()/reset() are
        # test-only entry points, and a lost race here costs at worst
        # one pre-arm finding, never a corrupt structure
        _ST = _State()
    return _ST


def _site(skip: int = 2) -> str:
    """Caller's file:line, skipping tsan frames — the witness a report
    points at. Only taken on SLOW paths (new edge, finding)."""
    for fr in reversed(traceback.extract_stack()[:-skip]):
        if not fr.filename.endswith(os.sep + "tsan.py") and \
                "tsan.py" not in fr.filename:
            return f"{fr.filename}:{fr.lineno}"
    return "<unknown>"


def _declared_orders() -> dict[str, int]:
    """Registry name → rank (lazy; cached). Import deferred so tsan
    stays importable below tpudl_torch.analysis."""
    global _ORDERS
    if _ORDERS is None:
        try:
            from tpudl_torch.analysis import locks as _locks

            _ORDERS = {d.name: d.order for d in _locks.LOCKS}
        # tpudl: ignore[swallowed-except] — registry unavailable means
        # order checking is off, not the sanitizer down; the empty map
        # records that
        except Exception:  # pragma: no cover - packaging skew
            _ORDERS = {}
    return _ORDERS


_ORDERS: dict[str, int] | None = None


def _file_finding(kind: str, detail: dict):
    """Record one finding: report list + tsan.* metric + flight error
    ring (metrics/flight best-effort — the sanitizer must never take
    down the process it watches)."""
    st = _state()
    entry = {"kind": kind, "ts": time.time(),
             "thread": threading.current_thread().name}
    entry.update(detail)
    with st.lock:
        st.findings.append(entry)
        del st.findings[:-256]  # bounded even under a pathological loop
    if getattr(st.tls, "reporting", False):
        return  # already inside the breadcrumb channel: no recursion
    # the metrics/flight hop below acquires NAMED product locks while
    # the offending thread may still hold its own — mute edge-noting
    # for the duration so the sanitizer never reports its own
    # reporting path (the self-deadlock raise stays live: an actual
    # reacquisition hang must still die loudly)
    st.tls.reporting = True
    try:
        from tpudl_torch.obs import metrics as _m

        # literal names on purpose: the registry round-trip audit
        # (tests/test_analysis.py) scans call sites for them
        if kind == "inversion":
            _m.counter("tsan.lock_order_inversions").inc()
        elif kind == "deadlock":
            _m.counter("tsan.deadlocks").inc()
        elif kind == "lockset":
            _m.counter("tsan.lockset_violations").inc()
        from tpudl_torch.obs import flight as _f

        _f.record_error(f"tsan.{kind}", entry.get("message", kind),
                        site=entry.get("site"))
    # tpudl: ignore[swallowed-except] — the sanitizer's breadcrumb
    # channel is best-effort: obs may not be importable in a minimal
    # subprocess, and the JSON exit report still carries the finding
    except Exception:
        pass
    finally:
        st.tls.reporting = False


def _note_edge(st: _State, a: str, b: str, same_instance: bool = False):
    """Record 'b acquired while a held'; a pre-existing b→…→a path
    makes this an observed inversion. Dedup keys are checked AND
    claimed under st.lock — two threads observing the same pair
    concurrently must still report it exactly once."""
    if a == b:
        # same instance: legit rlock reentrancy (a non-reentrant lock
        # already raised self-deadlock before reaching here). A SIBLING
        # instance of the same name is rank-equal, and equal ranks
        # never nest (CONCURRENCY.md) — that is a declared-order
        # violation even though no cross-name edge exists.
        if same_instance:
            return
        with st.lock:
            if ("ord-eq", a) in st.reported:
                return
            st.reported.add(("ord-eq", a))
        _file_finding("declared-order", {
            "message": f"equal-rank nesting: two {a!r} instances "
                       f"nested (per-instance siblings share a rank; "
                       f"equal ranks never nest)",
            "edge": [a, b], "site": _site()})
        return
    orders = _declared_orders()
    ra, rb = orders.get(a), orders.get(b)
    with st.lock:
        new = (a, b) not in st.edges
        if new:
            st.edges[(a, b)] = {"thread": threading.current_thread().name,
                                "site": _site(), "ts": time.time()}
            st.succ.setdefault(a, set()).add(b)
        inverted = new and _reaches(st, b, a)
        witness = st.edges.get((b, a)) or next(
            (st.edges[(x, y)] for (x, y) in st.edges
             if x == b), None)
        fire_inv = inverted and ("inv", a, b) not in st.reported
        if fire_inv:
            st.reported.add(("inv", a, b))
        # strictly-higher-only: acquiring an EQUAL rank while one is
        # held violates the contract just like a lower one
        fire_ord = ra is not None and rb is not None and rb <= ra and \
            ("ord", a, b) not in st.reported
        if fire_ord:
            st.reported.add(("ord", a, b))
    # findings are filed OUTSIDE st.lock: _file_finding re-acquires it
    if fire_inv:
        _file_finding("inversion", {
            "message": f"lock-order inversion observed: {a} -> {b} "
                       f"here, but {b} -> ... -> {a} was already "
                       f"recorded",
            "edge": [a, b], "site": _site(),
            "prior_witness": witness})
    if fire_ord:
        how = "equal ranks never nest" if rb == ra else \
            "only strictly higher ranks may be acquired"
        _file_finding("declared-order", {
            "message": f"declared-order violation: {b} (rank {rb}) "
                       f"acquired while holding {a} (rank {ra}) — "
                       f"{how}",
            "edge": [a, b], "site": _site()})


def _reaches(st: _State, src: str, dst: str) -> bool:
    """Path src →* dst in the observed order graph (caller holds
    st.lock)."""
    seen, stack = set(), [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(st.succ.get(n, ()))
    return False


def _waitfor_cycle(st: _State, tid: int) -> list[str] | None:
    """Walk thread → wanted lock → owner thread → …; a return to
    ``tid`` is a genuine deadlock. Returns the lock-name cycle."""
    with st.lock:
        path, seen, cur = [], set(), tid
        while cur not in seen:
            seen.add(cur)
            want = st.waiting.get(cur)
            if want is None:
                return None
            lock_id, name = want
            path.append(name)
            owner = st.owners.get(lock_id)
            if owner is None:
                return None
            cur = owner[0]
        return path if cur == tid else None


class _TsanLock:
    """Instrumented non-reentrant lock (``kind='rlock'`` wraps an RLock
    and permits same-thread reacquisition)."""

    __slots__ = ("name", "kind", "_inner")

    def __init__(self, name: str, kind: str = "lock"):
        _check_kind(kind)
        self.name = str(name)
        self.kind = kind
        self._inner = (threading.RLock() if kind == "rlock"
                       else threading.Lock())
        st = _state()
        with st.lock:
            st.known.add(self.name)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if not ENABLED:
            return self._inner.acquire(blocking, timeout)
        st = _state()
        held = st.held()
        # only an UNBOUNDED blocking reacquire by the holder is a
        # guaranteed hang; a bounded/non-blocking probe falls through
        # to the real inner acquire and returns False like the plain
        # lock — stdlib Condition's _is_owned probes exactly this way,
        # so the recommended Condition(named_lock(name)) pattern
        # depends on it
        if self.kind != "rlock" and blocking and timeout == -1 \
                and any(e[0] is self for e in held):
            _file_finding("deadlock", {
                "message": f"self-deadlock: non-reentrant lock "
                           f"{self.name!r} reacquired by its own "
                           f"holder", "locks": [self.name],
                "site": _site()})
            raise DeadlockError(
                f"tsan: thread would block forever reacquiring "
                f"{self.name!r}")
        if not blocking or timeout != -1:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._on_acquired(st)
            return got
        tid = threading.get_ident()
        slice_s = _deadlock_s()
        with st.lock:
            st.waiting[tid] = (id(self), self.name)
        try:
            while True:
                if self._inner.acquire(True, slice_s):
                    self._on_acquired(st)
                    return True
                if st.deadlocked:
                    raise DeadlockError(
                        f"tsan: process already diagnosed deadlocked; "
                        f"refusing to keep waiting for {self.name!r}")
                cycle = _waitfor_cycle(st, tid)
                if cycle is not None:
                    st.deadlocked = True
                    _file_finding("deadlock", {
                        "message": "deadlock: wait-for cycle "
                                   + " -> ".join(cycle),
                        "locks": cycle, "site": _site()})
                    write_report()
                    raise DeadlockError(
                        "tsan: deadlock detected waiting for "
                        f"{self.name!r} (cycle: {' -> '.join(cycle)})")
        finally:
            with st.lock:
                st.waiting.pop(tid, None)

    def _on_acquired(self, st: _State):
        held = st.held()
        # edges are noted on SUCCESSFUL acquisition only: a failed
        # trylock (`acquire(blocking=False)` backoff — the standard
        # deadlock-AVOIDANCE idiom) must not record an order edge or
        # fire inversion/declared-order findings for an interleaving
        # that never materialized
        if not getattr(st.tls, "reporting", False):
            for entry in held:
                _note_edge(st, entry[1], self.name,
                           same_instance=entry[0] is self)
        held.append((self, self.name, time.monotonic()))
        with st.lock:
            st.owners[id(self)] = (threading.get_ident(), self.name)

    def release(self):
        # bookkeeping cleanup runs whether or not the sanitizer is
        # STILL armed: a disarm() between acquire and release must not
        # leak the held entry/owner record (a stale entry would trip a
        # spurious self-deadlock on the next armed acquisition)
        st = _ST
        if st is not None:
            held = getattr(st.tls, "held", None) or []
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] is self:
                    dt = time.monotonic() - held[i][2]
                    del held[i]
                    with st.lock:
                        h = st.hold.setdefault(
                            self.name, {"max_s": 0.0, "total_s": 0.0,
                                        "n": 0})
                        h["max_s"] = max(h["max_s"], dt)
                        h["total_s"] += dt
                        h["n"] += 1
                        if not any(e[0] is self for e in held):
                            st.owners.pop(id(self), None)
                    break
        self._inner.release()

    def locked(self) -> bool:
        probe = getattr(self._inner, "locked", None)
        if probe is not None:
            return probe()
        # threading.RLock grows locked() only in 3.14 — approximate
        # with a non-blocking probe (NOTE: reports False when held by
        # the CALLING thread, since the reentrant acquire succeeds)
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def _check_kind(kind: str):
    """Only plain locks and rlocks can be handed out: silently giving
    a Lock to code that asked for a condition variable would be an
    AttributeError at the first wait()/notify() — in PRODUCTION, since
    the unarmed factory is the default path."""
    if kind not in ("lock", "rlock"):
        raise ValueError(
            f"named_lock kind {kind!r} is not constructible — for a "
            f"condition variable, wrap the named lock: "
            f"threading.Condition(named_lock(name))")


def named_lock(name: str, kind: str = "lock"):
    """Create the lock declared as ``name`` in the lock registry.

    Unarmed (the default): a plain ``threading.Lock``/``RLock`` —
    zero per-acquisition overhead. Armed (``TPUDL_TSAN=1``): an
    instrumented :class:`_TsanLock`. The name is the registry key; the
    static analyzer reads it off this very call site, so the one
    literal serves declaration coverage, the lock graph, and the
    runtime order checks."""
    if not ENABLED:
        _check_kind(kind)
        return threading.RLock() if kind == "rlock" else threading.Lock()
    return _TsanLock(name, kind)


def check_guarded(lock_name: str, structure: str = "", lock=None):
    """Assert the calling thread holds ``lock_name`` (registered shared
    structures call this at their mutation points, behind an
    ``if tsan.ENABLED:`` flag check so the unarmed hot path pays one
    boolean read). A miss is a lockset violation: somebody mutated the
    structure without its declared guard.

    Pass the guard lock object itself as ``lock`` for per-instance
    guards: name matching alone would be satisfied by holding a
    SIBLING instance's lock of the same registry name — exactly the
    cross-instance race the lockset check exists to catch."""
    if not ENABLED:
        return
    st = _state()
    if getattr(st.tls, "reporting", False):
        # the finding-recording hop itself (metrics counter + flight
        # breadcrumb, _file_finding's mute window): registering the
        # first tsan.* counter MUTATES the metrics registry map, whose
        # own lockset probe would fire here when the registry's guard
        # predates arming (a plain pre-armed Lock is invisible to
        # held()). Same principle as the edge-noting mute: the
        # sanitizer never reports its own reporting path.
        return
    held = st.held()
    if lock is not None:
        if any(e[0] is lock for e in held):
            return
    elif any(e[1] == lock_name for e in held):
        return
    key = ("lockset", lock_name, structure)
    with st.lock:  # check-and-claim atomically: report exactly once
        if lock_name not in st.known or key in st.reported:
            return
        st.reported.add(key)
    _file_finding("lockset", {
        "message": f"lockset violation: {structure or 'structure'} "
                   f"mutated without holding {lock_name!r}",
        "lock": lock_name, "structure": structure, "site": _site()})


def findings() -> list[dict]:
    st = _state()
    with st.lock:
        return list(st.findings)


def report() -> dict:
    """The full sanitizer report (what :func:`write_report` dumps)."""
    st = _state()
    with st.lock:
        return {
            "schema": "tpudl-tsan-report",
            "version": 1,
            "pid": os.getpid(),
            "ts": time.time(),
            "armed": ENABLED,
            "findings": list(st.findings),
            "edges": [{"from": a, "to": b, **w}
                      for (a, b), w in sorted(st.edges.items())],
            "locks_seen": sorted(st.known),
            "hold_times": {k: {"max_s": round(v["max_s"], 6),
                               "total_s": round(v["total_s"], 6),
                               "n": v["n"]}
                           for k, v in sorted(st.hold.items())},
        }


def report_path() -> str:
    d = os.environ.get("TPUDL_FLIGHT_DIR") or os.getcwd()
    return os.path.join(d, f"tpudl-tsan-{os.getpid()}.json")


def write_report(path: str | None = None) -> str | None:
    """Atomically write the report JSON; never raises (the sanitizer
    must not kill the exiting process it watched)."""
    out = path or report_path()
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        payload = report()
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, default=str)
        os.replace(tmp, out)
        return out
    except Exception:
        # exit-path best effort: a failed report write must not turn a
        # clean exit into a crash (the unlink attempt below is the
        # breadcrumb-free cleanup the rule accepts)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _register_atexit():
    global _ATEXIT_DONE
    if not _ATEXIT_DONE:
        _ATEXIT_DONE = True
        atexit.register(lambda: write_report() if ENABLED else None)


if ENABLED:
    _register_atexit()
