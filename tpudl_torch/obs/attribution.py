"""Attribution plane: scoped resource ledgers for multi-tenant obs.

Port of ``tpudl/obs/attribution.py`` (with its lock sanitizer's
hooks). Every counter in :mod:`tpudl_torch.obs.metrics` is process-wide;
this module adds who used it:

- **Scope** — ``obs.scope(tenant=..., job=..., run=...)`` sets a
  contextvar-propagated scope on the calling thread. ``job=`` takes the
  port's :class:`tpudl_torch.jobs.JobSpec` and keys on the first 12
  characters of its ``fingerprint()``. Scopes nest and merge.
- **carry(fn)** — contextvars do not cross thread pools: the executor's
  prepare pool, the HPO trial pool and the serve loop's per-request path
  carry the submitting scope (the request captures it at submit).
- **ScopeLedger** — bounded per-scope running sums: rows and tokens in
  and out, wire bytes, device-cache bytes resident and their peak,
  dispatch and compile seconds, retries, degradations, serve completions
  and SLO samples; LRU-bounded at ``TPUDL_OBS_SCOPES`` scopes, an evicted
  scope folding into ``unattributed``.

**The reconciliation invariant**: every charge sits beside the site that
increments its global counter, with the same amount (no scope: the
charge lands in ``unattributed``), so per-scope sums plus
``unattributed`` equal the global counters (:func:`reconcile`; offline
``python -m tpudl_torch.obs ledger <dir>``). The ledger's lock is a leaf:
charges never publish under it.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from collections import OrderedDict

from tpudl_torch.obs import metrics as _metrics
from tpudl_torch.testing import tsan as _tsan

__all__ = ["Scope", "scope", "current_scope", "carry", "ScopeLedger",
           "get_ledger", "reset_ledger", "charge", "ledger_snapshot",
           "ledger_totals", "reconcile", "status_section",
           "totals_of", "reconcile_snapshot",
           "LEDGER_FIELDS", "RECONCILED"]

# every per-scope aggregate the ledger tracks (one dict key per field;
# floats throughout — bytes/counts stay integral in practice)
LEDGER_FIELDS = ("rows_in", "rows_out", "tokens_in", "tokens_out",
                 "wire_bytes", "hbm_bytes", "hbm_peak_bytes",
                 "dispatch_s", "compile_s", "retries", "degradations",
                 "serve_completed", "slo_samples")

# the reconciliation contract: ledger field → the global metric it must
# sum to (kind matters: a gauge compares against .value, a counter
# against .value, a histogram against .count). hbm_peak_bytes and the
# purely-attributed fields (rows/tokens/dispatch_s) have no global
# counterpart and are excluded by construction.
RECONCILED = (
    ("wire_bytes", "data.wire.bytes_shipped", "counter"),
    ("hbm_bytes", "data.hbm.bytes_resident", "gauge"),
    ("compile_s", "compile.aot_s", "counter"),
    ("retries", "retry.attempts", "counter"),
    ("degradations", "frame.degraded.rungs", "counter"),
    ("serve_completed", "serve.completed", "counter"),
    ("slo_samples", "serve.latency_ms", "histogram"),
)

_SCOPE_VAR: contextvars.ContextVar = contextvars.ContextVar(
    "tpudl_obs_scope", default=None)

# seconds accumulate float dt in thread-arrival order; the global
# counter and the ledger may sum the same dts in DIFFERENT orders, so
# float rounding can differ in the last ulps — everything else (bytes,
# rows, counts) must match exactly
_SECONDS_RTOL = 1e-9


# copied from tpudl/obs/attribution.py:_env_int
def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# copied from tpudl/obs/attribution.py:Scope
class Scope:
    """One attribution identity: ``tenant`` / ``job`` / ``run``
    (any subset). Immutable; ``key`` is the stable ledger key."""

    __slots__ = ("tenant", "job", "run", "key")

    def __init__(self, tenant=None, job=None, run=None):
        if job is not None and not isinstance(job, str):
            # a JobSpec (tpudl.jobs.spec) attributes by its
            # fingerprint — the identity resume/retry already key on
            fp = getattr(job, "fingerprint", None)
            job = fp()[:12] if callable(fp) else str(job)
        object.__setattr__(self, "tenant",
                           str(tenant) if tenant is not None else None)
        object.__setattr__(self, "job", job)
        object.__setattr__(self, "run",
                           str(run) if run is not None else None)
        parts = [f"{k}={v}" for k, v in (("tenant", self.tenant),
                                         ("job", self.job),
                                         ("run", self.run))
                 if v is not None]
        object.__setattr__(self, "key", "|".join(parts) or None)

    def __setattr__(self, name, value):
        raise AttributeError("Scope is immutable")

    def merged(self, tenant=None, job=None, run=None) -> "Scope":
        """A child scope: unset fields inherit from this one."""
        child = Scope(tenant=tenant, job=job, run=run)
        return Scope(
            tenant=child.tenant if child.tenant is not None else self.tenant,
            job=child.job if child.job is not None else self.job,
            run=child.run if child.run is not None else self.run)

    def __repr__(self):
        return f"Scope({self.key or 'unattributed'})"


# copied from tpudl/obs/attribution.py:current_scope
def current_scope() -> Scope | None:
    """The attribution scope active on this thread (None = charges go
    to the ``unattributed`` bucket)."""
    return _SCOPE_VAR.get()


# copied from tpudl/obs/attribution.py:scope
@contextlib.contextmanager
def scope(tenant=None, job=None, run=None):
    """Enter an attribution scope on the calling thread. Nested scopes
    merge (inner unset fields inherit); ``job=`` accepts a JobSpec."""
    cur = _SCOPE_VAR.get()
    new = (cur.merged(tenant=tenant, job=job, run=run) if cur is not None
           else Scope(tenant=tenant, job=job, run=run))
    token = _SCOPE_VAR.set(new)
    try:
        yield new
    finally:
        _SCOPE_VAR.reset(token)


# copied from tpudl/obs/attribution.py:carry
def carry(fn):
    """Bind the CURRENT scope to ``fn`` for execution on another
    thread: ``pool.submit(carry(fn), ...)`` makes the worker's charges
    land in the submitter's scope (a contextvar does not cross the
    pool boundary by itself). Capture happens NOW, at wrap time —
    wrap at the submit site, not at pool construction."""
    captured = _SCOPE_VAR.get()
    if captured is None:
        return fn

    def bound(*args, **kw):
        token = _SCOPE_VAR.set(captured)
        try:
            return fn(*args, **kw)
        finally:
            _SCOPE_VAR.reset(token)

    return bound


# copied from tpudl/obs/attribution.py:_zero_row
def _zero_row() -> dict:
    return {f: 0.0 for f in LEDGER_FIELDS}


# copied from tpudl/obs/attribution.py:ScopeLedger
class ScopeLedger:
    """LRU-bounded scope → running-aggregates table plus the explicit
    ``unattributed`` bucket. One instance lock covers the table; every
    metric publish happens outside it."""

    def __init__(self):
        self.cap = max(1, _env_int("TPUDL_OBS_SCOPES", 64))
        self._lock = _tsan.named_lock("obs.attribution.ledger")
        self._scopes: OrderedDict[str, dict] = OrderedDict()
        self._unattributed = _zero_row()
        self._evicted = 0

    # -- hot path ----------------------------------------------------------
    def charge(self, field: str, amount: float = 1.0, *,
               key: object = current_scope, create: bool = True):
        """Add ``amount`` (negative = credit) to one scope's ``field``.

        ``key`` defaults to the calling context's scope; pass an
        explicit key string to charge a REMEMBERED owner (the HBM
        credit path), or ``None`` for unattributed. ``create=False``
        routes a charge for an absent key to ``unattributed`` instead
        of resurrecting an evicted scope (a credit against a folded
        scope must land where its debits went). Returns the key
        actually charged (None = unattributed) — HBM call sites store
        it on the cache entry for the eventual credit."""
        if field not in self._unattributed:
            raise KeyError(f"unknown ledger field {field!r}")
        if key is current_scope:
            sc = _SCOPE_VAR.get()
            key = sc.key if sc is not None else None
        amount = float(amount)
        evicted_key = None
        with self._lock:
            if key is None:
                row = self._unattributed
            else:
                row = self._scopes.get(key)
                if row is None:
                    if not create:
                        row, key = self._unattributed, None
                    else:
                        if len(self._scopes) >= self.cap:
                            evicted_key, old = self._scopes.popitem(
                                last=False)
                            self._fold_locked(old)
                        row = self._scopes[key] = _zero_row()
                else:
                    self._scopes.move_to_end(key)
            row[field] += amount
            if field == "hbm_bytes":
                row["hbm_peak_bytes"] = max(row["hbm_peak_bytes"],
                                            row["hbm_bytes"])
        if evicted_key is not None:
            # publish OUTSIDE the ledger lock (locks.py discipline)
            _metrics.counter("attribution.scopes_evicted").inc()
        return key

    def _fold_locked(self, row: dict) -> None:
        """Fold an evicted scope's totals into ``unattributed`` so the
        reconciliation invariant survives eviction (peak folds by max:
        it is a high-water mark, not a conserved quantity)."""
        self._evicted += 1
        for f, v in row.items():
            if f == "hbm_peak_bytes":
                self._unattributed[f] = max(self._unattributed[f],
                                            row["hbm_peak_bytes"])
            else:
                self._unattributed[f] += v

    # -- readers -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Deep plain-dict view: ``{"scopes": {key: row},
        "unattributed": row, "evicted": n, "cap": n}``."""
        with self._lock:
            scopes = {k: dict(v) for k, v in self._scopes.items()}
            una = dict(self._unattributed)
            evicted = self._evicted
        return {"scopes": scopes, "unattributed": una,
                "evicted": evicted, "cap": self.cap}

    def totals(self) -> dict:
        """Per-field sums across every scope PLUS unattributed — the
        left-hand side of the reconciliation invariant."""
        return totals_of(self.snapshot())

    def reconcile(self, metrics: dict | None = None) -> dict:
        """Check the invariant against a metrics snapshot (default: the
        live registry). Returns ``{"ok": bool, "checks": [...]}`` with
        one entry per RECONCILED pair; a global metric that was never
        created reads as 0 (a ledger that charged anyway is a bug)."""
        if metrics is None:
            metrics = _metrics.snapshot()
        return reconcile_snapshot(self.snapshot(), metrics)


# copied from tpudl/obs/attribution.py:totals_of
def totals_of(snap: dict) -> dict:
    """Per-field sums over a PLAIN ledger snapshot (live or parsed from
    a dump/status artifact) — the offline ``python -m tpudl.obs
    ledger`` path and the live :meth:`ScopeLedger.totals` share this
    math. ``hbm_peak_bytes`` is a high-water mark, not conserved, so it
    is excluded from the scope sum."""
    out = {f: float((snap.get("unattributed") or {}).get(f) or 0.0)
           for f in LEDGER_FIELDS}
    for row in (snap.get("scopes") or {}).values():
        for f in LEDGER_FIELDS:
            if f != "hbm_peak_bytes":
                out[f] += float(row.get(f) or 0.0)
    return out


# copied from tpudl/obs/attribution.py:reconcile_snapshot
def reconcile_snapshot(snap: dict, metrics: dict) -> dict:
    """The invariant check on plain dicts: one entry per RECONCILED
    pair, comparing the snapshot's totals to the metrics snapshot (a
    histogram reconciles against its ``count``; a metric that was never
    created reads 0 — a ledger that charged anyway is a bug)."""
    totals = totals_of(snap)
    checks = []
    ok = True
    for field, name, kind in RECONCILED:
        entry = (metrics or {}).get(name) or {}
        glob = float(entry.get("count" if kind == "histogram"
                               else "value") or 0.0)
        led = totals[field]
        if field.endswith("_s"):
            good = abs(led - glob) <= _SECONDS_RTOL * max(
                1.0, abs(led), abs(glob))
        else:
            good = led == glob
        ok = ok and good
        checks.append({"field": field, "metric": name,
                       "ledger": led, "global": glob, "ok": good})
    return {"ok": ok, "checks": checks}


_LEDGER = ScopeLedger()


# copied from tpudl/obs/attribution.py:get_ledger
def get_ledger() -> ScopeLedger:
    return _LEDGER


# copied from tpudl/obs/attribution.py:reset_ledger
def reset_ledger() -> ScopeLedger:
    """Fresh ledger re-reading ``TPUDL_OBS_SCOPES`` (tests monkeypatch
    then reset — the SloEngine pattern). Also clears the status
    section's rate state so a reset never yields negative rates."""
    global _LEDGER
    _LEDGER = ScopeLedger()
    _RATE_STATE.clear()
    return _LEDGER


# copied from tpudl/obs/attribution.py:charge
def charge(field: str, amount: float = 1.0, *,
           key: object = current_scope, create: bool = True):
    return _LEDGER.charge(field, amount, key=key, create=create)


# copied from tpudl/obs/attribution.py:ledger_snapshot
def ledger_snapshot() -> dict:
    return _LEDGER.snapshot()


# copied from tpudl/obs/attribution.py:ledger_totals
def ledger_totals() -> dict:
    return _LEDGER.totals()


# copied from tpudl/obs/attribution.py:reconcile
def reconcile(metrics: dict | None = None) -> dict:
    return _LEDGER.reconcile(metrics)


# -- the 1 Hz status section ----------------------------------------------
# per-scope (ts, rows_out, tokens_out) from the previous tick — the
# _HBM_RATE_STATE pattern (live.py): one writer (the status thread), so
# a plain dict suffices
_RATE_STATE: dict = {}


# copied from tpudl/obs/attribution.py:status_section
def status_section() -> dict | None:
    """The ``ledger`` block for the live status file (None until the
    first charge — no empty sections in the HUD). Adds per-tick
    ``rows_s``/``tokens_s`` rates and each scope's ``hbm_share`` of
    the resident total."""
    snap = _LEDGER.snapshot()
    if not snap["scopes"] and not any(snap["unattributed"].values()):
        return None
    now = time.monotonic()
    resident = sum(r["hbm_bytes"] for r in snap["scopes"].values())
    resident += snap["unattributed"]["hbm_bytes"]
    for k in list(_RATE_STATE):
        if k is not None and k not in snap["scopes"]:
            del _RATE_STATE[k]  # evicted/reset scopes drop rate state
    for k, row in list(snap["scopes"].items()) + [
            (None, snap["unattributed"])]:
        prev = _RATE_STATE.get(k)
        rows = row["rows_in"] + row["rows_out"]
        toks = row["tokens_in"] + row["tokens_out"]
        if prev is not None and now > prev[0]:
            dt = now - prev[0]
            row["rows_s"] = round(max(0.0, rows - prev[1]) / dt, 3)
            row["tokens_s"] = round(max(0.0, toks - prev[2]) / dt, 3)
        else:
            row["rows_s"] = None
            row["tokens_s"] = None
        _RATE_STATE[k] = (now, rows, toks)
        row["hbm_share"] = (round(row["hbm_bytes"] / resident, 4)
                            if resident > 0 else 0.0)
    return snap
