"""Live run monitor: atomic per-process status files and ``obs top``.

Port of ``tpudl/obs/live.py``, in tpudl's schema (``tpudl-status``,
version 1), so tpudl's ``tools/validate_status.py`` and its ``render``
read the port's files. Every process that registers a watchdog heartbeat
(``Frame.map_batches``, ``Trainer.fit``, estimator and HPO trials, UDF
calls, the serve loop) writes one self-contained status file,

    <TPUDL_STATUS_DIR>/tpudl-status-<pid>.json

atomically (tmp + ``os.replace`` in the same directory), assembled from
the pipeline-report ring, the heartbeat registry, the metrics registry,
the roofline model's verdict and the attribution ledger. Sections that
read the port's own sources:

- ``hbm``: the device cache's ``data.hbm.*`` metrics (bytes resident
  against its budget, hits, evictions), and under ``card`` the CUDA
  caching allocator's ``torch.cuda.memory_stats`` (allocated, reserved
  and peak bytes) once CUDA is up in the process (read without
  initializing it);
- ``compile``: the program store's ``compile.*`` counters;
- ``serve``: the serve metrics and the SLO engine's windows.

``python -m tpudl_torch.obs top <dir>`` renders a refreshing terminal view
of every status file in the directory; ``--once`` prints one frame. The
writer is one daemon thread at ``TPUDL_STATUS_INTERVAL_S`` (default 1 s);
the executor pays only a flag check when a heartbeat registers.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import sys
import threading
import time

from tpudl_torch.obs.metrics import _env_float
from tpudl_torch.testing import tsan as _tsan

__all__ = ["collect_status", "write_status", "ensure_status_writer",
           "start_status_writer", "stop_status_writer", "status_path",
           "read_statuses", "render", "SCHEMA", "VERSION",
           "STATUS_PREFIX"]

SCHEMA = "tpudl-status"
VERSION = 1
STATUS_PREFIX = "tpudl-status-"

_METRIC_PREFIXES = ("train.", "hpo.", "udf.", "estimator.",
                    "obs.watchdog.", "obs.roofline.",
                    "frame.map_batches.", "frame.degraded.", "retry.",
                    "data.hbm.", "data.wire.", "compile.", "serve.",
                    "attribution.")


# copied from tpudl/obs/live.py:_status_dir
def _status_dir() -> str | None:
    return os.environ.get("TPUDL_STATUS_DIR") or None


# copied from tpudl/obs/live.py:_interval_s
def _interval_s() -> float:
    return max(0.05, _env_float("TPUDL_STATUS_INTERVAL_S", 1.0))


# copied from tpudl/obs/live.py:status_path
def status_path(status_dir: str, pid: int | None = None) -> str:
    return os.path.join(status_dir,
                        f"{STATUS_PREFIX}{pid or os.getpid()}.json")


# -- assembly ----------------------------------------------------------------

# copied from tpudl/obs/live.py:_run_entry
def _run_entry(report: dict) -> dict:
    """One pipeline report → the status file's condensed run entry."""
    rows_total = report.get("rows")
    rows_done = int(report.get("rows_done") or 0)
    finished = bool(report.get("finished"))
    wall = (report.get("wall_seconds") if finished
            else report.get("age_s")) or 0.0
    rate = rows_done / wall if wall > 0 else None
    eta = None
    if (not finished and rate and rows_total
            and rows_total > rows_done):
        eta = (rows_total - rows_done) / rate
    entry = {
        "run_id": report.get("run_id"),
        "rows_total": rows_total,
        "rows_done": rows_done,
        "finished": finished,
        "wall_s": round(wall, 3),
        "rows_per_sec": round(rate, 2) if rate else None,
        "eta_s": round(eta, 1) if eta is not None else None,
        "stage_seconds": report.get("stage_seconds") or {},
        "overlap_efficiency": report.get("overlap_efficiency"),
        "queue_depth_mean": report.get("queue_depth_mean"),
        "config": {k: report.get(k) for k in (
            "executor", "batch_size", "fuse_steps", "prefetch_depth",
            "prepare_workers", "wire_codec", "batch_cache",
            "device_cache", "degraded_to", "recovered_batches", "mesh")
            if report.get(k) is not None},
    }
    if rows_total:
        entry["pct"] = round(100.0 * rows_done / rows_total, 1)
    return entry


def collect_status(roofline: bool = True) -> dict:
    """Assemble one status payload from the live registries. Never
    raises — a section that fails to assemble is recorded as absent
    (the observer must not take down the observed)."""
    payload = {
        "schema": SCHEMA,
        "version": VERSION,
        "ts": time.time(),
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "argv": [os.path.basename(sys.argv[0] or "python")]
        + sys.argv[1:3],
        "interval_s": _interval_s(),
        "alive": True,
        "runs": [],
        "heartbeats": {},
        "metrics": {},
        "roofline": None,
    }
    try:
        from tpudl_torch.obs import pipeline as _pipeline

        reports = list(_pipeline.pipeline_reports().values())
        # every unfinished run, plus the newest finished one (context
        # for "what just happened" when the process idles between runs)
        active = [r for r in reports if not r.get("finished")]
        done = [r for r in reports if r.get("finished")]
        keep = active + (done[-1:] if done else [])
        payload["runs"] = [_run_entry(r) for r in keep]
        if roofline:
            newest = (active or done)[-1] if (active or done) else None
            if newest:
                from tpudl_torch.obs import roofline as _roofline

                # allow_probe=False: the status thread reads the
                # CACHED wire figure but never issues a device op itself
                rr = _roofline.analyze(_roofline.model_report(newest),
                                       publish=False, allow_probe=False)
                if rr is not None:
                    payload["roofline"] = rr.to_dict()
    # tpudl: ignore[swallowed-except] — 1 Hz status thread: a broken
    # contributor drops its section, never the whole status file
    except Exception:
        pass
    try:
        from tpudl_torch.obs import watchdog as _watchdog

        payload["heartbeats"] = _watchdog.get_registry().describe()
    # tpudl: ignore[swallowed-except] — 1 Hz status thread: a broken
    # contributor drops its section, never the whole status file
    except Exception:
        pass
    try:
        from tpudl_torch.obs import metrics as _metrics

        # filtered AT the registry: the 1 Hz writer copies
        # only the sections it ships instead of snapshotting the whole
        # table and discarding most of it — the <5% overhead guard's
        # margin lives here
        payload["metrics"] = _metrics.snapshot(prefix=_METRIC_PREFIXES)
        hbm = _hbm_section(payload["metrics"], payload["ts"])
        card = _card_memory()
        if card is not None:
            hbm = hbm or {"bytes_resident": 0, "budget_bytes": None,
                          "budget_pct": None, "hits": 0, "misses": 0,
                          "evictions": 0, "hits_per_s": None}
            hbm["card"] = card
        if hbm is not None:
            payload["hbm"] = hbm
        comp = _compile_section(payload["metrics"])
        if comp is not None:
            payload["compile"] = comp
        srv = _serve_section(payload["metrics"])
        if srv is not None:
            payload["serve"] = srv
    # tpudl: ignore[swallowed-except] — 1 Hz status thread: a broken
    # contributor drops its section, never the whole status file
    except Exception:
        pass
    try:
        from tpudl_torch.obs import attribution as _attr

        led = _attr.status_section()
        if led is not None:
            payload["ledger"] = led
    # tpudl: ignore[swallowed-except] — 1 Hz status thread: a broken
    # contributor drops its section, never the whole status file
    except Exception:
        pass
    return payload


# hits/s needs a delta: the writer ticks at a fixed cadence, so one
# (ts, hits) pair of module state per process is enough — no lock
# (the 1 Hz writer is the only caller; a torn read worst-cases one
# frame's rate to None)
_HBM_RATE_STATE: dict = {}


# copied from tpudl/obs/live.py:_hbm_section
def _hbm_section(metrics: dict, now: float) -> dict | None:
    """The status file's HBM residency line: bytes resident
    vs budget, hit/miss/eviction totals, and a hits/s rate — a
    budget-thrashing job (evictions climbing, hit rate sagging) is
    visible LIVE instead of only in post-hoc counters. None when the
    device cache never armed in this process."""
    def val(name):
        entry = metrics.get(name) or {}
        v = entry.get("value")
        return v if isinstance(v, (int, float)) else None

    resident = val("data.hbm.bytes_resident")
    if resident is None:
        return None
    budget = val("data.hbm.budget_bytes")
    hits = val("data.hbm.hits") or 0
    out = {
        "bytes_resident": int(resident),
        "budget_bytes": int(budget) if budget else None,
        "budget_pct": (round(100.0 * resident / budget, 1)
                       if budget else None),
        "hits": int(hits),
        "misses": int(val("data.hbm.misses") or 0),
        "evictions": int(val("data.hbm.evictions") or 0),
        "hits_per_s": None,
    }
    prev = _HBM_RATE_STATE.get("tick")
    _HBM_RATE_STATE["tick"] = (now, hits)
    if prev and now > prev[0]:
        out["hits_per_s"] = round(
            max(0.0, hits - prev[1]) / (now - prev[0]), 1)
    return out


def _card_memory() -> dict | None:
    """The CUDA caching allocator's figures for the current card, or None
    when CUDA is not up in this process (the status thread never
    initializes it, nor imports torch)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    st = torch.cuda.memory_stats()
    return {"device": torch.cuda.current_device(),
            "allocated_bytes": int(st.get("allocated_bytes.all.current", 0)),
            "reserved_bytes": int(st.get("reserved_bytes.all.current", 0)),
            "peak_bytes": int(st.get("allocated_bytes.all.peak", 0))}


# copied from tpudl/obs/live.py:_compile_section
def _compile_section(metrics: dict) -> dict | None:
    """The status file's compile line: AOT program-store
    hit rate, programs restored/compiled, seconds spent in AOT work,
    bucket pad rows, and whether the persistent cache ever disabled —
    a fleet cold-starting (misses climbing, nothing restored, or
    cache_disabled > 0) is visible LIVE. None when no compile metric
    ever published in this process."""
    def val(name):
        entry = metrics.get(name) or {}
        v = entry.get("value")
        return v if isinstance(v, (int, float)) else None

    hits = val("compile.hits")
    misses = val("compile.misses")
    if hits is None and misses is None \
            and val("compile.programs_restored") is None \
            and val("compile.cache_disabled") is None:
        return None
    return {
        "hits": int(hits or 0),
        "misses": int(misses or 0),
        "programs_restored": int(val("compile.programs_restored") or 0),
        "programs_compiled": int(val("compile.programs_compiled") or 0),
        "aot_s": round(val("compile.aot_s") or 0.0, 3),
        "bucket_pad_rows": int(val("compile.bucket_pad_rows") or 0),
        "cache_disabled": int(val("compile.cache_disabled") or 0),
    }


# copied from tpudl/obs/live.py:_serve_section
def _serve_section(metrics: dict) -> dict | None:
    """The status file's serve line: offered vs rejected
    load, queue depth against its cap, slot occupancy, sustained token
    rate and the latency SLO percentiles — a saturating server (depth
    at cap, rejects climbing) or a TTFT regression is visible LIVE.
    None when no serve metric ever published in this process."""
    def val(name):
        entry = metrics.get(name) or {}
        v = entry.get("value")
        return v if isinstance(v, (int, float)) else None

    def pct(name, q):
        v = (metrics.get(name) or {}).get(q)
        return v if isinstance(v, (int, float)) else None

    if val("serve.requests") is None and val("serve.queue_cap") is None:
        return None
    # the WINDOWED view: recent p50/p99/burn from the SLO
    # engine, so `obs top` answers "how are we doing NOW", not "since
    # boot"; the lifetime percentiles stay as the fallback
    try:
        from tpudl_torch.obs import slo as _slo

        slo_section = _slo.get_slo_engine().status_section()
    # tpudl: ignore[swallowed-except] — status writer daemon: a broken
    # SLO engine must cost the slo block, never the whole status file
    except Exception:
        slo_section = None
    return {
        "requests": int(val("serve.requests") or 0),
        "rejects": int(val("serve.rejects") or 0),
        "completed": int(val("serve.completed") or 0),
        "deadline_sheds": int(val("serve.deadline_sheds") or 0),
        "queue_depth": int(val("serve.queue_depth") or 0),
        "queue_cap": int(val("serve.queue_cap") or 0),
        "occupancy": (round(val("serve.batch_occupancy"), 3)
                      if val("serve.batch_occupancy") is not None
                      else None),
        "tokens_per_s": (round(val("serve.tokens_per_s"), 1)
                         if val("serve.tokens_per_s") is not None
                         else None),
        "p50_ms": pct("serve.latency_ms", "p50"),
        "p99_ms": pct("serve.latency_ms", "p99"),
        "models": int(val("serve.models") or 0),
        "slo": slo_section,
    }


# copied from tpudl/obs/live.py:write_status
def write_status(status_dir: str | None = None,
                 payload: dict | None = None) -> str | None:
    """Write one atomic status file; returns its path (None on failure
    or when no directory is configured). tmp + ``os.replace`` in the
    SAME directory — a reader sees the old complete file or the new
    complete file, never bytes in between."""
    status_dir = status_dir or _status_dir()
    if not status_dir:
        return None
    try:
        payload = payload if payload is not None else collect_status()
        os.makedirs(status_dir, exist_ok=True)
        path = status_path(status_dir)
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(payload, default=str))
        os.replace(tmp, path)
        return path
    except Exception:
        return None


# -- the writer daemon -------------------------------------------------------

# copied from tpudl/obs/live.py:StatusWriter
class StatusWriter:
    """Daemon thread: one atomic status write per interval while the
    process lives; the final write (atexit or ``stop``) flips
    ``alive: false`` so ``obs top`` shows a clean exit instead of a
    stale age."""

    def __init__(self, status_dir: str, interval: float | None = None):
        self.status_dir = status_dir
        self.interval = float(interval if interval is not None
                              else _interval_s())
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpudl-status")
        self._thread.start()
        return self

    def _run(self):
        write_status(self.status_dir)  # first frame immediately
        while not self._stop.wait(self.interval):
            write_status(self.status_dir)

    def stop(self, final: bool = True):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
        if final:
            payload = collect_status()
            payload["alive"] = False
            write_status(self.status_dir, payload)


_WRITER: StatusWriter | None = None
_WRITER_LOCK = _tsan.named_lock("obs.live.writer")
_CHECKED = False  # fast path: ensure() is called per heartbeat


# copied from tpudl/obs/live.py:ensure_status_writer
def ensure_status_writer() -> "StatusWriter | None":
    """Lazily start the process-wide writer when ``TPUDL_STATUS_DIR``
    is set. Called by the heartbeat registrar, so ANY instrumented
    layer (executor, trainer, estimator, UDFs, HPO) starting work makes
    the process monitorable without its own plumbing. The post-start
    cost is one module-flag read."""
    global _CHECKED
    if _CHECKED:
        return _WRITER
    d = _status_dir()
    if d is None:
        # no flag-latch on the None path: an operator can export the
        # env var mid-process and the next run picks it up
        return None
    with _WRITER_LOCK:
        if _WRITER is None:
            _start_locked(d, None)
        _CHECKED = True
        return _WRITER


# copied from tpudl/obs/live.py:start_status_writer
def start_status_writer(status_dir: str | None = None,
                        interval: float | None = None) -> StatusWriter:
    """Start (or return) the process-wide writer. Explicit args win
    over the env knobs."""
    global _CHECKED
    with _WRITER_LOCK:
        if _WRITER is None:
            _start_locked(status_dir or _status_dir() or os.getcwd(),
                          interval)
        _CHECKED = True
        return _WRITER


# copied from tpudl/obs/live.py:_start_locked
def _start_locked(status_dir: str, interval):
    global _WRITER
    _WRITER = StatusWriter(status_dir, interval).start()
    atexit.register(_atexit_stop)


# copied from tpudl/obs/live.py:_atexit_stop
def _atexit_stop():
    w = _WRITER
    if w is not None:
        w.stop(final=True)


# copied from tpudl/obs/live.py:stop_status_writer
def stop_status_writer():
    """Stop and forget the writer (tests)."""
    global _WRITER, _CHECKED
    with _WRITER_LOCK:
        if _WRITER is not None:
            _WRITER.stop(final=False)
            _WRITER = None
        _CHECKED = False


# -- the reader / renderer (``obs top``) -------------------------------------

# copied from tpudl/obs/live.py:read_statuses
def read_statuses(status_dir: str) -> list[dict]:
    """Parse every status file under ``status_dir`` (newest-written
    first). A half-readable file is skipped, not fatal — the atomic-
    write contract means that only happens for foreign files."""
    out = []
    try:
        names = sorted(os.listdir(status_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(STATUS_PREFIX)
                and name.endswith(".json")):
            continue
        path = os.path.join(status_dir, name)
        try:
            with open(path) as f:
                payload = json.load(f)
            payload["_path"] = path
            out.append(payload)
        except (OSError, json.JSONDecodeError):
            continue
    out.sort(key=lambda p: -(p.get("ts") or 0))
    return out


# copied from tpudl/obs/live.py:_bar
def _bar(pct: float | None, width: int = 20) -> str:
    if pct is None:
        return "?" * width
    filled = int(width * min(100.0, max(0.0, pct)) / 100.0)
    return "#" * filled + "." * (width - filled)


# copied from tpudl/obs/live.py:_fmt_age
def _fmt_age(s: float) -> str:
    if s < 120:
        return f"{s:.1f}s"
    return f"{s / 60:.1f}m"


# copied from tpudl/obs/live.py:_fleet_serve_line
def _fleet_serve_line(serves: list[dict]) -> str:
    """One merged aggregate over every process's serve section (the
    doctor's per-host-merge treatment applied to ``obs top``): summed
    load, worst queue depth, and a REAL merged windowed p99 — computed
    over the concatenation of each process's exported window sample
    tail, not a max-of-p99s (which would overstate a balanced fleet)."""
    from tpudl_torch.obs.metrics import percentile as _pct

    requests = sum(int(s.get("requests") or 0) for s in serves)
    completed = sum(int(s.get("completed") or 0) for s in serves)
    rejects = sum(int(s.get("rejects") or 0) for s in serves)
    depth = max(int(s.get("queue_depth") or 0) for s in serves)
    slos = [s.get("slo") or {} for s in serves]
    qps = sum(float(sl.get("window_qps") or 0.0) for sl in slos)
    samples: list = []
    for sl in slos:
        samples.extend(x for x in (sl.get("window_samples_ms") or [])
                       if isinstance(x, (int, float)))
    line = (f"fleet serve ({len(serves)} procs): req {requests}"
            f"  done {completed}  rejects {rejects}"
            f"  queue max {depth}")
    if qps:
        line += f"  qps {qps:.1f}"
    merged_p99 = _pct(sorted(samples), 0.99)
    if merged_p99 is not None:
        line += f"  w_p99 {merged_p99:.0f}ms"
    burns = [sl.get("burn_short") for sl in slos
             if isinstance(sl.get("burn_short"), (int, float))]
    if burns:
        line += f"  burn {max(burns):.1f}x"
    return line


# copied from tpudl/obs/live.py:_fmt_bytes
def _fmt_bytes(n: float) -> str:
    n = float(n)
    if abs(n) >= 2**30:
        return f"{n / 2**30:.2f}GB"
    if abs(n) >= 2**20:
        return f"{n / 2**20:.1f}MB"
    if abs(n) >= 2**10:
        return f"{n / 2**10:.1f}KB"
    return f"{n:.0f}B"


# copied from tpudl/obs/live.py:_ledger_rows
def _ledger_rows(led: dict) -> list[tuple]:
    """(key, row) pairs worth rendering: every named scope plus the
    unattributed bucket when it actually carries charges."""
    rows = list((led.get("scopes") or {}).items())
    una = led.get("unattributed") or {}
    if any(una.get(f) for f in ("rows_in", "rows_out", "tokens_in",
                                "tokens_out", "wire_bytes", "hbm_bytes",
                                "serve_completed")):
        rows.append(("(unattributed)", una))
    return rows


# copied from tpudl/obs/live.py:_ledger_line
def _ledger_line(key: str, row: dict) -> str:
    """One ``obs top`` attribution row: who, rows/s, tokens/s, HBM
    share, wire bytes — the per-tenant surface."""
    line = f"    {key:<24}"
    rs, ts = row.get("rows_s"), row.get("tokens_s")
    line += (f" {rs:.1f} rows/s" if isinstance(rs, (int, float))
             else " - rows/s")
    line += (f"  {ts:.1f} tok/s" if isinstance(ts, (int, float))
             else "  - tok/s")
    share = row.get("hbm_share")
    if row.get("hbm_bytes") or share:
        line += (f"  hbm {_fmt_bytes(row.get('hbm_bytes') or 0)}"
                 + (f" ({100 * share:.0f}%)"
                    if isinstance(share, (int, float)) and share > 0
                    else ""))
    if row.get("wire_bytes"):
        line += f"  wire {_fmt_bytes(row['wire_bytes'])}"
    if row.get("serve_completed"):
        line += f"  served {row['serve_completed']:.0f}"
    return line


# copied from tpudl/obs/live.py:_fleet_ledger_lines
def _fleet_ledger_lines(ledgers: list[dict]) -> list[str]:
    """Per-tenant rows merged across every process's ledger section
    (the ``_fleet_serve_line`` treatment for attribution): additive
    fields and per-proc rates SUM; the HBM share is recomputed over
    the merged resident total."""
    merged: dict[str, dict] = {}
    evicted = 0
    for led in ledgers:
        evicted += int(led.get("evicted") or 0)
        for key, row in _ledger_rows(led):
            at = merged.setdefault(key, {})
            for f, v in row.items():
                if not isinstance(v, (int, float)):
                    continue
                if f == "hbm_share":
                    continue  # recomputed below, shares don't add
                at[f] = at.get(f, 0.0) + v
    resident = sum(r.get("hbm_bytes") or 0 for r in merged.values())
    lines = [f"fleet tenants ({len(ledgers)} procs, "
             f"{len(merged)} scopes"
             + (f", {evicted} evicted" if evicted else "") + "):"]
    for key, row in sorted(merged.items()):
        row["hbm_share"] = ((row.get("hbm_bytes") or 0) / resident
                            if resident > 0 else 0.0)
        lines.append(_ledger_line(key, row))
    return lines


# copied from tpudl/obs/live.py:render
def render(statuses: list[dict], now: float | None = None) -> str:
    """One text frame over parsed status payloads — pure (testable)."""
    now = now if now is not None else time.time()
    lines = [f"tpudl obs top — {len(statuses)} process(es) — "
             f"{time.strftime('%H:%M:%S', time.localtime(now))}"]
    if not statuses:
        lines.append("  (no tpudl-status-*.json files yet)")
    serves = [st.get("serve") for st in statuses if st.get("serve")]
    if len(serves) >= 2:
        lines.append(_fleet_serve_line(serves))
    ledgers = [st.get("ledger") for st in statuses if st.get("ledger")]
    if len(ledgers) >= 2:
        lines.extend(_fleet_ledger_lines(ledgers))
    for st in statuses:
        age = now - (st.get("ts") or now)
        stale_after = 3 * float(st.get("interval_s") or 1.0) + 2.0
        state = ("EXITED" if not st.get("alive", True)
                 else ("STALE" if age > stale_after else "live"))
        lines.append(
            f"\npid {st.get('pid')} [{state}] "
            f"{' '.join(st.get('argv') or [])}  "
            f"(written {_fmt_age(age)} ago on {st.get('host')})")
        for run in st.get("runs") or []:
            pct = run.get("pct")
            state_r = "done" if run.get("finished") else "RUNNING"
            rate = run.get("rows_per_sec")
            eta = run.get("eta_s")
            lines.append(
                f"  run {run.get('run_id')} [{state_r}] "
                f"rows {run.get('rows_done')}/{run.get('rows_total')}"
                + (f" ({pct:.0f}%)" if pct is not None else "")
                + f" |{_bar(pct)}|"
                + (f" {rate:.1f} rows/s" if rate else "")
                + (f" ETA {_fmt_age(eta)}" if eta is not None else "")
                # mesh topology on the run line: a glance
                # distinguishes an 8x1 data-parallel run from a 4x2
                # tensor-parallel one without digging into the knobs
                + (" mesh={}".format("x".join(
                    str((run.get("config") or {})["mesh"].get(a, 1))
                    for a in ("data", "model")))
                   if (run.get("config") or {}).get("mesh") else "")
                # fault containment: a run surviving on a degraded rung
                # is loud here — same field the PipelineReport carries
                + (f" DEGRADED->{(run.get('config') or {})['degraded_to']}"
                   if (run.get("config") or {}).get("degraded_to")
                   else ""))
            ss = run.get("stage_seconds") or {}
            if ss:
                stages = "  ".join(f"{k} {v:.2f}s" for k, v
                                   in sorted(ss.items(), key=lambda kv:
                                             -kv[1]))
                lines.append(f"      stages: {stages}")
            cfg = run.get("config") or {}
            if cfg:
                knobs = " ".join(f"{k}={v}" for k, v
                                 in sorted(cfg.items()))
                lines.append(f"      knobs:  {knobs}")
        hbs = st.get("heartbeats") or {}
        if hbs:
            parts = []
            for name, hb in sorted(hbs.items()):
                inflight = hb.get("in_flight") or {}
                suspect = (" [" + ",".join(
                    f"{k}:{v.get('age_s')}s" for k, v
                    in inflight.items()) + "]") if inflight else ""
                flag = " STALLED" if hb.get("stalled") else ""
                parts.append(f"{name} {hb.get('age_s')}s"
                             f"{suspect}{flag}")
            lines.append("  heartbeats: " + "; ".join(parts))
        hbm = st.get("hbm") or {}
        if hbm.get("bytes_resident") is not None:
            mb = hbm["bytes_resident"] / 2**20
            budget = hbm.get("budget_bytes")
            pct = hbm.get("budget_pct")
            rate = hbm.get("hits_per_s")
            line = f"  hbm:        {mb:.1f}"
            if budget:
                line += f"/{budget / 2**20:.1f} MB resident"
                if pct is not None:
                    line += f" ({pct:.0f}%)"
            else:
                line += " MB resident"
            line += f"  hits {hbm.get('hits', 0)}"
            if rate is not None:
                line += f" ({rate:.1f}/s)"
            if hbm.get("evictions"):
                line += f"  evictions {hbm['evictions']}"
            lines.append(line)
        comp = st.get("compile") or {}
        if comp:
            line = (f"  compile:    hits {comp.get('hits', 0)}"
                    f"  misses {comp.get('misses', 0)}")
            if comp.get("programs_restored"):
                line += f"  restored {comp['programs_restored']}"
            if comp.get("programs_compiled"):
                line += f"  aot {comp['programs_compiled']}"
            if comp.get("aot_s"):
                line += f" ({comp['aot_s']:.1f}s)"
            if comp.get("bucket_pad_rows"):
                line += f"  pad_rows {comp['bucket_pad_rows']}"
            if comp.get("cache_disabled"):
                line += (f"  CACHE-DISABLED "
                         f"x{comp['cache_disabled']}")
            lines.append(line)
        srv = st.get("serve") or {}
        if srv:
            line = (f"  serve:      req {srv.get('requests', 0)}"
                    f"  done {srv.get('completed', 0)}"
                    f"  queue {srv.get('queue_depth', 0)}"
                    f"/{srv.get('queue_cap', 0)}")
            if srv.get("rejects"):
                line += f"  rejects {srv['rejects']}"
            if srv.get("deadline_sheds"):
                line += f"  sheds {srv['deadline_sheds']}"
            if srv.get("occupancy") is not None:
                line += f"  occ {100 * srv['occupancy']:.0f}%"
            if srv.get("tokens_per_s") is not None:
                line += f"  tok/s {srv['tokens_per_s']:.1f}"
            slo = srv.get("slo") or {}
            if slo.get("window_p99_ms") is not None:
                # the WINDOWED truth (last window_s seconds), not the
                # lifetime histogram — "now", the number you page on
                line += (f"  w_p50 {slo['window_p50_ms']:.0f}ms"
                         f"  w_p99 {slo['window_p99_ms']:.0f}ms")
                if slo.get("burn_short") is not None:
                    line += f"  burn {slo['burn_short']:.1f}x"
            elif srv.get("p99_ms") is not None:
                line += f"  p99 {srv['p99_ms']:.0f}ms"
            if srv.get("models", 0) > 1:
                line += f"  models {srv['models']}"
            lines.append(line)
        led = st.get("ledger") or {}
        led_rows = _ledger_rows(led)
        if led_rows:
            head = f"  tenants:    {len(led.get('scopes') or {})} scope(s)"
            if led.get("evicted"):
                head += f"  evicted {led['evicted']}"
            lines.append(head)
            for key, row in led_rows:
                lines.append(_ledger_line(key, row))
        rl = st.get("roofline") or {}
        if rl.get("verdict"):
            lines.append(f"  roofline:   {rl['verdict']}")
            attr = rl.get("gap_attribution") or {}
            if attr:
                shares = "  ".join(
                    f"{k} {100 * v:.0f}%" for k, v in sorted(
                        attr.items(), key=lambda kv: -kv[1]) if v)
                lines.append(f"  gap:        {shares}")
        m = st.get("metrics") or {}
        stalls = (m.get("obs.watchdog.stalls") or {}).get("value")
        step = (m.get("train.last_step") or {}).get("value")
        bits = []
        if step is not None:
            bits.append(f"train.last_step {step:.0f}")
        if stalls:
            bits.append(f"watchdog stalls {stalls:.0f}")
        if bits:
            lines.append("  metrics:    " + "  ".join(bits))
    return "\n".join(lines)


# copied from tpudl/obs/live.py:top_main
def top_main(status_dir: str, once: bool = False,
             interval: float = 2.0, out=None) -> int:
    """The ``obs top`` loop. ``--once`` prints a single frame and
    returns 2 when the directory holds no status files (scriptable
    "is anything running here"); the live loop keeps waiting for
    processes to appear and exits 0 on Ctrl-C."""
    out = out or sys.stdout
    while True:
        try:
            statuses = read_statuses(status_dir)
            frame = render(statuses)
            if once:
                print(frame, file=out)
                return 0 if statuses else 2
            # clear + home, then the frame (plain ANSI — no curses dep)
            print("\x1b[2J\x1b[H" + frame, file=out, flush=True)
            # tpudl: ignore[adhoc-retry] — the interactive top refresh
            # cadence, not a retry: nothing failed, nothing backs off
            time.sleep(max(0.2, interval))
        except KeyboardInterrupt:  # pragma: no cover - interactive
            return 0
