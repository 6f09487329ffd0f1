"""Per-run pipeline reports: stage times, gauges, and the report ring.

Copied from ``tpudl/obs/pipeline.py`` (``PipelineReport`` and the ring of
recent reports), with its lock sanitizer's hooks. Each
:meth:`PipelineReport.stage` block is a host span ``frame.<stage>`` on the
tracer and enters and leaves the run's watchdog heartbeat (set by the
executor), so a stall names the stage it froze in; it tags an exception
that escapes it with ``tpudl_stage`` (the supervisor's taxonomy reads
it), and a supervised run's report carries ``degraded_to`` and
``recovered_batches``.
``PipelineReport`` is ONE ``Frame.map_batches`` run's (or one serve
session's) stage accounting;
on ``finish()`` it publishes its totals into the process-wide registry
(:mod:`tpudl_torch.obs.metrics`) under tpudl's names. The ring is keyed
by run id and bounded at ``TPUDL_PIPELINE_RING`` (default 16), so two
concurrent runs each keep their own report.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import deque

from tpudl_torch.obs import metrics as _metrics
from tpudl_torch.obs import tracer as _tracer
from tpudl_torch.testing import tsan as _tsan

__all__ = ["PipelineReport", "last_pipeline_report", "set_last_pipeline",
           "pipeline_reports", "get_pipeline_report"]

# per-gauge retained samples; running aggregates keep mean/max exact
GAUGE_SAMPLE_CAP = 4096

_run_counter = itertools.count()


def _next_run_id() -> str:
    return f"{os.getpid()}-{next(_run_counter)}"


class PipelineReport:
    """Per-stage wall time + gauges for ONE ``Frame.map_batches`` run.

    The stages, as the port's executor times them:

    - ``prepare``: prepare-pool seconds in pack, finite check, wire
      encode, bucket pad and pinning host memory (summed across the pool's
      workers, so it can exceed wall time);
    - ``infeed_wait``: consumer seconds blocked on the infeed queue — the
      unhidden remainder of prepare, the numerator of
      ``overlap_efficiency``;
    - ``h2d``: consumer seconds enqueuing the host→device copies of a
      batch (or of a fused group into its graph's static input);
    - ``dispatch``: consumer seconds in ``fn`` (enqueue only on the card)
      or in a graph replay;
    - ``dispatch_wait``: consumer seconds blocked on the oldest batch of
      the dispatch window (its outputs' device→host copies finishing) —
      the card time the window did not hide;
    - ``d2h``: seconds turning finished host copies into output columns.

    Gauges keep the last ``GAUGE_SAMPLE_CAP`` samples plus running
    count/sum/max: ``queue_depth`` (ready batches when the consumer takes
    one; at most K) and ``dispatch_inflight`` (batches in the window at
    each submit; at most D), and under a mesh ``mesh_pad_rows`` (each
    batch's pad rows to the data axis). Counts (``count``):
    ``fused_dispatches``, ``bytes_prepared``, ``bucket_pad_rows``,
    ``pad_rows`` (under a mesh) and ``first_dispatch_s``.
    Thread-safe: prepare workers and the consumer write concurrently."""

    def __init__(self):
        self.run_id = _next_run_id()
        self.stages: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.gauges: dict[str, _metrics.Histogram] = {}
        self.wall_seconds = 0.0
        self.config: dict = {}
        self.rows_done = 0
        self.finished = False
        self._t0 = time.perf_counter()
        # the executor's watchdog heartbeat (set by map_batches): every
        # stage entry beats it with the stage name
        self.heartbeat = None
        self._lock = _tsan.named_lock("obs.pipeline.report")

    @contextlib.contextmanager
    def stage(self, name: str):
        # enter/exit (not a bare beat): the stage stays in flight on the
        # heartbeat until it returns, so a freeze inside dispatch is
        # still the suspect after prepare workers beat afterwards
        hb = self.heartbeat
        if hb is not None:
            hb.stage_enter(name)
        with _tracer.span(f"frame.{name}", run=self.run_id):
            t0 = time.perf_counter()
            try:
                yield
            except BaseException as e:
                # the supervisor's taxonomy (tpudl_torch.frame.supervisor)
                # reads the INNERMOST stage an exception left: outer stage
                # blocks see the tag set and keep it, as in tpudl
                if getattr(e, "tpudl_stage", None) is None:
                    try:
                        e.tpudl_stage = name
                    # tpudl: ignore[swallowed-except] — exceptions with
                    # __slots__/immutable attrs just stay untagged; the
                    # classifier falls back to type/message anchoring
                    except Exception:
                        pass
                raise
            finally:
                self.add(name, time.perf_counter() - t0)
                if hb is not None:
                    hb.stage_exit(name)

    def add(self, name: str, seconds: float):
        with self._lock:
            self.stages[name] = self.stages.get(name, 0.0) + seconds
            self.calls[name] = self.calls.get(name, 0) + 1

    def count(self, name: str, k: int = 1):
        with self._lock:
            self.calls[name] = self.calls.get(name, 0) + k

    def progress(self, rows: int):
        """``rows`` more rows finished dispatching."""
        with self._lock:
            self.rows_done += int(rows)

    def gauge(self, name: str, value):
        with self._lock:
            h = self.gauges.get(name)
            if h is None:
                h = self.gauges[name] = _metrics.Histogram(
                    cap=GAUGE_SAMPLE_CAP)
        h.observe(value)

    def dispatch_overlap_s(self) -> float | None:
        """``dispatch`` seconds minus the consumer's ``dispatch_wait``
        (clamped at 0); None for a run without a dispatch window."""
        with self._lock:
            if "dispatch_wait" not in self.stages:
                return None
            return max(0.0, self.stages.get("dispatch", 0.0)
                       - self.stages.get("dispatch_wait", 0.0))

    def overlap_efficiency(self) -> float | None:
        """Fraction of prepare work hidden from the consumer:
        1 - infeed_wait/prepare, clamped to [0, 1]; None when nothing was
        prepared."""
        with self._lock:
            prep = self.stages.get("prepare", 0.0)
            wait = self.stages.get("infeed_wait", 0.0)
        if prep <= 0.0:
            return None
        return max(0.0, min(1.0, 1.0 - wait / prep))

    def finish(self, wall_seconds: float | None = None):
        """Close out the run: record wall time and publish totals into the
        process-wide registry (``frame.map_batches.{runs,rows,batches,
        wall_seconds}``, ``frame.stage.<name>.seconds``,
        ``frame.overlap_efficiency``, ``frame.dispatch.overlap_s``,
        ``frame.dispatch.inflight``; under a mesh
        ``frame.mesh.pad_rows``, ``.pad_overhead_pct`` and
        ``.model_axis``; for a serve session ``serve.batch_occupancy``, the
        mean of its ``slot_occupancy`` gauge, and ``serve.tokens_per_s``).
        The executor and the serve loop call it once."""
        if wall_seconds is not None:
            self.wall_seconds = wall_seconds
        self.finished = True
        _metrics.counter("frame.map_batches.runs").inc()
        rows = self.config.get("rows")
        if rows:
            _metrics.counter("frame.map_batches.rows").inc(rows)
        _metrics.histogram("frame.map_batches.wall_seconds").observe(
            self.wall_seconds)
        with self._lock:
            stages = dict(self.stages)
            dispatches = self.calls.get("dispatch", 0)
            inflight = self.gauges.get("dispatch_inflight")
        if dispatches:
            _metrics.counter("frame.map_batches.batches").inc(dispatches)
        for name, secs in stages.items():
            _metrics.counter(f"frame.stage.{name}.seconds").inc(secs)
        eff = self.overlap_efficiency()
        if eff is not None:
            _metrics.gauge("frame.overlap_efficiency").set(eff)
        overlap = self.dispatch_overlap_s()
        if overlap is not None:
            _metrics.gauge("frame.dispatch.overlap_s").set(overlap)
        if inflight is not None:
            _metrics.gauge("frame.dispatch.inflight").set(
                inflight.to_dict()["mean"])
        # copied from tpudl/obs/pipeline.py:PipelineReport.finish: the
        # rows of mesh padding this run shipped and computed only to
        # throw away, and the model axis it ran under
        if self.config.get("mesh"):
            with self._lock:
                pad = int(self.calls.get("pad_rows", 0))
            _metrics.gauge("frame.mesh.pad_rows").set(pad)
            if rows:
                _metrics.gauge("frame.mesh.pad_overhead_pct").set(
                    100.0 * pad / (int(rows) + pad))
            _metrics.gauge("frame.mesh.model_axis").set(
                int(self.config["mesh"].get("model") or 1))
        # the session-mean slot occupancy and the token rate of a serve
        # session:
        # copied from tpudl/obs/pipeline.py:PipelineReport.finish[serve]
        if self.config.get("serve"):
            with self._lock:
                occ = self.gauges.get("slot_occupancy")
                toks = int(self.calls.get("tokens", 0))
            if occ is not None and occ.to_dict()["mean"] is not None:
                _metrics.gauge("serve.batch_occupancy").set(
                    occ.to_dict()["mean"])
            if toks and self.wall_seconds:
                _metrics.gauge("serve.tokens_per_s").set(
                    toks / self.wall_seconds)
        _metrics.get_registry().maybe_flush()

    def report(self) -> dict:
        with self._lock:
            out = {
                "run_id": self.run_id,
                "wall_seconds": round(self.wall_seconds, 4),
                "stage_seconds": {k: round(v, 4)
                                  for k, v in sorted(self.stages.items())},
                "stage_calls": dict(sorted(self.calls.items())),
                "rows_done": self.rows_done,
                "finished": self.finished,
                "age_s": round(time.perf_counter() - self._t0, 4),
            }
            for name, h in sorted(self.gauges.items()):
                d = h.to_dict()
                out[f"{name}_mean"] = round(d["mean"], 2)
                out[f"{name}_max"] = d["max"]
            out.update(self.config)
        eff = self.overlap_efficiency()
        if eff is not None:
            out["overlap_efficiency"] = round(eff, 3)
        overlap = self.dispatch_overlap_s()
        if overlap is not None:
            out["dispatch_overlap_s"] = round(overlap, 4)
        return out


def _ring_size() -> int:
    try:
        return max(1, int(os.environ.get("TPUDL_PIPELINE_RING", "") or 16))
    except ValueError:
        return 16


_REPORTS: deque = deque(maxlen=_ring_size())
_REPORTS_LOCK = _tsan.named_lock("obs.pipeline.ring")


def set_last_pipeline(report: PipelineReport | None):
    """File ``report`` in the ring (``Frame.map_batches`` does, at the
    start of every run)."""
    if report is None:
        return
    with _REPORTS_LOCK:
        if _tsan.ENABLED:
            _tsan.check_guarded("obs.pipeline.ring",
                                "pipeline-report ring",
                                lock=_REPORTS_LOCK)
        _REPORTS.append(report)


def last_pipeline_report() -> dict | None:
    """Stage breakdown of the most recent map_batches run (or None)."""
    with _REPORTS_LOCK:
        newest = _REPORTS[-1] if _REPORTS else None
    return newest.report() if newest is not None else None


def pipeline_reports() -> dict[str, dict]:
    """``{run_id: report_dict}`` for the ring's runs, oldest→newest."""
    with _REPORTS_LOCK:
        reports = list(_REPORTS)
    return {r.run_id: r.report() for r in reports}


def get_pipeline_report(run_id: str) -> dict | None:
    """One ring entry by run id (None once evicted)."""
    with _REPORTS_LOCK:
        match = next((r for r in _REPORTS if r.run_id == run_id), None)
    return match.report() if match is not None else None
