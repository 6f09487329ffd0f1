"""Observability for the port: host spans, metrics, device traces, the
flight recorder and watchdog, the live status plane and the attribution
ledger — ``tpudl/obs`` on torch, with the same exports.

- :mod:`~tpudl_torch.obs.tracer` — ``obs.span("stage")`` records
  thread-aware wall-clock spans into a bounded ring, exportable as Chrome
  trace-event JSON;
- :mod:`~tpudl_torch.obs.metrics` — the process-wide registry of
  counters, gauges and bounded histograms, with ``snapshot()`` and the
  opt-in JSONL sink (``TPUDL_METRICS_FILE``);
- :mod:`~tpudl_torch.obs.trace` — ``obs.profile`` over
  ``torch.profiler`` (the card's kernels, copies and fills by name) and
  the host/device merge behind ``python -m tpudl_torch.obs trace``;
- :mod:`~tpudl_torch.obs.pipeline` — per-run executor reports;
- :mod:`~tpudl_torch.obs.flight`, :mod:`~tpudl_torch.obs.watchdog`,
  :mod:`~tpudl_torch.obs.doctor` — the black box, the stall daemon
  (``TPUDL_WATCHDOG_STALL_S``) and ``python -m tpudl_torch.obs doctor``;
- :mod:`~tpudl_torch.obs.roofline`, :mod:`~tpudl_torch.obs.live` — the
  per-run roofline and knob advisor (``map_batches(autotune=)``) and the
  ``tpudl-status-<pid>.json`` files behind ``obs top``;
- :mod:`~tpudl_torch.obs.attribution`, :mod:`~tpudl_torch.obs.slo` —
  ``obs.scope(tenant=, job=, run=)`` and the per-scope ledger that
  reconciles exactly against the global counters, and the serve plane's
  windowed SLO engine.
"""

from __future__ import annotations

from tpudl_torch.obs.attribution import (Scope, carry, charge,
                                         current_scope, get_ledger,
                                         ledger_snapshot, ledger_totals,
                                         reconcile, reset_ledger, scope)
from tpudl_torch.obs.flight import dump, get_recorder, record_error
from tpudl_torch.obs.live import (ensure_status_writer,
                                  start_status_writer, stop_status_writer,
                                  write_status)
from tpudl_torch.obs.roofline import RooflineReport, advise, autotune_seed
from tpudl_torch.obs.roofline import analyze as analyze_roofline
from tpudl_torch.obs.metrics import (Meter, counter, flush_metrics, gauge,
                                     get_registry, histogram, snapshot,
                                     timed)
from tpudl_torch.obs.watchdog import heartbeat, start_watchdog
from tpudl_torch.obs.pipeline import (PipelineReport, get_pipeline_report,
                                      last_pipeline_report,
                                      pipeline_reports, set_last_pipeline)
from tpudl_torch.obs.trace import (load_host_trace_events,
                                   load_trace_events, merge_trace_events,
                                   named_scope, profile,
                                   summarize_device_trace,
                                   summarize_merged)
from tpudl_torch.obs.tracer import export_chrome_trace, get_tracer, span

__all__ = [
    # attribution plane (scoped ledgers)
    "Scope", "scope", "current_scope", "carry", "charge",
    "get_ledger", "reset_ledger", "ledger_snapshot", "ledger_totals",
    "reconcile",
    # tracer
    "span", "get_tracer", "export_chrome_trace",
    # metrics
    "counter", "gauge", "histogram", "snapshot", "flush_metrics",
    "get_registry", "timed", "Meter",
    # device traces + merge
    "profile", "named_scope", "load_trace_events",
    "summarize_device_trace", "load_host_trace_events",
    "merge_trace_events", "summarize_merged",
    # per-run pipeline reports
    "PipelineReport", "last_pipeline_report", "set_last_pipeline",
    "pipeline_reports", "get_pipeline_report",
    # failure forensics (flight recorder + watchdog)
    "dump", "get_recorder", "record_error", "heartbeat",
    "start_watchdog",
    # live ops plane (roofline + status files)
    "RooflineReport", "analyze_roofline", "advise",
    "ensure_status_writer", "start_status_writer",
    "stop_status_writer", "write_status",
]
