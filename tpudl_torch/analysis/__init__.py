"""tpudl_torch.analysis — static enforcement of the port's contracts.

Port of ``tpudl/analysis``: the same analyzers, rule ids and
``# tpudl: ignore[rule] — reason`` suppression grammar, aimed at
``tpudl_torch``:

- :mod:`tpudl_torch.analysis.checker`: the AST invariant checker — eight
  per-file rules (atomic writes, flag-only signal handlers, the one
  RetryPolicy in ``tpudl_torch/jobs/retry.py``, no hot-path device
  syncs, no silent excepts, declared knobs/metrics, locked globals);
- :mod:`tpudl_torch.analysis.knobs`: the registry of every ``TPUDL_*``
  knob the port reads;
- :mod:`tpudl_torch.analysis.metric_names`: the registry of every
  metric name the port publishes;
- :mod:`tpudl_torch.analysis.concurrency`: the interprocedural half —
  the whole-tree lock graph and the four concurrency rules
  (lock-order, lock-held-blocking, signal-lock, daemon-shared-write);
- :mod:`tpudl_torch.analysis.locks`: the registry of every port lock
  (name / module / guards / declared rank) — feeds the lock graph and
  the runtime sanitizer (:mod:`tpudl_torch.testing.tsan`);
- :mod:`tpudl_torch.analysis.traceguard`: the capture-boundary half —
  which functions a CUDA graph records (``cuda_ops.capture_graph``,
  ``FusedGraph``/``BoundGraph``, the program store, the stages'
  ``_device_fn`` builders, plus transitively what they call) and the
  five trace rules. Runtime twin: :mod:`tpudl_torch.testing.traceck`
  (``TPUDL_TRACECK=1``).

CLI: ``python -m tpudl_torch.analysis tpudl_torch`` (exit 0 clean / 2
findings / 1 error; ``--rules`` / ``--json`` / ``--sarif`` /
``--registry-audit`` / ``--allow-stale-in``).
"""

from .checker import (Finding, RULES, Suppression, check_file,
                      check_paths, check_source, collect_usage,
                      iter_python_files)
from .concurrency import (CONCURRENCY_RULES, LockGraph, LockSite,
                          analyze as analyze_concurrency,
                          analyze_sources, build_lock_graph,
                          registry_coverage)
from .traceguard import (TRACE_RULES, TracedFn,
                         analyze as analyze_trace,
                         analyze_sources as analyze_trace_sources,
                         traced_functions)
from .knobs import KNOBS, KNOB_NAMES, Knob, render_knob_table
from .locks import (LOCKS, LOCK_NAMES, LockDecl, lock_order,
                    render_lock_table)
from .metric_names import (METRIC_NAMES, METRIC_PATTERNS, METRICS,
                           Metric, is_declared_metric,
                           render_metric_table, unknown_metric_names)

__all__ = [
    "Finding", "RULES", "Suppression", "check_file", "check_paths",
    "check_source", "collect_usage", "iter_python_files",
    "CONCURRENCY_RULES", "LockGraph", "LockSite",
    "analyze_concurrency", "analyze_sources", "build_lock_graph",
    "registry_coverage",
    "TRACE_RULES", "TracedFn", "analyze_trace",
    "analyze_trace_sources", "traced_functions",
    "Knob", "KNOBS", "KNOB_NAMES", "render_knob_table",
    "LockDecl", "LOCKS", "LOCK_NAMES", "lock_order",
    "render_lock_table",
    "Metric", "METRICS", "METRIC_NAMES", "METRIC_PATTERNS",
    "is_declared_metric", "render_metric_table",
    "unknown_metric_names",
]
