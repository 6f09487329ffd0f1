"""The registry of the port's ``tpudl_torch.obs`` metric names.

Port of ``tpudl/analysis/metric_names.py``: every counter/gauge/
histogram name the port publishes, declared once (a name shared with
tpudl keeps tpudl's kind). Consumers:

1. the static checker (rule ``undeclared-metric``): a literal (or
   f-string) name at a ``counter(...)``/``gauge(...)``/
   ``histogram(...)`` call site must match a declaration;
2. the round-trip test (``tests/test_torch_analysis.py``): declared ⊆
   used and used ⊆ declared over ``tpudl_torch/``.

Families with a runtime-computed segment (``frame.stage.<name>.seconds``)
are declared as patterns with exactly one ``*`` segment; the checker
matches an f-string's constant head/tail against them.
"""

from __future__ import annotations

from dataclasses import dataclass
from fnmatch import fnmatchcase

__all__ = ["Metric", "METRICS", "METRIC_NAMES", "METRIC_PATTERNS",
           "is_declared_metric", "unknown_metric_names",
           "render_metric_table"]


# copied from tpudl/analysis/metric_names.py:Metric
@dataclass(frozen=True)
class Metric:
    name: str     # exact dotted name, or a pattern with one '*'
    kind: str     # counter | gauge | histogram | report-gauge
    help: str


METRICS: tuple[Metric, ...] = (
    # -- frame executor ------------------------------------------------
    Metric("frame.map_batches.runs", "counter",
           "map_batches runs finished"),
    Metric("frame.map_batches.rows", "counter",
           "rows processed across runs"),
    Metric("frame.map_batches.batches", "counter",
           "dispatches issued across runs"),
    Metric("frame.map_batches.wall_seconds", "histogram",
           "wall time per run"),
    Metric("frame.stage.*.seconds", "counter",
           "cumulative seconds per executor stage "
           "(prepare/h2d/dispatch/d2h/infeed_wait)"),
    Metric("frame.overlap_efficiency", "gauge",
           "1 - infeed_wait/prepare for the last run"),
    Metric("frame.dispatch.inflight", "gauge",
           "mean in-flight dispatch-window occupancy of the last "
           "async run"),
    Metric("frame.dispatch.overlap_s", "gauge",
           "dispatch seconds the in-flight window hid from the "
           "consumer (last async run)"),
    Metric("frame.degraded.rungs", "counter",
           "degradation-ladder rungs applied by the fault-containment "
           "supervisor (FAULTS.md)"),
    Metric("frame.degraded.recovered_batches", "counter",
           "batches completed by runs that survived on a degraded "
           "rung"),
    Metric("frame.degraded.exhausted", "counter",
           "supervised runs whose ladder ran out (typed error + flight "
           "dump)"),
    Metric("frame.mesh.pad_rows", "gauge",
           "rows of SPMD batch padding the last mesh run shipped and "
           "discarded"),
    Metric("frame.mesh.pad_overhead_pct", "gauge",
           "pad rows as a percent of the last mesh run's dispatched "
           "rows"),
    Metric("frame.mesh.model_axis", "gauge",
           "model-axis size of the last mesh run's grid (1 = pure "
           "data parallelism, >1 = GSPMD tensor parallelism)"),
    Metric("queue_depth", "report-gauge",
           "infeed queue depth sampled per batch (PipelineReport)"),
    Metric("dispatch_inflight", "report-gauge",
           "in-flight dispatches sampled per submit (PipelineReport; "
           "max can never exceed dispatch_depth)"),
    Metric("mesh_pad_rows", "report-gauge",
           "SPMD pad rows sampled per mesh batch (PipelineReport)"),
    Metric("slot_occupancy", "report-gauge",
           "active decode slots over total, sampled per serve tick "
           "(PipelineReport; feeds serve.batch_occupancy at finish)"),
    Metric("wire_batch_bytes", "report-gauge",
           "bytes shipped per batch (PipelineReport)"),
    # -- data: codecs + shard cache ------------------------------------
    Metric("data.wire.bytes_shipped", "counter",
           "encoded bytes put on the H2D wire"),
    Metric("data.wire.bytes_dense", "counter",
           "what the same batches would have shipped un-encoded"),
    Metric("data.wire.bytes_saved", "counter",
           "dense minus shipped"),
    Metric("data.codec.encode_seconds", "counter",
           "host time spent wire-encoding"),
    Metric("data.codec.*.batches", "counter",
           "batches encoded per codec (identity/u8/bf16)"),
    Metric("data.cache.hits", "counter", "shard-cache verified hits"),
    Metric("data.cache.misses", "counter", "shard-cache misses"),
    Metric("data.cache.puts", "counter", "shards written"),
    Metric("data.cache.corrupt", "counter",
           "shards failing checksum (re-prepared, never fatal)"),
    Metric("data.cache.evicted", "counter",
           "shards unlinked by eviction mid-read (treated as a miss)"),
    Metric("data.cache.bytes_read", "counter", "shard bytes read"),
    Metric("data.cache.bytes_written", "counter", "shard bytes written"),
    # -- data: HBM-tier device cache (DATA.md "Cache hierarchy") -------
    Metric("data.hbm.bytes_resident", "gauge",
           "bytes currently pinned in the device batch cache"),
    Metric("data.hbm.budget_bytes", "gauge",
           "device-cache resident-byte budget "
           "(TPUDL_DATA_HBM_BUDGET_MB or derived)"),
    Metric("data.hbm.hits", "counter",
           "batches served device-resident (zero wire bytes)"),
    Metric("data.hbm.misses", "counter",
           "device-cache lookups that fell through to the lower tiers"),
    Metric("data.hbm.puts", "counter", "batches made resident"),
    Metric("data.hbm.evictions", "counter",
           "LRU entries evicted to fit the budget"),
    Metric("data.hbm.bytes_served", "counter",
           "bytes served from HBM instead of the wire (the roofline "
           "subtracts these from its wire attribution)"),
    Metric("data.hbm.put_failed", "counter",
           "batches that failed to become resident mid-placement "
           "(tallies stayed consistent; fell back to the wire)"),
    # -- image IO ------------------------------------------------------
    Metric("imageio.files_read", "counter", "files read off disk"),
    Metric("imageio.bytes_read", "counter", "bytes read off disk"),
    Metric("imageio.decode_errors", "counter",
           "undecodable images (null row, error ring sample)"),
    Metric("imageio.memo_hits", "counter",
           "LazyFileColumn memo hits (no re-read)"),
    Metric("imageio.uris_loaded", "counter",
           "URIs loaded via load_uri_batch"),
    # -- ml / hpo / tuning ---------------------------------------------
    Metric("estimator.trials", "counter", "estimator tuning trials run"),
    Metric("estimator.train_steps", "counter",
           "estimator train steps across trials"),
    Metric("estimator.trial_final_loss", "gauge",
           "last trial's final loss"),
    Metric("hpo.trials_started", "counter", "HPO trials started"),
    Metric("hpo.trials_completed", "counter", "HPO trials completed"),
    Metric("hpo.trials_failed", "counter",
           "HPO trials failed (after retries)"),
    Metric("hpo.trial_seconds", "histogram", "wall time per HPO trial"),
    Metric("hpo.trial_retries", "counter",
           "HPO trial attempts beyond the first"),
    Metric("ml.*.transforms", "counter",
           "transform() calls per ml transformer class"),
    Metric("ml.*.rows_in", "counter",
           "rows entering transform() per transformer class"),
    Metric("ml.*.rows_out", "counter",
           "rows leaving transform() per transformer class"),
    Metric("ml.*.fits", "counter",
           "fit() calls per estimator class"),
    Metric("udf.*.calls", "counter",
           "invocations per registered UDF"),
    Metric("udf.*.rows", "counter",
           "rows processed per registered UDF"),
    Metric("tuning.cv_folds", "counter", "cross-validation folds run"),
    Metric("tuning.cv_evaluations", "counter",
           "cross-validation model evaluations"),
    Metric("tuning.cv_last_metric", "gauge", "last CV fold metric"),
    Metric("tuning.cv_best_metric", "gauge", "best CV metric so far"),
    # -- train ---------------------------------------------------------
    Metric("train.steps", "counter", "optimizer steps taken"),
    Metric("train.examples", "counter", "examples consumed"),
    Metric("train.step_seconds", "histogram", "wall time per step"),
    Metric("train.last_step", "gauge",
           "last completed step (live progress)"),
    Metric("train.restarts", "counter", "gang restarts"),
    Metric("train.restart_backoff_s", "histogram",
           "backoff slept before each gang restart"),
    Metric("train.checkpoint_save_seconds", "histogram",
           "wall time per checkpoint save"),
    Metric("train.checkpoint_restore_seconds", "histogram",
           "wall time per checkpoint restore"),
    Metric("train.checkpoint.corrupt", "counter",
           "checkpoints failing checksum on restore (fell back)"),
    # -- jobs / retries ------------------------------------------------
    Metric("retry.attempts", "counter",
           "retry attempts across all RetryPolicy call sites"),
    Metric("retry.*", "counter",
           "retry attempts per kind (io.read, hpo.trial, ...)"),
    Metric("retry.backoff_s", "histogram",
           "seconds slept per retry backoff"),
    # -- obs self-metrics ----------------------------------------------
    Metric("obs.watchdog.stalls", "counter",
           "heartbeats flagged stalled (once per episode)"),
    Metric("tsan.lock_order_inversions", "counter",
           "armed sanitizer: observed ABBA inversions (once per edge "
           "pair)"),
    Metric("tsan.deadlocks", "counter",
           "armed sanitizer: wait-for cycles / self-deadlocks detected"),
    Metric("tsan.lockset_violations", "counter",
           "armed sanitizer: registered structure mutated without its "
           "declared guard lock"),
    Metric("traceck.traces", "counter",
           "armed sentinel: CUDA-graph captures observed (one per "
           "capture_graph call)"),
    Metric("traceck.retraces", "counter",
           "armed sentinel: second-or-later captures of one fn "
           "identity (each one a new graph)"),
    Metric("traceck.storms", "counter",
           "armed sentinel: identities captured past "
           "TPUDL_TRACECK_STORM (one recompile-storm finding each)"),
    # -- compile subsystem (COMPILE.md) --------------------------------
    Metric("compile.hits", "counter",
           "program-store dispatch hits (a captured or restored "
           "CUDA graph replayed)"),
    Metric("compile.misses", "counter",
           "program-store dispatch misses (the eager function ran; "
           "signature recorded + captured)"),
    Metric("compile.aot_s", "counter",
           "seconds spent capturing and restoring programs"),
    Metric("compile.bucket_pad_rows", "counter",
           "rows of bucket-ladder padding shipped and stripped "
           "(the price of O(log n) program signatures)"),
    Metric("compile.observed", "counter",
           "novel program signatures recorded into the manifest"),
    Metric("compile.programs_compiled", "counter",
           "programs AOT-compiled (warmup + background misses)"),
    Metric("compile.programs_restored", "counter",
           "serialized executables deserialized into the program "
           "table at process start (the zero-cold-start path)"),
    Metric("compile.store_corrupt", "counter",
           "corrupt program-store artifacts quarantined (manifest or "
           "executable checksum)"),
    Metric("compile.cache_disabled", "counter",
           "persistent-compilation-cache setup failures (a cold fleet "
           "is diagnosable: warn-once + flight breadcrumb ride along)"),
    Metric("obs.roofline.achieved_rows_per_s", "gauge",
           "measured end-to-end throughput (roofline input)"),
    Metric("obs.roofline.achievable_rows_per_s", "gauge",
           "modeled throughput with the gap closed"),
    Metric("obs.roofline.predicted_gain_pct", "gauge",
           "top advisor recommendation's predicted gain"),
    Metric("obs.roofline.gap_frac.*", "gauge",
           "device-vs-e2e gap share attributed per component "
           "(prepare/wire_h2d/dispatch/d2h/other/collective)"),
    Metric("obs.roofline.collective_s", "gauge",
           "gap seconds attributed to model-axis collectives (2-D "
           "mesh runs with a measured comm share)"),
    # -- serve plane (SERVE.md) ----------------------------------------
    Metric("serve.requests", "counter",
           "requests ADMITTED by the queue (offered load = requests "
           "+ rejects)"),
    Metric("serve.rejects", "counter",
           "typed admission rejects (queue_full / hbm_budget) — the "
           "load-shedding evidence obs doctor's overload_shed reads"),
    Metric("serve.deadline_sheds", "counter",
           "requests shed on an expired deadline (queued or "
           "mid-decode, both typed DeadlineExceeded)"),
    Metric("serve.queue_depth", "gauge",
           "current request-queue depth (bounded by "
           "TPUDL_SERVE_QUEUE_CAP)"),
    Metric("serve.queue_cap", "gauge",
           "the admission cap the queue was built with (at-death "
           "evidence for overload_shed)"),
    Metric("serve.inserts", "counter",
           "prompt prefills inserted into decode slots"),
    Metric("serve.evictions", "counter",
           "slots freed EARLY (deadline shed, cancel, supervised "
           "retry) — natural completions are serve.completed"),
    Metric("serve.steps", "counter",
           "slot decode-step dispatches (one compiled program per "
           "step, every active slot rides it)"),
    Metric("serve.tokens", "counter",
           "tokens emitted across all slots"),
    Metric("serve.tokens_per_s", "gauge",
           "sustained token rate of the last finished serve session"),
    Metric("serve.completed", "counter",
           "requests finished with their full token budget"),
    Metric("serve.batches", "counter",
           "rung-bucketed dynamic batches dispatched for ragged "
           "featurize/UDF payloads (RungBatcher)"),
    Metric("serve.batch_occupancy", "gauge",
           "real rows/slots over rung/slot capacity for the last "
           "dispatch (session mean committed at finish; the "
           "saturation SLO: > 0.5 under load)"),
    Metric("serve.latency_ms", "histogram",
           "end-to-end request latency, submit to completion "
           "(p50/p99 are the serving SLO line)"),
    Metric("serve.ttft_s", "histogram",
           "time-to-first-token, submit to prefill completion (the "
           "warm-start win)"),
    Metric("serve.models", "gauge",
           "models registered in the serve registry"),
    # -- serve SLO plane (tpudl_torch.obs.slo windows) -------------------
    Metric("serve.slo.target_ms", "gauge",
           "the configured latency objective "
           "(TPUDL_SERVE_SLO_P99_MS) the windowed gauges judge "
           "against"),
    Metric("serve.slo.window_p50_ms", "gauge",
           "p50 latency over the short SLO window "
           "(TPUDL_SERVE_SLO_WINDOW_S) — recent, not lifetime"),
    Metric("serve.slo.window_p99_ms", "gauge",
           "p99 latency over the short SLO window — the number an "
           "operator pages on"),
    Metric("serve.slo.availability", "gauge",
           "fraction of short-window requests meeting the objective"),
    Metric("serve.slo.burn_short", "gauge",
           "error-budget burn rate over the short window (violating "
           "fraction / the 1% p99 budget; >= 1 = burning)"),
    Metric("serve.slo.burn_long", "gauge",
           "burn rate over the long (10x) window — page when BOTH "
           "burn, investigate when only the short one does"),
    Metric("serve.slo.exemplars", "counter",
           "tail exemplars captured into the error ring (latency > "
           "TPUDL_SERVE_SLO_TAIL_K x the windowed median)"),
    # -- attribution plane (tpudl_torch.obs.attribution) -----------------
    Metric("attribution.scopes_evicted", "counter",
           "ledger scope rows LRU-evicted at the TPUDL_OBS_SCOPES "
           "cardinality bound (totals fold into the unattributed "
           "bucket — the reconciliation invariant survives)"),
    # -- text plane (TEXT.md: tokenizer codec + LM stages) -------------
    Metric("text.tokenize.calls", "counter",
           "tokenize_pack invocations on the prepare pool (epoch-2 "
           "delta MUST be 0 on a cached tokenized Dataset — the "
           "zero-decode warm-replay evidence)"),
    Metric("text.tokenize.tokens", "counter",
           "token ids produced by tokenization (pre-padding)"),
    Metric("text.tokenize.seconds", "histogram",
           "host tokenize+pack latency per prepare call"),
    Metric("text.pack.rows", "counter",
           "packed batch rows emitted (ragged right-padded or dense "
           "chunked)"),
    Metric("text.pack.pad_tokens", "counter",
           "pad ids written into packed batches (the padding tax "
           "bucketing bounds)"),
    Metric("text.pack.fill_pct", "gauge",
           "real-token fraction of the last packed batch (100 = no "
           "padding; dense packing pins this near 100)"),
    Metric("lm.embed.rows", "counter",
           "strings embedded by LMFeaturizer (masked mean-pooled "
           "hidden states)"),
    Metric("lm.classify.rows", "counter",
           "strings labeled by LMClassifier (argmax over class-token "
           "logits at the last real position)"),
    Metric("lm.generate.requests", "counter",
           "prompts completed by LMGenerator transforms"),
    Metric("lm.generate.tokens", "counter",
           "tokens generated by LMGenerator (post-EOS-trim; the "
           "lm_generate bench rate numerator)"),
    # -- the port's own names --------------------------------------------
    Metric("compile.programs", "gauge",
           "CUDA graphs held in the program store's in-process table"),
    Metric("compile.restore_skipped", "counter",
           "manifest entries not captured at restore: the process's "
           "kernel flags differ from the entry's"),
    Metric("compile.storms", "counter",
           "failed supervised attempts that captured program-store "
           "programs of their own (the scoped recompile-storm signal)"),
    Metric("mesh.allreduce.calls", "counter",
           "gradient all-reduce calls (one flattened NCCL all-reduce "
           "per dtype a step)"),
    Metric("mesh.allreduce.bytes", "counter",
           "bytes handed to the gradient all-reduces"),
    Metric("obs.profile.captures", "counter",
           "obs.profile captures written"),
    Metric("obs.profile.head_lost", "counter",
           "device events captures lost at their head (counted on the "
           "marker kernels)"),
    Metric("obs.profile.truncated", "counter",
           "captures whose loss may reach the block: every head marker "
           "or the closing one missing"),
)

METRIC_NAMES = frozenset(m.name for m in METRICS if "*" not in m.name)
METRIC_PATTERNS = tuple(m.name for m in METRICS if "*" in m.name)


# copied from tpudl/analysis/metric_names.py:is_declared_metric
def is_declared_metric(name: str) -> bool:
    """Exact-name membership, falling back to the one-'*' patterns."""
    if name in METRIC_NAMES:
        return True
    return any(fnmatchcase(name, p) for p in METRIC_PATTERNS)


# copied from tpudl/analysis/metric_names.py:matches_pattern_prefix
def matches_pattern_prefix(head: str, tail: str = "") -> bool:
    """True when an f-string name with constant ``head``/``tail`` around
    one dynamic segment fits a declared pattern (the checker's view of
    ``f"frame.stage.{name}.seconds"``: head ``frame.stage.``, tail
    ``.seconds``). Containment, not equality: ``f"retry.io.{op}"``
    (head ``retry.io.``) expands only to names the declared ``retry.*``
    already covers, so a sub-family under a declared pattern needs no
    redundant registry entry."""
    for p in METRIC_PATTERNS:
        ph, _, pt = p.partition("*")
        if head.startswith(ph) and tail.endswith(pt):
            return True
    return False


# copied from tpudl/analysis/metric_names.py:unknown_metric_names
def unknown_metric_names(names) -> list[str]:
    """The subset of ``names`` not declared here (for the JSONL-sink
    validator's opt-in cross-check)."""
    return sorted(n for n in set(names) if not is_declared_metric(n))


def render_metric_table() -> str:
    """Markdown table of the declared names."""
    lines = ["| metric | kind | meaning |", "|---|---|---|"]
    for m in METRICS:
        lines.append(f"| `{m.name}` | {m.kind} | {m.help} |")
    return "\n".join(lines)
