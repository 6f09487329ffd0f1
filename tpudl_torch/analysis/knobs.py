"""The machine-readable registry of every ``TPUDL_*`` environment knob
the port reads.

Port of ``tpudl/analysis/knobs.py``: one declaration per knob — name,
value kind, default, owning subsystem, and a one-line meaning — for the
knobs ``tpudl_torch`` reads (a knob shared with tpudl keeps tpudl's
name, kind and default). Consumers:

1. the static checker (:mod:`tpudl_torch.analysis.checker`, rule
   ``undeclared-knob``): every ``"TPUDL_*"`` string literal read in the
   port's source must be declared here;
2. :func:`render_knob_table`, a markdown table of the knobs;
3. the registry round-trip test (``tests/test_torch_analysis.py``):
   every declared knob is read somewhere in ``tpudl_torch``, every read
   knob is declared.

Adding a knob = add a :class:`Knob` entry here, then use the literal.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Knob", "KNOBS", "KNOB_NAMES", "knobs_by_subsystem",
           "render_knob_table"]


# copied from tpudl/analysis/knobs.py:Knob
@dataclass(frozen=True)
class Knob:
    name: str        # the full TPUDL_* env var
    kind: str        # int | float | bool | str | enum | path | json
    default: str     # rendered default ("" = unset / derived)
    subsystem: str   # frame | data | obs | jobs | train | zoo |
                     # compile | serve | text
    help: str        # one line, present tense


KNOBS: tuple[Knob, ...] = (
    # -- frame executor (PIPELINE.md) ----------------------------------
    Knob("TPUDL_FRAME_PREFETCH", "bool", "1", "frame",
         "0 force-disables the pipelined executor (serial arm: no "
         "prefetch, no prepare pool, no fusion)"),
    Knob("TPUDL_FRAME_PREFETCH_DEPTH", "int", "2", "frame",
         "bounded infeed queue depth (prepared batches in flight)"),
    Knob("TPUDL_FRAME_PREPARE_WORKERS", "int", "2", "frame",
         "prepare-pool threads packing/decoding batches concurrently"),
    Knob("TPUDL_FRAME_FUSE_STEPS", "int", "1", "frame",
         "microbatches per fused dispatch, one CUDA-graph replay "
         "(1 = off)"),
    Knob("TPUDL_FRAME_DISPATCH_DEPTH", "int", "2", "frame",
         "async dispatch window: in-flight dispatches kept as futures "
         "(1 = blocking dispatch)"),
    Knob("TPUDL_FRAME_DONATE", "bool", "1", "frame",
         "donate input buffers on the fused/codec-wrapped dispatch "
         "paths (0 = off; accepted and reported: a torch function "
         "donates nothing)"),
    Knob("TPUDL_FRAME_AUTOTUNE", "bool", "1", "frame",
         "seed unset fuse_steps/dispatch_depth/prefetch_depth from the "
         "roofline advisor's recommendations (0 = off)"),
    Knob("TPUDL_FRAME_DEGRADE", "bool", "0", "frame",
         "1 arms the fault-containment supervisor (FAULTS.md): "
         "classified executor faults retry the run down the bounded "
         "degradation ladder instead of dying"),
    Knob("TPUDL_FRAME_DEGRADE_MAX_RUNGS", "int", "6", "frame",
         "degradation rungs the supervisor may apply before raising "
         "the typed error with a flight dump"),
    Knob("TPUDL_MESH_FAST_PATH", "bool", "1", "frame",
         "0 reverts the mesh executor to the conservative path "
         "(serial blocking dispatch, blocking transfer barrier, no "
         "fusion/donation/autotune under a mesh) — the A/B arm and "
         "escape hatch"),
    Knob("TPUDL_MESH_MODEL", "int", "1", "frame",
         "model-axis size for 2-D (data, model) meshes — build_mesh's "
         "n_model default and the HorovodRunner/estimator grid fold "
         "(>1 arms tensor parallelism over the model axis)"),
    Knob("TPUDL_FRAME_IO_WORKERS", "int", "8", "frame",
         "LazyFileColumn file-read threads"),
    Knob("TPUDL_FRAME_DECODE_WORKERS", "int", "1", "frame",
         "image-decode threads per batch slice"),
    Knob("TPUDL_DECODE_THREADS", "int", "", "frame",
         "native image loader decode threads (default: native layer "
         "picks)"),
    Knob("TPUDL_PIPELINE_RING", "int", "16", "frame",
         "PipelineReports retained in the bounded ring"),
    # -- data: wire codecs + shard cache (DATA.md) ---------------------
    Knob("TPUDL_WIRE_CODEC", "enum", "", "data",
         "wire codec for map_batches inputs: identity|u8|bf16|auto "
         "(unset = off)"),
    Knob("TPUDL_WIRE_MBPS", "float", "", "data",
         "H2D bandwidth override in MB/s (skips the wire probe; also "
         "read by the roofline model)"),
    Knob("TPUDL_DATA_BF16_WIRE_MBPS", "float", "1000", "data",
         "wire speed below which codec 'auto' picks bf16 for float "
         "columns"),
    Knob("TPUDL_DATA_CACHE_DIR", "path", "", "data",
         "prepared-batch shard cache directory (unset = cache off)"),
    Knob("TPUDL_DATA_VERIFY", "enum", "first", "data",
         "shard checksum policy: first|always|never"),
    Knob("TPUDL_DATA_DEVICE_CACHE", "bool", "0", "data",
         "1 arms HBM-tier batch residency: prepared encoded batches "
         "pin in device memory, epochs >= 2 ship zero wire bytes"),
    Knob("TPUDL_DATA_HBM_BUDGET_MB", "float", "", "data",
         "device-cache resident-byte budget in MB (unset = a "
         "conservative fraction of reported device memory)"),
    # -- observability (OBSERVABILITY.md) ------------------------------
    Knob("TPUDL_METRICS_FILE", "path", "", "obs",
         "JSONL metrics sink path (unset = no sink)"),
    Knob("TPUDL_METRICS_FLUSH_S", "float", "60", "obs",
         "min seconds between periodic metrics-sink flushes"),
    Knob("TPUDL_TRACE_RING", "int", "65536", "obs",
         "host-span tracer ring capacity"),
    Knob("TPUDL_STATUS_DIR", "path", "", "obs",
         "arms the live status writer: tpudl-status-<pid>.json lands "
         "here (unset = off)"),
    Knob("TPUDL_STATUS_INTERVAL_S", "float", "1.0", "obs",
         "live status writer period (floor 0.05)"),
    Knob("TPUDL_OBS_SCOPES", "int", "64", "obs",
         "attribution-ledger cardinality bound: live scope rows kept "
         "before LRU eviction folds the oldest into unattributed"),
    Knob("TPUDL_WATCHDOG_STALL_S", "float", "0", "obs",
         "heartbeat age that flags a stall; > 0 lazily starts the "
         "watchdog daemon (0/unset = off)"),
    Knob("TPUDL_FLIGHT_DIR", "path", "", "obs",
         "flight-recorder dump directory (default: cwd)"),
    Knob("TPUDL_FLIGHT_BATCHES", "int", "32", "obs",
         "flight recorder: batch-descriptor ring capacity"),
    Knob("TPUDL_FLIGHT_ERRORS", "int", "64", "obs",
         "flight recorder: error ring capacity"),
    Knob("TPUDL_FLIGHT_STALLS", "int", "16", "obs",
         "flight recorder: stall-event ring capacity"),
    Knob("TPUDL_FLIGHT_TICKS", "int", "32", "obs",
         "flight recorder: metric-tick ring capacity"),
    Knob("TPUDL_FLIGHT_REQUESTS", "int", "64", "obs",
         "flight recorder: completed-serve-request descriptor ring "
         "capacity (trace ids + segment timings, never prompt "
         "content)"),
    Knob("TPUDL_FLIGHT_SPANS", "int", "512", "obs",
         "span-ring tail length embedded in a dump"),
    Knob("TPUDL_FAULTHANDLER", "bool", "0", "obs",
         "1 wires stdlib faulthandler to tpudl-fault-<pid>.log for "
         "native (CUDA, libjpeg) crashes"),
    Knob("TPUDL_DEVICE_MS_PER_STEP", "float", "0", "obs",
         "measured device ms/step fed to the roofline model (0/unset "
         "= derive from the report)"),
    Knob("TPUDL_TRACECK", "bool", "0", "obs",
         "1 arms the recompile-storm sentinel "
         "(tpudl_torch.testing.traceck): cuda_ops.capture_graph gains "
         "a capture-counting shim, captures per fn identity land in "
         "traceck.* metrics + the flight error ring"),
    Knob("TPUDL_TRACECK_STORM", "int", "3", "obs",
         "captures of one fn identity beyond which the sentinel files "
         "a recompile_storm finding"),
    # -- jobs / train / retries (JOBS.md) ------------------------------
    Knob("TPUDL_RETRY_IO_ATTEMPTS", "int", "3", "jobs",
         "io_policy() total attempts per file operation (1 disables)"),
    Knob("TPUDL_RETRY_IO_BACKOFF_S", "float", "0.05", "jobs",
         "io_policy() base backoff seconds (exponential + jitter)"),
    Knob("TPUDL_HPO_TRIAL_ATTEMPTS", "int", "1", "jobs",
         "attempts per HPO trial (unset/1 = no retry)"),
    Knob("TPUDL_TRAIN_RESTART_BACKOFF_S", "float", "0.1", "train",
         "gang-restart base backoff seconds (HorovodRunner)"),
    Knob("TPUDL_FAULT_PLAN", "json", "", "jobs",
         "fault-injection plan JSON (tpudl_torch.testing.faults), "
         "honored "
         "across process boundaries"),
    Knob("TPUDL_TSAN", "bool", "0", "jobs",
         "1 arms the runtime lock sanitizer "
         "(tpudl_torch.testing.tsan): named_lock() hands out "
         "instrumented locks, findings land in tsan.* metrics + "
         "tpudl-tsan-<pid>.json"),
    Knob("TPUDL_TSAN_DEADLOCK_S", "float", "10", "jobs",
         "armed-acquisition wait slice before the sanitizer walks the "
         "wait-for graph for a deadlock cycle"),
    # -- zoo -----------------------------------------------------------
    Knob("TPUDL_WEIGHTS_DIR", "path", "", "zoo",
         "offline pretrained-weights directory (<model>.npz artifacts)"),
    Knob("TPUDL_IMAGENET_CLASS_INDEX", "path", "", "zoo",
         "imagenet class-index JSON override (else keras cache)"),
    # -- compile subsystem (COMPILE.md) --------------------------------
    Knob("TPUDL_COMPILE_CACHE_DIR", "path", "tpudl_torch/_build",
         "compile",
         "kernel-build cache directory, and the program store's base "
         "(0 disables, loudly: warn-once + compile.cache_disabled)"),
    Knob("TPUDL_COMPILE_AOT", "str", "", "compile",
         "arms the AOT program store: 1 = on at "
         "<compile cache dir>/programs, a path = on at that "
         "directory, unset/0 = off. Dispatch replays captured CUDA "
         "graphs; a miss captures, and its signature persists in the "
         "manifest for the next process"),
    Knob("TPUDL_COMPILE_BUCKETS", "str", "", "compile",
         "shape-bucket ladder: pow2 | pow2ish (also 1/auto) | an "
         "explicit comma list of rungs | unset/0 = off. Ragged "
         "dispatch shapes pad to the nearest rung so the workload "
         "runs through O(log n) captured programs"),
    # -- serve plane (SERVE.md) ----------------------------------------
    Knob("TPUDL_SERVE_QUEUE_CAP", "int", "64", "serve",
         "request-queue admission cap: past this depth submits get a "
         "typed reject (serve.rejects) instead of unbounded growth"),
    Knob("TPUDL_SERVE_SLOTS", "int", "8", "serve",
         "decode slots per model engine — the fixed leading dim of "
         "the slot KV cache (one captured step program per geometry)"),
    Knob("TPUDL_SERVE_DEADLINE_S", "float", "", "serve",
         "default per-request deadline (seconds from submit); expired "
         "requests are shed typed before/while decoding (unset = "
         "no deadline)"),
    Knob("TPUDL_SERVE_HBM_MB", "float", "", "serve",
         "admission budget on QUEUED payload bytes (MB): submits past "
         "it get a typed hbm_budget reject (unset = off)"),
    # -- serve telemetry (lifecycle traces + SLO engine) ----------------
    Knob("TPUDL_SERVE_TRACE", "bool", "1", "serve",
         "request lifecycle tracing: 0 disarms ReqTrace entirely "
         "(every stamp site gates on it; the <5% overhead guard "
         "measures this toggle)"),
    Knob("TPUDL_SERVE_TRACE_EVENTS", "int", "64", "serve",
         "per-request trace event cap (bounded stamp list; terminal "
         "stamps always land inside it)"),
    Knob("TPUDL_SERVE_TRACE_CADENCE", "int", "16", "serve",
         "decode cadence: stamp every N-th decoded token into the "
         "request trace"),
    Knob("TPUDL_SERVE_SLO_P99_MS", "float", "500", "serve",
         "the latency objective (ms): windowed availability and burn "
         "rate (serve.slo.*) are computed against it"),
    Knob("TPUDL_SERVE_SLO_WINDOW_S", "float", "30", "serve",
         "short SLO window (seconds); the long burn window is 10x "
         "this (the classic multi-window pairing)"),
    Knob("TPUDL_SERVE_SLO_TAIL_K", "float", "4", "serve",
         "tail-exemplar gate: a completed request slower than k x the "
         "windowed median is captured with its segment breakdown into "
         "the error ring"),
    # -- text plane (TEXT.md: tokenizer codec + LM stages) -------------
    Knob("TPUDL_TEXT_WIRE_DTYPE", "enum", "", "text",
         "TokenCodec wire dtype: u16|i32 (unset = auto: u16 when the "
         "vocab fits 65536 ids, else i32); an explicit codec arg "
         "always wins over the env"),
)

KNOB_NAMES = frozenset(k.name for k in KNOBS)


# copied from tpudl/analysis/knobs.py:knobs_by_subsystem
def knobs_by_subsystem() -> dict[str, list[Knob]]:
    out: dict[str, list[Knob]] = {}
    for k in KNOBS:
        out.setdefault(k.subsystem, []).append(k)
    return out


def render_knob_table(subsystem: str | None = None) -> str:
    """Markdown table of (a subsystem's) knobs."""
    rows = [k for k in KNOBS
            if subsystem is None or k.subsystem == subsystem]
    lines = ["| knob | kind | default | meaning |",
             "|---|---|---|---|"]
    for k in rows:
        default = k.default if k.default != "" else "*(unset)*"
        lines.append(f"| `{k.name}` | {k.kind} | `{default}` "
                     f"| {k.help} |")
    return "\n".join(lines)
