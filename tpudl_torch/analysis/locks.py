"""The machine-readable registry of every lock the port constructs.

Port of ``tpudl/analysis/locks.py``. One declaration per lock
``tpudl_torch`` builds (through :func:`tpudl_torch.testing.tsan.named_lock`
— the name literal at the construction site IS the registry key). A
lock that is a twin of one of tpudl's keeps tpudl's name, scope and
rank. Consumers:

1. the static concurrency analyzer
   (:mod:`tpudl_torch.analysis.concurrency`): the lock graph resolves
   every construction site to a declaration, and the coverage round-trip
   test (``tests/test_torch_analysis.py``) fails when a
   ``threading.Lock``/``RLock``/``Condition`` appears in ``tpudl_torch/``
   without one (or a declaration loses its construction site);
2. the runtime sanitizer (:mod:`tpudl_torch.testing.tsan`): armed runs
   check observed acquisition order against the declared ranks and
   name locks in inversion/deadlock/lockset findings;
3. :func:`render_lock_table`, the lock inventory as a markdown table.

**Declared order**: ``order`` is a rank — a thread holding a lock may
only acquire locks of a STRICTLY HIGHER rank (outer/coarse locks are
low, leaf scalar locks are high). Equal ranks must never nest (the
per-instance locks of one class share a rank for exactly this reason).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["LockDecl", "LOCKS", "LOCK_NAMES", "lock_order",
           "render_lock_table"]


# copied from tpudl/analysis/locks.py:LockDecl
@dataclass(frozen=True)
class LockDecl:
    name: str       # the named_lock(...) literal, dotted lowercase
    module: str     # owning module (dotted, under tpudl_torch)
    kind: str       # lock | rlock | condition. A condition is built by
                    # WRAPPING a named lock in stdlib Condition —
                    # named_lock itself refuses kind="condition" so a
                    # plain Lock can never stand in for one silently.
    scope: str      # "module" (one per process) | "instance" (per obj)
    order: int      # rank: may only acquire strictly higher while held
    guards: str     # one line: the state this lock protects


LOCKS: tuple[LockDecl, ...] = (
    # -- rank 10: coarse outer locks (held across whole operations) ----
    LockDecl("data.shards.manifest", "tpudl_torch.data.shards", "lock",
             "instance", 10,
             "ShardCache shard map + verified set + manifest file IO"),
    LockDecl("jobs.runtime.manifest", "tpudl_torch.jobs.runtime", "lock",
             "instance", 10,
             "JobRuntime resume-manifest read/modify/write"),
    LockDecl("compile.program_store", "tpudl_torch.compile.store",
             "rlock", "instance", 10,
             "ProgramStore entry/table maps, live-function and owner "
             "maps, bound programs, pool futures + manifest file IO"),
    LockDecl("native.build", "tpudl_torch.native", "lock", "module", 10,
             "one-shot native decoder build (g++ subprocess) + dlopen"),
    LockDecl("native.crc.build", "tpudl_torch.native.crc", "lock",
             "module", 10,
             "one-shot CRC-32C library build (g++ subprocess) + dlopen"),
    LockDecl("frame.fused_cache", "tpudl_torch.frame.frame", "lock",
             "module", 11,
             "the fused CUDA graphs cached on each per-batch fn (LRU "
             "of 8 a fn; an evicted graph is released after the lock)"),
    LockDecl("train.checkpoint.manifest", "tpudl_torch.train.checkpoint",
             "lock", "instance", 12,
             "CheckpointManager manifest + checkpoint store IO"),
    LockDecl("compile.graphs.fused", "tpudl_torch.compile.graphs", "lock",
             "instance", 13,
             "one FusedGraph's static buffers, capture and replay (the "
             "h2d and dispatch stages of a fused dispatch run under "
             "it)"),
    LockDecl("cuda_ops.capture", "tpudl_torch.cuda_ops", "lock",
             "module", 14,
             "one CUDA-graph capture at a time in the process (the "
             "captured function runs under it)"),
    LockDecl("image.lazyfile.transform", "tpudl_torch.image.imageIO",
             "lock", "instance", 15,
             "LazyFileColumn serial-decode contract (non-thread-safe "
             "transforms run one batch at a time)"),
    LockDecl("compile.store.singleton", "tpudl_torch.compile.store",
             "lock", "module", 16,
             "process-wide ProgramStore create/re-root (a changed "
             "TPUDL_COMPILE_AOT dir swaps the instance)"),
    LockDecl("data.device_cache.singleton",
             "tpudl_torch.data.device_cache", "lock", "module", 16,
             "process-wide DeviceBatchCache create/reset (construction "
             "publishes the budget gauges — metrics locks are higher)"),
    LockDecl("obs.live.writer", "tpudl_torch.obs.live", "lock", "module",
             16, "status-writer singleton start/stop"),
    LockDecl("obs.watchdog.daemon", "tpudl_torch.obs.watchdog", "lock",
             "module", 16, "watchdog daemon singleton start/stop"),
    LockDecl("data.codec.plan", "tpudl_torch.data.codec", "lock",
             "instance", 18,
             "CodecPlan per-column codec resolution/adoption"),
    LockDecl("ingest.input.graph", "tpudl_torch.ingest.input", "lock",
             "instance", 18,
             "TFInputGraph's frozen weights a device and its built "
             "graph functions a feed/fetch key"),
    LockDecl("mesh.replicas", "tpudl_torch.mesh", "lock", "module", 18,
             "module replicas a (module, device) and the copy streams "
             "a card"),
    LockDecl("data.codec.wire_probe", "tpudl_torch.data.codec", "lock",
             "module", 20,
             "process-wide H2D wire-bandwidth probe cache (one probe, "
             "ever)"),
    LockDecl("data.device_cache", "tpudl_torch.data.device_cache", "lock",
             "instance", 20,
             "DeviceBatchCache entry map + LRU order + resident-byte and "
             "pin accounting (metrics published outside the lock)"),
    LockDecl("image.lazyfile.memo", "tpudl_torch.image.imageIO", "lock",
             "instance", 20, "LazyFileColumn small-access decode memo"),
    LockDecl("ingest.graphdef.shared", "tpudl_torch.ingest.graphdef",
             "lock", "instance", 20,
             "one GraphDef's Const values, their uploads and derived "
             "forms a device, folds and translated function bodies"),
    LockDecl("ml.hpo.slices", "tpudl_torch.ml.hpo", "lock", "module", 20,
             "free device-slice list under the trial thread pool "
             "(function-local; module scope = one per run_parallel "
             "call)"),
    LockDecl("obs.pipeline.ring", "tpudl_torch.obs.pipeline", "lock",
             "module", 20, "bounded ring of recent PipelineReports"),
    LockDecl("serve.loadgen", "tpudl_torch.serve.loadgen", "lock",
             "module", 20,
             "closed-loop client tallies: request counter + latency/"
             "TTFT/reject/shed lists (function-local; module scope = "
             "one per run_closed_loop call; never held across a "
             "submit/result wait)"),
    LockDecl("serve.queue", "tpudl_torch.serve.queue", "lock", "instance",
             20,
             "RequestQueue deque + payload-byte ledger (admission "
             "decision; metrics and reject raise happen outside the "
             "lock)"),
    LockDecl("serve.registry", "tpudl_torch.serve.registry", "lock",
             "instance", 20,
             "serve ModelRegistry name→entry map (serve.models gauge "
             "published outside the lock)"),
    LockDecl("testing.faults.arm", "tpudl_torch.testing.faults", "lock",
             "module", 20, "fault-plan arm/disarm singleton"),
    LockDecl("testing.traceck", "tpudl_torch.testing.traceck", "lock",
             "module", 20,
             "traceck per-fn-identity capture counts + storm findings "
             "(metrics/flight reporting happens AFTER release)"),
    # -- rank 24-26: registries and rings (held across short bookkeeping)
    LockDecl("obs.metrics.registry", "tpudl_torch.obs.metrics", "lock",
             "instance", 24,
             "MetricsRegistry name→metric map + flush throttle"),
    LockDecl("obs.watchdog.registry", "tpudl_torch.obs.watchdog", "lock",
             "instance", 24,
             "HeartbeatRegistry active set (the watchdog's scan list)"),
    LockDecl("obs.flight.recorder", "tpudl_torch.obs.flight", "lock",
             "instance", 25,
             "FlightRecorder evidence rings (batches/errors/stalls/"
             "ticks/requests/restarts/events) + dumped-paths list"),
    LockDecl("obs.pipeline.report", "tpudl_torch.obs.pipeline", "lock",
             "instance", 25,
             "PipelineReport stages/calls/gauges/progress (prepare "
             "workers + consumer write concurrently)"),
    LockDecl("obs.slo.engine", "tpudl_torch.obs.slo", "lock", "instance",
             25,
             "SloEngine windowed stamp ring + cached median + publish "
             "throttle (gauges and exemplar writes happen outside the "
             "lock)"),
    LockDecl("testing.faults.plan", "tpudl_torch.testing.faults", "lock",
             "instance", 25,
             "FaultPlan rule counters + fired list (the hot fire() "
             "hook)"),
    LockDecl("obs.attribution.ledger", "tpudl_torch.obs.attribution",
             "lock", "instance", 26,
             "ScopeLedger scope table + unattributed bucket (LRU "
             "bookkeeping and folds under the lock; the eviction "
             "counter publishes after release)"),
    # -- rank 30: leaf scalar locks (never held across another lock) ---
    LockDecl("compile.fingerprint_memo", "tpudl_torch.compile.store",
             "lock", "module", 30,
             "fn_fingerprint weak memo map (dispatch pool + warmup "
             "threads share it; pure dict ops under the lock)"),
    LockDecl("cuda_ops.launch_counts", "tpudl_torch.cuda_ops", "lock",
             "module", 30,
             "the kernels' launch counters and a capture's record"),
    LockDecl("data.device_cache.token_memo",
             "tpudl_torch.data.device_cache", "lock", "module", 30,
             "array_token memo map (concurrent estimator trial threads "
             "share it; pure dict ops under the lock)"),
    LockDecl("device.full_f32", "tpudl_torch.device", "lock", "module", 30,
             "full_f32's open-block count and the TF32 flags it saved"),
    LockDecl("image.lazyfile.reads", "tpudl_torch.image.imageIO", "lock",
             "instance", 30, "LazyFileColumn read counter"),
    LockDecl("obs.metrics.counter", "tpudl_torch.obs.metrics", "lock",
             "instance", 30, "one Counter's running value"),
    LockDecl("obs.metrics.gauge", "tpudl_torch.obs.metrics", "lock",
             "instance", 30, "one Gauge's value/count/total/max"),
    LockDecl("obs.metrics.histogram", "tpudl_torch.obs.metrics", "lock",
             "instance", 30,
             "one Histogram's sample ring + running aggregates"),
    LockDecl("obs.tracer.ring", "tpudl_torch.obs.tracer", "lock",
             "instance", 30, "host-span tracer ring + dropped counter"),
    LockDecl("obs.watchdog.heartbeat", "tpudl_torch.obs.watchdog", "lock",
             "instance", 30,
             "Heartbeat beat fields (info/last_beat/beats/stalled) + "
             "in-flight stage map"),
)

LOCK_NAMES = frozenset(d.name for d in LOCKS)


# copied from tpudl/analysis/locks.py:lock_order
def lock_order(name: str) -> int | None:
    for d in LOCKS:
        if d.name == name:
            return d.order
    return None


def render_lock_table() -> str:
    """Markdown lock-inventory table."""
    lines = ["| order | lock | module | scope | guards |",
             "|---|---|---|---|---|"]
    for d in sorted(LOCKS, key=lambda d: (d.order, d.name)):
        lines.append(f"| {d.order} | `{d.name}` | `{d.module}` "
                     f"| {d.scope} | {d.guards} |")
    return "\n".join(lines)
