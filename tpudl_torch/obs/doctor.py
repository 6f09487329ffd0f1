"""``obs doctor`` — turn flight-recorder dumps into a diagnosis.

Port of ``tpudl/obs/doctor.py`` over the port's dumps (which share
tpudl's schema, so it reads tpudl's dumps too and classifies them as
tpudl's doctor does). ``recompile_storm`` reads tpudl's evidence — the
traceck sentinel's ``traceck.storms`` and its ``traceck.recompile_storm``
error-ring entries (:mod:`tpudl_torch.testing.traceck`, the port's
twin, counts CUDA-graph captures a function identity) — and, beside it,
the port's scoped signal: the program store's capture misses that a
failed supervised attempt made itself (``compile.storms`` and the
``compile.storm`` entries of the error ring, filed by
:mod:`tpudl_torch.frame.supervisor`).

The offline half of failure forensics: given one
``tpudl-dump-*.json.gz`` (or a directory of them from a multi-host
gang), merge per-host evidence and CLASSIFY the failure:

- ``preempted_resumable`` — the job runtime (tpudl.jobs) caught the
  SIGTERM, checkpointed, and exited RC_PREEMPTED: the dump carries a
  resume-manifest pointer — relaunch the same JobSpec to resume.
  Checked FIRST: stall/storm history must not bury the one actionable
  fact;
- ``infeed_stall`` — the watchdog flagged a frozen input-side stage
  (prepare/h2d/infeed), or the pipeline report died with the consumer
  parked in ``infeed_wait``: the input pipeline stopped delivering;
- ``decode_error_storm`` — decode/corruption errors are a large
  fraction of reads (``imageio.decode_errors``, ``data.cache.corrupt``
  and the error ring agree): the data went bad, not the code;
- ``recompile_storm`` — the traceck sentinel flagged a function
  identity captured past its threshold (``traceck.storms``), or a
  failed supervised attempt made program-store capture misses of its
  own (``compile.storms``), and the error ring agrees:
  the run was recompiling instead of computing — ranked beside (and checked
  before) ``dispatch_slowdown``, because a storm IS the usual cause
  of a slow dispatch that nobody can explain;
- ``degraded_run`` — the fault-containment supervisor
  (tpudl.frame.supervisor, FAULTS.md) was walking its degradation
  ladder when the process died: ``frame.degraded.*`` metrics and the
  ``frame.degraded`` error-ring events name the rungs and the faults
  that triggered them. Checked after the storm rules (a storm explains
  WHY the run was degrading) and before the stall rules — a run the
  supervisor was actively retrying is not "stuck", it is recovering,
  and the actionable fact is which rung it died on. Gated on
  degradation being CURRENT at death (the exhaustion dump, the
  supervisor's live heartbeat, or the newest report's ``degraded_to``)
  so one long-recovered fault never reroutes a later unrelated death;
- ``overload_shed`` — the serve plane's admission control was
  rejecting a sustained fraction of offered load when the process
  died (``serve.rejects`` against ``serve.requests``, with the queue
  depth/cap gauges as the at-death evidence): the death is — or rode
  on — an overload the queue answered with TYPED rejects, not a hang.
  Ordered after ``degraded_run`` (the ladder explains WHY capacity
  shrank when both fired) and before the stall rules: a saturated
  serve loop still beating its heartbeat is shedding, not stuck;
- ``slo_burn`` — the serve plane was admitting fine but missing its
  latency objective: the windowed burn gauge (``serve.slo.burn_short``,
  tpudl.obs.slo) was >= 1 at death and the error ring holds tail
  exemplars whose segment breakdowns
  (queue_wait/batching/prefill/decode, tpudl.serve.reqtrace) name
  WHERE the time went. Ordered after ``overload_shed`` — shedding
  outranks slow (typed rejects are the louder, more actionable fact)
  — and before the stall rules: a burning-but-live serve loop still
  beats its heartbeat (slow, not stuck);
- ``dispatch_slowdown`` — a stall (or dominant stage share) in
  ``dispatch``: the device/backend stopped answering or slowed;
- ``clean_external_kill`` — a SIGTERM/SIGQUIT dump with no stall and
  no error storm, and NO resume state: the driver killed a healthy
  run (the rc=124 class);
- ``exception`` — an unhandled exception dump: the error is right
  there;
- ``unclassified`` — evidence exists but matches no rule (everything
  the doctor looked at is printed, so a human can take over).

Importable (:func:`load_dumps` / :func:`merge_dumps` / :func:`classify`
/ :func:`format_report`) and runnable:
``python -m tpudl_torch.obs doctor <dump-or-dir>``.
"""

from __future__ import annotations

import glob
import gzip
import json
import os

__all__ = ["load_dump", "load_dumps", "merge_dumps", "classify",
           "format_report", "INFEED_STAGES"]

# input-side stage names: a stall whose last beat named one of these is
# the input pipeline's fault, not the device's
INFEED_STAGES = ("prepare", "h2d", "infeed", "infeed_wait", "decode",
                 "pack", "cache")
# storm thresholds: at least this many bad events AND this fraction of
# the read attempts (an isolated corrupt file is noise, not a storm)
STORM_MIN_EVENTS = 8
STORM_MIN_FRAC = 0.10

# overload_shed thresholds: same shape as the storm gate — absolute
# floor (a handful of rejects on a tiny run is noise) AND a fraction
# of OFFERED load (admitted + rejected), so a long healthy run with a
# brief historical blip never reroutes an unrelated death
SHED_MIN_EVENTS = 8
SHED_MIN_FRAC = 0.10

# slo_burn gates: the burn gauge must show the budget actually burning
# at death AND enough tail exemplars must exist to make the dominant-
# segment attribution statistics, not an anecdote
SLO_BURN_MIN = 1.0
SLO_MIN_EXEMPLARS = 3
# the reqtrace segment model, in lifecycle order, with the remedy each
# dominant segment points at
SLO_SEGMENTS = ("queue_wait", "batching", "prefill", "decode")
SLO_REMEDIES = {
    "queue_wait": "requests park at admission — raise "
                  "TPUDL_SERVE_SLOTS or add serving capacity",
    "batching": "rung packing is the cost — check the prompt-bucket "
                "ladder (TPUDL_BUCKET_LADDER)",
    "prefill": "first-token work dominates — warm the AOT program "
               "store (TPUDL_COMPILE_AOT) so prefill rungs restore, "
               "not compile",
    "decode": "decode steps dominate — lower max_new, raise "
              "TPUDL_SERVE_SLOTS, or add device capacity",
}


# copied from tpudl/obs/doctor.py:load_dump
def load_dump(path: str) -> dict:
    """One dump file (gzip or plain JSON) → payload dict."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        return json.load(f)


# copied from tpudl/obs/doctor.py:find_dump_files
def find_dump_files(path: str) -> list[str]:
    """Dump files under ``path`` (a file is itself; a directory is
    scanned for the recorder's naming pattern, both gzip and plain)."""
    if os.path.isdir(path):
        hits = sorted(glob.glob(os.path.join(path, "tpudl-dump-*.json.gz"))
                      + glob.glob(os.path.join(path, "tpudl-dump-*.json")))
        return hits
    return [path] if os.path.exists(path) else []


# copied from tpudl/obs/doctor.py:load_dumps
def load_dumps(path: str) -> list[dict]:
    """Every parseable dump under ``path``; unreadable files are
    skipped (a torn dump from a dying host must not block the
    readable ones)."""
    dumps = []
    for p in find_dump_files(path):
        try:
            d = load_dump(p)
        except (OSError, json.JSONDecodeError, EOFError):
            continue
        if isinstance(d, dict) and d.get("schema") == "tpudl-flight-dump":
            d["_path"] = p
            dumps.append(d)
    return dumps


# copied from tpudl/obs/doctor.py:merge_dumps
def merge_dumps(dumps: list[dict]) -> dict:
    """Per-process dumps → one merged view. Deduplication is keyed by
    (process_index, pid) — only dumps from the SAME process (an
    explicit obs.dump() plus the death dump) collapse to the newest;
    two processes sharing index 0 (a bench parent and its trial
    subprocess in one dir) both keep their evidence. ``hosts`` keys
    are the process index, suffixed with the pid only when several
    processes share an index. The merged timeline tail interleaves
    every process's spans by wall-clock."""
    by_proc: dict[tuple[int, int], dict] = {}
    for d in dumps:
        key = (int(d.get("process_index", 0) or 0),
               int(d.get("pid", 0) or 0))
        cur = by_proc.get(key)
        if cur is None or d.get("ts", 0) >= cur.get("ts", 0):
            by_proc[key] = d
    idx_counts: dict[int, int] = {}
    for idx, _pid in by_proc:
        idx_counts[idx] = idx_counts.get(idx, 0) + 1
    hosts: dict[str, dict] = {}
    items = []  # (host label for attribution, dump)
    for (idx, pid), d in sorted(by_proc.items()):
        label = str(idx) if idx_counts[idx] == 1 else f"{idx}:{pid}"
        hosts[label] = d
        items.append((label, d))
    spans = []
    for label, d in items:
        for s in d.get("spans", []) or []:
            spans.append(dict(s, host=label))
    spans.sort(key=lambda s: s.get("ts_us") or 0)

    def _by_ts(key):
        # wall-clock order across processes: "the last stall" must be
        # the NEWEST event, not whichever dump iterated last
        entries = [dict(e, host=label) for label, d in items
                   for e in d.get(key, []) or []]
        entries.sort(key=lambda e: e.get("ts") or 0)
        return entries

    return {"hosts": hosts, "n_hosts": len(hosts),
            "spans": spans,
            "stalls": _by_ts("stalls"),
            "errors": _by_ts("errors"),
            "restarts": _by_ts("restarts")}


# copied from tpudl/obs/doctor.py:_metric_value
def _metric_value(dump: dict, name: str) -> float:
    m = (dump.get("metrics") or {}).get(name) or {}
    v = m.get("value")
    return float(v) if isinstance(v, (int, float)) else 0.0


# copied from tpudl/obs/doctor.py:_last_report
def _last_report(dump: dict) -> dict | None:
    reports = dump.get("pipeline_reports") or {}
    if not reports:
        return None
    # ring order is oldest→newest; run ids are "<pid>-<seq>"
    return list(reports.values())[-1]


# copied from tpudl/obs/doctor.py:_stage_rates
def _stage_rates(report: dict | None) -> dict:
    """Per-stage throughput at time of death: seconds, calls and
    seconds-per-call for each executor stage of the newest report."""
    if not report:
        return {}
    secs = report.get("stage_seconds") or {}
    calls = report.get("stage_calls") or {}
    out = {}
    for name, s in secs.items():
        n = calls.get(name) or 0
        out[name] = {"seconds": round(float(s), 4), "calls": int(n),
                     "s_per_call": round(float(s) / n, 5) if n else None}
    return out


# copied from tpudl/obs/doctor.py:_stall_stage
def _stall_stage(stall: dict) -> str | None:
    # the frozen stage is the one ENTERED longest ago and never exited
    # (in_flight), not the last one to beat: a wedged dispatch outlives
    # the prepare pool's final beats
    inflight = stall.get("in_flight") or {}
    if inflight:
        return max(inflight.items(),
                   key=lambda kv: kv[1].get("age_s") or 0)[0]
    info = stall.get("info") or {}
    stage = info.get("stage")
    return str(stage) if stage is not None else None


# copied from tpudl/obs/doctor.py:_ledger_evidence
def _ledger_evidence(hosts: dict) -> list[str]:
    """Common evidence from the dumps' attribution ledgers (v3): name
    the scope that dominated the process at death — the WHO axis every
    classification benefits from in a multi-tenant process — and flag a
    broken reconciliation (a ledger/global mismatch is itself a bug
    worth surfacing, whatever killed the run)."""
    merged: dict[str, float] = {}
    hbm: dict[str, float] = {}
    bad_checks: list[str] = []
    for d in hosts.values():
        led = d.get("ledger") or {}
        rows = list((led.get("scopes") or {}).items())
        una = led.get("unattributed") or {}
        if any(isinstance(v, (int, float)) and v for v in una.values()):
            rows.append(("(unattributed)", una))
        for key, row in rows:
            work = sum(float(row.get(f) or 0) for f in
                       ("rows_in", "rows_out", "tokens_in",
                        "tokens_out", "serve_completed"))
            merged[key] = merged.get(key, 0.0) + work
            hbm[key] = hbm.get(key, 0.0) \
                + float(row.get("hbm_bytes") or 0)
        rec = led.get("reconcile") or {}
        if rec and not rec.get("ok", True):
            bad_checks.extend(
                f"{c['field']} ledger {c['ledger']} != global "
                f"{c['global']}" for c in rec.get("checks", [])
                if not c.get("ok"))
    out: list[str] = []
    if merged:
        key, work = max(merged.items(), key=lambda kv: kv[1])
        line = (f"dominant scope at death: {key} "
                f"({work:.0f} rows+tokens attributed")
        if hbm.get(key):
            line += f", {hbm[key] / 2**20:.1f} MB HBM resident"
        out.append(line + f"; {len(merged)} scope(s) in the ledger)")
    if bad_checks:
        out.append("ledger reconciliation BROKEN at death: "
                   + "; ".join(bad_checks[:3]))
    return out


# copied from tpudl/obs/doctor.py:_is_infeed
def _is_infeed(stall: dict) -> bool:
    stage = (_stall_stage(stall) or "").lower()
    if any(k in stage for k in INFEED_STAGES):
        return True
    name = str(stall.get("name", "")).lower()
    # a stalled frame heartbeat with no stage info yet: the run froze
    # before its first dispatch — the input side by construction
    return stage == "" and "frame" in name


def classify(merged: dict) -> dict:
    """The diagnosis: ``{classification, suspect_stage, suspect_host,
    evidence: [...], stage_rates}``. Rules are ordered by specificity —
    an error storm explains a stall (workers burning time on garbage),
    so the storm wins when both fire."""
    evidence: list[str] = []
    hosts = merged.get("hosts") or {}
    stalls = merged.get("stalls") or []
    errors = merged.get("errors") or []
    restarts = merged.get("restarts") or []

    # evidence common to every rule
    decode_errs = sum(_metric_value(d, "imageio.decode_errors")
                      for d in hosts.values())
    corrupt = sum(_metric_value(d, "data.cache.corrupt")
                  for d in hosts.values())
    reads = sum(_metric_value(d, "imageio.files_read")
                + _metric_value(d, "data.cache.hits")
                + _metric_value(d, "data.cache.misses")
                for d in hosts.values())
    bad = decode_errs + corrupt
    ring_bad = sum(1 for e in errors
                   if str(e.get("kind", "")).startswith(
                       ("imageio", "decode", "data.cache", "shard")))
    newest = max(hosts.values(), key=lambda d: d.get("ts", 0)) \
        if hosts else {}
    reason = str(newest.get("reason", ""))
    report = _last_report(newest)
    rates = _stage_rates(report)
    suspect_host = None
    if stalls:
        suspect_host = stalls[-1].get("host")
    if restarts:
        evidence.append(
            f"{len(restarts)} gang restart(s); last: "
            f"{restarts[-1].get('error_type')}: "
            f"{str(restarts[-1].get('error'))[:120]} "
            f"(attempt {restarts[-1].get('attempt')}, "
            f"step {restarts[-1].get('step')})")
    evidence.extend(_ledger_evidence(hosts))

    # 1. the job runtime turned the kill into a recovery event: the
    #    dump says so (reason) or carries the job.preempted breadcrumb
    #    with the resume-manifest pointer. FIRST rule: the runtime
    #    literally checkpointed and exited rc 75 — stall/storm evidence
    #    from earlier in the run's history must not bury the one
    #    actionable fact (relaunch the spec); it still rides along in
    #    the evidence list. Checked across ALL hosts — in a gang, any
    #    member that persisted resume state makes the death resumable
    preempt_ev = None
    for d in sorted(hosts.values(), key=lambda d: d.get("ts", 0),
                    reverse=True):
        for ev in reversed(d.get("events") or []):
            if ev.get("kind") == "job.preempted":
                preempt_ev = ev
                break
        if preempt_ev is not None:
            break
    if reason == "preempted_resumable" or preempt_ev is not None:
        manifest = (preempt_ev or {}).get("manifest")
        if stalls:
            last = stalls[-1]
            evidence.append(
                f"history: watchdog flagged {len(stalls)} stall(s); "
                f"last: {last.get('name')} frozen {last.get('age_s')}s "
                f"in stage {_stall_stage(last) or 'unknown'!r}")
        if bad:
            evidence.append(f"history: {decode_errs:.0f} decode errors "
                            f"+ {corrupt:.0f} corrupt shards over "
                            f"{reads:.0f} read attempts")
        evidence.insert(0, (
            "the job runtime checkpointed and exited on the kill "
            "(rc 75, preempted-resumable); resume state: "
            f"{manifest or 'see job-manifest.json in the job workdir'}"
            + (f", cursor {preempt_ev.get('cursor')}"
               if preempt_ev and preempt_ev.get("cursor") else "")))
        evidence.append("relaunch the SAME JobSpec to resume with "
                        "bounded rework (JOBS.md)")
        return {"classification": "preempted_resumable",
                "suspect_stage": None, "suspect_host": None,
                "resume_manifest": manifest,
                "evidence": evidence, "stage_rates": rates}

    # 2. decode-error storm: the strongest failure signal — bad data
    #    starves or stalls everything downstream of it
    if bad >= STORM_MIN_EVENTS and bad >= STORM_MIN_FRAC * max(reads, 1.0):
        evidence.insert(0, (
            f"{decode_errs:.0f} decode errors + {corrupt:.0f} corrupt "
            f"shards over {reads:.0f} read attempts "
            f"({bad / max(reads, 1.0):.0%}); {ring_bad} sample(s) in "
            "the error ring"))
        return {"classification": "decode_error_storm",
                "suspect_stage": "decode",
                "suspect_host": suspect_host,
                "evidence": evidence, "stage_rates": rates}

    # 2b. recompile storm: the traceck sentinel measured a fn identity
    #     capturing (or, in a tpudl dump, retracing) past its threshold,
    #     or a failed supervised attempt captured new programs of its
    #     own (compile.storms). Checked BEFORE the stall rules —
    #     compiling reads as a dispatch stall/slowdown from outside; the
    #     storm is the cause, not the symptom
    storms = sum(_metric_value(d, "compile.storms")
                 + _metric_value(d, "traceck.storms")
                 for d in hosts.values())
    storm_ring = [e for e in errors
                  if str(e.get("kind", "")).startswith(
                      ("compile.storm", "traceck"))]
    if storms or storm_ring:
        misses = sum(_metric_value(d, "compile.misses")
                     + _metric_value(d, "traceck.retraces")
                     for d in hosts.values())
        evidence.insert(0, (
            f"{storms:.0f} recompile storm(s): failed attempts that "
            f"compiled or captured new programs ({misses:.0f} program "
            f"misses or retraces in all)"))
        for e in storm_ring[-3:]:
            evidence.append(
                f"storm: {e.get('fn', e.get('stage', '?'))} "
                f"{e.get('misses', e.get('traces', '?'))} new program(s)")
        if stalls:
            last = stalls[-1]
            evidence.append(
                f"history: watchdog flagged {len(stalls)} stall(s); "
                f"last: {last.get('name')} frozen {last.get('age_s')}s "
                f"in stage {_stall_stage(last) or 'unknown'!r}")
        evidence.append("fix the churn site: a signature that changes "
                        "every batch (shapes, dtypes, devices) captures "
                        "a new program each time; bucket the shapes "
                        "(TPUDL_COMPILE_BUCKETS)")
        return {"classification": "recompile_storm",
                "suspect_stage": "dispatch",
                "suspect_host": suspect_host,
                "evidence": evidence, "stage_rates": rates}

    # 2c. degraded run: the fault-containment supervisor was mid-ladder
    #     when the process died — the rung trail is the diagnosis (and
    #     a killed retrying run must not read as a generic stall).
    #     ``exhausted`` dumps carry their own typed error; both shapes
    #     land here so a degraded-then-killed run is one class.
    #     Gated on degradation being CURRENT at death — the exhaustion
    #     dump itself, the supervisor's heartbeat still registered, or
    #     the NEWEST pipeline report carrying degraded_to — never on
    #     the cumulative counters alone: one long-recovered fault early
    #     in a process's life must not reroute every later unrelated
    #     death away from the stall/kill classes
    degr_rungs = sum(_metric_value(d, "frame.degraded.rungs")
                     for d in hosts.values())
    degr_ring = [e for e in errors
                 if str(e.get("kind", "")).startswith("frame.degraded")]
    sup_hb = (newest.get("heartbeats") or {}).get(
        "frame.supervisor") or {}
    degr_current = (
        reason == "degraded_exhausted"
        # a LIVE supervisor heartbeat only counts when ITS run has
        # actually applied rungs (it beats rungs=len(self.rungs)):
        # under process-wide TPUDL_FRAME_DEGRADE=1 every supervised
        # run registers one, and mere presence would let a stale
        # recovered fault reroute a later unrelated death
        or int((sup_hb.get("info") or {}).get("rungs") or 0) > 0
        or bool(report and report.get("degraded_to")))
    if degr_current and (degr_rungs or degr_ring):
        exhausted = sum(_metric_value(d, "frame.degraded.exhausted")
                        for d in hosts.values())
        recovered = sum(
            _metric_value(d, "frame.degraded.recovered_batches")
            for d in hosts.values())
        evidence.insert(0, (
            f"the executor supervisor applied {degr_rungs:.0f} "
            f"degradation rung(s) before death"
            + (f"; ladder EXHAUSTED {exhausted:.0f} time(s) "
               "(typed error + this dump)" if exhausted else "")
            + (f"; {recovered:.0f} batch(es) recovered on degraded "
               "rungs" if recovered else "")))
        suspect = None
        for e in degr_ring[-3:]:
            evidence.append(
                f"rung: {e.get('rung', e.get('kind'))} after "
                f"{e.get('type')} in stage {e.get('stage')!r}")
            suspect = e.get("stage") or suspect
        if stalls:
            last = stalls[-1]
            evidence.append(
                f"history: watchdog flagged {len(stalls)} stall(s); "
                f"last: {last.get('name')} frozen {last.get('age_s')}s "
                f"in stage {_stall_stage(last) or 'unknown'!r}")
        evidence.append("the rung trail + FAULTS.md name the knob that "
                        "was being degraded; fix the underlying fault "
                        "(ring entries carry the original exception)")
        return {"classification": "degraded_run",
                "suspect_stage": suspect,
                "suspect_host": suspect_host,
                "evidence": evidence, "stage_rates": rates}

    # 2d. overload shed: admission control was rejecting a sustained
    #     fraction of offered load at death — the serve plane answered
    #     pressure with typed rejects (the load-shedding contract),
    #     and the actionable fact is capacity, not a bug hunt. Before
    #     the stall rules: a saturated loop still beating its
    #     heartbeat is shedding, not stuck.
    rejects = sum(_metric_value(d, "serve.rejects")
                  for d in hosts.values())
    admitted = sum(_metric_value(d, "serve.requests")
                   for d in hosts.values())
    offered = rejects + admitted
    if rejects >= SHED_MIN_EVENTS \
            and rejects >= SHED_MIN_FRAC * max(offered, 1.0):
        shed_host = None
        for h, d in hosts.items():
            if _metric_value(d, "serve.rejects"):
                shed_host = h
                break
        depth = _metric_value(newest, "serve.queue_depth")
        cap = _metric_value(newest, "serve.queue_cap")
        sheds = sum(_metric_value(d, "serve.deadline_sheds")
                    for d in hosts.values())
        evidence.insert(0, (
            f"admission control rejected {rejects:.0f} of "
            f"{offered:.0f} offered requests "
            f"({rejects / max(offered, 1.0):.0%}) — sustained "
            "overload, shed by typed rejects"))
        if cap:
            evidence.append(
                f"queue at death: depth {depth:.0f} of cap {cap:.0f}")
        if sheds:
            evidence.append(
                f"{sheds:.0f} request(s) shed on expired deadlines")
        if stalls:
            last = stalls[-1]
            evidence.append(
                f"history: watchdog flagged {len(stalls)} stall(s); "
                f"last: {last.get('name')} frozen {last.get('age_s')}s "
                f"in stage {_stall_stage(last) or 'unknown'!r}")
        evidence.append(
            "the queue stayed bounded and clients got typed answers; "
            "raise TPUDL_SERVE_QUEUE_CAP / TPUDL_SERVE_SLOTS or add "
            "serving capacity (SERVE.md)")
        return {"classification": "overload_shed",
                "suspect_stage": "admission",
                "suspect_host": shed_host or suspect_host,
                "evidence": evidence, "stage_rates": rates}

    # 2e. slo burn: admission was fine but the latency objective was
    #     NOT being met at death — the windowed burn gauge says the
    #     budget was burning and the tail exemplars in the error ring
    #     say where the time went. After overload_shed (shedding
    #     outranks slow) and before the stall rules (a slow-but-live
    #     loop still beats its heartbeat).
    exemplars = [e for e in errors
                 if str(e.get("kind", "")).startswith("serve.slo")]
    burn = max((_metric_value(d, "serve.slo.burn_short")
                for d in hosts.values()), default=0.0)
    if len(exemplars) >= SLO_MIN_EXEMPLARS and burn >= SLO_BURN_MIN:
        target = max((_metric_value(d, "serve.slo.target_ms")
                      for d in hosts.values()), default=0.0)
        win_p99 = max((_metric_value(d, "serve.slo.window_p99_ms")
                       for d in hosts.values()), default=0.0)
        seg_tot: dict[str, float] = {}
        for e in exemplars:
            for seg in SLO_SEGMENTS:
                v = e.get(f"{seg}_ms")
                if isinstance(v, (int, float)):
                    seg_tot[seg] = seg_tot.get(seg, 0.0) + float(v)
        total_ms = sum(seg_tot.values())
        dominant = (max(seg_tot.items(), key=lambda kv: kv[1])[0]
                    if seg_tot else None)
        headline = (f"p99 burn: windowed p99 {win_p99:.0f}ms against "
                    f"the {target:.0f}ms objective "
                    f"(burn {burn:.1f}x the error budget)")
        if dominant is not None:
            share = seg_tot[dominant] / max(total_ms, 1e-9)
            headline += (f"; {share:.0%} of tail latency across "
                         f"{len(exemplars)} exemplar(s) is {dominant}")
        evidence.insert(0, headline)
        if seg_tot:
            evidence.append("tail time by segment: " + "  ".join(
                f"{k} {v:.0f}ms" for k, v in sorted(
                    seg_tot.items(), key=lambda kv: -kv[1])))
        if dominant is not None:
            evidence.append(SLO_REMEDIES.get(
                dominant, "add serving capacity (SERVE.md)"))
        if stalls:
            last = stalls[-1]
            evidence.append(
                f"history: watchdog flagged {len(stalls)} stall(s); "
                f"last: {last.get('name')} frozen {last.get('age_s')}s "
                f"in stage {_stall_stage(last) or 'unknown'!r}")
        return {"classification": "slo_burn",
                "suspect_stage": dominant,
                "suspect_host": (exemplars[-1].get("host")
                                 or suspect_host),
                "evidence": evidence, "stage_rates": rates}

    # 3/4. watchdog stalls: which side froze?
    if stalls:
        last = stalls[-1]
        stage = _stall_stage(last)
        evidence.insert(0, (
            f"watchdog flagged {len(stalls)} stall(s); last: "
            f"{last.get('name')} frozen {last.get('age_s')}s in stage "
            f"{stage or 'unknown'!r} on host {last.get('host')}"))
        if _is_infeed(last):
            return {"classification": "infeed_stall",
                    "suspect_stage": stage or "prepare",
                    "suspect_host": last.get("host"),
                    "evidence": evidence, "stage_rates": rates}
        if stage is not None:
            return {"classification": "dispatch_slowdown",
                    "suspect_stage": stage,
                    "suspect_host": last.get("host"),
                    "evidence": evidence, "stage_rates": rates}
        # a supervised non-executor unit (train step, UDF call, HPO
        # trial) froze with no stage attribution: an honest "stall"
        # beats guessing a side — the dump's thread stacks say where
        evidence.append("no stage attribution (non-executor "
                        "heartbeat); see the stall's thread stacks "
                        "in the dump")
        return {"classification": "stall",
                "suspect_stage": None,
                "suspect_host": last.get("host"),
                "evidence": evidence, "stage_rates": rates}

    # 5. no stall, no storm, external signal: a healthy run was killed
    if reason.startswith("signal"):
        evidence.insert(0, (
            f"dump reason {reason!r} with no stalls and no error "
            "storm — the process was killed from outside while making "
            "progress"))
        if rates:
            dominant = max(rates.items(),
                           key=lambda kv: kv[1]["seconds"])
            total = sum(v["seconds"] for v in rates.values()) or 1.0
            evidence.append(
                f"time went to {dominant[0]!r} "
                f"({dominant[1]['seconds'] / total:.0%} of stage "
                "time) — slow, not stuck")
        return {"classification": "clean_external_kill",
                "suspect_stage": None, "suspect_host": None,
                "evidence": evidence, "stage_rates": rates}

    # 6. unhandled exception: the error explains itself
    err = newest.get("error")
    if reason == "exception" and err:
        evidence.insert(0, f"unhandled {err.get('type')}: "
                        f"{str(err.get('message'))[:200]}")
        return {"classification": "exception",
                "suspect_stage": None, "suspect_host": None,
                "evidence": evidence, "stage_rates": rates}

    # 7. a slow-but-alive dispatch dominating the last report
    if rates:
        dominant = max(rates.items(), key=lambda kv: kv[1]["seconds"])
        total = sum(v["seconds"] for v in rates.values()) or 1.0
        share = dominant[1]["seconds"] / total
        if dominant[0] == "dispatch" and share > 0.8:
            evidence.insert(0, (
                f"dispatch holds {share:.0%} of stage time "
                f"({dominant[1]['s_per_call']}s/call) in the last "
                "report — device-bound at death"))
            return {"classification": "dispatch_slowdown",
                    "suspect_stage": "dispatch", "suspect_host": None,
                    "evidence": evidence, "stage_rates": rates}

    evidence.insert(0, f"reason {reason!r}; no rule matched")
    return {"classification": "unclassified", "suspect_stage": None,
            "suspect_host": None, "evidence": evidence,
            "stage_rates": rates}


# copied from tpudl/obs/doctor.py:format_report
def format_report(merged: dict, diagnosis: dict,
                  tail: int = 12) -> str:
    """Human-readable doctor output: verdict first, then the evidence,
    per-stage throughput at death, and the merged timeline tail."""
    lines = []
    hosts = merged.get("hosts") or {}
    lines.append(f"== tpudl obs doctor — {len(hosts)} host dump(s) ==")
    for idx in sorted(hosts, key=lambda k: [int(x)
                                            for x in str(k).split(":")]):
        d = hosts[idx]
        lines.append(
            f"  host {idx}: pid {d.get('pid')} reason "
            f"{d.get('reason')!r} ({d.get('_path', '?')})")
    lines.append("")
    lines.append(f"DIAGNOSIS: {diagnosis['classification']}"
                 + (f"  (suspect stage: {diagnosis['suspect_stage']}"
                    + (f", host {diagnosis['suspect_host']}"
                       if diagnosis.get("suspect_host") is not None
                       else "") + ")"
                    if diagnosis.get("suspect_stage") else ""))
    for ev in diagnosis.get("evidence", []):
        lines.append(f"  - {ev}")
    rates = diagnosis.get("stage_rates") or {}
    if rates:
        lines.append("")
        lines.append("per-stage throughput at time of death:")
        for name, r in sorted(rates.items(),
                              key=lambda kv: -kv[1]["seconds"]):
            per = (f"{r['s_per_call'] * 1e3:.2f} ms/call"
                   if r["s_per_call"] is not None else "-")
            lines.append(f"  {name:<14} {r['seconds']:>9.3f}s "
                         f"x{r['calls']:<6} {per}")
    spans = merged.get("spans") or []
    if spans:
        lines.append("")
        lines.append(f"timeline tail (last {min(tail, len(spans))} "
                     "spans):")
        for s in spans[-tail:]:
            dur_ms = (s.get("dur_us") or 0) / 1e3
            lines.append(f"  [host {s.get('host', 0)}] "
                         f"{s.get('name', '?'):<28} {dur_ms:>10.2f} ms"
                         + (f"  {s['attrs']}" if s.get("attrs") else ""))
    errors = merged.get("errors") or []
    if errors:
        lines.append("")
        lines.append(f"error ring tail ({min(5, len(errors))} of "
                     f"{len(errors)}):")
        for e in errors[-5:]:
            etype = f"{e['type']} " if e.get("type") else ""
            lines.append(f"  [host {e.get('host', 0)}] "
                         f"{e.get('kind')}: {etype}"
                         f"{str(e.get('message'))[:100]}")
    return "\n".join(lines)


# copied from tpudl/obs/doctor.py:diagnose
def diagnose(path: str) -> tuple[dict, dict] | None:
    """Convenience: load + merge + classify ``path``; None when no
    dumps are found."""
    dumps = load_dumps(path)
    if not dumps:
        return None
    merged = merge_dumps(dumps)
    return merged, classify(merged)
