"""Device traces and the host/device merged timeline, over torch.profiler.

Port of ``tpudl/obs/trace.py`` with ``torch.profiler`` in place of
``jax.profiler``: :func:`profile` captures CPU and, where a card is
present, CUDA activity (CUPTI, through Kineto) and writes the Chrome trace
into its directory; :func:`load_trace_events` parses it;
:func:`summarize_device_trace` aggregates the card's lanes, and
:func:`merge_trace_events` / :func:`summarize_merged` put the host-span
tracer's export (:mod:`tpudl_torch.obs.tracer`) beside them in one Chrome
trace and one summary: device busy %, host stage totals, how much host
work ran under device work, and the top device ops.
``python -m tpudl_torch.obs trace <dir>`` drives it from the command line.

Device lanes are Kineto's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events (:data:`DEVICE_CATEGORIES`), where tpudl reads its profiler's Modules and
Ops lanes: every kernel a kernel event, under its demangled name (a
hand-written flash kernel as ``flash_fwd_kernel<float, 64>``, whether it
was launched through ctypes or replayed from a CUDA graph). The summary
keeps tpudl's keys: ``module_us``/``module_count`` are the device events'
total time and count, ``ops`` their per-name totals with the event's
category.

Time bases: Kineto's events and the host spans each carry their own, so
the merge normalizes each stream to its own first event, as tpudl's does;
the merged timeline is stream-relative, which is exact when both streams
cover one window (``obs.profile`` records its window on the tracer).

A capture can lose device events at its head: on an NVIDIA H100 80GB HBM3
at 700 W Kineto's trace holds fewer device events than the block ran, the
first ones, while their launches' host records stay: a span of the
capture's first device time that grows with the time since the process's
first profiler session (0 events at 19 s, 64 at 807 s in a process that
did nothing but capture) and jumps in some sessions (every one of 512
~2 µs markers once), whatever the process ran meanwhile. No port call
resets it, so every device-time reading goes through :func:`capture`: it
fences the block with marker kernels, which absorb the loss (the trace
says how many it lost, ``tpudlCapture``), and a capture whose loss may
reach the block raises :class:`TruncatedCapture` rather than give totals
that are not the block's. :func:`profile` is :func:`capture` with the trace written to a
directory.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import itertools
import json
import os
import time

__all__ = ["profile", "capture", "TruncatedCapture", "named_scope",
           "load_trace_events", "account_marks",
           "load_capture", "summarize_device_trace", "load_host_trace_events",
           "find_trace_files", "merge_trace_events", "summarize_merged",
           "DEVICE_CATEGORIES", "device_events"]

HOST_PID = 0  # merged-trace pid for the host lane (device pids re-number up)

# Kineto's categories of work that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_TRACE_SEQ = itertools.count()


# A capture on a card opens with HEAD_MARKS launches of torch.cuda._sleep's
# spin kernel, each spinning HEAD_CYCLES (~25 µs on an H100), and closes
# with one that spins TAIL_CYCLES (~0.5 ms), each side fenced by a
# synchronize: how many head markers reach the trace is how many device
# events the capture lost at its head, and the markers are taken out of
# the trace. The loss is a span of the capture's first device time, which
# drifts with the process's age and jumps in some sessions (a whole 512
# of ~2 µs markers once, on the H100): the head spans ~25 ms, so a loss
# reaches the block only past that. A block that itself calls
# torch.cuda._sleep is miscounted.
HEAD_MARKS = 1024
HEAD_CYCLES = 50_000
TAIL_CYCLES = 1_000_000
TAIL_MIN_US = 250.0                # a spin kernel this long is the tail marker
MARK_KERNEL = "spin_kernel"


def _launch_marks(n: int, cycles: int = 0) -> None:
    import torch

    for _ in range(n):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


def account_marks(events: list[dict], head_marks: int):
    """``(events, capture)``: the trace's events without the marker kernels
    :func:`profile` launched before and after its block (nor their
    runtime launches and flow arrows), and the capture's record —
    ``head_marks`` launched, ``head_seen`` on the device lanes,
    ``head_lost`` (device events the capture lost at its head, counted
    while fewer than ``head_marks``), ``tail_seen``, ``truncated`` (no
    head marker reached the trace, so the loss may reach the block, or
    the closing one did not, so the tail was cut) and
    ``launches_without_kernel`` (:func:`_orphan_launches`). Kernels that other
    threads launch during the capture do not disturb the count."""
    if not head_marks:
        return list(events), {"head_marks": 0, "head_seen": 0,
                              "head_lost": 0, "tail_seen": None,
                              "truncated": False,
                              "launches_without_kernel": 0}
    marks = [e for e in events if _is_device(e)
             and MARK_KERNEL in str(e.get("name", ""))]
    tail = [e for e in marks if float(e.get("dur", 0.0)) >= TAIL_MIN_US]
    head = [e for e in marks if float(e.get("dur", 0.0)) < TAIL_MIN_US]
    ours = {id(e) for e in marks}
    corr = {(e.get("args") or {}).get("correlation") for e in marks}
    corr.discard(None)

    def mine(e):
        if id(e) in ours:
            return True
        if e.get("cat") == "ac2g":
            return e.get("id") in corr
        return (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and (e.get("args") or {}).get("correlation") in corr)

    kept = [e for e in events if not mine(e)]
    capture = {"head_marks": head_marks, "head_seen": len(head),
               "head_lost": max(head_marks - len(head), 0),
               "tail_seen": bool(tail),
               "truncated": not head or not tail,
               "launches_without_kernel": _orphan_launches(kept)}
    return kept, capture


def _orphan_launches(events: list[dict]) -> int:
    """Runtime or driver launch calls in the trace whose correlation id no
    device event carries: kernels whose device record was lost while the
    launch's host record was kept."""
    corr = {(e.get("args") or {}).get("correlation")
            for e in events if _is_device(e)}
    return sum(1 for e in events
               if e.get("ph") == "X"
               and e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "Launch" in str(e.get("name", ""))
               and (e.get("args") or {}).get("correlation") is not None
               and e["args"]["correlation"] not in corr)


class TruncatedCapture(RuntimeError):
    """A capture lost every head marker, or its closing one: the loss
    may reach the block, so its device totals are not the block's."""


@contextlib.contextmanager
def capture(cpu: bool = True):
    """A ``torch.profiler`` session over the enclosed block: the one path
    the port reads device time through. CUDA activity when a card is
    present, CPU activity too unless ``cpu=False`` (recording host ops
    would slow a host-bound block). On a card the block is fenced: a
    synchronize and ``HEAD_MARKS`` marker kernels before it, a
    synchronize and one closing marker after. Yields the
    ``torch.profiler.profile`` object; on exit its ``trace`` holds the
    Chrome trace without the markers (nor their launches), its
    ``capture`` :func:`account_marks`' record, and its events and
    ``key_averages()`` stay readable (the markers are ``MARK_KERNEL``
    there). A capture that lost head markers counts
    ``obs.profile.head_lost``; a truncated one counts
    ``obs.profile.truncated`` and raises :class:`TruncatedCapture`."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _torch_profile

    from tpudl_torch.obs import metrics as _metrics

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] if cpu or not cuda else []
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = _torch_profile(activities=activities)
    marks = HEAD_MARKS if cuda else 0
    prof.__enter__()
    try:
        if marks:
            _launch_marks(marks, HEAD_CYCLES)
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
            _launch_marks(1, TAIL_CYCLES)
        prof.__exit__(None, None, None)
    fd, tmp = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(tmp)
        with open(tmp) as f:
            tr = json.load(f)
    finally:
        os.remove(tmp)
    events = tr["traceEvents"] if isinstance(tr, dict) else tr
    kept, record = account_marks(events, marks)
    prof.trace = (dict(tr, traceEvents=kept) if isinstance(tr, dict)
                  else {"traceEvents": kept})
    prof.capture = record
    _metrics.counter("obs.profile.captures").inc()
    if record["head_lost"]:
        _metrics.counter("obs.profile.head_lost").inc(record["head_lost"])
    if record["truncated"]:
        _metrics.counter("obs.profile.truncated").inc()
        raise TruncatedCapture(
            f"obs.profile: truncated capture ({record}): its device "
            f"totals are not the block's")


@contextlib.contextmanager
def profile(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block through
    :func:`capture` (CPU activity always, CUDA activity when a card is
    present: the block's kernels, copies and fills, each under its own
    name, fenced by marker kernels). On exit the trace is written into
    ``log_dir`` as ``tpudl-<pid>-<n>.trace.json.gz`` (Chrome trace-event
    JSON, which :func:`load_trace_events` and ``chrome://tracing`` read)
    with the capture's record as its ``tpudlCapture``, and the capture
    window is recorded on the host-span tracer, so
    ``export_chrome_trace(path, window="profile")`` exports exactly the
    spans this block covered. Yields the ``torch.profiler.profile``
    object; on exit its ``trace_path`` and ``capture`` are set. A
    truncated capture is written all the same, then raises
    :class:`TruncatedCapture`."""
    from tpudl_torch.obs import tracer as _tracer_mod

    os.makedirs(log_dir, exist_ok=True)
    t0_us = time.time() * 1e6
    truncated = None
    try:
        with capture(cpu=True) as prof:
            yield prof
    except TruncatedCapture as e:
        truncated = e
    _tracer_mod.get_tracer().last_profile_window = (t0_us,
                                                    time.time() * 1e6)
    path = os.path.join(
        log_dir, f"tpudl-{os.getpid()}-{next(_TRACE_SEQ)}.trace.json.gz")
    tr = dict(prof.trace, tpudlCapture=prof.capture)
    with gzip.open(path, "wt") as dst:
        json.dump(tr, dst)
    prof.trace_path = path
    if truncated is not None:
        raise truncated


def named_scope(name: str):
    """Label a region on the profiler's timeline
    (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)


def _device_trace_paths(trace_dir: str) -> list[str]:
    pats = ("**/*.trace.json.gz", "**/*.trace.json")
    return [p for pat in pats
            for p in glob.glob(os.path.join(trace_dir, pat), recursive=True)
            if not p.endswith((".host.trace.json", ".host.trace.json.gz"))]


def _read_events(path: str) -> list[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tr = json.load(f)
    return tr["traceEvents"] if isinstance(tr, dict) else tr


def load_trace_events(trace_dir: str) -> list[dict]:
    """Events from the newest profiler trace under ``trace_dir`` (a
    ``*.trace.json.gz`` that :func:`profile` wrote, or torch's own
    ``*.pt.trace.json``)."""
    paths = _device_trace_paths(trace_dir)
    if not paths:
        raise FileNotFoundError(f"no trace.json(.gz) under {trace_dir}")
    return _read_events(max(paths, key=os.path.getmtime))


def load_capture(path: str) -> dict | None:
    """The ``tpudlCapture`` record :func:`profile` wrote into a trace
    file (``None`` for a trace it did not write)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tr = json.load(f)
    return tr.get("tpudlCapture") if isinstance(tr, dict) else None


def load_host_trace_events(path: str) -> list[dict]:
    """Events from a host-span tracer export (plain or gzipped JSON)."""
    return _read_events(path)


def find_trace_files(trace_dir: str) -> dict:
    """Locate the newest host export and device trace under a directory:
    ``{"host": path|None, "device": path|None}``. Host exports are the
    tracer's ``*.host.trace.json`` (optionally ``.gz``); device traces
    are the profiler's ``*.trace.json(.gz)`` (host exports excluded)."""
    host = [p for pat in ("**/*.host.trace.json", "**/*.host.trace.json.gz")
            for p in glob.glob(os.path.join(trace_dir, pat), recursive=True)]
    dev = _device_trace_paths(trace_dir)
    newest = lambda ps: max(ps, key=os.path.getmtime) if ps else None  # noqa: E731
    return {"host": newest(host), "device": newest(dev)}


def _is_device(e: dict) -> bool:
    return (e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES)


def device_events(events: list[dict]) -> list[dict]:
    """The trace's device-lane events: Kineto's kernels, copies and
    fills."""
    return [e for e in events if _is_device(e)]


def summarize_device_trace(events: list[dict]) -> dict:
    """Aggregate device-side time from a Kineto event list.

    Returns ``{"module_us": total µs of device events, "module_count": n,
    "ops": {name: {us, count, category, long_name, bytes}}}`` — tpudl's
    keys, with every kernel, copy and fill a device event and ``bytes``
    the copies' and fills' byte counts. An empty summary (count 0) when
    the trace has no device lanes (a CPU-only capture)."""
    module_us, module_count = 0.0, 0
    ops: dict[str, dict] = {}
    for e in events:
        if not _is_device(e):
            continue
        dur = float(e.get("dur", 0.0))
        module_us += dur
        module_count += 1
        a = e.get("args") or {}
        rec = ops.setdefault(e["name"], {
            "us": 0.0, "count": 0, "category": "", "long_name": "",
            "bytes": 0})
        rec["us"] += dur
        rec["count"] += 1
        rec["category"] = str(e.get("cat", rec["category"]))
        rec["long_name"] = e["name"]
        rec["bytes"] += int(a.get("bytes", 0) or 0)
    return {"module_us": module_us, "module_count": module_count,
            "ops": ops}


# copied from tpudl/obs/trace.py:_durations
def _durations(events, keep) -> list[tuple[float, float]]:
    """(start, end) µs intervals of "X" events passing ``keep(e)``."""
    out = []
    for e in events:
        if e.get("ph") == "X" and keep(e):
            ts = float(e.get("ts", 0.0))
            out.append((ts, ts + float(e.get("dur", 0.0))))
    return out


# copied from tpudl/obs/trace.py:_merged
def _merged(intervals) -> list[tuple[float, float]]:
    """Coalesce possibly-overlapping intervals — the ONE sweep behind
    both union and intersection (diverging copies would skew
    device_busy_us vs overlap_us)."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


# copied from tpudl/obs/trace.py:_union_us
def _union_us(intervals) -> float:
    """Total covered time of possibly-overlapping intervals."""
    return sum(e - s for s, e in _merged(intervals))


# copied from tpudl/obs/trace.py:_intersection_us
def _intersection_us(a, b) -> float:
    """Covered time where union(a) and union(b) overlap."""
    am, bm = _merged(a), _merged(b)
    i = j = 0
    total = 0.0
    while i < len(am) and j < len(bm):
        s = max(am[i][0], bm[j][0])
        e = min(am[i][1], bm[j][1])
        if s < e:
            total += e - s
        if am[i][1] < bm[j][1]:
            i += 1
        else:
            j += 1
    return total


# copied from tpudl/obs/trace.py:_normalize
def _normalize(events) -> list[dict]:
    """Shift a stream's "X" timestamps so its first event starts at 0
    (metadata events pass through untouched)."""
    xs = [float(e["ts"]) for e in events
          if e.get("ph") == "X" and "ts" in e]
    if not xs:
        return list(events)
    base = min(xs)
    out = []
    for e in events:
        if e.get("ph") == "X" and "ts" in e:
            e = dict(e)
            e["ts"] = float(e["ts"]) - base
        out.append(e)
    return out


# copied from tpudl/obs/trace.py:merge_trace_events
def merge_trace_events(host_events: list[dict],
                       device_events: list[dict]) -> list[dict]:
    """One Chrome trace with the host-span lane alongside the device
    lanes. Each stream is normalized to its own start (time bases are
    incompatible: host = epoch µs, device = profiler-internal); host
    events take ``pid=HOST_PID`` and device pids are renumbered from 1
    upward so the lanes can never collide."""
    host = _normalize(host_events)
    dev = _normalize(device_events)
    merged = []
    for e in host:
        e = dict(e)
        e["pid"] = HOST_PID
        merged.append(e)
    pid_map: dict = {}
    for e in device_events:
        if "pid" in e and e["pid"] not in pid_map:
            pid_map[e["pid"]] = len(pid_map) + 1
    for e in dev:
        e = dict(e)
        if "pid" in e:
            e["pid"] = pid_map[e["pid"]]
        merged.append(e)
    return merged


def summarize_merged(host_events: list[dict],
                     device_events: list[dict]) -> dict:
    """The merged-timeline summary behind ``python -m tpudl_torch.obs
    trace``, in tpudl's keys.

    - ``device``: :func:`summarize_device_trace` of the device stream;
    - ``device_busy_us`` / ``device_busy_frac``: union of the device
      events' intervals over their own wall window — the card's duty
      cycle;
    - ``host_stage_us`` / ``host_stage_calls``: per-span-name host
      totals;
    - ``host_busy_us``: union of all host spans;
    - ``overlap_us`` / ``host_overlap_frac``: host-busy time that
      coincides with device-busy time, each stream on its own normalized
      clock (both streams must cover one window for this to mean
      overlap, as ``obs.profile`` + the tracer arrange);
    - ``wall_us``, ``top_ops`` (the five device ops with most time).

    The device stream is normalized to its first event of any kind
    (Kineto's CPU ops included), as tpudl normalizes the whole
    profiler stream."""
    dev_norm = _normalize(device_events)
    host_norm = _normalize(host_events)
    dev_iv = _durations(dev_norm, _is_device)
    host_iv = _durations(host_norm, lambda e: True)
    host_stage_us: dict[str, float] = {}
    host_stage_calls: dict[str, int] = {}
    for e in host_norm:
        if e.get("ph") == "X":
            host_stage_us[e["name"]] = (host_stage_us.get(e["name"], 0.0)
                                        + float(e.get("dur", 0.0)))
            host_stage_calls[e["name"]] = host_stage_calls.get(e["name"],
                                                               0) + 1
    xs = [x for s, e in dev_iv + host_iv for x in (s, e)]
    wall_us = (max(xs) - min(xs)) if xs else 0.0
    dev_xs = [x for s, e in dev_iv for x in (s, e)]
    dev_wall = (max(dev_xs) - min(dev_xs)) if dev_xs else 0.0
    device_busy = _union_us(dev_iv)
    host_busy = _union_us(host_iv)
    overlap = _intersection_us(host_iv, dev_iv)
    summary = summarize_device_trace(device_events)
    top = sorted(summary["ops"].items(), key=lambda kv: -kv[1]["us"])[:5]
    return {
        "device": summary,
        "device_busy_us": round(device_busy, 1),
        "device_busy_frac": (round(device_busy / dev_wall, 4)
                             if dev_wall > 0 else None),
        "host_stage_us": {k: round(v, 1)
                          for k, v in sorted(host_stage_us.items())},
        "host_stage_calls": dict(sorted(host_stage_calls.items())),
        "host_busy_us": round(host_busy, 1),
        "overlap_us": round(overlap, 1),
        "host_overlap_frac": (round(overlap / host_busy, 4)
                              if host_busy > 0 else None),
        "wall_us": round(wall_us, 1),
        "top_ops": [{"name": k, "us": round(v["us"], 1),
                     "count": v["count"], "category": v["category"]}
                    for k, v in top],
    }
