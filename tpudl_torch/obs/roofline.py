"""Roofline bottleneck attribution and the knob advisor.

Port of ``tpudl/obs/roofline.py``: :class:`RooflineReport`,
:func:`analyze`, :func:`advise`, :func:`autotune_seed` and the
``obs.roofline.*`` gauges, the same functions of a pipeline-report dict
plus their inputs. Given one run's report it splits the gap between the
achieved rate and the card's rate over ``prepare / wire(h2d) / dispatch /
d2h`` and recommends ``fuse_steps`` / ``dispatch_depth`` /
``prefetch_depth`` / ``prepare_workers`` / ``wire_codec`` settings with
their predicted gain; ``Frame.map_batches(autotune=)`` seeds its unset
knobs from those recommendations, and the live status file republishes
the verdict.

The model reads tpudl's stage terms: ``dispatch`` seconds hold the
host→device transfer and the device compute of a dispatch (tpudl's tunnel
path, where the transfer rides the dispatch), ``dispatch_wait`` (when
present) replaces them by the consumer's unhidden wait, an explicit
``h2d`` stage is a mesh transfer already measured, ``infeed_wait`` is
prepare work the pipeline failed to hide and ``d2h`` the outfeed drain.
The port's executor times its stages otherwise (``obs/pipeline.py``):
``h2d`` is the consumer's enqueue of asynchronous pinned copies (the
wire time itself lands later), ``dispatch`` the enqueue of ``fn``'s
kernels, ``dispatch_wait`` the wait on the oldest batch's device→host
copies (where the card's compute and both copies land), and ``d2h`` the
join of finished host copies. :func:`model_report` maps a port report into
the model's terms: its ``dispatch`` is the port's ``h2d + dispatch +
dispatch_wait`` (every consumer second from a prepared batch to its
finished copies), with no ``dispatch_wait`` and no explicit ``h2d``, so
the model carves the device compute and the modeled wire out of it as it
does tpudl's; ``infeed_wait`` and ``d2h`` carry over. ``analyze()`` with no
report and the executor's autotune read the newest port report through
it; an explicit report dict is taken in the model's terms, as tpudl's is.

The model's inputs on the card:

- ``device_ms_per_dispatch``: the caller's figure, or
  ``TPUDL_DEVICE_MS_PER_STEP`` (times ``fuse_steps``, as in tpudl). Take
  it from the card's busy time under a profile (``obs.profile`` and
  :func:`tpudl_torch.obs.trace.summarize_merged`'s ``device_busy_us``
  over the dispatches), not from CUDA events around a dispatch: events
  span the stream from the first launch to the last, so on a host-bound
  run they also time the card's waits for the host's enqueue
  (``chip_smoke.py`` phase 20 prints both readings);
- the wire rate: ``data/codec.py:probe_wire_mbps`` (a pinned 4 MB
  host→card copy, cached per process), which ``TPUDL_WIRE_MBPS``
  overrides;
- the memory budget: the device cache's budget
  (``data/device_cache.py:budget_bytes``, a fraction of the card's memory
  or ``TPUDL_DATA_HBM_BUDGET_MB``), read without touching the card.

Every ``analyze()`` publishes ``obs.roofline.*`` gauges.
"""

from __future__ import annotations

import math
import os

from tpudl_torch.obs.metrics import _env_float

__all__ = ["RooflineReport", "analyze", "advise", "autotune_seed",
           "model_report", "KNOB_CAPS", "AUTOTUNE_KNOBS"]

# advisor ceilings — the executor's own sane bounds (a recommendation
# past these would trade host RAM / compile time / in-flight device
# buffers for nothing)
KNOB_CAPS = {"fuse_steps": 16, "prefetch_depth": 8, "prepare_workers": 8,
             "dispatch_depth": 8}

# the knobs Frame.map_batches seeds from advise() when left unset
# (TPUDL_FRAME_AUTOTUNE, on by default)
AUTOTUNE_KNOBS = ("fuse_steps", "dispatch_depth", "prefetch_depth")

# a component under this share of the gap is not worth a knob verdict
_MINOR_FRAC = 0.10


# copied from tpudl/obs/roofline.py:RooflineReport
class RooflineReport:
    """One run's decomposition of achieved vs achievable throughput.

    Seconds (over the whole run):

    - ``device_compute_s``   on-chip execution (None when no device
      step time was available — attribution then stops at the dispatch
      stage without splitting it);
    - ``wire_h2d_s``         modeled host→device transfer
      (``bytes_prepared / h2d_MBps``, clamped into the measured
      dispatch window where the transfer rides the dispatch);
    - ``dispatch_overhead_s`` the blocking per-dispatch round-trip
      residue — what multi-step fusion amortizes;
    - ``prepare_unhidden_s`` consumer seconds blocked on the infeed
      (``infeed_wait`` — prepare work prefetch failed to hide);
    - ``d2h_s``              measured outfeed drain;
    - ``collective_s``       model-axis communication on a 2-D mesh
      (the tensor-parallel all-reduce/reduce-scatter share of the
      dispatch window — supplied per dispatch by a profile or the
      measured arm delta; 0 on 1-D grids);
    - ``other_s``            wall minus all of the above (host glue).

    ``gap_attribution`` maps each non-compute component to its fraction
    of the device-vs-e2e gap (``wall - device_compute``); ``bottleneck``
    names the largest. ``advice`` is the knob advisor's ranked
    recommendation list (see :func:`advise`).
    """

    def __init__(self, **kw):
        self.run_id = kw.get("run_id")
        self.rows = kw.get("rows")
        self.wall_s = kw.get("wall_s")
        self.achieved_rows_per_s = kw.get("achieved_rows_per_s")
        self.achievable_rows_per_s = kw.get("achievable_rows_per_s")
        self.device_compute_s = kw.get("device_compute_s")
        self.wire_h2d_s = kw.get("wire_h2d_s")
        self.dispatch_overhead_s = kw.get("dispatch_overhead_s")
        self.prepare_unhidden_s = kw.get("prepare_unhidden_s")
        self.d2h_s = kw.get("d2h_s")
        self.collective_s = kw.get("collective_s")
        self.other_s = kw.get("other_s")
        self.gap_s = kw.get("gap_s")
        self.gap_attribution = kw.get("gap_attribution") or {}
        self.bottleneck = kw.get("bottleneck")
        self.inputs = kw.get("inputs") or {}
        self.advice = kw.get("advice") or []
        self.verdict = kw.get("verdict")

    def dispatch_plus_wire_frac(self) -> float | None:
        """Share of the gap owned by dispatch plus the wire both ways, as
        one number."""
        if not self.gap_attribution:
            return None
        return sum(self.gap_attribution.get(k, 0.0)
                   for k in ("dispatch", "wire_h2d", "d2h"))

    def to_dict(self) -> dict:
        def r(v, nd=4):
            return None if v is None else round(v, nd)

        return {
            "run_id": self.run_id,
            "rows": self.rows,
            "wall_s": r(self.wall_s),
            "achieved_rows_per_s": r(self.achieved_rows_per_s, 2),
            "achievable_rows_per_s": r(self.achievable_rows_per_s, 2),
            "device_compute_s": r(self.device_compute_s),
            "wire_h2d_s": r(self.wire_h2d_s),
            "dispatch_overhead_s": r(self.dispatch_overhead_s),
            "prepare_unhidden_s": r(self.prepare_unhidden_s),
            "d2h_s": r(self.d2h_s),
            "collective_s": r(self.collective_s),
            "other_s": r(self.other_s),
            "gap_s": r(self.gap_s),
            "gap_attribution": {k: r(v) for k, v
                                in self.gap_attribution.items()},
            "bottleneck": self.bottleneck,
            "inputs": self.inputs,
            "advice": self.advice,
            "verdict": self.verdict,
        }


def model_report(report: dict | None) -> dict | None:
    """A port executor's report dict in the model's stage terms (see the
    module docstring): ``dispatch`` = ``h2d + dispatch + dispatch_wait``
    seconds (their calls stay the dispatch count), no ``dispatch_wait``
    and no ``h2d``. Every other key is the report's own. None stays
    None."""
    if not report:
        return report
    stages = dict(report.get("stage_seconds") or {})
    moved = sum(float(stages.pop(k, 0.0))
                for k in ("h2d", "dispatch_wait"))
    if "dispatch" in stages or moved:
        stages["dispatch"] = float(stages.get("dispatch", 0.0)) + moved
    out = dict(report)
    out["stage_seconds"] = stages
    return out


# copied from tpudl/obs/roofline.py:_wire_probe_mbps
def _wire_probe_mbps(allow_probe: bool = True) -> float | None:
    """The process's cached bare-device_put H2D probe (one probe ever,
    ``TPUDL_WIRE_MBPS`` overrides) — tpudl.data owns the probe; the
    model only consumes it. None = unknown (never guessed fast).
    ``allow_probe=False`` reads the env/cache WITHOUT ever issuing a
    device op or initializing CUDA — the status-writer thread's contract
    (a host-only process must stay host-only)."""
    env = os.environ.get("TPUDL_WIRE_MBPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    try:
        from tpudl_torch.data import codec as _codec

        if not allow_probe:
            return _codec._WIRE_MBPS_CACHE.get("mbps")
        return _codec.probe_wire_mbps()
    except Exception:
        return None


def analyze(report: dict | None = None, *,
            h2d_mbps: float | None = None,
            device_ms_per_dispatch: float | None = None,
            bytes_prepared: float | None = None,
            collective_ms_per_dispatch: float | None = None,
            publish: bool = True,
            allow_probe: bool = True) -> RooflineReport | None:
    """Build a :class:`RooflineReport` from one pipeline-report dict.

    ``report`` defaults to ``obs.last_pipeline_report()``. ``h2d_mbps``
    defaults to ``TPUDL_WIRE_MBPS`` / the process's cached wire probe.
    ``device_ms_per_dispatch`` is the on-device time of ONE dispatch
    (a profile's device ms/step × fuse_steps for fused
    programs); when absent (``TPUDL_DEVICE_MS_PER_STEP`` is read as a
    fallback) the dispatch stage is attributed whole, un-split.
    ``bytes_prepared`` overrides the executor's own byte accounting.
    ``collective_ms_per_dispatch`` is the model-axis communication time
    of ONE dispatch (a profile's ICI all-reduce/reduce-scatter total,
    or a measured TP-vs-DP arm delta); it carves a
    ``collective`` component out of the dispatch residue — only
    honored when the report ran on a mesh whose ``model`` axis is >1
    (on a 1-D grid there is no model-axis traffic to attribute).
    Returns None when the report has no dispatches to attribute.
    """
    if report is None:
        from tpudl_torch.obs import pipeline as _pipeline

        report = model_report(_pipeline.last_pipeline_report())
    if not report:
        return None
    stages = report.get("stage_seconds") or {}
    calls = report.get("stage_calls") or {}
    n_disp = int(calls.get("dispatch") or 0)
    rows = report.get("rows_done") or report.get("rows") or 0
    wall = report.get("wall_seconds") or report.get("age_s") or 0.0
    dispatch_s = float(stages.get("dispatch", 0.0))
    if "dispatch_wait" in stages:
        # async dispatch window: the ``dispatch`` stage is pool-summed
        # across the window's threads (it may exceed wall time) and the
        # overlapped part is already HIDDEN — attributing it would
        # mis-charge time the executor paid for once. What the consumer
        # actually paid is the window wait: the unhidden residue.
        dispatch_s = float(stages.get("dispatch_wait", 0.0))
    if n_disp <= 0 or wall <= 0 or rows <= 0:
        return None

    if h2d_mbps is None:
        h2d_mbps = _wire_probe_mbps(allow_probe)
    if device_ms_per_dispatch is None:
        env_ms = _env_float("TPUDL_DEVICE_MS_PER_STEP", 0.0)
        if env_ms > 0:
            fuse = int(report.get("fuse_steps") or 1)
            device_ms_per_dispatch = env_ms * max(1, fuse)
    if bytes_prepared is None:
        bytes_prepared = calls.get("bytes_prepared")

    achieved = rows / wall
    explicit_h2d = float(stages.get("h2d", 0.0))  # mesh path only

    device_s = None
    achievable = None
    if device_ms_per_dispatch is not None and device_ms_per_dispatch > 0:
        device_s = n_disp * device_ms_per_dispatch / 1e3
        if device_s > 0:
            achievable = rows / device_s

    prepare_unhidden = float(stages.get("infeed_wait", 0.0))
    d2h = float(stages.get("d2h", 0.0))
    gap = max(0.0, wall - (device_s or 0.0))

    # wire model: bytes over the measured link. In the model's terms the
    # transfer rides INSIDE dispatch, so the modeled wire time is
    # clamped into the dispatch window that remains after compute — a
    # probe taken during different link weather must not "explain" more
    # of the dispatch stage than the stage measured. Bytes served from
    # the HBM device cache never crossed the link — `bytes_prepared`
    # still counts them (it means "bytes fed to dispatch"), so the wire
    # model subtracts the resident share or a mostly-resident run would
    # report a phantom wire bottleneck.
    bytes_hbm = float(calls.get("bytes_hbm_hit") or 0.0)
    wire_h2d = None
    wire_in_dispatch = 0.0
    wire_bytes = max(0.0, float(bytes_prepared or 0.0) - bytes_hbm)
    if explicit_h2d <= 0 and wire_bytes and h2d_mbps and h2d_mbps > 0:
        modeled = wire_bytes / 2**20 / h2d_mbps
        window = max(0.0, dispatch_s - (device_s or 0.0))
        wire_h2d = wire_in_dispatch = min(modeled, window)

    dispatch_overhead = None
    if device_s is not None:
        dispatch_overhead = max(
            0.0, dispatch_s - device_s - wire_in_dispatch)
    dispatch_comp = (dispatch_overhead if dispatch_overhead is not None
                     else max(0.0, dispatch_s - wire_in_dispatch))

    if explicit_h2d > 0:
        # mesh path: h2d has its OWN measured stage, but it is POOL-
        # SUMMED prepare-worker seconds largely hidden under dispatch
        # (prepare-side stages can exceed wall time) — it
        # may only claim the part of the gap nothing else explains
        wire_h2d = min(explicit_h2d, max(
            0.0, gap - prepare_unhidden - d2h - dispatch_comp))

    # model-axis communication: tensor-parallel collectives
    # execute INSIDE the dispatched program, so their time hides in the
    # dispatch residue — a supplied per-dispatch collective time carves
    # it out as its own component (clamped: a profile from different
    # weather may not "explain" more dispatch time than was measured)
    model_axis = int((report.get("mesh") or {}).get("model") or 1)
    collective_s = 0.0
    if (collective_ms_per_dispatch is not None
            and collective_ms_per_dispatch > 0 and model_axis > 1):
        collective_s = min(n_disp * collective_ms_per_dispatch / 1e3,
                           max(0.0, dispatch_comp))
        dispatch_comp = max(0.0, dispatch_comp - collective_s)

    comps = {
        "prepare": prepare_unhidden,
        "wire_h2d": wire_h2d or 0.0,
        "dispatch": dispatch_comp,
        "d2h": d2h,
        "collective": collective_s,
    }
    other = max(0.0, gap - sum(comps.values()))
    attribution = {}
    if gap > 0:
        # normalized so the fractions can never sum past 1 even when
        # measured consumer-wall components overlap in odd ways
        scale = min(1.0, gap / max(gap, sum(comps.values()) + other))
        attribution = {k: min(1.0, v * scale / gap)
                       for k, v in comps.items()}
        attribution["other"] = min(1.0, other * scale / gap)
    bottleneck = (max(comps, key=comps.get)
                  if any(v > 0 for v in comps.values()) else None)

    rr = RooflineReport(
        run_id=report.get("run_id"), rows=rows, wall_s=wall,
        achieved_rows_per_s=achieved, achievable_rows_per_s=achievable,
        device_compute_s=device_s, wire_h2d_s=wire_h2d,
        dispatch_overhead_s=dispatch_overhead,
        prepare_unhidden_s=prepare_unhidden, d2h_s=d2h,
        collective_s=collective_s or None, other_s=other,
        gap_s=gap, gap_attribution=attribution, bottleneck=bottleneck,
        inputs={
            "h2d_mbps": h2d_mbps,
            "device_ms_per_dispatch": device_ms_per_dispatch,
            "bytes_prepared": bytes_prepared,
            "n_dispatches": n_disp,
            "fuse_steps": report.get("fuse_steps"),
            "dispatch_depth": report.get("dispatch_depth"),
            "prefetch_depth": report.get("prefetch_depth"),
            "prepare_workers": report.get("prepare_workers"),
            "wire_codec": report.get("wire_codec"),
            "batch_size": report.get("batch_size"),
            # mesh topology + the measured sharded-transfer stage
            #: the advisor's dispatch_depth/fuse_steps recs
            # apply unchanged to sharded reports — a mesh multiplies
            # compute, not the per-dispatch round-trip, so on a
            # wire-bound link overlap matters MORE per card
            "mesh": report.get("mesh"),
            "model_axis": model_axis,
            "collective_ms_per_dispatch": collective_ms_per_dispatch,
            "h2d_s": explicit_h2d or None,
            "pad_rows": calls.get("pad_rows"),
            # HBM residency: whether the run already rode
            # the device cache, and how many dispatch-fed bytes never
            # crossed the wire — the advisor's device_cache rec and
            # the wire subtraction above both key on these
            "device_cache": report.get("device_cache"),
            "bytes_hbm_hit": bytes_hbm or None,
            # cold-start attribution: the first dispatch
            # carries trace+compile on a cold process; its excess over
            # the steady-state per-dispatch time is what the AOT
            # program store (COMPILE.md) removes — the `precompile`
            # advisor rec keys on it
            "aot": report.get("aot"),
            "aot_hits": calls.get("aot_hits"),
            "aot_misses": calls.get("aot_misses"),
            "first_dispatch_s": calls.get("first_dispatch_s"),
            "cold_start_s": _cold_start_s(stages, calls, n_disp),
            # serve-session shape: mean slot occupancy and
            # the admission caps the session ran under — the advisor's
            # queue_cap rec keys on rejecting load while slots idled
            "serve": report.get("serve"),
            "serve_queue_cap": report.get("queue_cap"),
            "serve_occupancy": report.get("slot_occupancy_mean"),
            "serve_rejects": _serve_rejects(report),
        })
    rr.advice = advise(rr)
    rr.verdict = _verdict(rr)
    if publish:
        _publish(rr)
    return rr


# copied from tpudl/obs/roofline.py:_next_pow2
def _next_pow2(x: float) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1.0, x))))


# copied from tpudl/obs/roofline.py:_cold_start_s
def _cold_start_s(stages: dict, calls: dict, n_disp: int) -> float | None:
    """The first dispatch's excess over the steady-state per-dispatch
    time — trace + compile on a cold process (the measured cost the
    AOT program store removes). None when the run can't attribute it
    (single dispatch, or no first-dispatch sample)."""
    first = float(calls.get("first_dispatch_s") or 0.0)
    if first <= 0 or n_disp <= 1:
        return None
    total = float(stages.get("dispatch", 0.0))
    steady = max(0.0, total - first) / (n_disp - 1)
    cold = first - steady
    return cold if cold > 0 else None


# copied from tpudl/obs/roofline.py:_serve_rejects
def _serve_rejects(report: dict) -> float | None:
    """Admission rejects for a serve report, from the process registry
    (the queue publishes there, not into the per-run report). None for
    non-serve reports — the key must not imply serve semantics on an
    executor run."""
    if not report.get("serve"):
        return None
    from tpudl_torch.obs import metrics as _m

    v = float(_m.counter("serve.rejects").value)
    return v or None


# copied from tpudl/obs/roofline.py:advise
def advise(rr: RooflineReport) -> list[dict]:
    """Knob recommendations ranked by predicted gain, each
    ``{knob, current, recommended, predicted_gain_pct, saved_s,
    reason}``. The predictions come from the SAME decomposition the
    attribution used — no second model:

    - **dispatch round-trip**, first choice: the D-deep async dispatch
      window overlaps the round-trips themselves — depth d→d' keeps
      d/d' of the overhead visible AND hides the same share of the d2h
      drain (copies start at dispatch), with no recompilation and no
      full-size-batch constraint, which is why it outranks fusion on a
      purely dispatch-bound run;
    - **dispatch round-trip**, second lever: fusion amortizes 1/fuse —
      raising ``fuse_steps`` f→f' keeps f/f' of the overhead (one
      compiled program per f' microbatches; the two compose);
    - **unhidden prepare** halves (conservatively) when the pool
      doubles — prepare is embarrassingly parallel across batches, but
      decode sources may serialize internally;
    - **wire** shrinks with the codec (4× for u8 image pixels, 2× for
      bf16; 'auto' is recommended so a non-u8-able batch still gets the
      safe pick).
    """
    recs = []
    if rr.gap_s is None or rr.gap_s <= 0 or not rr.wall_s:
        return recs
    inp = rr.inputs

    def _rec(knob, current, recommended, saved_s, reason):
        new_wall = max(rr.wall_s - saved_s,
                       rr.device_compute_s or 1e-9)
        gain = rr.wall_s / new_wall - 1.0
        if gain < 0.02:  # sub-2% predictions are model noise
            return
        recs.append({
            "knob": knob, "current": current, "recommended": recommended,
            "saved_s": round(saved_s, 4),
            "predicted_gain_pct": round(100 * gain, 1),
            "reason": reason,
        })

    # 0) cold start → precompile: the first dispatch paid
    #    trace + compile while every later one ran warm. The AOT
    #    program store removes it from every FUTURE process (restored
    #    serialized executables before the first batch lands), so the
    #    rec fires only when the store is not already armed — armed
    #    runs warm themselves up on the next start automatically.
    cold = inp.get("cold_start_s")
    if cold and cold > _MINOR_FRAC * rr.gap_s and not inp.get("aot"):
        _rec("precompile", "off", "on", float(cold),
             f"the first dispatch carried {float(cold):.2f}s of "
             f"trace+compile (cold start); arm TPUDL_COMPILE_AOT=1 so "
             f"a fresh process restores precompiled programs from the "
             f"AOT store before the first batch (COMPILE.md)")
    # 1) dispatch round-trip → dispatch_depth (the async window): depth
    #    d hides all but ~1/d of the blocking round-trip residue, and —
    #    because the D2H copies start at dispatch — the same share of
    #    the outfeed drain rides under later dispatches. Recommended
    #    FIRST: it needs no recompile and no full-size-batch run, so on
    #    a purely dispatch-bound shape it is the cheaper, bigger win.
    if (rr.dispatch_overhead_s is not None
            and rr.dispatch_overhead_s > _MINOR_FRAC * rr.gap_s):
        cur_dd = max(1, int(inp.get("dispatch_depth") or 1))
        target_overhead = max(0.1 * (rr.device_compute_s or 0.0), 1e-3)
        want_dd = cur_dd * rr.dispatch_overhead_s / target_overhead
        new_dd = min(KNOB_CAPS["dispatch_depth"],
                     max(2 * cur_dd, _next_pow2(want_dd)))
        if new_dd > cur_dd:
            hidden = 1.0 - cur_dd / new_dd
            saved = (rr.dispatch_overhead_s + (rr.d2h_s or 0.0)) * hidden
            _rec("dispatch_depth", cur_dd, new_dd, saved,
                 f"dispatch round-trip is "
                 f"{rr.dispatch_overhead_s:.2f}s of the run; a "
                 f"{new_dd}-deep in-flight window overlaps the "
                 f"round-trips (and the d2h drain) leaving "
                 f"~{cur_dd}/{new_dd} visible, with no recompile")
    # 2) dispatch round-trip → fuse_steps (composes with the window)
    if (rr.dispatch_overhead_s is not None
            and rr.dispatch_overhead_s > _MINOR_FRAC * rr.gap_s):
        cur = max(1, int(inp.get("fuse_steps") or 1))
        # pick the fuse depth that pushes the overhead under ~10% of
        # device compute (or the cap); power of two keeps the compiled
        # (m, B, ...) signatures few
        target_overhead = max(0.1 * (rr.device_compute_s or 0.0), 1e-3)
        want = cur * rr.dispatch_overhead_s / target_overhead
        new = min(KNOB_CAPS["fuse_steps"], max(2 * cur, _next_pow2(want)))
        if new > cur:
            saved = rr.dispatch_overhead_s * (1.0 - cur / new)
            _rec("fuse_steps", cur, new, saved,
                 f"dispatch round-trip is "
                 f"{rr.dispatch_overhead_s:.2f}s of the run; one fused "
                 f"program per {new} microbatches keeps ~{cur}/{new} "
                 f"of it")
    # 3) unhidden prepare → prepare_workers (+ depth to feed them)
    if (rr.prepare_unhidden_s is not None
            and rr.prepare_unhidden_s > _MINOR_FRAC * rr.gap_s):
        cur_w = max(1, int(inp.get("prepare_workers") or 1))
        cur_d = max(1, int(inp.get("prefetch_depth") or 1))
        new_w = min(KNOB_CAPS["prepare_workers"], 2 * cur_w)
        new_d = min(KNOB_CAPS["prefetch_depth"], max(cur_d, new_w + 1))
        if new_w > cur_w:
            saved = rr.prepare_unhidden_s * 0.5
            n_before = len(recs)
            _rec("prepare_workers", cur_w, new_w, saved,
                 f"{rr.prepare_unhidden_s:.2f}s of prepare went "
                 f"unhidden (infeed_wait); a {new_w}-worker pool with "
                 f"depth {new_d} hides more of it")
            if len(recs) > n_before and new_d > cur_d:
                recs.append({
                    "knob": "prefetch_depth", "current": cur_d,
                    "recommended": new_d, "saved_s": 0.0,
                    "predicted_gain_pct": 0.0,
                    "reason": "companion to prepare_workers — the queue "
                              "must hold the extra in-flight batches",
                })
    # 4) wire → codec
    codec = str(inp.get("wire_codec") or "off")
    if (rr.wire_h2d_s is not None
            and rr.wire_h2d_s > _MINOR_FRAC * rr.gap_s
            and codec in ("off", "identity")):
        # u8 image pixels ship 4×, bf16 floats 2× — predict with the
        # conservative 2× ('auto' picks the safe codec per column)
        saved = rr.wire_h2d_s * 0.5
        _rec("wire_codec", codec, "auto", saved,
             f"H2D transfer is {rr.wire_h2d_s:.2f}s at "
             f"{inp.get('h2d_mbps')} MB/s; a wire codec ships 2–4× "
             f"fewer bytes (DATA.md)")
    # 5) wire → device cache (HBM residency): a wire-bound
    #    run whose whole dataset fits the resident budget should pin it
    #    — every epoch/repeat run past the first then ships ZERO bytes.
    #    Advisory only (never autotuned: it allocates device memory);
    #    the budget is read env/cache-only — this path must never
    #    initialize CUDA or touch a card (the status-thread contract).
    if (rr.wire_h2d_s is not None
            and rr.wire_h2d_s > _MINOR_FRAC * rr.gap_s
            and not inp.get("device_cache")):
        bp = inp.get("bytes_prepared")
        budget = _hbm_budget_bytes()
        if bp and budget and float(bp) <= budget:
            # warm passes pay no wire at all; the first pass already
            # happened, so the whole modeled wire time is the saving
            # on every repeat
            _rec("device_cache", "off", "on", rr.wire_h2d_s,
                 f"H2D transfer is {rr.wire_h2d_s:.2f}s and the "
                 f"dataset ({bp / 2**20:.0f} MB prepared) fits the "
                 f"{budget / 2**20:.0f} MB HBM budget; device-resident "
                 f"batches make every later epoch ship zero wire "
                 f"bytes (DATA.md 'Cache hierarchy')")
    # 6) model-axis collectives: a 2-D run whose dispatch
    #    window is mostly TP communication is over-sharded for its
    #    per-device compute — a narrower model axis (if the params
    #    still fit) trades collective hops back for arithmetic.
    #    Advisory only (never autotuned: resizing the grid re-places
    #    every parameter shard).
    if (rr.collective_s is not None
            and rr.collective_s > _MINOR_FRAC * rr.gap_s):
        cur_tp = max(1, int(inp.get("model_axis") or 1))
        if cur_tp > 1:
            new_tp = cur_tp // 2
            # halving the axis roughly halves the per-layer all-reduce
            # payload each device sends (ring cost ∝ (tp-1)/tp)
            saved = rr.collective_s * 0.5
            _rec("model_axis", cur_tp, new_tp, saved,
                 f"model-axis collectives are {rr.collective_s:.2f}s "
                 f"of the run; if the params fit {new_tp}-way "
                 f"(TPUDL_MESH_MODEL={new_tp}), a narrower grid trades "
                 f"ICI hops back for local compute")
    # 7) serve admission: the session REJECTED load while
    #    decode slots sat idle — admission, not capacity, was the
    #    limit. Advisory only (capacity knobs change admission
    #    semantics, never autotuned); conservative saving: perfect
    #    packing serves the same tokens in ~occ of the wall, claim
    #    half of that.
    if inp.get("serve") and (inp.get("serve_rejects") or 0) > 0:
        occ = inp.get("serve_occupancy")
        if occ is not None and float(occ) < 0.5:
            cur_cap = int(inp.get("serve_queue_cap") or 0)
            saved = rr.wall_s * (1.0 - float(occ)) * 0.5
            _rec("queue_cap", cur_cap or "default",
                 (2 * cur_cap) if cur_cap else "raise",
                 saved,
                 f"{inp['serve_rejects']:.0f} request(s) were rejected "
                 f"while mean slot occupancy was {float(occ):.0%} — "
                 f"the queue turned work away from idle slots; raise "
                 f"TPUDL_SERVE_QUEUE_CAP (and/or TPUDL_SERVE_SLOTS) "
                 f"so admission matches decode capacity (SERVE.md)")
    recs.sort(key=lambda r: -r["predicted_gain_pct"])
    return recs


# copied from tpudl/obs/roofline.py:_hbm_budget_bytes
def _hbm_budget_bytes() -> int | None:
    """The device-cache budget WITHOUT device access (env override or
    the process's already-derived figure) — None when unknown, which
    suppresses the device_cache recommendation rather than guessing."""
    try:
        from tpudl_torch.data import device_cache as _dc

        return _dc.budget_bytes(allow_device=False)
    except Exception:
        return None


# copied from tpudl/obs/roofline.py:_verdict
def _verdict(rr: RooflineReport) -> str:
    """One operator-readable line: what binds the run and what to do."""
    if rr.gap_s is None or rr.wall_s is None:
        return "unknown: not enough measurements"
    if rr.device_compute_s is not None and rr.gap_s < 0.2 * rr.wall_s:
        return (f"device-bound: {rr.achieved_rows_per_s:.0f} rows/s is "
                f"within 20% of the chip's "
                f"{rr.achievable_rows_per_s:.0f} rows/s ceiling")
    name = {"dispatch": "dispatch-bound", "wire_h2d": "wire-bound",
            "prepare": "prepare-bound", "d2h": "outfeed-bound",
            "collective": "collective-bound"}.get(
                rr.bottleneck, "host-bound")
    if rr.advice:
        top = rr.advice[0]
        return (f"{name}: set {top['knob']} "
                f"{top['current']}→{top['recommended']} "
                f"(predicted +{top['predicted_gain_pct']:.0f}%)")
    return f"{name}: no actionable knob (see gap_attribution)"


# copied from tpudl/obs/roofline.py:_publish
def _publish(rr: RooflineReport) -> None:
    """``obs.roofline.*`` gauges — the model's trajectory in the same
    registry/sink every other layer publishes to."""
    from tpudl_torch.obs import metrics as _m

    if rr.achieved_rows_per_s is not None:
        _m.gauge("obs.roofline.achieved_rows_per_s").set(
            rr.achieved_rows_per_s)
    if rr.achievable_rows_per_s is not None:
        _m.gauge("obs.roofline.achievable_rows_per_s").set(
            rr.achievable_rows_per_s)
    for comp, frac in (rr.gap_attribution or {}).items():
        _m.gauge(f"obs.roofline.gap_frac.{comp}").set(frac)
    if rr.collective_s:
        # model-axis comm seconds — absolute, beside the
        # normalized gap_frac.collective fraction above
        _m.gauge("obs.roofline.collective_s").set(rr.collective_s)
    if rr.advice:
        _m.gauge("obs.roofline.predicted_gain_pct").set(
            rr.advice[0]["predicted_gain_pct"])


def autotune_seed(report: dict | None = None, *,
                  allow_probe: bool = False,
                  match: dict | None = None) -> dict:
    """The async executor's knob seed: ``{knob: value}`` for the
    :data:`AUTOTUNE_KNOBS` the advisor recommends over the PREVIOUS
    run's report (default: ``obs.last_pipeline_report()``) — how
    ``TPUDL_FRAME_AUTOTUNE`` closes the loop without
    hand-set env knobs. Values are the advisor's own ``recommended``
    numbers, clamped into :data:`KNOB_CAPS`; an empty dict (no prior
    report, nothing attributable, no confident advice, or a
    ``match`` miss) leaves the executor on its defaults.

    ``match`` is the workload guard: ``{report_key: value}`` pairs the
    prior report must carry verbatim, or nothing seeds. The executor
    passes its own ``batch_size`` — the advisor's numbers are
    per-dispatch quantities at THAT batch geometry, and a process that
    alternates workloads (a big featurizer, then a tiny scorer) must
    not tune each run for the other's report.

    ``allow_probe`` defaults to False here — seeding happens on the
    executor's hot setup path and must never issue a device op (the
    cached probe / ``TPUDL_WIRE_MBPS`` is consumed when known)."""
    if report is None:
        from tpudl_torch.obs import pipeline as _pipeline

        report = model_report(_pipeline.last_pipeline_report())
    if not report:
        return {}
    for key, want in (match or {}).items():
        if report.get(key) != want:
            return {}
    rr = analyze(report, publish=False, allow_probe=allow_probe)
    if rr is None:
        return {}
    seeds: dict = {}
    for rec in rr.advice:
        knob = rec.get("knob")
        val = rec.get("recommended")
        if knob in AUTOTUNE_KNOBS and knob not in seeds \
                and isinstance(val, (int, float)):
            cap = KNOB_CAPS.get(knob)
            seeds[knob] = max(1, min(int(val), cap) if cap else int(val))
    return seeds
