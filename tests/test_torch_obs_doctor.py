"""``obs doctor`` (``tpudl_torch.obs.doctor``) against tpudl's.

Each failure scenario of tpudl's own doctor tests (a frozen input stage,
a frozen dispatch, a decode-error storm, a degraded run, a preempted
job, an overload, an SLO burn, an unhandled exception, an external kill)
is written once by tpudl's flight recorder and once by the port's; both
doctors classify both dumps alike, and as the scenario says. The one rule
that reads other evidence, ``recompile_storm``, takes the port's storm
(``compile.storms``, the ``compile.storm`` ring entries) as well as
tpudl's ``traceck`` one. A real stall, caught by the port's watchdog in
a ``map_batches`` run, dumps as ``infeed_stall`` for both doctors, and
the CLI keeps tpudl's exit codes."""

import gzip
import json
import time

import numpy as np
import pytest

from tpudl.obs import doctor as jdoctor
from tpudl.obs import flight as jflight

from tpudl_torch.frame import Frame
from tpudl_torch.obs import __main__ as cli
from tpudl_torch.obs import doctor as tdoctor
from tpudl_torch.obs import flight as tflight
from tpudl_torch.obs import watchdog as twatchdog

FLIGHTS = {"tpudl": jflight, "port": tflight}
DOCTORS = {"tpudl": jdoctor, "port": tdoctor}


def _c(v):
    return {"type": "counter", "value": float(v)}


def _g(v):
    return {"type": "gauge", "value": float(v), "count": 1, "max": v,
            "mean": v}


def _stall(stage):
    return {"ts": time.time(), "name": "frame.map_batches",
            "info": {"stage": stage}, "beats": 3, "age_s": 5.0,
            "stall_s": 1.0, "in_flight": {stage: {"count": 1,
                                                  "age_s": 5.0}},
            "active": ["frame.map_batches"], "stacks": {"1:MainThread": []}}


def _scenario(name, rec):
    """``(reason, error, metrics)`` after filing the scenario's evidence
    in ``rec`` (a fresh recorder of either package)."""
    if name == "infeed_stall":
        rec.record_stall(_stall("prepare"))
        return "manual", None, {"obs.watchdog.stalls": _c(1)}
    if name == "dispatch_slowdown":
        rec.record_stall(_stall("dispatch"))
        return "manual", None, {"obs.watchdog.stalls": _c(1)}
    if name == "decode_error_storm":
        for i in range(5):
            rec.record_error("imageio.decode_error", ValueError("bad"),
                             origin=f"f{i}.jpg")
        return "manual", None, {"imageio.decode_errors": _c(20),
                                "imageio.files_read": _c(40)}
    if name == "degraded_run":
        for rung in ("dispatch_depth=2", "serial"):
            rec.record_error("frame.degraded", RuntimeError("fault"),
                             rung=rung, stage="dispatch")
        rec.record_error("frame.degraded.exhausted", RuntimeError("fault"),
                         fault_kind="stage", stage="dispatch")
        return "degraded_exhausted", RuntimeError("fault"), {
            "frame.degraded.rungs": _c(2),
            "frame.degraded.exhausted": _c(1)}
    if name == "preempted_resumable":
        rec.record_event("job.preempted", manifest="/w/job-manifest.json",
                         cursor={"step": 8})
        rec.record_stall(_stall("prepare"))     # history only
        return "preempted_resumable", None, {}
    if name == "overload_shed":
        return "manual", None, {"serve.rejects": _c(20),
                                "serve.requests": _c(40),
                                "serve.queue_depth": _g(8),
                                "serve.queue_cap": _g(8)}
    if name == "slo_burn":
        for i in range(4):
            rec.record_error("serve.slo.exemplar", "tail", latency_ms=900.0,
                             queue_wait_ms=800.0, decode_ms=100.0,
                             dominant_segment="queue_wait")
        return "manual", None, {"serve.slo.burn_short": _g(5.0),
                                "serve.requests": _c(40)}
    if name == "exception":
        return "exception", KeyError("missing"), {}
    if name == "clean_external_kill":
        return "signal:SIGTERM", None, {}
    raise AssertionError(name)


def _write(flight_mod, name, path):
    rec = flight_mod.FlightRecorder()
    reason, error, metrics = _scenario(name, rec)
    payload = rec.snapshot(reason=reason, error=error)
    # the scenario's counters only: a test process's own registry carries
    # whatever earlier tests left there
    payload["metrics"] = metrics
    payload["pipeline_reports"] = {}
    payload["heartbeats"] = {}
    with gzip.open(path, "wt") as f:
        json.dump(payload, f, default=str)
    return path


SCENARIOS = ["infeed_stall", "dispatch_slowdown", "decode_error_storm",
             "degraded_run", "preempted_resumable", "overload_shed",
             "slo_burn", "exception", "clean_external_kill"]


@pytest.mark.parametrize("writer", sorted(FLIGHTS))
@pytest.mark.parametrize("name", SCENARIOS)
def test_both_doctors_classify_both_dumps_alike(tmp_path, name, writer):
    path = _write(FLIGHTS[writer], name,
                  str(tmp_path / "tpudl-dump-1.json.gz"))
    got = {side: doc.diagnose(path)[1] for side, doc in DOCTORS.items()}
    assert got["port"]["classification"] == name
    assert got["tpudl"]["classification"] == name
    assert got["port"]["suspect_stage"] == got["tpudl"]["suspect_stage"]
    assert got["port"]["evidence"] == got["tpudl"]["evidence"]


@pytest.mark.parametrize("evidence", ["compile.storms", "compile.storm ring",
                                      "traceck.storms"])
def test_recompile_storm_reads_the_ports_evidence(tmp_path, evidence):
    rec = tflight.FlightRecorder()
    metrics = {"frame.degraded.rungs": _c(1)}
    if evidence == "compile.storms":
        metrics["compile.storms"] = _c(1)
    elif evidence == "compile.storm ring":
        rec.record_error("compile.storm", RuntimeError("fault"),
                         stage="dispatch", misses=3)
    else:
        metrics["traceck.storms"] = _c(2)
    payload = rec.snapshot(reason="degraded_exhausted")
    payload.update(metrics=metrics, pipeline_reports={}, heartbeats={})
    path = tmp_path / "tpudl-dump-1.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(payload, f)
    merged, diag = tdoctor.diagnose(str(path))
    assert diag["classification"] == "recompile_storm"
    assert diag["suspect_stage"] == "dispatch"
    if evidence == "traceck.storms":      # tpudl's own evidence: alike
        assert jdoctor.diagnose(str(path))[1]["classification"] == \
            "recompile_storm"
    assert "recompile_storm" in tdoctor.format_report(merged, diag)


def test_a_real_stall_dumps_as_infeed_stall(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDL_FLIGHT_DIR", str(tmp_path))
    monkeypatch.delenv("TPUDL_STATUS_DIR", raising=False)
    twatchdog.stop_watchdog()
    twatchdog.start_watchdog(stall_s=0.2, interval=0.05)
    tflight.get_recorder().reset()

    def pack(col):
        if int(col[0]) == 8:
            time.sleep(0.8)         # batch 1 freezes inside prepare
        return np.asarray(col, dtype=np.float32)[:, None]

    try:
        Frame({"x": np.arange(24)}).map_batches(
            lambda t: t + 1, ["x"], ["y"], device="cpu", batch_size=8,
            pack=pack, prefetch_depth=1, prepare_workers=1,
            dispatch_depth=1, autotune=False)
    finally:
        twatchdog.stop_watchdog()
    stalls = tflight.get_recorder().snapshot()["stalls"]
    assert [s["name"] for s in stalls] == ["frame.map_batches"]
    path = tflight.dump(reason="manual")
    for side, doc in DOCTORS.items():
        diag = doc.diagnose(path)[1]
        assert diag["classification"] == "infeed_stall", side
    assert cli.main(["doctor", str(tmp_path)]) == 0


def test_cli_exit_codes_are_tpudls(tmp_path):
    assert cli.main(["doctor", str(tmp_path)]) == 2
    assert cli.main(["ledger", str(tmp_path)]) == 2
    assert cli.main(["top", str(tmp_path), "--once"]) == 2
    from tpudl_torch.obs import attribution as attr

    rec = tflight.FlightRecorder()
    payload = rec.snapshot(reason="manual")
    zero = {f: 0.0 for f in attr.LEDGER_FIELDS}
    payload.update(metrics={"serve.completed": _c(2)}, pipeline_reports={},
                   heartbeats={}, stalls=[], errors=[],
                   ledger={"scopes": {"tenant=a": dict(
                       zero, serve_completed=2.0)},
                       "unattributed": zero, "evicted": 0, "cap": 64})
    path = tmp_path / "tpudl-dump-7.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(payload, f)
    assert cli.main(["doctor", str(tmp_path)]) == 1      # unclassified
    assert cli.main(["ledger", str(tmp_path)]) == 0      # reconciled
    payload["metrics"]["serve.completed"] = _c(3)
    with gzip.open(path, "wt") as f:
        json.dump(payload, f)
    assert cli.main(["ledger", str(tmp_path)]) == 1      # mismatch
