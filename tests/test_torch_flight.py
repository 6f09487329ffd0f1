"""The flight recorder (``tpudl_torch.obs.flight``) against tpudl's.

- a dump is in tpudl's schema and version, passes tpudl's
  ``tools/validate_dump.py``, names torch where tpudl names jax, carries
  the tracer's tail, the live heartbeats and the attribution ledger, and
  lands under tpudl's file names;
- batch descriptors carry tpudl's fingerprint, and ``map_batches`` files
  one a prepared batch (shapes and dtypes, never the data);
- the rings keep their bounds, and a gang restart files its cause and
  step;
- tpudl's own ``obs doctor`` reads the port's preempted dump as
  ``preempted_resumable`` and its ladder-exhaustion dump as
  ``degraded_run``;
- ``install`` chains the excepthook and SIGTERM after their earlier
  handlers, and ``TPUDL_FAULTHANDLER=1`` opens the fault log (in child
  processes)."""

import gzip
import importlib.util
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from tpudl.obs import doctor as jdoctor
from tpudl.obs import flight as jflight

from tpudl_torch.frame import Frame
from tpudl_torch.obs import tracer as obs_tracer
from tpudl_torch.obs import watchdog as obs_watchdog
from tpudl_torch.obs import flight
from tpudl_torch.testing import faults

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUDL_FLIGHT_DIR", str(tmp_path))
    faults.disarm()
    flight.get_recorder().reset()
    yield tmp_path
    faults.disarm()
    flight.get_recorder().reset()


def _validator():
    sys.path.insert(0, str(REPO / "tools"))     # validate_metrics beside it
    try:
        spec = importlib.util.spec_from_file_location(
            "validate_dump", REPO / "tools" / "validate_dump.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(str(REPO / "tools"))


def _load(path):
    with gzip.open(path, "rt", encoding="utf-8") as f:
        return json.load(f)


def test_a_dump_is_in_tpudls_schema_and_passes_its_validator(clean):
    rec = flight.get_recorder()
    rec.record_batch("prepare", 0, [np.zeros((4, 3), np.float32)], rows=4)
    rec.record_error("data.cache.corrupt", ValueError("crc"), index=2,
                     key=object())
    rec.record_restart(1, RuntimeError("rank died"), step=5,
                       max_restarts=2)
    rec.record_request({"ts": 1.0, "trace_id": "t", "model": "m",
                        "prompt_len": 3, "max_new": 4, "outcome": "ok",
                        "latency_ms": 1.5, "segments": {"queue_ms": 0.5}})
    rec.record_event("job.start", name="x")
    rec.record_metrics_tick()
    with obs_tracer.span("test.flight.span", k=1):
        pass
    with obs_watchdog.heartbeat("test.flight.beat", rows=4) as hb:
        hb.beat(stage="prepare")
        path = flight.dump(reason="manual", error=RuntimeError("why"))
    assert path == os.path.join(str(clean),
                                f"tpudl-dump-{os.getpid()}.json.gz")
    assert _validator().validate_dump(path) == []
    payload = _load(path)
    assert (payload["schema"], payload["version"]) == (
        jflight.DUMP_SCHEMA, jflight.DUMP_VERSION)
    assert sorted(payload) == sorted(jflight.FlightRecorder().snapshot())
    assert payload["backend"]["torch_loaded"] is True
    assert payload["backend"]["version"] == torch.__version__
    assert payload["backend"]["backend"] == "cpu"
    assert payload["process_index"] == 0 and payload["process_count"] == 1
    assert payload["error"]["type"] == "RuntimeError"
    assert payload["errors"][0]["key"].startswith("<object")
    assert [e["kind"] for e in payload["errors"]] == [
        "data.cache.corrupt", "train.restart"]
    assert payload["restarts"][0]["step"] == 5
    # the tracer's tail, the live heartbeats and the attribution ledger
    # with its verdict, as tpudl's dump carries them
    assert payload["spans"][-1]["name"] == "test.flight.span"
    assert payload["spans"][-1]["attrs"] == {"k": 1}
    beat = payload["heartbeats"]["test.flight.beat"]
    assert beat["info"] == {"rows": 4, "stage": "prepare"}
    assert beat["beats"] == 1
    assert {"scopes", "unattributed", "reconcile"} <= set(payload["ledger"])
    assert rec.dumped_paths == [path]


@pytest.mark.parametrize("arrays", [
    [np.arange(600, dtype=np.float32).reshape(20, 30)],
    [np.arange(600, dtype=np.float32).reshape(20, 30).T,
     np.arange(10, dtype=np.int32)],
    [np.array([b"a", None], dtype=object)],
])
def test_batch_fingerprint_equals_tpudls(arrays):
    assert flight.batch_fingerprint(arrays) == \
        jflight.batch_fingerprint(arrays)


def test_dump_paths_are_tpudls(clean):
    assert flight.dump_path_for(0, 1) == jflight.dump_path_for(0, 1)
    assert flight.dump_path_for(2, 4) == jflight.dump_path_for(2, 4)
    assert os.path.basename(flight.dump_path_for(2, 4)) == \
        f"tpudl-dump-host2-{os.getpid()}.json.gz"


def test_map_batches_files_one_descriptor_a_prepared_batch():
    x = {"x": np.arange(30, dtype=np.float32).reshape(10, 3)}
    Frame(x).map_batches(lambda t: t + 1, ["x"], ["y"], device="cpu",
                         batch_size=4)
    batches = flight.get_recorder().snapshot()["batches"]
    assert sorted(b["index"] for b in batches) == [0, 1, 2]
    by = {b["index"]: b for b in batches}
    assert by[2]["shapes"] == [[2, 3]] and by[2]["rows"] == 2
    assert by[0]["dtypes"] == ["float32"] and by[0]["hbm_hit"] is False
    assert by[0]["fingerprint"] == jflight.batch_fingerprint(
        [x["x"][:4]])


def test_the_rings_keep_their_bounds(monkeypatch):
    monkeypatch.setenv("TPUDL_FLIGHT_ERRORS", "3")
    monkeypatch.setenv("TPUDL_FLIGHT_BATCHES", "2")
    rec = flight.FlightRecorder()
    for i in range(10):
        rec.record_error("k", f"e{i}")
        rec.record_batch("prepare", i, [np.zeros(2)])
    for i in range(70):
        rec.record_restart(i, RuntimeError("x"))
    snap = rec.snapshot()
    assert [e["message"] for e in snap["errors"]] == [
        "x", "x", "x"]      # the restarts' own error entries came last
    assert [b["index"] for b in snap["batches"]] == [8, 9]
    assert len(snap["restarts"]) == 64


def test_a_gang_restart_files_its_cause_and_step(tmp_path):
    from tpudl_torch.train import HorovodRunner

    calls = []

    def train_fn(ctx):
        calls.append(ctx.attempt)
        if ctx.attempt == 0:
            raise RuntimeError("rank lost")
        return "ok"

    runner = HorovodRunner(np=1, max_restarts=1, device="cpu")
    runner.retry_policy._sleep = lambda s: None
    assert runner.run(train_fn) == "ok" and calls == [0, 1]
    snap = flight.get_recorder().snapshot()
    assert [(r["attempt"], r["error_type"]) for r in snap["restarts"]] == [
        (1, "RuntimeError")]
    kinds = [e["kind"] for e in snap["errors"]]
    assert "train.restart" in kinds and "retry.train.restart" in kinds


# -- tpudl's doctor reads the port's dumps -----------------------------------

def test_the_doctor_reads_a_preempted_job_as_preempted_resumable(tmp_path):
    from tpudl_torch.jobs import JobPreempted, JobRuntime, JobSpec

    spec = JobSpec("custom", str(tmp_path / "job"))

    def payload(ctx):
        ctx.update_cursor(step=3)
        ctx.request_stop()
        raise ctx._rt._preempted()

    with pytest.raises(JobPreempted):
        JobRuntime(spec, install_signals=False).run(payload)
    _, diag = jdoctor.diagnose(spec.workdir)
    assert diag["classification"] == "preempted_resumable"
    assert diag["resume_manifest"] == os.path.join(spec.workdir,
                                                   "job-manifest.json")
    assert '"step": 3' in " ".join(diag["evidence"])


def test_the_doctor_reads_an_exhausted_ladder_as_degraded_run(clean):
    from tpudl_torch.frame import supervisor as sup

    x = {"x": np.arange(16, dtype=np.float32).reshape(8, 2)}
    plan = faults.FaultPlan([{"point": "frame.dispatch", "action": "raise"}])
    with plan.armed(), pytest.raises(sup.StageFault):
        Frame(x).map_batches(lambda t: t, ["x"], ["y"], device="cpu",
                             batch_size=4, supervise=True)
    [dump] = flight.get_recorder().dumped_paths
    assert _load(dump)["reason"] == "degraded_exhausted"
    assert _validator().validate_dump(dump) == []
    _, diag = jdoctor.diagnose(dump)
    assert diag["classification"] == "degraded_run"
    assert diag["suspect_stage"] == "dispatch"


# -- install: the excepthook, SIGTERM and the fault log ------------------------

_CHILD = """
import os, signal, sys
sys.path.insert(0, {repo!r})
from tpudl_torch.obs import flight
def earlier(signum, frame):
    print("EARLIER", signum, flush=True)
    sys.exit(7)
signal.signal(signal.SIGTERM, earlier)
flight.install(dump_dir={dump_dir!r})
if {mode!r} == "raise":
    raise ValueError("unhandled")
os.kill(os.getpid(), signal.SIGTERM)
"""


@pytest.mark.parametrize("mode", ["raise", "sigterm"])
def test_install_chains_the_earlier_handlers(tmp_path, mode):
    env = dict(os.environ, TPUDL_FAULTHANDLER="1")
    r = subprocess.run(
        [sys.executable, "-c", _CHILD.format(repo=str(REPO),
                                             dump_dir=str(tmp_path),
                                             mode=mode)],
        capture_output=True, text=True, env=env, timeout=60)
    dumps = list(tmp_path.glob("tpudl-dump-*.json.gz"))
    assert len(dumps) == 1
    payload = _load(dumps[0])
    assert list(tmp_path.glob("tpudl-fault-*.log"))
    assert any(e["kind"] == "faulthandler" for e in payload["events"])
    if mode == "raise":
        assert r.returncode == 1
        assert "ValueError: unhandled" in r.stderr    # the earlier hook ran
        assert payload["reason"] == "exception"
        assert payload["error"]["type"] == "ValueError"
    else:
        assert r.returncode == 7 and "EARLIER 15" in r.stdout
        assert payload["reason"] == f"signal:{int(signal.SIGTERM)}"
