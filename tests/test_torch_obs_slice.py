"""The observability slice end to end on the CPU, at 2 layers and dim 32.

An ``LMFeaturizer`` run with everything armed (``obs.profile``, the
tracer, the watchdog daemon, a status directory, ``obs.scope(tenant=)``)
gives features bit for bit those of the same run with nothing armed, and
within 2e-5 of tpudl's stage on the same weights. Its timeline carries
the executor's stage spans; the status file names the tenant; the
ledger reconciles; a dump taken under a live heartbeat, after a watchdog
stall, a decode error, a served request and a gang restart, passes
tpudl's ``tools/validate_dump.py`` with every section filled."""

import gzip
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl.frame import Frame as JaxFrame
from tpudl.obs import live as jlive
from tpudl.ml import LMFeaturizer as JaxFeaturizer
from tpudl.text import ByteTokenizer as JaxByteTokenizer
from tpudl.zoo.transformer import TinyCausalLM as JaxLM

from tpudl_torch import obs
from tpudl_torch.frame import Frame
from tpudl_torch.ml import LMFeaturizer
from tpudl_torch.obs import flight, live, trace, watchdog
from tpudl_torch.text import ByteTokenizer
from tpudl_torch.zoo.transformer import TinyCausalLM

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ARCH = dict(vocab=260, dim=32, heads=4, layers=2, max_len=64)
TEXTS = np.array([f"row {i} " + "text " * (i % 5) for i in range(11)],
                 dtype=object)


def _validator():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        spec = importlib.util.spec_from_file_location(
            "validate_dump", REPO / "tools" / "validate_dump.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(str(REPO / "tools"))


def _reconciled(rec) -> bool:
    """Every reconciliation pair but ``hbm_bytes``, which mirrors ONE
    gauge that each new ``DeviceBatchCache`` (other test files build
    private ones on this worker) resets."""
    return all(c["ok"] for c in rec["checks"] if c["field"] != "hbm_bytes")


def _featurize(spec, params):
    out = LMFeaturizer(inputCol="text", outputCol="vec", model=spec,
                       weights=params, tokenizer=ByteTokenizer(),
                       batchSize=4, device="cpu").transform(
                           Frame({"text": TEXTS}))
    return np.stack(list(out["vec"]))


@pytest.fixture
def armed(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDL_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("TPUDL_STATUS_DIR", str(tmp_path / "status"))
    monkeypatch.setenv("TPUDL_STATUS_INTERVAL_S", "0.05")
    watchdog.stop_watchdog()
    live.stop_status_writer()
    jlive.stop_status_writer()
    yield tmp_path
    watchdog.stop_watchdog()
    live.stop_status_writer()


def test_instrumented_featurizer_is_bitwise_and_leaves_a_full_dump(armed):
    spec = TinyCausalLM(device="meta", **ARCH)
    params = spec.init(0)
    plain = _featurize(spec, params)

    watchdog.start_watchdog(stall_s=0.2, interval=0.05)
    flight.get_recorder().reset()
    tenant = f"slice-{os.getpid()}"
    with obs.scope(tenant=tenant):
        with trace.profile(str(armed / "trace")):
            with obs.span("test.slice.featurize", rows=len(TEXTS)):
                got = _featurize(spec, params)
    assert np.array_equal(got, plain)
    # tpudl's stage without the status directory: its own writer would
    # write the same tpudl-status-<pid>.json (one pid, one file name)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("TPUDL_STATUS_DIR")
        want = JaxFeaturizer(
            inputCol="text", outputCol="vec", model=JaxLM(**ARCH),
            weights=jax.tree.map(jnp.asarray, params),
            tokenizer=JaxByteTokenizer(), batchSize=4).transform(
                JaxFrame({"text": TEXTS}))
    np.testing.assert_allclose(got, np.stack(list(want["vec"])),
                               rtol=2e-5, atol=2e-5)

    # the timeline: the executor's stages inside the featurize span
    host = obs.export_chrome_trace(str(armed / "trace" /
                                       "run.host.trace.json"),
                                   window="profile")
    merged = trace.summarize_merged(trace.load_host_trace_events(host),
                                    trace.load_trace_events(
                                        str(armed / "trace")))
    for stage in ("frame.prepare", "frame.dispatch", "frame.d2h",
                  "ml.LMFeaturizer.transform", "test.slice.featurize"):
        assert merged["host_stage_calls"].get(stage, 0) >= 1, stage
    assert merged["host_stage_calls"]["frame.dispatch"] == 3
    # the ledger: this tenant's rows, reconciled
    row = obs.ledger_snapshot()["scopes"][f"tenant={tenant}"]
    assert row["rows_in"] == row["rows_out"] == len(TEXTS)
    assert _reconciled(obs.reconcile())
    # the heartbeat armed the status writer; a frame names the tenant
    path = live.status_path(str(armed / "status"))
    deadline = time.time() + 10
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.05)
    assert os.path.exists(path)
    assert live.write_status() == path
    assert f"tenant={tenant}" in json.loads(
        Path(path).read_text())["ledger"]["scopes"]

    # the rest of the evidence a dump carries
    def slow_pack(col):
        time.sleep(0.6)
        return np.asarray(col, dtype=np.float32)[:, None]

    Frame({"x": np.arange(4)}).map_batches(
        lambda t: t, ["x"], ["y"], device="cpu", batch_size=4,
        pack=slow_pack, autotune=False)
    from tpudl_torch.image import imageIO

    assert imageIO._decode_row(lambda raw: None, "bad.jpg", b"x") is None
    flight.record_request({"ts": time.time(), "trace_id": "t1",
                           "model": "m", "prompt_len": 3, "max_new": 2,
                           "outcome": "ok", "latency_ms": 1.0,
                           "segments": {"queue_wait_ms": 0.5}})
    flight.get_recorder().record_restart(1, RuntimeError("rank died"),
                                         step=2, max_restarts=2)
    flight.get_recorder().record_event("test.slice.done", rows=len(TEXTS))
    with watchdog.heartbeat("test.slice.dump", rows=len(TEXTS)) as hb:
        hb.beat(stage="d2h")
        dump = flight.dump(reason="manual")
    assert _validator().validate_dump(dump) == []
    with gzip.open(dump, "rt") as f:
        payload = json.load(f)
    for section in ("batches", "errors", "stalls", "metric_ticks",
                    "requests", "restarts", "events", "metrics",
                    "pipeline_reports", "spans", "heartbeats"):
        assert payload[section], section
    assert _reconciled(payload["ledger"]["reconcile"])
    assert any(s["name"] == "frame.map_batches" for s in payload["stalls"])
    assert any(e["kind"] == "imageio.decode_error"
               for e in payload["errors"])
