"""The live status plane (``tpudl_torch.obs.live``) against tpudl's.

A port process's status file (after an executor run, a serve drain with
two tenants and a device-cache run) is in tpudl's schema: tpudl's
``tools/validate_status.py`` accepts it, and tpudl's ``render`` gives the
same ``obs top`` text on it as the port's. The ``compile`` line reads the
program store's counters, the ``serve`` line the SLO engine, the
``tenants`` block the attribution ledger; ``top --once`` returns 2 on an
empty directory."""

import importlib.util
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from tpudl.obs import live as jlive

from tpudl_torch.data import device_cache as dc
from tpudl_torch.frame import Frame
from tpudl_torch.obs import attribution as attr
from tpudl_torch.obs import live as tlive
from tpudl_torch.obs import metrics

REPO = Path(__file__).resolve().parents[1]


def _validator():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        spec = importlib.util.spec_from_file_location(
            "validate_status", REPO / "tools" / "validate_status.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(str(REPO / "tools"))


@pytest.fixture
def status_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("TPUDL_STATUS_DIR", raising=False)
    return tmp_path


def _serve_two_tenants():
    from tpudl_torch.serve import (ModelRegistry, RequestQueue, Server,
                                   run_closed_loop)
    from tpudl_torch.zoo.transformer import TinyCausalLM

    spec = TinyCausalLM(vocab=64, dim=32, heads=2, layers=2, max_len=64,
                        device="meta")
    reg = ModelRegistry()
    reg.add_model("default", spec, spec.init(0), slots=2, cache_len=32,
                  warm=False, device="cpu")
    srv = Server(reg, RequestQueue(cap=8)).start_async()
    try:
        run_closed_loop(srv, lambda i: np.arange(1, 3 + i % 3,
                                                 dtype=np.int32),
                        requests=6, clients=2, max_new=2, timeout=60,
                        tenant=("live-a", "live-b"))
    finally:
        srv.close(timeout=60)


def test_status_file_is_tpudls_schema_and_renders_alike(status_dir):
    x = {"x": np.arange(40 * 3, dtype=np.float32).reshape(40, 3)}
    dc.reset_device_cache()
    with attr.scope(tenant="live-frame"):
        Frame(x).map_batches(lambda t: t + 1, ["x"], ["y"], device="cpu",
                             batch_size=8, device_cache=True)
    metrics.counter("compile.hits").inc(0)     # the compile line exists
    _serve_two_tenants()
    path = tlive.write_status(str(status_dir))
    assert path == tlive.status_path(str(status_dir))
    assert _validator().validate_status(path) == []
    payload = json.loads(Path(path).read_text())
    assert payload["schema"] == jlive.SCHEMA
    assert payload["version"] == jlive.VERSION
    assert payload["runs"] and payload["runs"][-1]["finished"] is True
    assert payload["hbm"]["bytes_resident"] > 0
    assert "card" not in payload["hbm"]        # no CUDA in this process
    assert payload["compile"]["hits"] >= 0
    assert payload["serve"]["slo"]["window_n"] >= 6
    assert {"tenant=live-a", "tenant=live-b", "tenant=live-frame"} <= set(
        payload["ledger"]["scopes"])
    statuses = tlive.read_statuses(str(status_dir))
    now = payload["ts"] + 0.5
    ours = tlive.render(statuses, now=now)
    assert ours == jlive.render(jlive.read_statuses(str(status_dir)),
                                now=now)
    for line in ("serve:", "hbm:", "compile:", "tenants:", "tenant=live-a",
                 "w_p99"):
        assert line in ours
    dc.reset_device_cache()


def test_top_once_renders_and_returns_rcs(status_dir):
    out = io.StringIO()
    assert tlive.top_main(str(status_dir), once=True, out=out) == 2
    assert "no tpudl-status" in out.getvalue()
    tlive.write_status(str(status_dir))
    out = io.StringIO()
    assert tlive.top_main(str(status_dir), once=True, out=out) == 0
    assert f"pid {os.getpid()} [live]" in out.getvalue()


def test_the_writer_thread_writes_and_flips_alive_on_stop(status_dir):
    w = tlive.StatusWriter(str(status_dir), interval=0.05).start()
    try:
        path = tlive.status_path(str(status_dir))
        for _ in range(200):
            if os.path.exists(path):
                break
            import time
            time.sleep(0.01)
        assert json.loads(Path(path).read_text())["alive"] is True
    finally:
        w.stop(final=True)
    assert json.loads(Path(path).read_text())["alive"] is False
    assert [n for n in os.listdir(status_dir) if ".tmp" in n] == []


def test_fleet_lines_equal_tpudls():
    a = {"pid": 1, "ts": 10.0, "alive": True, "interval_s": 1.0,
         "serve": {"requests": 4, "completed": 4, "rejects": 0,
                   "queue_depth": 1, "queue_cap": 8,
                   "slo": {"window_qps": 2.0, "burn_short": 0.5,
                           "window_samples_ms": [10.0, 20.0, 400.0]}},
         "ledger": {"scopes": {"tenant=a": {"rows_in": 4, "rows_out": 4,
                                            "hbm_bytes": 100}},
                    "unattributed": {}, "evicted": 0}}
    b = dict(a, pid=2, ledger={"scopes": {"tenant=b": {"rows_in": 2}},
                               "unattributed": {}, "evicted": 1})
    assert tlive.render([a, b], now=11.0) == jlive.render([a, b], now=11.0)
