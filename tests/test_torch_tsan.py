"""The port's runtime lock sanitizer (``tpudl_torch.testing.tsan``) held
against tpudl's (``tpudl.testing.tsan``, stdlib at import).

The same acquisitions give the same finding kinds and lock names through
both: an observed ABBA inversion, a declared-order breach over registry
names both packages declare with one rank, a lockset miss, a
self-deadlock, and a real two-thread deadlock in a child process that
the armed sanitizer turns into ``DeadlockError`` and a report naming both
locks. Armed, the port's own structures and a small CPU run of its
executor, serving and training paths file no finding.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from tpudl.testing import tsan as tpudl_tsan
from tpudl_torch.testing import tsan as port_tsan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"tpudl": tpudl_tsan, "port": port_tsan}


@pytest.fixture
def armed_both():
    """Both sanitizers armed with a clean slate; restored after."""
    prev = {k: m.ENABLED for k, m in PACKAGES.items()}
    for m in PACKAGES.values():
        m.reset()
        m.arm()
    yield
    for k, m in PACKAGES.items():
        m.ENABLED = prev[k]
        m.reset()


def _inversion(t):
    a, b = t.named_lock("fix.inv.a"), t.named_lock("fix.inv.b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def _declared_order(t):
    # rank 30 then rank 24 in both registries
    hi, lo = t.named_lock("obs.metrics.counter"), \
        t.named_lock("obs.metrics.registry")
    with hi:
        with lo:
            pass


def _equal_rank_siblings(t):
    a = t.named_lock("obs.watchdog.heartbeat")
    b = t.named_lock("obs.watchdog.heartbeat")
    with a:
        with b:
            pass


def _lockset(t):
    lk = t.named_lock("fix.guard")
    with lk:
        t.check_guarded("fix.guard", "guarded structure", lock=lk)
    t.check_guarded("fix.guard", "guarded structure", lock=lk)


def _self_deadlock(t):
    lk = t.named_lock("fix.self")
    with pytest.raises(t.DeadlockError):
        with lk:
            lk.acquire()


def _consistent(t):
    a, b = t.named_lock("fix.ok.a"), t.named_lock("fix.ok.b")
    for _ in range(3):
        with a:
            with b:
                pass


def _summary(findings):
    return sorted((f["kind"], tuple(sorted(f.get("edge") or
                                           f.get("locks") or
                                           [f.get("lock")])))
                  for f in findings)


@pytest.mark.parametrize("scenario, want", [
    (_inversion, {"inversion"}),
    (_declared_order, {"declared-order"}),
    (_equal_rank_siblings, {"declared-order"}),
    (_lockset, {"lockset"}),
    (_self_deadlock, {"deadlock"}),
    (_consistent, set()),
], ids=["inversion", "declared-order", "equal-rank", "lockset",
        "self-deadlock", "consistent"])
def test_findings_equal_tpudls(armed_both, scenario, want):
    got = {}
    for name, t in PACKAGES.items():
        scenario(t)
        got[name] = _summary(t.findings())
    assert got["port"] == got["tpudl"]
    assert {k for k, _ in got["port"]} == want


ABBA = """
import sys
import threading

from {pkg}.testing import tsan

LOCK_A = tsan.named_lock("fix.abba.a")
LOCK_B = tsan.named_lock("fix.abba.b")
BARRIER = threading.Barrier(2)


def forward():
    with LOCK_A:
        BARRIER.wait()
        with LOCK_B:
            pass


def backward():
    with LOCK_B:
        BARRIER.wait()
        with LOCK_A:
            pass


if __name__ == "__main__":
    threads = [threading.Thread(target=f) for f in (forward, backward)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    bad = [f for f in tsan.findings() if f["kind"] == "deadlock"]
    tsan.write_report()
    sys.exit(3 if bad else 0)
"""


@pytest.mark.parametrize("pkg", ["tpudl", "tpudl_torch"])
def test_a_real_deadlock_raises_and_names_both_locks(tmp_path, pkg):
    script = tmp_path / "abba.py"
    script.write_text(ABBA.format(pkg=pkg))
    env = dict(os.environ, TPUDL_TSAN="1", TPUDL_TSAN_DEADLOCK_S="0.5",
               TPUDL_FLIGHT_DIR=str(tmp_path), PYTHONPATH=REPO,
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3, (proc.stdout, proc.stderr)
    assert "DeadlockError" in proc.stderr
    (report,) = tmp_path.glob("tpudl-tsan-*.json")
    rep = json.loads(report.read_text())
    dead = [f for f in rep["findings"] if f["kind"] == "deadlock"]
    assert dead and set(dead[0]["locks"]) == {"fix.abba.a", "fix.abba.b"}


def test_condition_over_a_named_lock_waits_and_notifies_armed(armed_both):
    for t in PACKAGES.values():
        with pytest.raises(ValueError, match="condition"):
            t.named_lock("fix.cv", kind="condition")
        cv = threading.Condition(t.named_lock("fix.cv"))
        box = []

        def consumer():
            with cv:
                ok = cv.wait_for(lambda: "item" in box, timeout=10)
                box.append(ok)

        th = threading.Thread(target=consumer)
        th.start()
        time.sleep(0.05)
        with cv:
            box.append("item")
            cv.notify_all()
        th.join(timeout=10)
        assert not th.is_alive() and box == ["item", True]
        assert t.findings() == []


def test_the_ports_structures_are_clean_armed(armed_both):
    from tpudl_torch.obs import flight, watchdog
    from tpudl_torch.obs.metrics import MetricsRegistry
    from tpudl_torch.obs.pipeline import PipelineReport, set_last_pipeline

    m = MetricsRegistry()
    m.counter("train.steps").inc()
    m.gauge("train.last_step").set(3)
    m.histogram("train.step_seconds").observe(0.01)
    r = PipelineReport()
    with r.stage("prepare"):
        pass
    r.progress(4)
    set_last_pipeline(r)
    rec = flight.FlightRecorder()
    rec.record_batch("dispatch", 0, [])
    with watchdog.HeartbeatRegistry().start("fix.stage") as hb:
        hb.stage_enter("dispatch")
        hb.beat()
        hb.stage_exit("dispatch")
    bad = [f for f in port_tsan.findings()
           if f["kind"] in ("lockset", "inversion", "deadlock",
                            "declared-order")]
    assert bad == [], bad
    seen = set(port_tsan.report()["locks_seen"])
    assert {"obs.metrics.registry", "obs.pipeline.report",
            "obs.flight.recorder", "obs.watchdog.registry"} <= seen
    # the product wiring: mutating a guarded ring unguarded is caught
    # (the ring's lock predates arming: register its name as armed)
    port_tsan.named_lock("obs.pipeline.ring")
    port_tsan.check_guarded("obs.pipeline.ring", "pipeline-report ring")
    assert [f["kind"] for f in port_tsan.findings()] == ["lockset"]


SLICE = """
import json
import sys

import numpy as np
import torch

from tpudl_torch.frame import Frame
from tpudl_torch.ml import LMFeaturizer
from tpudl_torch.serve import ModelRegistry, RequestQueue, Server
from tpudl_torch.testing import tsan
from tpudl_torch.text import ByteTokenizer
from tpudl_torch.train import Trainer, adamw
from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

assert tsan.enabled()
spec = TinyCausalLM(512, 32, 4, 2, 128, device="meta")
weights = spec.init(0)
texts = ["text %d " % i * (i % 5 + 1) for i in range(12)]
outs = []
for kw in ({}, {"fuseSteps": 2}):
    st = LMFeaturizer(inputCol="t", outputCol="v", model=spec,
                      weights=weights, tokenizer=ByteTokenizer(),
                      batchSize=4, device="cpu", maxLen=64, **kw)
    outs.append(np.stack(list(st.transform(Frame({"t": texts}))["v"])))
assert np.array_equal(outs[0], outs[1])
reg = ModelRegistry()
reg.add_model("lm", spec, weights, slots=2, cache_len=64, device="cpu")
srv = Server(reg, RequestQueue(cap=8), supervise=True)
reqs = [srv.submit(np.array([1 + i, 2, 3], np.int32), 4, model="lm")
        for i in range(3)]
srv._stop.set()
srv.run()
assert all(len(r.result(timeout=30)) for r in reqs)
net = TinyCausalLM(512, 32, 4, 2, 128, device="cpu")
load_jax_params(net, weights)
rows = np.random.default_rng(0).integers(0, 64, (2, 17)).astype(np.int32)
Trainer(net.loss_fn(), adamw(1e-3)).fit(net, lambda step: rows, 1)
rep = tsan.report()
json.dump({"findings": rep["findings"], "locks": rep["locks_seen"]},
          sys.stdout)
"""


def test_a_cpu_run_of_the_slice_files_no_finding_armed(tmp_path):
    env = dict(os.environ, TPUDL_TSAN="1", PYTHONPATH=REPO,
               TPUDL_FLIGHT_DIR=str(tmp_path), JAX_PLATFORMS="cpu",
               TPUDL_FRAME_AUTOTUNE="0")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SLICE)],
                          env=env, capture_output=True, text=True,
                          timeout=240, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["findings"] == [], out["findings"]
    assert {"obs.pipeline.report", "serve.queue",
            "obs.metrics.registry"} <= set(out["locks"])
