"""The port's capture-storm sentinel (``tpudl_torch.testing.traceck``)
against tpudl's (``tpudl.testing.traceck``).

On the CPU a stand-in takes ``cuda_ops.capture_graph``'s place before the
sentinel installs over it, so captures through the executor's
``FusedGraph`` are counted as on the card: per function identity (the
function the graph runs), ``traceck.traces``/``.retraces``/``.storms``,
and one ``traceck.recompile_storm`` in the flight error ring past
``TPUDL_TRACECK_STORM``. The dump that storm leaves is classified
``recompile_storm`` by the port's doctor and by tpudl's, as tpudl's own
sentinel's dump is; the supervisor reads ``traceck.storms`` as tpudl's
does.
"""

import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from tpudl.obs import doctor as tpudl_doctor
from tpudl_torch import cuda_ops
from tpudl_torch.compile.graphs import FusedGraph
from tpudl_torch.frame import supervisor
from tpudl_torch.obs import doctor, flight
from tpudl_torch.obs import metrics as M
from tpudl_torch.testing import traceck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stand_in(run, device, warmup=None):
    """The capture path on the CPU: warm up, run once, no graph."""
    (warmup or run)()
    run()
    return None, {}


@pytest.fixture
def sentinel(monkeypatch):
    monkeypatch.setattr(cuda_ops, "capture_graph", _stand_in)
    prev = traceck.ENABLED
    traceck.reset()
    traceck.arm()
    yield traceck
    traceck.uninstall()
    traceck.ENABLED = prev
    traceck.reset()


def _value(name):
    return M.counter(name).value


def _capture(fn):
    g = FusedGraph(fn, 1, (torch.zeros(2, 3),), 1, "cpu")
    g.ready([((torch.ones(2, 3),),)])
    return g


def test_install_wraps_the_one_capture_path(sentinel):
    assert traceck.installed()
    assert getattr(cuda_ops.capture_graph, "_tpudl_traceck", False)
    traceck.uninstall()
    assert cuda_ops.capture_graph is _stand_in
    traceck.install()
    assert traceck.installed()


def test_captures_count_per_function_identity(sentinel, monkeypatch):
    monkeypatch.setenv("TPUDL_TRACECK_STORM", "3")
    t0, r0, s0 = (_value(n) for n in ("traceck.traces",
                                      "traceck.retraces",
                                      "traceck.storms"))

    def stable(x):
        return x * 2

    _capture(stable)
    _capture(stable)            # a second graph of one function: a retrace
    for k in range(5):          # a fresh closure each time: a storm
        _capture(lambda x, k=k: x + k)
    counts = traceck.counts()
    stable_id = next(i for i in counts if i.endswith(".stable"))
    churn_id = next(i for i in counts if "<lambda>" in i)
    assert counts[stable_id] == 2 and counts[churn_id] == 5
    assert __file__ in stable_id      # the function the graph runs
    assert (_value("traceck.traces") - t0, _value("traceck.retraces") - r0,
            _value("traceck.storms") - s0) == (7, 5, 1)
    (finding,) = traceck.findings()
    assert finding == {"kind": "recompile_storm", "fn": churn_id,
                       "traces": 4, "threshold": 3}
    ring = [e for e in flight.get_recorder().snapshot()["errors"]
            if e["kind"] == "traceck.recompile_storm"]
    assert ring and ring[-1]["fn"] == churn_id


def test_unarmed_counts_nothing(sentinel):
    traceck.disarm()
    _capture(lambda x: x)
    assert traceck.counts() == {}


def test_identity_is_tpudls_for_plain_functions(sentinel):
    from tpudl.testing import traceck as tpudl_traceck

    def f(x):
        return x

    assert traceck._identity(f) == tpudl_traceck._identity(f)
    assert traceck._identity(lambda x: x).endswith("<lambda>")


STORM_CHILD = """
import json, sys
import torch
from tpudl_torch import cuda_ops
def stand_in(run, device, warmup=None):
    (warmup or run)(); run(); return None, {}
cuda_ops.capture_graph = stand_in
from tpudl_torch.testing import traceck
traceck.uninstall(); traceck.install()   # over the stand-in
from tpudl_torch.compile.graphs import FusedGraph
from tpudl_torch.obs import flight
assert traceck.installed()
for k in range(5):
    g = FusedGraph(lambda x, k=k: x + k, 1, (torch.zeros(2),), 1, "cpu")
    g.ready([((torch.ones(2),),)])
print(json.dumps(traceck.findings()))
flight.dump(reason="storm", path=sys.argv[1])
"""


def test_the_storms_dump_reads_recompile_storm_to_both_doctors(tmp_path):
    dump = tmp_path / "tpudl-dump-1.json.gz"
    env = dict(os.environ, TPUDL_TRACECK="1", TPUDL_TRACECK_STORM="3",
               PYTHONPATH=REPO, TPUDL_FLIGHT_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", STORM_CHILD, str(dump)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(json.loads(proc.stdout.strip().splitlines()[-1])) == 1
    with gzip.open(dump, "rt") as f:
        payload = json.load(f)
    assert payload["metrics"]["traceck.storms"]["value"] == 1
    _, ours = doctor.diagnose(str(dump))
    _, theirs = tpudl_doctor.diagnose(str(dump))
    assert ours["classification"] == theirs["classification"] == \
        "recompile_storm"


def test_the_supervisor_reads_traceck_storms():
    assert supervisor._storms() == M.counter("traceck.storms").value
    assert supervisor.classify_exception(
        RuntimeError("boom"), stage="dispatch", storm=True) == \
        "recompile_storm"
