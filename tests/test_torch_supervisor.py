"""The fault supervisor (``tpudl_torch.frame.supervisor``) against tpudl's.

- ``classify_exception`` sorts a shared table of exceptions (every stage
  tag and storm flag) into tpudl's kinds, and the CUDA allocator's
  ``torch.cuda.OutOfMemoryError`` is ``oom``;
- the same ``FaultPlan`` makes the port's supervised ``map_batches`` and
  tpudl's take the same rungs (the ``frame.degraded`` entries of each
  flight recorder), over ``fuse_steps=4`` and ``dispatch_depth=4``, and
  the port's recovered outputs equal its healthy run's bit for bit: an
  injected OOM (``evict_hbm``, which empties the device cache's unpinned
  entries), three dispatch faults (depth 4 → 2 → 1, then ``fuse_steps``
  → 1), a prepare fault, and a raising ``fn`` whose first call runs out
  of memory;
- a transfer fault retries under the shared IO policy with no rung;
- under ``TPUDL_FRAME_DEGRADE_MAX_RUNGS=1`` exhaustion raises the typed
  error chained to the fault and writes a dump that tpudl's ``obs
  doctor`` classifies as ``degraded_run``, as tpudl's run does;
- a supervised ``Server`` recovers from a dispatch fault down tpudl's
  rung, and its streams equal serial ``generate``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl.frame import Frame as JaxFrame
from tpudl.frame import supervisor as jsup
from tpudl.obs import doctor as jdoctor
from tpudl.obs import flight as jflight
from tpudl.testing import faults as jfaults
from tpudl.train import Preempted as JaxPreempted

from tpudl_torch.data import device_cache as dc
from tpudl_torch.frame import Frame
from tpudl_torch.frame import supervisor as sup
from tpudl_torch.obs import flight, last_pipeline_report
from tpudl_torch.obs import metrics
from tpudl_torch.testing import faults
from tpudl_torch.train import Preempted

torch.set_num_threads(1)

ROWS, BATCH = 40, 4     # 10 full batches: fuse 4 → 2 fused groups + 2


@jax.jit
def jfn(x):
    return 2.0 * x + 1.0


def tfn(x):
    return 2.0 * x + 1.0


def _columns():
    return {"x": np.random.default_rng(0).normal(
        size=(ROWS, 3)).astype(np.float32)}


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUDL_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("TPUDL_RETRY_IO_BACKOFF_S", "0.001")
    for k in ("TPUDL_FRAME_DEGRADE", "TPUDL_FRAME_DEGRADE_MAX_RUNGS",
              "TPUDL_FRAME_PREFETCH", "TPUDL_FRAME_FUSE_STEPS",
              "TPUDL_FRAME_DISPATCH_DEPTH", "TPUDL_COMPILE_AOT"):
        monkeypatch.delenv(k, raising=False)
    for f, rec in ((faults, flight), (jfaults, jflight)):
        f.disarm()
        rec.get_recorder().reset()
    dc.reset_device_cache()
    yield tmp_path
    faults.disarm()
    jfaults.disarm()
    dc.reset_device_cache()


# -- the taxonomy ------------------------------------------------------------

def _table():
    """(name, exception) pairs both packages must sort alike."""
    return [
        ("OSError", OSError("disk")),
        ("TimeoutError", TimeoutError()),
        ("ConnectionError", ConnectionError()),
        ("RuntimeError", RuntimeError("boom")),
        ("ValueError", ValueError("shape")),
        ("KeyError", KeyError("col")),
        ("TypeError", TypeError("bug")),
        ("AttributeError", AttributeError("bug")),
        ("KeyboardInterrupt", KeyboardInterrupt()),
        ("SystemExit", SystemExit()),
        ("MemoryError", MemoryError()),
        ("RESOURCE_EXHAUSTED text", RuntimeError(
            "RESOURCE_EXHAUSTED: Out of memory while trying to allocate 8 "
            "bytes.")),
        ("tpudl oom_error", jfaults.oom_error(1 << 20)),
        ("other library's OOM wording", RuntimeError(
            "some library: ran out of memory")),
        ("port Preempted", Preempted(3)),
        ("tpudl Preempted", JaxPreempted(3)),
        ("port FaultInjected", faults.FaultInjected("x")),
        ("tpudl FaultInjected", jfaults.FaultInjected("x")),
        ("port typed Fatal", sup.Fatal("x")),
        ("tpudl typed Fatal", jsup.Fatal("x")),
    ]


@pytest.mark.parametrize("stage", [None, "prepare", "h2d", "dispatch"])
@pytest.mark.parametrize("storm", [False, True])
def test_classify_sorts_the_shared_table_like_tpudl(stage, storm):
    for name, exc in _table():
        assert sup.classify_exception(exc, stage=stage, storm=storm) == \
            jsup.classify_exception(exc, stage=stage, storm=storm), name


def test_the_cuda_allocators_oom_is_oom():
    for exc in (torch.cuda.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 "
                    "has a total capacity of 79.10 GiB"),
                faults.oom_error(4096, point="frame.dispatch call 1"),
                RuntimeError("CUDA out of memory. Tried to allocate 8 "
                             "bytes.")):
        for stage in (None, "h2d", "dispatch"):
            assert sup.classify_exception(exc, stage=stage) == "oom"
    assert sup.classify_exception(RuntimeError(
        "a kernel failed: CUDA out of memory"), stage="dispatch") == "stage"


def test_typed_errors_carry_tpudls_kinds_and_fatal_contract():
    for name in ("DeviceOOM", "TransferError", "RecompileStorm",
                 "StageFault", "Fatal"):
        ours, theirs = getattr(sup, name), getattr(jsup, name)
        assert ours.kind == theirs.kind
        assert issubclass(ours, sup.FaultError)
        e = ours("m", stage="h2d", rungs=["a"])
        assert (e.stage, e.rungs) == ("h2d", ("a",))
    assert sup.Fatal.tpudl_fatal and sup.LADDER == jsup.LADDER
    assert sup.DEFAULT_MAX_RUNGS == jsup.DEFAULT_MAX_RUNGS


def test_enabled_reads_the_kwarg_then_the_variable(monkeypatch):
    assert not sup.enabled() and sup.enabled(True)
    monkeypatch.setenv("TPUDL_FRAME_DEGRADE", "1")
    assert sup.enabled() and not sup.enabled(False)
    assert sup.enabled() == jsup.enabled()


# -- the ladder through map_batches ------------------------------------------

def _rungs(recorder):
    return [e["rung"] for e in recorder.get_recorder().snapshot()["errors"]
            if e["kind"] == "frame.degraded"]


def _port(plan=None, fn=tfn, **kw):
    kw = dict(batch_size=BATCH, device="cpu", fuse_steps=4,
              dispatch_depth=4, autotune=False, **kw)
    if plan is None:
        return Frame(_columns()).map_batches(fn, ["x"], ["y"], **kw)
    with plan.armed():
        return Frame(_columns()).map_batches(fn, ["x"], ["y"],
                                             supervise=True, **kw)


def _jax(plan):
    with plan.armed():
        return JaxFrame(_columns()).map_batches(
            jfn, ["x"], ["y"], batch_size=BATCH, fuse_steps=4,
            dispatch_depth=4, autotune=False, supervise=True)


def _y(frame):
    return np.stack(list(frame["y"]))


PLANS = {
    "oom at dispatch": (lambda f: f.FaultPlan.oom("frame.dispatch"),
                        ["evict_hbm"]),
    "three dispatch faults": (
        lambda f: f.FaultPlan(
            f.FaultPlan.raise_in_stage("dispatch", 1).rules
            + f.FaultPlan.raise_in_stage("dispatch", 2).rules
            + f.FaultPlan.raise_in_stage("dispatch", 3).rules),
        ["dispatch_depth=2", "dispatch_depth=1", "fuse_steps=1"]),
    "prepare fault": (lambda f: f.FaultPlan.raise_in_stage("prepare"),
                      ["dispatch_depth=2"]),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_a_plan_takes_tpudls_rungs_and_returns_the_healthy_bytes(name):
    make, want_rungs = PLANS[name]
    healthy = _y(_port())
    cache = dc.get_device_cache()
    cache.put(("stale-run", 0), [torch.zeros(8, 8)]).release()
    got = _y(_port(make(faults)))
    rep = last_pipeline_report()
    _jax(make(jfaults))
    assert _rungs(flight) == _rungs(jflight) == want_rungs
    assert rep["degraded_to"] == want_rungs[-1]
    assert rep["recovered_batches"] == rep["stage_calls"]["dispatch"]
    assert np.array_equal(got, healthy)
    # only the OOM rung empties the device cache's unpinned entries
    assert (cache.bytes_resident == 0) == (want_rungs[0] == "evict_hbm")


def test_a_real_out_of_memory_in_fn_recovers_on_the_evict_rung():
    calls = {"n": 0}

    def greedy(x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 1.00 TiB.")
        return tfn(x)

    healthy = _y(_port())
    cache = dc.get_device_cache()
    cache.put(("stale-run", 0), [torch.zeros(16, 16)]).release()
    before = metrics.counter("data.hbm.evictions").value
    got = _y(_port(faults.FaultPlan([]), fn=greedy))
    assert np.array_equal(got, healthy)
    assert _rungs(flight) == ["evict_hbm"]
    assert cache.bytes_resident == 0
    assert metrics.counter("data.hbm.evictions").value == before + 1
    ring = [e for e in flight.get_recorder().snapshot()["errors"]
            if e["kind"] == "frame.degraded"]
    assert ring[0]["type"] == "OutOfMemoryError"
    assert ring[0]["freed_bytes"] == 16 * 16 * 4


def test_a_transfer_fault_retries_under_the_io_policy_with_no_rung():
    before = {n: metrics.counter(n).value
              for n in ("retry.frame.transfer", "frame.degraded.rungs")}
    healthy = _y(_port())
    plan = faults.FaultPlan([{"point": "frame.h2d", "action": "raise",
                              "exc": "OSError", "first_calls": 1}])
    got = _y(_port(plan))
    assert np.array_equal(got, healthy)
    rep = last_pipeline_report()
    assert rep.get("degraded_to") is None
    assert metrics.counter("retry.frame.transfer").value == \
        before["retry.frame.transfer"] + 1
    assert metrics.counter("frame.degraded.rungs").value == \
        before["frame.degraded.rungs"]
    assert _rungs(flight) == []


def test_unsupervised_runs_raise_the_fault_once():
    plan = faults.FaultPlan.raise_in_stage("dispatch")
    with plan.armed(), pytest.raises(faults.FaultInjected) as ei:
        Frame(_columns()).map_batches(tfn, ["x"], ["y"], device="cpu",
                                      batch_size=BATCH)
    assert ei.value.tpudl_stage == "dispatch" and len(plan.fired) == 1


def test_a_programming_error_is_never_retried():
    def buggy(x):
        raise TypeError("bug in fn")

    with pytest.raises(TypeError, match="bug in fn"):
        _port(faults.FaultPlan([]), fn=buggy)
    assert _rungs(flight) == []


def test_exhaustion_raises_typed_with_a_dump_the_doctor_reads(
        clean, monkeypatch):
    monkeypatch.setenv("TPUDL_FRAME_DEGRADE_MAX_RUNGS", "1")
    before = metrics.counter("frame.degraded.exhausted").value
    every = [{"point": "frame.dispatch", "action": "raise"}]
    # each package dumps into a directory of its own: both name their
    # dump tpudl-dump-<pid>.json.gz, and in one directory tpudl's would
    # overwrite the port's (carrying tpudl's process-wide counters, which
    # other test files on this worker may have filled with decode errors)
    port_dir, tpudl_dir = clean / "port", clean / "tpudl"
    monkeypatch.setenv("TPUDL_FLIGHT_DIR", str(port_dir))
    with pytest.raises(sup.StageFault) as ours:
        _port(faults.FaultPlan(every))
    monkeypatch.setenv("TPUDL_FLIGHT_DIR", str(tpudl_dir))
    with pytest.raises(jsup.StageFault) as theirs:
        _jax(jfaults.FaultPlan(every))
    assert ours.value.rungs == theirs.value.rungs == (
        "dispatch_depth=2", "serial")
    assert ours.value.stage == theirs.value.stage == "dispatch"
    assert isinstance(ours.value.__cause__, faults.FaultInjected)
    assert metrics.counter("frame.degraded.exhausted").value == before + 1
    ring = [e for e in flight.get_recorder().snapshot()["errors"]
            if e["kind"] == "frame.degraded.exhausted"]
    assert ring[-1]["fault_kind"] == "stage"
    dumps = sorted(port_dir.glob("tpudl-dump-*.json.gz"))
    assert len(dumps) >= 1
    assert len(list(tpudl_dir.glob("tpudl-dump-*.json.gz"))) == 1
    port_dump = [d for d in dumps
                 if str(d) in flight.get_recorder().dumped_paths]
    assert len(port_dump) == 1
    merged, diag = jdoctor.diagnose(str(port_dump[0]))
    # the doctor read the port's dump, not tpudl's
    [host] = merged["hosts"].values()
    assert host["backend"]["torch_loaded"] is True
    assert diag["classification"] == "degraded_run"



def test_store_misses_on_another_thread_are_not_a_recompile_storm(clean):
    """The storm signal is the attempt's own program-store misses: a
    thread that misses the store all through a supervised run leaves a
    stage fault's rungs tpudl's (a storm would have skipped to the
    ``fuse_steps`` rung), and the outputs the healthy run's."""
    import threading

    from tpudl_torch.compile import store as cstore

    healthy = _y(_port())
    stop = threading.Event()

    def miss():
        while not stop.is_set():
            cstore.get_program_store().count_miss()
            stop.wait(0.0005)

    storms = metrics.counter("compile.storms").value
    t = threading.Thread(target=miss, daemon=True)
    t.start()
    try:
        got = _port(faults.FaultPlan.raise_in_stage("dispatch"))
    finally:
        stop.set()
        t.join(5)
    _jax(jfaults.FaultPlan.raise_in_stage("dispatch"))
    assert _rungs(flight) == _rungs(jflight) == ["dispatch_depth=2"]
    assert metrics.counter("compile.storms").value == storms
    assert np.array_equal(_y(got), healthy)


def test_counting_misses_counts_this_context_only():
    """``counting_misses`` sees the misses of its own thread, and not
    those of a thread started inside it."""
    import threading

    from tpudl_torch.compile import store as cstore

    st = cstore.get_program_store()
    with cstore.counting_misses() as n:
        st.count_miss()
        t = threading.Thread(target=st.count_miss)
        t.start()
        t.join(5)
        st.count_miss()
    assert n == [2]
    with cstore.counting_misses() as outer:
        with cstore.counting_misses() as inner:
            st.count_miss()
        st.count_miss()
    assert (outer, inner) == ([1], [1])

# -- supervised serving --------------------------------------------------------

ARCH = dict(vocab=64, dim=32, heads=2, layers=2, max_len=64)


def test_a_supervised_server_recovers_and_streams_equal_generate():
    import tpudl.serve as jserve
    from tpudl.zoo.transformer import TinyCausalLM as JaxLM

    import tpudl_torch.serve as tserve
    from tpudl_torch.zoo.transformer import TinyCausalLM

    from tpudl_torch.zoo.transformer import load_jax_params

    spec = TinyCausalLM(device="cpu", **ARCH)
    params = spec.init(0)
    load_jax_params(spec, params)
    prompts = [np.arange(1, n + 1, dtype=np.int32) % 64 for n in (3, 6, 9, 4)]
    max_new = 5
    plan_rules = [{"point": "serve.dispatch", "action": "raise",
                   "at_call": 4}]
    results = {}
    for side in ("port", "tpudl"):
        serve = tserve if side == "port" else jserve
        f = faults if side == "port" else jfaults
        reg = serve.ModelRegistry()
        if side == "port":
            reg.add_model("default", spec, params, slots=4, cache_len=32,
                          warm=False, device="cpu")
        else:
            reg.add_model("default", JaxLM(**ARCH),
                          jax.tree.map(jnp.asarray, params), slots=4,
                          cache_len=32, warm=False)
        srv = serve.Server(reg, serve.RequestQueue(cap=8), supervise=True)
        reqs = [srv.submit(p, max_new) for p in prompts]
        srv._stop.set()
        plan = f.FaultPlan(plan_rules)
        with plan.armed():
            summary = srv.run()
        results[side] = (summary["degraded_to"], summary["completed"],
                         [np.asarray(r.result(timeout=60)).tolist()
                          for r in reqs])
    assert results["port"][:2] == results["tpudl"][:2] == (
        "dispatch_depth=2", 4)
    serial = [np.asarray(spec.generate(p[None], max_new)[0]).tolist()
              for p in prompts]
    assert results["port"][2] == serial
