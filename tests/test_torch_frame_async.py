"""The port's pipelined executor (``tpudl_torch.frame.Frame.map_batches``)
against tpudl's, on the same numpy frame, across the knob matrix: prefetch
depth K, prepare workers N, dispatch depth D, fused steps M and bucket
ladders, with a ragged tail and with the ``num_partitions`` hint.

tpudl runs a jitted ``jnp`` function, the port the torch function that
computes the same thing with exact f32 ops (``2*x+1``) and an integer
gather, so the outputs are held bitwise: to tpudl's, and within the port
to the serial arm (``TPUDL_FRAME_PREFETCH=0``). ``report.config`` must
equal tpudl's on every key both set (both with ``autotune=False``, which
the report's keys are held under). Raising ``fn`` and ``pack`` propagate their own
exception, and the prepare pool's threads exit; every wait for them has a
timeout."""

import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import tpudl.frame.frame as jframe
import tpudl_torch.frame.frame as pframe
from tpudl import obs as jobs
from tpudl.frame import Frame as JaxFrame
from tpudl_torch.frame import Frame
from tpudl_torch.obs import last_pipeline_report

torch.set_num_threads(1)

ROWS, BATCH = 23, 4          # 5 full batches and a ragged tail of 3
TABLE = (np.arange(50, dtype=np.float32) * 1.5 - 7.0)
ENV = ("TPUDL_FRAME_PREFETCH", "TPUDL_FRAME_PREFETCH_DEPTH",
       "TPUDL_FRAME_PREPARE_WORKERS", "TPUDL_FRAME_FUSE_STEPS",
       "TPUDL_FRAME_DISPATCH_DEPTH", "TPUDL_FRAME_DONATE",
       "TPUDL_FRAME_AUTOTUNE", "TPUDL_COMPILE_BUCKETS", "TPUDL_WIRE_CODEC")
_TABLE_T = torch.from_numpy(TABLE)


@jax.jit
def jfn(x, i):
    return 2.0 * x + 1.0, jnp.asarray(TABLE)[i]


def tfn(x, i):
    return 2.0 * x + 1.0, _TABLE_T[i.long()]


def _columns():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(ROWS, 3)).astype(np.float32)
    i = rng.integers(0, len(TABLE), size=ROWS).astype(np.int32)
    return {"x": x, "i": i}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


def _outputs(frame):
    return np.stack(list(frame["y"])), np.asarray(frame["g"])


def _assert_same(got, want):
    for a, b in zip(_outputs(got), _outputs(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _infeed_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("tpudl-infeed")]


def _wait_pool_gone(timeout=10.0):
    t_end = time.monotonic() + timeout
    while _infeed_threads() and time.monotonic() < t_end:
        time.sleep(0.01)
    assert _infeed_threads() == []


@pytest.fixture(scope="module")
def serial():
    """The port's serial arm, the bitwise yardstick of every other arm."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUDL_FRAME_PREFETCH", "0")
        out = Frame(_columns()).map_batches(
            tfn, ["x", "i"], ["y", "g"], batch_size=BATCH, device="cpu")
        report = last_pipeline_report()
    assert report["executor"] == "serial" and report["fuse_steps"] == 1
    return out


@pytest.mark.parametrize("buckets", [None, "pow2"])
@pytest.mark.parametrize("fuse", [1, 3])
@pytest.mark.parametrize("d_depth", [1, 2, 3])
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("k_depth", [1, 2, 4])
def test_knob_matrix_matches_tpudl_and_serial(serial, k_depth, workers,
                                              d_depth, fuse, buckets):
    kw = dict(batch_size=BATCH, prefetch_depth=k_depth,
              prepare_workers=workers, dispatch_depth=d_depth,
              fuse_steps=fuse, buckets=buckets)
    want = JaxFrame(_columns()).map_batches(jfn, ["x", "i"], ["y", "g"],
                                            autotune=False, **kw)
    jrep = jobs.last_pipeline_report()
    got = Frame(_columns()).map_batches(tfn, ["x", "i"], ["y", "g"],
                                        device="cpu", autotune=False, **kw)
    prep = last_pipeline_report()
    assert got.columns == want.columns == ["x", "i", "y", "g"]
    _assert_same(got, want)
    _assert_same(got, serial)
    shared = set(jrep) & set(prep) - {"run_id", "wall_seconds", "age_s",
                                     "stage_seconds", "stage_calls",
                                     "queue_depth_mean",
                                     "dispatch_inflight_mean",
                                     "queue_depth_max",
                                     "dispatch_inflight_max",
                                     "overlap_efficiency",
                                     "dispatch_overlap_s"}
    assert {k: prep[k] for k in shared} == {k: jrep[k] for k in shared}
    assert set(jrep) - set(prep) <= {"dispatch_overlap_s"}
    assert prep["queue_depth_max"] <= prep["prefetch_depth"]
    if d_depth > 1:
        assert 1 <= prep["dispatch_inflight_max"] <= d_depth
    else:
        assert "dispatch_inflight_max" not in prep
    calls = prep["stage_calls"]
    assert calls.get("fused_dispatches", 0) == (1 if fuse == 3 else 0)
    assert calls.get("fused_dispatches", 0) == \
        jrep["stage_calls"].get("fused_dispatches", 0)
    assert calls.get("bucket_pad_rows", 0) == (1 if buckets else 0)
    assert prep["rows_done"] == ROWS
    _wait_pool_gone()


@pytest.mark.parametrize("fuse", [1, 3])
@pytest.mark.parametrize("num_partitions", [1, 3, 6, 23, 40])
def test_num_partitions_sets_the_batch(serial, num_partitions, fuse):
    cols = _columns()
    want = JaxFrame(cols, num_partitions).map_batches(
        jfn, ["x", "i"], ["y", "g"], fuse_steps=fuse, autotune=False)
    jrep = jobs.last_pipeline_report()
    got = Frame(cols, num_partitions).map_batches(
        tfn, ["x", "i"], ["y", "g"], fuse_steps=fuse, device="cpu")
    prep = last_pipeline_report()
    assert prep["batch_size"] == jrep["batch_size"] == \
        -(-ROWS // num_partitions)
    assert prep["stage_calls"].get("fused_dispatches", 0) == \
        jrep["stage_calls"].get("fused_dispatches", 0)
    assert got.num_partitions == num_partitions
    _assert_same(got, want)
    _assert_same(got, serial)


@pytest.mark.parametrize("fuse", [1, 3])
def test_batch_a_ladder_pads_does_not_fuse(fuse):
    """batch 5 pads to 8 on "pow2", so every full batch carries pad rows
    and fusion drops to per-batch dispatch, as in tpudl."""
    kw = dict(batch_size=5, fuse_steps=fuse, buckets="pow2")
    want = JaxFrame(_columns()).map_batches(jfn, ["x", "i"], ["y", "g"],
                                            autotune=False, **kw)
    jrep = jobs.last_pipeline_report()
    got = Frame(_columns()).map_batches(tfn, ["x", "i"], ["y", "g"],
                                        device="cpu", **kw)
    prep = last_pipeline_report()
    _assert_same(got, want)
    assert prep["fuse_steps"] == jrep["fuse_steps"] == 1
    assert prep["stage_calls"]["bucket_pad_rows"] == \
        jrep["stage_calls"]["bucket_pad_rows"] == 4 * 3 + 1


@pytest.mark.parametrize("d_depth", [1, 2])
@pytest.mark.parametrize("fuse", [1, 3])
def test_windowed_outfeed_matches(monkeypatch, serial, fuse, d_depth):
    """tpudl's windowed outfeed (outputs too large to keep on its device,
    fetched as each batch leaves, a fused run dropping to per-batch
    dispatch after its first group) gives the rows, and the count of
    fused dispatches, of the port's one outfeed, which copies every
    output to host memory at dispatch."""
    monkeypatch.setattr(jframe, "_ACC_FETCH_CAP", 0)
    kw = dict(batch_size=BATCH, fuse_steps=fuse, dispatch_depth=d_depth)
    want = JaxFrame(_columns()).map_batches(jfn, ["x", "i"], ["y", "g"],
                                            autotune=False, **kw)
    jrep = jobs.last_pipeline_report()
    got = Frame(_columns()).map_batches(tfn, ["x", "i"], ["y", "g"],
                                        device="cpu", **kw)
    prep = last_pipeline_report()
    _assert_same(got, want)
    _assert_same(got, serial)
    assert prep["stage_calls"].get("fused_dispatches", 0) == \
        jrep["stage_calls"].get("fused_dispatches", 0) == \
        (1 if fuse > 1 else 0)


def test_ragged_groups_fall_back_to_per_batch():
    """A pack whose width changes between batches cannot stack; such a
    group dispatches per batch, and the rows are tpudl's."""
    col = np.empty(12, dtype=object)
    col[:] = [np.full(1 + (i // 2) % 3, i, np.float32) for i in range(12)]

    def pack(sl):
        width = max(len(v) for v in sl)
        return np.stack([np.pad(v, (0, width - len(v))) for v in sl])

    want = JaxFrame({"v": col}).map_batches(
        jax.jit(lambda v: v.sum(axis=1) * 2.0), ["v"], ["s"], batch_size=2,
        pack=pack, fuse_steps=3, autotune=False)
    got = Frame({"v": col}).map_batches(
        lambda v: v.sum(dim=1) * 2.0, ["v"], ["s"], batch_size=2, pack=pack,
        fuse_steps=3, device="cpu")
    assert np.array_equal(got["s"], want["s"])
    assert last_pipeline_report()["stage_calls"].get(
        "fused_dispatches", 0) == jobs.last_pipeline_report()[
            "stage_calls"].get("fused_dispatches", 0) == 0


class Boom(Exception):
    pass


@pytest.mark.parametrize("d_depth", [1, 3])
@pytest.mark.parametrize("fuse", [1, 2])
@pytest.mark.parametrize("where", ["fn", "pack"])
def test_errors_propagate_and_the_pool_exits(where, fuse, d_depth):
    calls = []

    def fn(x, i):
        calls.append(x.shape[0])
        if where == "fn" and len(calls) == 2:
            raise Boom("fn")
        return tfn(x, i)

    def pack(sl):
        if where == "pack" and np.array_equal(sl, _columns()["i"][8:12]):
            raise Boom("pack")
        return np.asarray(sl)

    pack.thread_safe = True
    with pytest.raises(Boom, match=where):
        Frame(_columns()).map_batches(
            fn, ["x", "i"], ["y", "g"], batch_size=BATCH, pack=pack,
            prefetch_depth=4, prepare_workers=2, fuse_steps=fuse,
            dispatch_depth=d_depth, device="cpu")
    _wait_pool_gone()


def test_unmarked_pack_runs_on_one_worker():
    seen = set()

    def pack(sl):
        seen.add(threading.current_thread().name)
        time.sleep(0.01)
        return np.asarray(sl)

    Frame(_columns()).map_batches(tfn, ["x", "i"], ["y", "g"],
                                  batch_size=2, pack=pack,
                                  prefetch_depth=4, device="cpu")
    assert last_pipeline_report()["prepare_workers"] == 1
    assert len(seen) == 1
    pack.thread_safe = True
    seen.clear()
    Frame(_columns()).map_batches(tfn, ["x", "i"], ["y", "g"],
                                  batch_size=2, pack=pack,
                                  prefetch_depth=4, device="cpu")
    assert last_pipeline_report()["prepare_workers"] == 2
    _wait_pool_gone()


def test_env_variables_set_the_knobs(monkeypatch):
    monkeypatch.setenv("TPUDL_FRAME_PREFETCH_DEPTH", "3")
    monkeypatch.setenv("TPUDL_FRAME_PREPARE_WORKERS", "1")
    monkeypatch.setenv("TPUDL_FRAME_FUSE_STEPS", "2")
    monkeypatch.setenv("TPUDL_FRAME_DISPATCH_DEPTH", "4")
    monkeypatch.setenv("TPUDL_FRAME_DONATE", "0")
    JaxFrame(_columns()).map_batches(jfn, ["x", "i"], ["y", "g"],
                                     batch_size=BATCH, autotune=False)
    jrep = jobs.last_pipeline_report()
    Frame(_columns()).map_batches(tfn, ["x", "i"], ["y", "g"],
                                  batch_size=BATCH, device="cpu")
    prep = last_pipeline_report()
    for k in ("prefetch_depth", "prepare_workers", "fuse_steps",
              "dispatch_depth", "donate", "executor"):
        assert prep[k] == jrep[k], k
    assert (prep["prefetch_depth"], prep["prepare_workers"],
            prep["fuse_steps"], prep["dispatch_depth"],
            prep["donate"]) == (3, 1, 2, 4, False)


@pytest.mark.parametrize("knob,value,item", [
    ("supervise", True, "Jobs, faults and the supervisor"),
    ("autotune", True, "The rest of observability"),
])
def test_unported_knobs_raise_by_name(knob, value, item):
    """Both knobs were once refused by their ROADMAP items' names and now
    run. ``autotune=True`` ('The rest of observability') seeds the knobs
    left unset from the previous run's report at the same batch size: the
    report says so, and the rows equal the untuned run's bit for bit.
    ``supervise=True`` ('Jobs, faults and the supervisor'): a fault
    injected into the first dispatch costs one rung of the ladder, and
    the recovered outputs equal the unsupervised run's bit for bit."""
    pin = ({"batch_size": BATCH} if knob == "autotune"
           else {knob: False})
    want = Frame(_columns()).map_batches(tfn, ["x", "i"], ["y", "g"],
                                         device="cpu", autotune=False,
                                         **pin)
    assert last_pipeline_report()["autotune"] is False
    assert len(want) == ROWS
    if knob == "autotune":
        for _ in range(2):   # the second run reads the first's report
            got = Frame(_columns()).map_batches(
                tfn, ["x", "i"], ["y", "g"], device="cpu",
                batch_size=BATCH, **{knob: value})
            rep = last_pipeline_report()
            assert rep["autotune"] is True and rep["batch_size"] == BATCH
            assert set(rep["autotuned"]) <= {"fuse_steps",
                                             "dispatch_depth",
                                             "prefetch_depth"}
            _assert_same(got, want)
        return
    from tpudl_torch.testing import faults

    plan = faults.FaultPlan.raise_in_stage("dispatch")
    with plan.armed():
        got = Frame(_columns()).map_batches(
            tfn, ["x", "i"], ["y", "g"], device="cpu", autotune=False,
            **{knob: value})
    rep = last_pipeline_report()
    assert [f["point"] for f in plan.fired] == ["frame.dispatch"]
    assert rep["degraded_to"] == "dispatch_depth=1"
    assert rep["recovered_batches"] == rep["stage_calls"]["dispatch"]
    for col in ("y", "g"):
        assert np.array_equal(np.stack(list(got[col])),
                              np.stack(list(want[col])))


def test_aot_knob_runs_through_the_program_store(tmp_path, monkeypatch):
    """``aot=True`` (once refused, 'Compile') runs: outputs bit for bit the
    unarmed run, the report says so and counts the store's hits and
    misses."""
    monkeypatch.setenv("TPUDL_COMPILE_AOT", str(tmp_path / "programs"))
    want = Frame(_columns()).map_batches(tfn, ["x", "i"], ["y", "g"],
                                         device="cpu", aot=False)
    assert last_pipeline_report()["aot"] is False
    got = Frame(_columns()).map_batches(tfn, ["x", "i"], ["y", "g"],
                                        device="cpu", aot=True)
    rep = last_pipeline_report()
    assert rep["aot"] is True
    calls = rep["stage_calls"]
    assert calls.get("aot_hits", 0) + calls["aot_misses"] == \
        calls["dispatch"]
    for c in ("y", "g"):
        np.testing.assert_array_equal(np.stack(list(got[c])),
                                      np.stack(list(want[c])))


@pytest.mark.parametrize("knob,value", [
    ("cache_dir", "shards"), ("cache_key", "k"), ("device_cache", True)])
def test_data_layer_knobs_run_as_tpudls(tmp_path, knob, value):
    """The knobs the port used to refuse ('Data layer') run: outputs bit
    for bit the uncached run's, and the report says what ran, as
    tpudl's does (``cache_key`` keys a ``cache_dir``)."""
    from tpudl_torch.data import device_cache

    device_cache.reset_device_cache()
    kw = {"cache_dir": str(tmp_path / "shards")}
    if knob != "cache_dir":
        kw = {knob: value} if knob == "device_cache" else {
            **kw, knob: value}
    base = Frame(_columns()).map_batches(tfn, ["x", "i"], ["y", "g"],
                                         device="cpu")
    for _ in range(2):   # cold, then warm
        out = Frame(_columns()).map_batches(tfn, ["x", "i"], ["y", "g"],
                                            device="cpu", **kw)
        for c in ("y", "g"):
            assert np.array_equal(np.stack(list(out[c])),
                                  np.stack(list(base[c])))
    rep = last_pipeline_report()
    assert rep["batch_cache"] is ("cache_dir" in kw)
    assert rep["device_cache"] is (knob == "device_cache")
    warm = rep["stage_calls"]
    assert warm.get("hbm_hits" if knob == "device_cache"
                    else "cache_hits") == rep["stage_calls"]["dispatch"]
    device_cache.reset_device_cache()


@pytest.mark.parametrize("d_depth,fuse,want", [(1, 1, 2), (2, 1, 2),
                                               (3, 1, 3), (1, 4, 4),
                                               (2, 3, 6)])
def test_default_infeed_feeds_the_window(d_depth, fuse, want):
    """Left unset, K covers the D dispatches of M batches each that the
    window drains at a time (tpudl raises it to D; at M=1 the two agree),
    and the rows stay the serial arm's."""
    got = Frame(_columns()).map_batches(
        tfn, ["x", "i"], ["y", "g"], batch_size=2, fuse_steps=fuse,
        dispatch_depth=d_depth, device="cpu")
    rep = last_pipeline_report()
    assert rep["prefetch_depth"] == want
    assert rep["prepare_workers"] == 2
    if fuse == 1:
        JaxFrame(_columns()).map_batches(
            jfn, ["x", "i"], ["y", "g"], batch_size=2,
            dispatch_depth=d_depth, autotune=False)
        assert jobs.last_pipeline_report()["prefetch_depth"] == want
    want_rows = Frame(_columns()).map_batches(
        tfn, ["x", "i"], ["y", "g"], batch_size=2, prefetch=False,
        dispatch_depth=1, device="cpu")
    _assert_same(got, want_rows)


class _FakeStream:
    def wait_event(self, event):
        pass


class _FakeEvent:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


class _FakeGraph:
    """Stands in for a captured CUDA graph on the CPU: its replay reads
    the static input and overwrites the static output, yielding the GIL
    between the two as a card's queue would interleave."""

    def __init__(self, fused):
        self._fused = fused
        fused.static_out = (torch.empty(fused.static_in[0].numel()),)

    def replay(self):
        x = self._fused.static_in[0].reshape(-1).clone()
        time.sleep(0.0005)
        self._fused.static_out[0].copy_(2.0 * x + 1.0)


def test_fused_graph_runs_are_atomic_across_threads(monkeypatch):
    """Threads dispatch through ONE cached graph, as transforms of one
    stage on several threads do: each load, replay and clone of outputs
    must happen under the graph's lock, so each thread reads back its own
    rows. More threads than cores, and a short switch interval."""
    import sys

    from tpudl_torch.obs import PipelineReport

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    like = [torch.zeros(BATCH)]
    fused = pframe._FusedGraph(None, 2, like, 1, "cpu")
    fused.graph = _FakeGraph(fused)
    errors, start = [], threading.Event()

    def worker(seed):
        report = PipelineReport()
        rng = np.random.default_rng(seed)
        assert start.wait(timeout=10)
        for _ in range(50):
            group = [([torch.from_numpy(rng.normal(size=BATCH).astype(
                np.float32))], 0) for _ in range(2)]
            (got,) = fused.run(group, report)
            want = torch.cat([2.0 * g[0][0] + 1.0 for g in group])
            if not torch.equal(got, want):
                errors.append(seed)
                return

    threads = [threading.Thread(target=worker, args=(s,))
               for s in range(12)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        start.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_fused_graph_cache_is_bounded(monkeypatch):
    """A fn keeps at most ``_FUSED_CACHE_SIZE`` graphs, the least recently
    used going first (each released before it is dropped); a hit moves
    its graph to the back."""
    released = []
    monkeypatch.setattr(pframe._FusedGraph, "release",
                        lambda self: released.append(self))

    def fn(x):
        return x

    def group(width):
        return [([torch.zeros(2, width)], 0)] * 2

    n = pframe._FUSED_CACHE_SIZE
    graphs = [pframe._fused_graph(fn, fn, group(w), None, 1, "cpu", {})
              for w in range(1, n + 1)]
    assert pframe._fused_graph(fn, fn, group(1), None, 1, "cpu",
                               {}) is graphs[0]
    pframe._fused_graph(fn, fn, group(n + 1), None, 1, "cpu", {})
    assert len(fn._tpudl_fused) == n
    assert released == [graphs[1]]
    assert graphs[0] in fn._tpudl_fused.values()


def test_capture_counts_only_the_capturing_threads_launches(monkeypatch):
    """Launches inside a capture are recorded for the graph, not counted;
    another thread's launches meanwhile count as usual, and every replay
    adds the graph's record."""
    from tpudl_torch import cuda_ops

    monkeypatch.setattr(cuda_ops, "launch_counts",
                        dict.fromkeys(cuda_ops.launch_counts, 0))
    inside, done = threading.Event(), threading.Event()

    def other_thread():
        assert inside.wait(timeout=10)
        cuda_ops._count("flash_attn_fwd", 5)
        done.set()

    def capture():
        cuda_ops._count("flash_attn_fwd")
        inside.set()
        assert done.wait(timeout=10)
        cuda_ops._count("flash_attn_fwd")

    t = threading.Thread(target=other_thread)
    t.start()
    rec = cuda_ops.capture_launches(capture)
    t.join(timeout=10)
    assert not t.is_alive()
    assert rec["flash_attn_fwd"] == 2
    assert cuda_ops.launch_counts["flash_attn_fwd"] == 5
    cuda_ops.count_replay(rec)
    cuda_ops.count_replay(rec)
    assert cuda_ops.launch_counts["flash_attn_fwd"] == 9

