"""The port's local mesh (``tpudl_torch.mesh``) and ``Frame.map_batches(
mesh=)`` against tpudl's mesh executor on the tests' 8 simulated devices.

The port's mesh is ``build_mesh(devices=["cpu"] * 8)``: eight entries on
the host, each running its contiguous shard of a batch. The cases are
tpudl's own (``tests/test_mesh_executor.py``): the depth × donate × fuse
matrix, the u8 codec, a ragged tail, an indivisible batch size, a host
function, the ``TPUDL_MESH_FAST_PATH=0`` arm and the report's keys. The
function's arithmetic is exact in f32 (small integers times 3, plus
0.5, summed), so every output is held bit for bit: to tpudl's mesh run,
to the port's run without a mesh, and across the port's arms."""

import threading

import numpy as np
import pytest

import jax
import torch

from tpudl import mesh as jax_mesh
from tpudl import obs as jobs
from tpudl.frame import Frame as JaxFrame
from tpudl.frame import frame as jframe
from tpudl_torch import mesh as M
from tpudl_torch.frame import Frame
from tpudl_torch.frame import frame as pframe
from tpudl_torch.obs import last_pipeline_report, metrics

torch.set_num_threads(1)

ENV = ("TPUDL_FRAME_PREFETCH", "TPUDL_FRAME_PREFETCH_DEPTH",
       "TPUDL_FRAME_PREPARE_WORKERS", "TPUDL_FRAME_FUSE_STEPS",
       "TPUDL_FRAME_DISPATCH_DEPTH", "TPUDL_FRAME_DONATE",
       "TPUDL_FRAME_AUTOTUNE", "TPUDL_MESH_FAST_PATH", "TPUDL_WIRE_CODEC",
       "TPUDL_DATA_CACHE_DIR", "TPUDL_DATA_DEVICE_CACHE", "TPUDL_WIRE_MBPS",
       "TPUDL_COMPILE_BUCKETS", "TPUDL_MESH_MODEL")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def cpu8():
    return M.build_mesh(devices=["cpu"] * 8)


@jax.jit
def jfn(b):
    return (b * 3.0 + 0.5).sum(axis=1)


def tfn(b):
    return (b * 3.0 + 0.5).sum(dim=1)


def _x(n=40, cols=6, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, cols)).astype(np.float32)


def _y(frame):
    return np.asarray(list(frame["y"]), np.float32)


def _single(x, fn=tfn, batch_size=8):
    """The port's serial run without a mesh."""
    return _y(Frame({"x": x}).map_batches(
        fn, ["x"], ["y"], batch_size=batch_size, prefetch=False,
        dispatch_depth=1, device="cpu"))


def _tpudl(x, mesh, batch_size=8, **kw):
    out = JaxFrame({"x": x}).map_batches(
        jfn, ["x"], ["y"], batch_size=batch_size, mesh=mesh,
        autotune=False, **kw)
    return _y(out), jobs.last_pipeline_report()


CONFIG_KEYS = ("mesh", "fuse_steps", "dispatch_depth", "donate", "executor",
               "batch_size", "rows")


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("fuse", [1, 4])
def test_depth_donate_fuse_matrix_bitwise(cpu8, mesh8, depth, donate, fuse):
    """Every depth × donate × fuse cell on the mesh is bit for bit the run
    without one and tpudl's mesh run, and reports what tpudl reports."""
    x = _x()
    want, jrep = _tpudl(x, mesh8, dispatch_depth=depth, donate=donate,
                        fuse_steps=fuse)
    got = _y(Frame({"x": x}).map_batches(
        tfn, ["x"], ["y"], batch_size=8, mesh=cpu8, dispatch_depth=depth,
        donate=donate, fuse_steps=fuse))
    rep = last_pipeline_report()
    assert np.array_equal(got, want) and np.array_equal(got, _single(x))
    for k in CONFIG_KEYS:
        assert rep[k] == jrep[k], k
    assert rep["mesh"] == {"data": 8, "model": 1}
    assert rep["stage_calls"].get("fused_dispatches") == \
        jrep["stage_calls"].get("fused_dispatches")


def test_u8_codec_fused_async_donating_mesh_bitwise(cpu8, mesh8):
    x = _x()
    want, _ = _tpudl(x, mesh8, wire_codec="u8", fuse_steps=4,
                     dispatch_depth=4, donate=True)
    got = _y(Frame({"x": x}).map_batches(
        tfn, ["x"], ["y"], batch_size=8, mesh=cpu8, wire_codec="u8",
        fuse_steps=4, dispatch_depth=4, donate=True))
    assert np.array_equal(got, want)
    rep = last_pipeline_report()
    assert rep["mesh"] == {"data": 8, "model": 1}
    # 40 rows at batch 8: 5 full batches, one fused group of 4
    assert rep["stage_calls"].get("fused_dispatches") == 1


def test_ragged_tail_pads_and_unpads(cpu8, mesh8):
    """21 rows at batch 8: the 5-row tail pads to 8 (row 0 repeated) and
    its 3 pad rows leave the outputs; the pad gauges move as tpudl's."""
    x = _x(n=21)
    want, jrep = _tpudl(x, mesh8, fuse_steps=2, dispatch_depth=4)
    jsnap = jobs.snapshot()
    got = _y(Frame({"x": x}).map_batches(
        tfn, ["x"], ["y"], batch_size=8, mesh=cpu8, fuse_steps=2,
        dispatch_depth=4))
    assert np.array_equal(got, want) and len(got) == 21
    rep = last_pipeline_report()
    assert rep["stage_calls"]["pad_rows"] == jrep["stage_calls"]["pad_rows"]\
        == 3
    assert rep["mesh_pad_rows_max"] == jrep["mesh_pad_rows_max"] == 3
    assert metrics.gauge("frame.mesh.pad_rows").value == \
        jsnap["frame.mesh.pad_rows"]["value"] == 3
    assert metrics.gauge("frame.mesh.pad_overhead_pct").value == \
        pytest.approx(jsnap["frame.mesh.pad_overhead_pct"]["value"])
    assert metrics.gauge("frame.mesh.pad_overhead_pct").value == \
        pytest.approx(100.0 * 3 / 24)


def test_indivisible_batch_size_disables_fusion_not_parity(cpu8, mesh8):
    x = _x(n=30)
    want, jrep = _tpudl(x, mesh8, batch_size=6, fuse_steps=4,
                        dispatch_depth=2)
    got = _y(Frame({"x": x}).map_batches(
        tfn, ["x"], ["y"], batch_size=6, mesh=cpu8, fuse_steps=4,
        dispatch_depth=2))
    assert np.array_equal(got, want)
    rep = last_pipeline_report()
    assert rep["fuse_steps"] == jrep["fuse_steps"] == 1
    assert "fused_dispatches" not in rep["stage_calls"]
    # every batch of 6 pads 2 rows to the 8-entry axis
    assert rep["stage_calls"]["pad_rows"] == 5 * 2


@pytest.mark.parametrize("batch_size,fast,want", [
    (8, "1", True), (16, "1", True), (6, "1", False), (8, "0", False)])
def test_mesh_fuse_ok_is_tpudls(cpu8, mesh8, monkeypatch, batch_size, fast,
                                want):
    monkeypatch.setenv("TPUDL_MESH_FAST_PATH", fast)
    assert pframe.mesh_fuse_ok(batch_size, cpu8) is want
    assert jframe.mesh_fuse_ok(batch_size, mesh8) is want
    assert pframe.mesh_fuse_ok(batch_size, None) is True


def test_host_fn_under_mesh_stays_serial_and_unfused(cpu8):
    """A numpy function under a mesh runs serial and unfused, on the
    caller's thread, as tpudl keeps a function it cannot jit."""
    names = []

    def host_fn(b):
        names.append(threading.current_thread().name)
        return np.asarray(b).sum(axis=1)

    x = _x()
    out = Frame({"x": x}).map_batches(host_fn, ["x"], ["y"], batch_size=8,
                                      mesh=cpu8, fuse_steps=4,
                                      dispatch_depth=4)
    assert np.array_equal(_y(out), x.sum(axis=1))
    rep = last_pipeline_report()
    assert rep["fuse_steps"] == 1 and rep["dispatch_depth"] == 1
    assert rep["donate"] is False
    assert "fused_dispatches" not in rep["stage_calls"]
    assert set(names) == {threading.current_thread().name}
    assert len(names) == 5 * 8   # one call an entry a batch


def test_mesh_fast_path_kill_switch(cpu8, mesh8, monkeypatch):
    """``TPUDL_MESH_FAST_PATH=0``: serial dispatch, no fusion, no
    donation, blocking transfers — and the same bits."""
    monkeypatch.setenv("TPUDL_MESH_FAST_PATH", "0")
    x = _x()
    want, jrep = _tpudl(x, mesh8, fuse_steps=4, dispatch_depth=4,
                        donate=True)
    got = _y(Frame({"x": x}).map_batches(
        tfn, ["x"], ["y"], batch_size=8, mesh=cpu8, fuse_steps=4,
        dispatch_depth=4, donate=True))
    assert np.array_equal(got, want)
    rep = last_pipeline_report()
    for k in ("fuse_steps", "dispatch_depth", "donate", "autotune"):
        assert rep[k] == jrep[k], k
    assert (rep["fuse_steps"], rep["dispatch_depth"], rep["donate"]) == \
        (1, 1, False)


def test_report_carries_mesh_shape_stages_and_window(cpu8, mesh8):
    x = _x(n=64)
    _tpudl(x, mesh8, dispatch_depth=3)
    Frame({"x": x}).map_batches(tfn, ["x"], ["y"], batch_size=8, mesh=cpu8,
                                dispatch_depth=3)
    rep = last_pipeline_report()
    assert rep["mesh"] == {"data": 8, "model": 1}
    assert rep["executor"] == "pipelined"
    assert "h2d" in rep["stage_seconds"]
    assert "dispatch_wait" in rep["stage_seconds"]
    assert 1 <= rep["dispatch_inflight_max"] <= 3
    assert rep["mesh_pad_rows_max"] == 0
    assert rep["device"] == ",".join(["cpu"] * 8)
    assert metrics.gauge("frame.mesh.model_axis").value == 1


def test_run_without_a_mesh_reports_no_mesh_keys():
    Frame({"x": _x(n=16)}).map_batches(tfn, ["x"], ["y"], batch_size=8,
                                       device="cpu")
    rep = last_pipeline_report()
    assert rep["mesh"] is None
    assert "mesh_pad_rows_max" not in rep


def test_mesh_of_one_is_the_run_without_one_bit_for_bit():
    """A one-entry mesh runs the same batches through the same function:
    no pad rows, the same bits and the same fused grouping at M=1."""
    x = _x(n=37)
    one = M.build_mesh(devices=["cpu"])
    for kw in ({}, {"fuse_steps": 2, "dispatch_depth": 3}):
        got = _y(Frame({"x": x}).map_batches(tfn, ["x"], ["y"],
                                             batch_size=8, mesh=one, **kw))
        rep = last_pipeline_report()
        assert rep["mesh"] == {"data": 1, "model": 1}
        assert rep["stage_calls"].get("pad_rows") is None
        assert np.array_equal(got, _single(x))


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["cpu"] * 3, ["cpu"] * 5])
def test_each_entry_runs_its_contiguous_shard(devices):
    """Entry i of an n-entry mesh gets rows [i·B/n, (i+1)·B/n) of the
    padded batch, and the outputs come back in row order."""
    mesh = M.build_mesh(devices=devices)
    seen = []

    def fn(b):
        seen.append(b[:, 0].clone())
        return b[:, 0] * 2

    x = np.arange(22, dtype=np.float32)[:, None].repeat(2, axis=1)
    out = Frame({"x": x}).map_batches(fn, ["x"], ["y"], batch_size=10,
                                      mesh=mesh)
    assert np.array_equal(np.asarray(out["y"]), x[:, 0] * 2)
    n = len(devices)
    assert len(seen) == n * 3
    padded = -(-10 // n) * n
    assert all(len(s) == padded // n for s in seen[:n])
    assert np.array_equal(torch.cat(seen[:n]).numpy()[:10], x[:10, 0])


def test_build_mesh_local_forms_and_refusals(monkeypatch):
    mesh = M.build_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.local and mesh.shape == {"data": 3, "model": 1}
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.distinct_devices() == [torch.device("cpu")]
    assert M.build_mesh(2, devices=["cpu"] * 8).shape["data"] == 2
    assert jax_mesh.build_mesh(2, devices=jax.devices()).shape["data"] == 2
    with pytest.raises(ValueError, match="needs 9 devices"):
        M.build_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        M.build_mesh()          # no silent drop to the host
    with pytest.raises(RuntimeError, match="is_available"):
        M.build_mesh(devices=["cuda:0"])
    # a model axis (once refused, 'LM parallelism'): tpudl's row-major
    # (data, model) grid; a row's first card is its data-axis entry
    monkeypatch.setenv("TPUDL_MESH_MODEL", "2")
    grid = M.build_mesh(devices=["cpu:0", "cpu:1", "cpu:2", "cpu:3"])
    assert grid.shape == {"data": 2, "model": 2}
    assert [[d.index for d in row] for row in grid.grid] == [[0, 1], [2, 3]]
    assert [d.index for d in grid.devices] == [0, 2]
    assert grid.row(1).grid == (grid.grid[1],)


def test_a_process_group_mesh_is_refused_by_the_executor():
    group_mesh = M.Mesh(2, 0, torch.device("cpu"), object())
    assert not group_mesh.local and group_mesh.devices == (
        torch.device("cpu"),)
    with pytest.raises(ValueError, match="one card a process"):
        Frame({"x": _x(n=8)}).map_batches(tfn, ["x"], ["y"],
                                          mesh=group_mesh)


def test_replicate_makes_one_copy_a_device_once():
    lin = torch.nn.Linear(3, 2)
    mesh = M.build_mesh(devices=["cpu"] * 4)
    reps = M.replicate(lin, mesh)
    assert list(reps) == [torch.device("cpu")]
    assert reps[torch.device("cpu")] is lin     # already there: itself
    tree = {"w": torch.ones(2), "b": [torch.zeros(1)]}
    placed = M.replicate(tree, mesh)[torch.device("cpu")]
    assert torch.equal(placed["w"], tree["w"]) and placed["w"] is not \
        tree["w"]
    # a module on another device is deep-copied there once and cached
    first = M._copy_to(lin, torch.device("meta"))
    assert first is not lin and first is M._copy_to(lin,
                                                    torch.device("meta"))
    assert first.weight.device == torch.device("meta")
    assert lin.weight.device == torch.device("cpu")


def test_transfer_reduce_and_broadcast_on_repeated_devices():
    mesh = M.build_mesh(devices=["cpu"] * 4)
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    shards = M.transfer_batch([x, x[:, 0]], mesh)
    assert [s[0].shape[0] for s in shards] == [2] * 4
    assert torch.equal(torch.cat([s[0] for s in shards]), x)
    with pytest.raises(ValueError, match="does not split over 4"):
        M.transfer_batch([x[:7]], mesh)
    per_entry = M.shard_batch((x.numpy(), x[:, 0].numpy()), mesh)
    assert len(per_entry) == 4 and isinstance(per_entry[0], tuple)
    assert torch.equal(per_entry[3][0], x[6:])
    parts = [[torch.full((2,), float(i)), torch.ones(1) * i]
             for i in range(4)]
    summed = M.reduce_add(parts, mesh.devices)
    assert torch.equal(summed[0], torch.full((2,), 6.0))
    assert torch.equal(parts[0][0], torch.zeros(2))   # inputs untouched
    reps = [[torch.zeros(2)] for _ in range(4)]
    M.broadcast([torch.ones(2)], reps, mesh.devices)
    assert all(torch.equal(r[0], torch.ones(2)) for r in reps[1:])
    assert torch.equal(reps[0][0], torch.zeros(2))


def test_per_device_dispatches_on_its_argument():
    fn = M.PerDevice({"cpu": lambda t: t + 1})
    assert torch.equal(fn(torch.zeros(2)), torch.ones(2))
    assert fn.devices == [torch.device("cpu")]
    with pytest.raises(ValueError, match="no replica on meta"):
        fn(torch.zeros(2, device="meta"))
