"""The fault-injection harness (``tpudl_torch.testing.faults``) and the
port's fault points, against tpudl's.

- a ``FaultPlan`` gives tpudl's ``to_env()`` string, and over the same
  calls the same ``fired`` sequence and actions; ``oom_error`` is a
  ``torch.cuda.OutOfMemoryError`` in the CUDA allocator's words;
- unarmed, a fault point never enters a plan (calls counted);
- the fault points fire where tpudl's do: the executor's stages, a
  training step, a program capture, the mesh's transfer edge and the
  load generator's clients;
- ``corrupt_on_read``, a deleted shard and ``transient_io`` give tpudl's
  counters and the same outputs;
- ``require_hbm_fit`` refuses with tpudl's message, and
  ``bytes_per_device`` counts a split layout as tpudl's ``shard_shape``;
- every ``# copied from tpudl/...`` block of the slice's new modules is
  its source's code (docstrings aside, tpudl's lock sanitizer read as a
  plain lock)."""

import ast
import os
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl import mesh as jmesh
from tpudl.data.shards import ShardCache as JaxShardCache
from tpudl.frame import Frame as JaxFrame
from tpudl.frame import supervisor as jsup
from tpudl.obs import flight as jflight
from tpudl.obs import metrics as jmetrics
from tpudl.testing import faults as jfaults

import test_torch_boundary as B
from tpudl_torch import mesh as M
from tpudl_torch.data.shards import ShardCache
from tpudl_torch.frame import Frame
from tpudl_torch.frame import supervisor as sup
from tpudl_torch.obs import flight, metrics
from tpudl_torch.testing import faults

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.setenv("TPUDL_RETRY_IO_BACKOFF_S", "0")
    monkeypatch.delenv("TPUDL_DATA_HBM_BUDGET_MB", raising=False)
    monkeypatch.delenv("TPUDL_FRAME_DEGRADE", raising=False)
    for f, rec in ((faults, flight), (jfaults, jflight)):
        f.disarm()
        rec.get_recorder().reset()
    yield
    faults.disarm()
    jfaults.disarm()


# -- the plan ------------------------------------------------------------------

def _plans(f):
    return {
        "kill_at_step": f.FaultPlan.kill_at_step(7),
        "raise_in_stage": f.FaultPlan.raise_in_stage("dispatch", 2,
                                                     "ValueError"),
        "transient_io": f.FaultPlan.transient_io(3),
        "delay": f.FaultPlan.delay("frame.dispatch", 0.0, first_calls=2),
        "burst": f.FaultPlan.burst(5, at_call=2),
        "slow_client": f.FaultPlan.slow_client(0.0),
        "oom": f.FaultPlan.oom(at_call=2, nbytes=4096),
        "corrupt_on_read": f.FaultPlan.corrupt_on_read(at_call=1),
        "several": f.FaultPlan(
            f.FaultPlan.raise_in_stage("prepare").rules
            + [{"point": "shards.read", "action": "unlink",
                "when": {"index": 3}}]
            + f.FaultPlan.burst(2).rules),
    }


@pytest.mark.parametrize("name", sorted(_plans(faults)))
def test_plan_env_string_equals_tpudls(name, monkeypatch):
    ours, theirs = _plans(faults)[name], _plans(jfaults)[name]
    assert ours.to_env() == theirs.to_env()
    monkeypatch.setenv(faults.PLAN_ENV, ours.to_env())
    armed = faults.install_from_env()
    try:
        assert armed.to_env() == ours.to_env()
    finally:
        faults.disarm()


CALLS = ([("frame.dispatch", {"index": i}) for i in range(4)]
         + [("io.read", {"path": "/nowhere"})] * 4
         + [("serve.tick", {"tick": i, "client": 0}) for i in range(3)]
         + [("serve.client", {"client": 0, "i": i}) for i in range(2)]
         + [("train.step", {"step": s}) for s in (6, 7, 8)]
         + [("frame.prepare", {"index": 0})] * 2)


def _drive(f, plan):
    """Every call of ``CALLS`` through ``plan``: ``(fired, outcomes)``,
    an outcome the raised type's kind or the returned payload."""
    outcomes = []
    with plan.armed():
        for point, ctx in CALLS:
            if point == "train.step" and any(
                    r.action == "sigterm" for r in plan.rules):
                continue   # a SIGTERM would end this process
            try:
                outcomes.append(f.fire(point, **ctx))
            except Exception as e:
                kind = sup.classify_exception(e)
                outcomes.append(("raised", kind, type(e).__name__
                                 if kind != "oom" else "oom"))
    return plan.fired, outcomes


@pytest.mark.parametrize("name", sorted(set(_plans(faults)) - {
    "corrupt_on_read"}))
def test_fired_sequence_equals_tpudls(name):
    assert _drive(faults, _plans(faults)[name]) == _drive(
        jfaults, _plans(jfaults)[name])


def test_oom_error_is_the_cuda_allocators():
    e = faults.oom_error(4096, point="frame.dispatch call 1")
    assert isinstance(e, torch.cuda.OutOfMemoryError)
    assert str(e) == ("CUDA out of memory. Tried to allocate 4096 bytes. "
                      "[frame.dispatch call 1]")
    assert sup.classify_exception(e) == "oom"
    assert jsup.classify_exception(jfaults.oom_error(4096)) == "oom"


def test_every_fired_fault_lands_in_the_error_ring():
    plan = faults.FaultPlan.burst(3)
    with plan.armed():
        assert faults.fire("serve.tick", tick=1, client=0) == 3
    ring = flight.get_recorder().snapshot()["errors"]
    assert [(e["kind"], e["point"], e["action"], e["tick"]) for e in ring] \
        == [("fault.injected", "serve.tick", "burst", 1)]


def test_an_unarmed_point_never_enters_a_plan(monkeypatch):
    """The unarmed cost, by counting: no plan's ``fire`` runs while none
    is armed; armed, one call a firing."""
    entered = []
    orig = faults.FaultPlan.fire
    monkeypatch.setattr(faults.FaultPlan, "fire",
                        lambda self, point, **ctx: entered.append(point)
                        or orig(self, point, **ctx))
    x = {"x": np.arange(24, dtype=np.float32).reshape(12, 2)}
    Frame(x).map_batches(lambda t: t * 2, ["x"], ["y"], device="cpu",
                         batch_size=4)
    assert entered == []
    with faults.FaultPlan([]).armed():
        Frame(x).map_batches(lambda t: t * 2, ["x"], ["y"], device="cpu",
                             batch_size=4, prefetch=False)
    assert sorted(set(entered)) == ["frame.d2h", "frame.dispatch",
                                    "frame.h2d", "frame.prepare"]
    assert entered.count("frame.dispatch") == 3


# -- the fault points ------------------------------------------------------------

def _points(f, run):
    plan = f.FaultPlan([{"point": p, "action": "delay", "seconds": 0.0}
                        for p in ("frame.prepare", "frame.dispatch",
                                  "train.step", "mesh.transfer",
                                  "serve.tick", "serve.client")])
    with plan.armed():
        run()
    return [(e["point"], e.get("index", e.get("step"))) for e in plan.fired]


def test_the_executors_points_fire_as_tpudls():
    x = {"x": np.arange(40, dtype=np.float32).reshape(20, 2)}
    kw = dict(batch_size=4, fuse_steps=2, dispatch_depth=2)
    ours = _points(faults, lambda: Frame(x).map_batches(
        lambda t: t * 2, ["x"], ["y"], device="cpu", **kw))
    theirs = _points(jfaults, lambda: JaxFrame(x).map_batches(
        jax.jit(lambda t: t * 2), ["x"], ["y"], autotune=False, **kw))
    assert sorted(ours) == sorted(theirs)
    assert [p for p, _ in ours].count("frame.dispatch") == 3


def test_a_training_step_fires_train_step_as_tpudls():
    import optax

    from tpudl.train import Trainer as JaxTrainer
    from tpudl.zoo.transformer import TinyCausalLM as JaxLM
    from tpudl_torch.train import Trainer, sgd
    from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

    arch = dict(vocab=64, dim=32, heads=2, layers=2, max_len=64)
    params = JaxLM(**arch).init(0)
    toks = np.random.default_rng(0).integers(0, 64, (2, 9)).astype(np.int32)
    lm = TinyCausalLM(device="cpu", **arch)
    load_jax_params(lm, params)
    ours = _points(faults, lambda: Trainer(lm.loss_fn(), sgd(0.1)).fit(
        lm, lambda s: toks, 3))
    theirs = _points(jfaults, lambda: JaxTrainer(
        JaxLM(**arch).loss_fn(), optax.sgd(0.1)).fit(
            jax.tree.map(jnp.asarray, params), lambda s: toks, 3))
    assert ours == theirs == [("train.step", s) for s in range(3)]


def test_a_capture_fires_compile_precompile(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDL_COMPILE_AOT", str(tmp_path / "programs"))
    from tpudl_torch.compile import reset_program_store

    reset_program_store()
    plan = faults.FaultPlan([{"point": "compile.precompile",
                              "action": "raise", "exc": "OSError"}])
    x = {"x": np.arange(8, dtype=np.float32).reshape(4, 2)}

    def fn(t):
        return t + 1

    try:
        with plan.armed(), pytest.raises(OSError):
            Frame(x).map_batches(fn, ["x"], ["y"], device="cpu",
                                 batch_size=4)
        assert [f["point"] for f in plan.fired] == ["compile.precompile"]
        assert len(plan.fired[0]["key"]) == 12
    finally:
        reset_program_store()


def test_the_mesh_transfer_edge_fires_mesh_transfer():
    mesh = M.build_mesh(devices=["cpu", "cpu"])
    ours = _points(faults, lambda: M.transfer_batch(
        [torch.zeros(4, 2)], mesh))
    assert ours == [("mesh.transfer", None)]
    plan = faults.FaultPlan([{"point": "mesh.transfer", "action": "raise",
                              "exc": "OSError", "first_calls": 1}])
    x = {"x": np.arange(16, dtype=np.float32).reshape(8, 2)}
    want = Frame(x).map_batches(lambda t: t * 2, ["x"], ["y"], mesh=mesh,
                                batch_size=4)
    with plan.armed():
        got = Frame(x).map_batches(lambda t: t * 2, ["x"], ["y"], mesh=mesh,
                                   batch_size=4, supervise=True)
    assert np.array_equal(np.stack(list(got["y"])),
                          np.stack(list(want["y"])))
    assert len(plan.fired) == 1


def test_the_load_generators_clients_fire_tick_and_client():
    import tpudl_torch.serve as tserve

    class Instant:
        def submit(self, prompt, max_new, **kw):
            raise tserve.AdmissionError("full", reason="queue_full")

    plan = faults.FaultPlan.burst(2, at_call=1)
    with plan.armed():
        out = tserve.run_closed_loop(Instant(), lambda i: [1], requests=3,
                                     clients=1, timeout=5)
    # the burst's two extra submits are rejected like the three others
    assert out["rejected"] == 3 + 2
    ours = _points(faults, lambda: tserve.run_closed_loop(
        Instant(), lambda i: [1], requests=3, clients=1, timeout=5))
    assert [p for p, _ in ours] == ["serve.tick", "serve.client"] * 3


# -- shards and file reads: tpudl's counters ------------------------------------

SHARD_COUNTERS = ("data.cache.corrupt", "data.cache.evicted",
                  "data.cache.misses", "data.cache.hits")


@pytest.mark.parametrize("rule", [
    {"point": "shards.read", "action": "corrupt", "at_call": 1},
    {"point": "shards.read", "action": "unlink", "at_call": 1},
    {"point": "shards.read", "action": "corrupt", "at_call": 2},
])
def test_a_shard_fault_gives_tpudls_counters_and_outputs(tmp_path, rule):
    arr = np.arange(8, dtype=np.float32)
    got = {}
    for side, cls, f, m, rec in (
            ("port", ShardCache, faults, metrics, flight),
            ("tpudl", JaxShardCache, jfaults, jmetrics, jflight)):
        cache = cls(str(tmp_path / side), "k1")
        cache.put(0, [arr])
        before = {n: m.counter(n).value for n in SHARD_COUNTERS}
        with f.FaultPlan([rule]).armed():
            first = cache.get(0)
            second = cache.get(0)
        kinds = [e["kind"] for e in rec.get_recorder().snapshot()["errors"]]
        got[side] = (
            None if first is None else np.asarray(first[0]).tolist(),
            None if second is None else np.asarray(second[0]).tolist(),
            {n: m.counter(n).value - before[n] for n in SHARD_COUNTERS},
            kinds.count("data.cache.corrupt"), len(cache))
    assert got["port"] == got["tpudl"]


def test_a_failing_shard_write_retries_under_the_io_policy(tmp_path):
    arr = np.arange(8, dtype=np.float32)
    before = metrics.counter("retry.data.cache.write").value
    plan = faults.FaultPlan.transient_io(2, point="shards.write")
    cache = ShardCache(str(tmp_path), "k1")
    with plan.armed():
        cache.put(0, [arr])
    assert metrics.counter("retry.data.cache.write").value == before + 2
    assert np.array_equal(cache.get(0)[0], arr)


@pytest.mark.parametrize("first_calls,recovers", [(2, True), (3, False)])
def test_transient_io_on_file_reads_gives_tpudls_counters(
        tmp_path, first_calls, recovers):
    from tpudl.image.imageIO import filesToFrame as jfiles
    from tpudl_torch.image.imageIO import filesToFrame

    for i in range(3):
        (tmp_path / f"f{i}.bin").write_bytes(bytes([i]) * (10 + i))
    got = {}
    for side, files, f, m in (("port", filesToFrame, faults, metrics),
                              ("tpudl", jfiles, jfaults, jmetrics)):
        col = files(str(tmp_path))["fileData"]
        before = m.counter("retry.imageio.read").value
        with f.FaultPlan.transient_io(first_calls).armed():
            try:
                out = [bytes(col[i]) for i in range(3)]
            except OSError as e:
                out = type(e).__name__
        got[side] = (out, m.counter("retry.imageio.read").value - before)
    assert got["port"] == got["tpudl"]
    assert (got["port"][0] != "OSError") == recovers


# -- the placement gate ----------------------------------------------------------

def test_require_hbm_fit_refuses_with_tpudls_message(monkeypatch):
    tree = {"w": np.zeros((512, 256), np.float32),
            "b": np.zeros((256,), np.float32)}
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", "0.25")
    with pytest.raises(sup.DeviceOOM) as ours:
        M.require_hbm_fit(tree, what="replicated tree")
    with pytest.raises(jsup.DeviceOOM) as theirs:
        jmesh.require_hbm_fit(tree, what="replicated tree")
    assert str(ours.value) == str(theirs.value)
    assert "TPUDL_DATA_HBM_BUDGET_MB grants 0.2 MB" in str(ours.value)
    with pytest.raises(sup.DeviceOOM):
        M.replicate(tree, M.build_mesh(devices=["cpu", "cpu"]))
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", "1")
    M.require_hbm_fit(tree)            # fits
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", "0")
    M.require_hbm_fit(tree)            # 0 forbids residency, not placements
    monkeypatch.delenv("TPUDL_DATA_HBM_BUDGET_MB")
    M.require_hbm_fit(tree)            # unarmed without an explicit budget


def test_bytes_per_device_of_a_split_layout_equals_tpudls(monkeypatch):
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpudl.zoo.transformer import TinyCausalLM as JaxLM
    from tpudl_torch.zoo.transformer import TinyCausalLM

    arch = dict(vocab=64, dim=32, heads=2, layers=2, max_len=64)
    params = JaxLM(**arch).init(0)
    jm = JaxMesh(np.array(jax.devices("cpu")[:2]).reshape(1, 2),
                 ("data", "model"))
    want = jmesh.bytes_per_device(params, JaxLM(**arch).param_shardings(jm))
    lm = TinyCausalLM(device="cpu", **arch)
    mesh = M.build_mesh(1, 2, devices=["cpu", "cpu"])
    got = M.bytes_per_device(lm._param_tree(), lm.param_shardings(mesh))
    assert got == want
    assert M.bytes_per_device(lm._param_tree()) == \
        jmesh.bytes_per_device(params)
    assert NamedSharding and P    # jax's sharding types, used above
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", str(got / 2**20 * 0.99))
    with pytest.raises(sup.DeviceOOM, match="TinyCausalLM:v64:d32:h2"):
        lm.shard_params(mesh)
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", str(got / 2**20 * 1.01))
    lm.shard_params(mesh)
    assert M.bytes_per_device(lm._param_tree(),
                              lm.param_shardings(mesh)) == got


# -- the copies ------------------------------------------------------------------

_NEW = ("testing/faults.py", "obs/flight.py", "frame/supervisor.py",
        "jobs/spec.py", "jobs/runtime.py")


def _copied_blocks():
    out = []
    for sub in _NEW:
        text = (REPO / "tpudl_torch" / sub).read_text()
        out += [(sub, src, qual) for src, qual, _ in B._COPIED.findall(text)]
    return out


@pytest.mark.parametrize("sub,src,qual", _copied_blocks())
def test_copied_block_equals_its_tpudl_source(sub, src, qual):
    ours = ast.parse((REPO / "tpudl_torch" / sub).read_text())
    theirs = B._ServeHooks().visit(ast.parse((REPO / src).read_text()))
    assert B._code_of(ours, qual) == B._code_of(theirs, qual), \
        f"tpudl_torch/{sub}:{qual} drifted from {src}"


def test_the_new_modules_copy_what_they_can():
    blocks = _copied_blocks()
    assert len(blocks) >= 40
    assert {s for s, _, _ in blocks} == set(_NEW)
    for sub in _NEW:
        text = (REPO / "tpudl_torch" / sub).read_text()
        assert not re.search(r"^\s*(?:from|import)\s+(?:jax|tpudl)\b",
                             text, re.MULTILINE)
    assert os.path.isfile(REPO / "tests" / "torch_jobs_fns.py")
