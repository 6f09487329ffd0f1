"""The mesh through the data layer, the estimator and the process group,
held to tpudl on the CPU: the device cache's topology keys (an entry made
for one mesh misses on any other), ``Dataset(mesh=)`` residency as
per-entry shards, trial slices, ``KerasImageFileEstimator`` training
data-parallel over a mesh (``fit``) and over trial slices
(``fitMultiple``), and ``host_sharded`` reads and a ``tcp://<host>``
rendezvous over two gloo processes.

The port's mesh is ``build_mesh(devices=["cpu"] * n)``; tpudl's is
``build_mesh(devices=jax.devices()[:n])`` on the tests' 8 simulated
devices. Executor outputs are exact in f32 and held bit for bit; a
data-parallel fit sums its shards' gradients in another order than
tpudl's SPMD step, so its losses are held within 2e-5."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl import distributed as jax_distributed
from tpudl import mesh as jax_mesh
from tpudl.data import Dataset as JaxDataset
from tpudl.frame import Frame as JaxFrame
from tpudl.ml import hpo as jax_hpo
from tpudl_torch import mesh as M
from tpudl_torch.data import Dataset
from tpudl_torch.data import device_cache as dc
from tpudl_torch.frame import Frame
from tpudl_torch.ml import hpo
from tpudl_torch.obs import metrics

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 2e-5


def _snap(name):
    return metrics.snapshot().get(name, {}).get("value", 0.0)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("TPUDL_DATA_HBM_BUDGET_MB", "TPUDL_DATA_DEVICE_CACHE",
              "TPUDL_WIRE_CODEC", "TPUDL_DATA_CACHE_DIR",
              "TPUDL_MESH_FAST_PATH", "TPUDL_FRAME_PREFETCH",
              "TPUDL_FRAME_FUSE_STEPS", "TPUDL_MESH_MODEL"):
        monkeypatch.delenv(k, raising=False)
    dc.reset_device_cache()
    yield
    dc.reset_device_cache()


def _cpu(n):
    return M.build_mesh(devices=["cpu"] * n)


def _x(n=64, cols=8, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, cols)).astype(np.float32)


def tfn(b):
    return (b * 2.0 + 1.0).sum(dim=1)


def _y(frame):
    return np.asarray(frame["y"], np.float32)


# -- the device cache under a mesh -------------------------------------------

def test_topology_mismatch_is_a_miss():
    """tpudl's case: entries made for the 8-entry mesh miss on a 4-entry
    mesh and on a run without a mesh, and each topology then replays its
    own resident set (4 batches a run)."""
    x = _x()
    want = 2.0 * x.sum(axis=1) + x.shape[1]
    kw = dict(batch_size=16, device_cache=True)
    f = Frame({"x": x})
    assert np.array_equal(_y(f.map_batches(tfn, ["x"], ["y"], mesh=_cpu(8),
                                           **kw)), want)
    hits0 = _snap("data.hbm.hits")
    y4 = _y(f.map_batches(tfn, ["x"], ["y"], mesh=_cpu(4), **kw))
    assert np.array_equal(y4, want)
    assert _snap("data.hbm.hits") - hits0 == 0
    hits1 = _snap("data.hbm.hits")
    assert np.array_equal(_y(f.map_batches(tfn, ["x"], ["y"], device="cpu",
                                           **kw)), want)
    assert _snap("data.hbm.hits") - hits1 == 0
    hits2 = _snap("data.hbm.hits")
    shipped = _snap("frame.stage.h2d.seconds")
    y8 = _y(f.map_batches(tfn, ["x"], ["y"], mesh=_cpu(8), **kw))
    assert np.array_equal(y8, want)
    assert _snap("data.hbm.hits") - hits2 == 4
    assert _snap("frame.stage.h2d.seconds") == shipped   # nothing shipped


def test_resident_batches_are_per_entry_shards():
    f = Frame({"x": _x(n=40)})
    mesh = _cpu(4)
    f.map_batches(tfn, ["x"], ["y"], batch_size=8, mesh=mesh,
                  device_cache=True)
    cache = dc.get_device_cache()
    assert len(cache) == 5
    key = next(iter(cache._entries))
    assert key[0].endswith("|mesh=data=4,model=1|dev=cpu,cpu,cpu,cpu")
    entry = cache._entries[key]
    (col,) = entry.arrays
    assert isinstance(col, M.Sharded) and len(col) == 4
    assert [t.shape[0] for t in col] == [2] * 4
    assert entry.nbytes == col.nbytes == 8 * 8 * 4


@pytest.mark.parametrize("codec", [None, "u8"])
def test_dataset_mesh_epoch2_ships_zero_and_matches_tpudl(mesh8, codec):
    """``Dataset(mesh=, device_cache=True)``: epoch 1 places each batch as
    its per-entry shards, epoch 2 replays them with no wire bytes; the
    ragged tail (3 rows over 8 entries) stays a host batch, as tpudl's;
    every batch's rows are tpudl's."""
    x = _x(n=35).astype(np.uint8)
    ds = Dataset(Frame({"x": x}), ["x"], batch_size=16, wire_codec=codec,
                 device_cache=True, mesh=_cpu(8))
    first = [b[0] for b in ds.iter_epoch(0)]
    shipped, hits = _snap("data.wire.bytes_shipped"), _snap("data.hbm.hits")
    again = [b[0] for b in ds.iter_epoch(1)]
    assert _snap("data.hbm.hits") - hits == 2
    assert all(isinstance(b, M.Sharded) for b in again[:2])
    assert [len(b) for b in again[:2]] == [8, 8]
    assert all(a is b for a, b in zip(first[:2], again[:2]))
    assert not isinstance(again[2], M.Sharded)      # 3 rows: no split
    assert _snap("data.wire.bytes_shipped") - shipped == (
        3 * 8 if codec else 0)   # only the host tail ships (u8: 1 B a value)
    jds = JaxDataset(JaxFrame({"x": x}), ["x"], batch_size=16,
                     wire_codec=codec, device_cache=True, mesh=mesh8)
    want = [np.asarray(b[0]) for b in jds.iter_epoch(0)]
    def host(b):
        return (torch.cat(list(b)).numpy() if isinstance(b, M.Sharded)
                else np.asarray(b))

    for got, w in zip(again, want):
        assert np.array_equal(host(got), w)
    restored = ds.device_restore((again[0],))[0]
    assert np.array_equal(host(restored),
                          np.asarray(jds.device_restore((want[0],))[0]))


# -- trial slices ------------------------------------------------------------

@pytest.mark.parametrize("n_devices,n_trials,widths", [
    (8, 3, [3, 3, 2]), (4, 2, [2, 2]), (2, 5, [1, 1])])
def test_mesh_slices_are_tpudls(n_devices, n_trials, widths):
    ours = hpo.device_slices(n_trials, _cpu(n_devices).devices)
    theirs = jax_hpo.device_slices(
        n_trials, jax_mesh.build_mesh(
            devices=jax.devices()[:n_devices]).devices.flat)
    assert [len(s) for s in ours] == [len(s) for s in theirs] == widths
    assert sum(ours, []) == list(_cpu(n_devices).devices)


# -- the estimator over a mesh -----------------------------------------------

keras = pytest.importorskip("keras")

import torch_keras_models as KM  # noqa: E402
from PIL import Image  # noqa: E402

from tpudl.ml import KerasImageFileEstimator as JaxEstimator  # noqa: E402
from tpudl_torch.ingest.kerasfile import load_keras_file  # noqa: E402
from tpudl_torch.ml import KerasImageFileEstimator  # noqa: E402


def _loader(uri):
    img = Image.open(uri).convert("RGB").resize((32, 32), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


@pytest.fixture(scope="module")
def fit_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_est")
    rng = np.random.default_rng(0)
    uris, labels = [], []
    for i in range(24):
        arr = rng.integers(0, 255, size=(40, 40, 3), dtype=np.uint8)
        p = str(d / f"im{i}.png")
        Image.fromarray(arr).save(p)
        uris.append(p)
        labels.append(np.eye(2, dtype=np.float32)[i % 2])
    lab = np.empty(len(labels), dtype=object)
    lab[:] = labels
    return KM.saved("cnn", d), np.array(uris, dtype=object), lab


def _kw(path, **fit):
    return dict(inputCol="uri", outputCol="out", labelCol="label",
                imageLoader=_loader, modelFile=path, kerasOptimizer="adam",
                kerasLoss="categorical_crossentropy",
                kerasFitParams={"epochs": 2, "batch_size": 8, **fit})


def _jax_steps(est, frame):
    """Fit tpudl's estimator and record its per-step losses."""
    steps = []
    get_step = est._get_step

    def recording(*a, **k):
        entry = get_step(*a, **k)
        inner = entry.step

        def step(p, s, xb, yb):
            out = inner(p, s, xb, yb)
            steps.append(float(out[2]))
            return out

        entry.step = step
        return entry

    est._get_step = recording
    return est.fit(frame), steps


@pytest.mark.parametrize("fit", [{}, {"batch_size": 7, "shuffle": False}])
def test_fit_over_a_mesh_matches_tpudls_sub_mesh(fit_set, fit):
    """``fit`` on an estimator with a 2-entry mesh trains data-parallel
    over it: per-step losses within 2e-5 of tpudl's estimator over 2 of
    its devices (batch 7 rounds up to 8 on both), the trained file within
    1e-3 of the update, and the single-entry fit's losses too."""
    path, uris, labels = fit_set
    frame = Frame({"uri": uris, "label": labels})
    jmodel, jsteps = _jax_steps(
        JaxEstimator(mesh=jax_mesh.build_mesh(devices=jax.devices()[:2]),
                     **_kw(path, **fit)),
        JaxFrame({"uri": uris, "label": labels}))
    model = KerasImageFileEstimator(mesh=_cpu(2), **_kw(path, **fit)).fit(
        frame)
    single = KerasImageFileEstimator(device="cpu", **_kw(
        path, **dict(fit, batch_size=8))).fit(frame)
    steps = model.history["step_loss"]
    assert len(steps) == len(jsteps) == 2 * 3
    np.testing.assert_allclose(steps, jsteps, atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(steps, single.history["step_loss"],
                               atol=LOSS_ATOL, rtol=0)
    assert model.mesh is not None and model.mesh.size == 2
    _cfg, trained = load_keras_file(model.getModelFile())
    _cfg, plain = load_keras_file(single.getModelFile())
    _cfg, start = load_keras_file(path)
    top = max(np.abs(plain[k] - start[k]).max() for k in start)
    for k in start:
        assert np.abs(trained[k] - plain[k]).max() <= 1e-3 * top, k
    for m in (model, single, jmodel):
        os.remove(m.getModelFile())


def test_first_step_gradients_sum_the_shards(fit_set):
    """One sgd step over a 3-entry mesh moves the variables as the same
    step on one device does: the shards' weighted gradients sum to the
    batch's."""
    path, uris, labels = fit_set
    kw = _kw(path, epochs=1, batch_size=24, shuffle=False)
    kw["kerasOptimizer"] = "sgd"
    est = KerasImageFileEstimator(mesh=_cpu(3), **kw)
    frame = Frame({"uri": uris, "label": labels})
    X, y = est._getNumpyFeaturesAndLabels(frame)
    gin = est._ingest()
    meshed, _, m_steps = est._train_one(gin, X, y)
    single, _, s_steps = est._train_one(gin, X, y, "cpu")
    assert abs(m_steps[0] - s_steps[0]) <= LOSS_ATOL
    start = {k: torch.from_numpy(np.asarray(v)) for k, v in
             gin.params.items()}
    top = max(float((single[k].detach() - start[k]).abs().max())
              for k in start if start[k].is_floating_point())
    for k in start:
        err = float((meshed[k].detach() - single[k].detach()).abs().max())
        assert err <= 1e-4 * top, k


@pytest.mark.parametrize("n", [2, 4])
def test_adam_sharded_gradients_hold_float64_like_tpudls(fit_set, n):
    """An adam fit over ``n`` entries, checked where a fault would sit:
    before each of 3 optimizer steps, the gradients of ``sharded_backward``
    over the mesh and of tpudl's step differentiated over ``n`` of its
    devices, both at the port's current weights, within phase 14's 1e-2
    of the largest gradient of a float64 run of the whole batch on one
    device. Losses after adam steps drift further apart than gradients
    do (its first steps are ~lr·sign(g)), so they are not what is held."""
    from jax.sharding import NamedSharding, PartitionSpec

    from tpudl.ml.losses import get_loss as jax_get_loss
    from tpudl_torch.ml.estimator import sharded_backward
    from tpudl_torch.ml.losses import (get_loss, get_optimizer_dynamic,
                                       set_learning_rate)

    path, uris, labels = fit_set
    kw = _kw(path, epochs=1, batch_size=8, shuffle=False)
    frame = Frame({"uri": uris, "label": labels})
    est = KerasImageFileEstimator(mesh=_cpu(n), **kw)
    X, y = est._getNumpyFeaturesAndLabels(frame)
    gin = est._ingest()
    _model, jgin, _keys = JaxEstimator(**kw)._ingest()
    assert sorted(jgin.params) == sorted(gin.params)
    jmesh = jax_mesh.build_mesh(devices=jax.devices()[:n])
    data = NamedSharding(jmesh, PartitionSpec(jmesh.axis_names[0]))
    jloss, japply = jax_get_loss("categorical_crossentropy"), jgin.make_fn()
    jgrad = jax.jit(jax.grad(lambda p, xb, yb: jloss(japply(p, xb), yb)))
    loss_fn, apply_fn = get_loss("categorical_crossentropy"), gin.make_fn()
    mesh = _cpu(n)
    params = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in gin.params.items()}
    factory, lr = get_optimizer_dynamic("adam")
    opt = factory(list(params.values()))
    set_learning_rate(opt, lr)
    replicas = [params] + [{k: t.detach().clone().requires_grad_()
                            for k, t in params.items()}
                           for _ in range(n - 1)]
    for step in range(3):
        xb, yb = X[8 * step:8 * step + 8], y[8 * step:8 * step + 8]
        grads, _ = sharded_backward(apply_fn, loss_fn, replicas,
                                    M.shard_batch((xb, yb), mesh),
                                    mesh.devices)
        p64 = {k: t.detach().double().requires_grad_()
               for k, t in params.items()}
        loss_fn(apply_fn(p64, torch.from_numpy(xb).double()),
                torch.from_numpy(yb).double()).backward()
        ref = {k: t.grad.numpy() for k, t in p64.items()}
        top = max(float(np.abs(g).max()) for g in ref.values())
        theirs = jgrad({k: jnp.asarray(t.detach().numpy())
                        for k, t in params.items()},
                       jax.device_put(xb, data), jax.device_put(yb, data))
        for k, g in ref.items():
            ours = np.abs(grads[k].double().numpy() - g).max() / top
            tpudls = np.abs(np.asarray(theirs[k], np.float64) - g).max() / top
            assert ours <= 1e-2 and tpudls <= 1e-2, (step, k, ours, tpudls)
        for k, g in grads.items():
            params[k].grad = g
        opt.step()
        M.broadcast(list(params.values()),
                    [list(rep.values()) for rep in replicas], mesh.devices)


def test_fit_multiple_trains_each_trial_over_its_slice(fit_set,
                                                      monkeypatch):
    """A 4-entry mesh and 2 trials: each trial trains data-parallel over
    a 2-entry slice (tpudl's carving), with the losses of a fit over a
    2-entry mesh, and its model runs over the estimator's mesh."""
    path, uris, labels = fit_set
    frame = Frame({"uri": uris, "label": labels})
    widths = []
    train_one = KerasImageFileEstimator._train_one

    def recording(self, gin, X, y, devices=None):
        widths.append(len(devices))
        return train_one(self, gin, X, y, devices)

    monkeypatch.setattr(KerasImageFileEstimator, "_train_one", recording)
    est = KerasImageFileEstimator(mesh=_cpu(4), **_kw(path, epochs=1))
    maps = [{est.kerasFitParams: {"epochs": 1, "batch_size": b}}
            for b in (8, 6)]
    models = dict(est.fitMultiple(frame, maps))
    assert sorted(models) == [0, 1] and widths == [2, 2]
    assert [len(s) for s in jax_hpo.device_slices(
        2, jax.devices()[:4])] == [2, 2]
    monkeypatch.undo()
    for i in (0, 1):
        solo = KerasImageFileEstimator(mesh=_cpu(2), **_kw(
            path, **maps[i][est.kerasFitParams])).fit(frame)
        np.testing.assert_allclose(models[i].history["step_loss"],
                                   solo.history["step_loss"],
                                   atol=LOSS_ATOL, rtol=0)
        assert models[i].mesh is est.mesh
        os.remove(solo.getModelFile())
        os.remove(models[i].getModelFile())


# -- host_sharded and a tcp:// rendezvous over two processes -----------------

_RANK = r"""
import json, sys
import torch
import torch.distributed as dist
from tpudl_torch import distributed as D
from tpudl_torch.image import imageIO

rank, address, directory = int(sys.argv[1]), sys.argv[2], sys.argv[3]
D.initialize(address, 2, rank, backend="gloo")
t = torch.tensor([rank + 1.0])
dist.all_reduce(t)
frame = imageIO.filesToFrame(directory, host_sharded=True)
print(json.dumps({"count": D.process_count(), "index": D.process_index(),
                  "sum": float(t), "paths": list(frame["filePath"]),
                  "read": len(imageIO.readImagesWithCustomFn(
                      directory, imageIO.default_decode,
                      host_sharded=True))}))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def test_host_sharded_over_two_gloo_processes(tmp_path):
    """Two processes join ``tcp://<this host's name>:<port>`` (a
    coordinator named by host, as on another machine) and each keeps
    tpudl's ``host_shard`` of the 5 files: 3 and 3, the second wrapping to
    the first file."""
    for i in range(5):
        Image.fromarray(np.full((4, 4, 3), i, np.uint8)).save(
            tmp_path / f"f{i}.png")
    address = f"tcp://{socket.gethostname()}:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(rank), address, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    paths = sorted(str(tmp_path / f"f{i}.png") for i in range(5))
    for rank, got in enumerate(outs):
        assert (got["count"], got["index"], got["sum"]) == (2, rank, 3.0)
        assert got["paths"] == jax_distributed.host_shard(
            paths, index=rank, count=2)
        assert got["read"] == 3
    assert outs[1]["paths"][-1] == paths[0]


def test_initialize_takes_a_bare_host_and_port(monkeypatch):
    """tpudl's ``coordinator_address`` is ``host:port``; the port reads it
    as ``tcp://host:port`` (here a one-process group)."""
    import torch.distributed as dist

    from tpudl_torch import distributed as D

    D.initialize(f"{socket.gethostname()}:{_free_port()}", 1, 0,
                 backend="gloo")
    try:
        assert D.process_count() == 1 and D.is_primary()
    finally:
        dist.destroy_process_group()
