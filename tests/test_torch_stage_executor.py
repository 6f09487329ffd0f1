"""The image stages through the pipelined executor on the CPU: the
executor knobs reach ``map_batches`` and change no bit of the features,
the per-batch function is built once per loaded model (so a fused CUDA
graph cached on it serves every later ``transform``), and tpudl's knobs
with no counterpart yet are still refused by name."""

import numpy as np
import pytest
import torch

from tpudl_torch.frame import Frame
from tpudl_torch.image import imageArrayToStruct
from tpudl_torch.ml import DeepImageFeaturizer, DeepImagePredictor
from tpudl_torch.obs import last_pipeline_report

torch.set_num_threads(1)

MODEL = "MobileNetV2"
ROWS = 7                    # batches of 2: three full and a tail of 1


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(0)
    col = np.empty(ROWS, dtype=object)
    col[:] = [imageArrayToStruct(rng.integers(0, 256, (40, 30, 3),
                                              dtype=np.uint8))
              for _ in range(ROWS)]
    return Frame({"image": col})


def _run(stage, frame):
    out = stage.transform(frame)
    return np.stack(list(out[stage.getOutputCol()])), last_pipeline_report()


@pytest.mark.parametrize("stage_cls", [DeepImageFeaturizer,
                                       DeepImagePredictor])
def test_fused_windowed_stage_is_bitwise_the_plain_one(frame, stage_cls):
    common = dict(inputCol="image", outputCol="y", modelName=MODEL,
                  batchSize=2, device="cpu")
    plain = stage_cls(fuseSteps=1, dispatchDepth=1, **common)
    fused = stage_cls(fuseSteps=2, dispatchDepth=2, prefetchDepth=3,
                      prepareWorkers=2, **common)
    want, rep0 = _run(plain, frame)
    got, rep = _run(fused, frame)
    assert np.array_equal(got, want)
    assert (rep0["fuse_steps"], rep0["dispatch_depth"]) == (1, 1)
    assert (rep["fuse_steps"], rep["dispatch_depth"], rep["prefetch_depth"],
            rep["prepare_workers"]) == (2, 2, 3, 2)
    # three full batches: one fused pair, then the third and the tail
    assert rep["stage_calls"]["fused_dispatches"] == 1
    assert rep["stage_calls"]["dispatch"] == 3
    fn = fused._batch_fn()
    again, _ = _run(fused, frame)
    assert fused._batch_fn() is fn and np.array_equal(again, want)


def test_rewritten_weights_free_the_old_model(frame, tmp_path):
    """A rewritten ``.npz`` reloads the model; the stage keeps one
    per-batch function, so the old function and model go."""
    import gc
    import os
    import weakref

    from tpudl_torch.ml.named_image import load_named_params
    from tpudl_torch.zoo.convert import save_params_npz

    path = str(tmp_path / "MobileNetV2.npz")
    save_params_npz(load_named_params(MODEL, "random"), path)
    st = DeepImageFeaturizer(inputCol="image", outputCol="y",
                             modelName=MODEL, weights=path, batchSize=4,
                             device="cpu")
    want, _ = _run(st, frame)
    old_net, old_fn = weakref.ref(st._loaded[1]), weakref.ref(
        st._fn_entry[1])
    save_params_npz(load_named_params(MODEL, "random"), path)
    mtime = os.path.getmtime(path) + 1.0  # a coarse clock may not tick
    os.utime(path, (mtime, mtime))
    got, _ = _run(st, frame)
    gc.collect()
    assert old_net() is None and old_fn() is None
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fuse", [1, 2])
def test_mesh_stage_runs_each_entry_on_its_replica(frame, fuse):
    """``mesh`` (once refused, 'Training, rest'): over a 2-entry host mesh
    the stage builds one per-batch function a distinct device, over the
    loaded model's replica, once, and its features hold the plain stage's
    (each entry's shard runs at half the batch)."""
    from tpudl_torch import mesh as port_mesh

    mesh = port_mesh.build_mesh(devices=["cpu"] * 2)
    common = dict(inputCol="image", outputCol="y", modelName=MODEL,
                  batchSize=2)
    want, _ = _run(DeepImageFeaturizer(device="cpu", **common), frame)
    stage = DeepImageFeaturizer(mesh=mesh, fuseSteps=fuse, **common)
    got, rep = _run(stage, frame)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 2e-5 * scale
    assert rep["mesh"] == {"data": 2, "model": 1}
    assert rep["fuse_steps"] == fuse
    assert rep["stage_calls"]["pad_rows"] == 1      # the tail of 1 row
    fn = stage._batch_fn()
    assert isinstance(fn, port_mesh.PerDevice)
    assert fn.devices == [torch.device("cpu")]
    again, _ = _run(stage, frame)
    assert stage._batch_fn() is fn and np.array_equal(again, got)


@pytest.mark.parametrize("knob", ["cacheDir", "deviceCache"])
def test_data_layer_stage_knobs_replay_bitwise(frame, tmp_path, knob):
    """``cacheDir`` and ``deviceCache`` (once refused, 'Data layer') reach
    the executor: a second transform replays the prepared batches (from
    the shards, or resident) and gives the same bits."""
    from tpudl_torch.data import device_cache

    device_cache.reset_device_cache()
    value = str(tmp_path) if knob == "cacheDir" else True
    st = DeepImageFeaturizer(inputCol="image", outputCol="y", batchSize=2,
                             modelName=MODEL, device="cpu", **{knob: value})
    want, _ = _run(DeepImageFeaturizer(inputCol="image", outputCol="y",
                                       batchSize=2, modelName=MODEL,
                                       device="cpu"), frame)
    first, rep1 = _run(st, frame)
    again, rep2 = _run(st, frame)
    hits = "cache_hits" if knob == "cacheDir" else "hbm_hits"
    assert rep1["stage_calls"].get(hits) is None
    assert rep2["stage_calls"][hits] == 4
    assert np.array_equal(first, want) and np.array_equal(again, want)
    device_cache.reset_device_cache()


def test_autotune_is_refused_by_the_executor(frame):
    """Once refused ('The rest of observability'): ``autotune=True`` on a
    stage's frame runs, marks the report, seeds only tpudl's autotune
    knobs, and returns the untuned run's rows bit for bit."""
    from tpudl_torch.image import imageStructToArray

    def pack(structs):
        return np.stack([imageStructToArray(v) for v in structs]).astype(
            np.float32)

    kw = dict(device="cpu", batch_size=2, pack=pack)
    want = frame.map_batches(lambda x: x * 2, ["image"], ["y"],
                             autotune=False, **kw)
    assert last_pipeline_report()["autotune"] is False
    for _ in range(2):   # the second run reads the first's report
        got = frame.map_batches(lambda x: x * 2, ["image"], ["y"],
                                autotune=True, **kw)
        rep = last_pipeline_report()
        assert rep["autotune"] is True
        assert set(rep["autotuned"]) <= {"fuse_steps", "dispatch_depth",
                                         "prefetch_depth"}
        assert np.array_equal(np.stack(list(got["y"])),
                              np.stack(list(want["y"])))
