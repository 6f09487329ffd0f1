"""The executor's fused dispatch on the card: a CUDA graph of InceptionV3
in bf16, captured while other threads pin host memory, replays bitwise
what the eager per-batch path computes. Marked ``cuda``: it skips without
an NVIDIA GPU. The repo's ``conftest.py`` hides the card and imports jax,
so run it on a machine with a card as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_executor_card.py

A capture in CUDA's ``global`` mode fails when another thread pins memory
(``cudaHostAlloc``, ``cudaHostRegister``) meanwhile, as the prepare pool
does; the executor captures in ``thread_local`` mode. Bitwise: the graph
replays the kernels the eager call launches, on the same inputs."""

import threading
import time

import numpy as np
import pytest
import torch

from tpudl_torch.frame import Frame
from tpudl_torch.image import imageArrayToStruct
from tpudl_torch.ml import DeepImageFeaturizer
from tpudl_torch.obs import last_pipeline_report

ROWS, BATCH = 40, 8        # 5 batches: two fused pairs and one alone


def _frame():
    rng = np.random.default_rng(0)
    col = np.empty(ROWS, dtype=object)
    col[:] = [imageArrayToStruct(rng.integers(0, 256, (299, 299, 3),
                                              dtype=np.uint8))
              for _ in range(ROWS)]
    return Frame({"image": col})


@pytest.mark.cuda
def test_fused_bf16_graph_captured_while_the_pool_pins_is_bitwise_eager():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    frame = _frame()
    common = dict(inputCol="image", outputCol="f", modelName="InceptionV3",
                  computeDtype="bfloat16", batchSize=BATCH)
    eager = DeepImageFeaturizer(fuseSteps=1, dispatchDepth=1, **common)
    want = np.stack(list(eager.transform(frame)["f"]))

    cudart = torch.cuda.cudart()
    buf = np.empty(1 << 22, np.uint8)
    stop, pins = threading.Event(), [0]

    def pinner():
        # pin and unpin host memory for as long as the capture may run
        while not stop.is_set():
            if int(cudart.cudaHostRegister(buf.ctypes.data, buf.nbytes,
                                           0)) == 0:
                cudart.cudaHostUnregister(buf.ctypes.data)
                pins[0] += 1
            time.sleep(0)

    fused = DeepImageFeaturizer(fuseSteps=2, dispatchDepth=2,
                                prefetchDepth=4, prepareWorkers=2, **common)
    t = threading.Thread(target=pinner)
    t.start()
    try:
        got = np.stack(list(fused.transform(frame)["f"]))
        rep = last_pipeline_report()
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive() and pins[0] > 0
    assert rep["stage_calls"]["fused_dispatches"] == 2
    assert got.shape == (ROWS, 2048) and np.isfinite(got).all()
    assert np.array_equal(got, want)
    # the cached graph replays on a second transform, bitwise again
    again = np.stack(list(fused.transform(frame)["f"]))
    assert np.array_equal(again, want)
    deadline = time.monotonic() + 10
    while any(th.name.startswith("tpudl-infeed")
              for th in threading.enumerate()) and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    assert not any(th.name.startswith("tpudl-infeed")
                   for th in threading.enumerate())


@pytest.mark.cuda
def test_two_threads_transform_through_one_stages_graph():
    """Two threads transform different frames with ONE fused stage, whose
    cached graph both replay: each thread's rows are bitwise the eager
    rows of its own frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    common = dict(inputCol="image", outputCol="f", modelName="ResNet50",
                  computeDtype="bfloat16", batchSize=BATCH)
    frames = []
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        col = np.empty(4 * BATCH, dtype=object)
        col[:] = [imageArrayToStruct(rng.integers(0, 256, (224, 224, 3),
                                                  dtype=np.uint8))
                  for _ in range(4 * BATCH)]
        frames.append(Frame({"image": col}))
    eager = DeepImageFeaturizer(fuseSteps=1, dispatchDepth=1, **common)
    wants = [np.stack(list(eager.transform(f)["f"])) for f in frames]
    fused = DeepImageFeaturizer(fuseSteps=2, dispatchDepth=2, **common)
    fused.transform(frames[0])  # captures the one graph both threads use
    start, results, errors = threading.Event(), {}, []

    def worker(i):
        try:
            assert start.wait(timeout=10)
            results[i] = [np.stack(list(fused.transform(frames[i])["f"]))
                          for _ in range(4)]
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    start.set()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(fused._fn_entry[1]._tpudl_fused) == 1
    for i, want in enumerate(wants):
        for got in results[i]:
            assert np.array_equal(got, want)
