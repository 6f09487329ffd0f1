"""Parallel reads and decodes of the port's ``LazyFileColumn`` and the
``numPartition`` hint of its readers, against tpudl's on the same files:
rows equal to tpudl's for every ``decode_workers``, file reads counted
once per row, and a decoder that is not marked thread-safe serialised
across the executor's concurrent prepare workers. Exact equality."""

import threading
import time

import numpy as np
import pytest

from tpudl.image import imageIO as jio
from tpudl_torch.frame import Frame
from tpudl_torch.image import imageIO
from tpudl_torch.obs import last_pipeline_report
from torch_native_fixture import private_tpudl_decoder  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")

N_FILES = 12


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i in range(N_FILES):
        arr = rng.integers(0, 256, (8, 6, 3), dtype=np.uint8)
        ext = "png" if i % 3 else "jpg"
        Image.fromarray(arr).save(d / f"img{i:02d}.{ext}")
    (d / "zz_broken.jpg").write_bytes(b"\xff\xd8 not really")
    return str(d)


def _structs(col):
    return [None if v is None else (v["origin"], v["height"], v["width"],
                                     v["mode"], v["data"]) for v in col]


@pytest.mark.parametrize("decode_workers", [1, 4])
@pytest.mark.parametrize("num_partition", [None, 1, 4, 13])
def test_read_images_rows_match_tpudl(monkeypatch, image_dir,
                                      num_partition, decode_workers):
    monkeypatch.setenv("TPUDL_FRAME_DECODE_WORKERS", str(decode_workers))
    got = imageIO.readImages(image_dir, numPartition=num_partition)
    want = jio.readImages(image_dir, numPartition=num_partition)
    col = got["image"]
    assert col.decode_workers == decode_workers and col.io_workers == 8
    assert got.num_partitions == want.num_partitions == num_partition
    assert _structs(col[:]) == _structs(want["image"][:])
    assert col.reads == N_FILES + 1
    assert got.fingerprint() == want.fingerprint()


@pytest.mark.parametrize("io_workers", [1, 3])
def test_files_to_frame_reads_each_file_once(monkeypatch, image_dir,
                                             io_workers):
    monkeypatch.setenv("TPUDL_FRAME_IO_WORKERS", str(io_workers))
    got = imageIO.filesToFrame(image_dir, numPartitions=3)
    want = jio.filesToFrame(image_dir, numPartitions=3)
    col = got["fileData"]
    assert col.io_workers == io_workers and col.reads == 0
    assert list(col[:]) == list(want["fileData"][:])
    assert col.reads == N_FILES + 1
    assert got.num_partitions == 3
    # a lazy subset view keeps the workers
    derived = col.with_transform(lambda p, raw: len(raw))
    assert derived.io_workers == io_workers


def test_map_batches_decodes_in_the_prepare_pool(image_dir):
    """readImages → map_batches with decode on the pool: every row read
    and decoded once, rows in order."""
    frame = imageIO.readImages(image_dir, numPartition=4).dropna()
    col = frame["image"]
    reads0 = col._base.reads

    def pack(sl):
        return np.stack([np.frombuffer(v["data"], np.uint8)[:16]
                         for v in sl])

    pack.thread_safe = True
    import torch

    out = frame.map_batches(lambda x: x.to(torch.int32).sum(dim=1),
                            ["image"], ["s"], pack=pack, prepare_workers=2,
                            prefetch_depth=3, device="cpu")
    assert last_pipeline_report()["batch_size"] == 3  # ceil(12 / 4)
    want = [int(np.frombuffer(v["data"], np.uint8)[:16].astype(np.int64)
                .sum()) for v in jio.readImages(image_dir).dropna()[
                    "image"][:]]
    assert list(out["s"]) == want
    assert col._base.reads - reads0 == N_FILES


def test_unmarked_decoder_is_serialised_across_prepare_workers(image_dir):
    active, peak, lock = [0], [0], threading.Lock()

    def decode(raw):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.005)
        with lock:
            active[0] -= 1
        return np.zeros((2, 2, 3), np.uint8)

    frame = imageIO.readImagesWithCustomFn(image_dir, decode,
                                           numPartition=6)

    def pack(sl):
        return np.stack([imageIO.imageStructToArray(v) for v in sl])

    pack.thread_safe = True
    out = frame.map_batches(lambda x: x.sum(dim=(1, 2, 3)), ["image"], ["s"],
                            pack=pack, prepare_workers=2, prefetch_depth=4,
                            device="cpu")
    assert last_pipeline_report()["prepare_workers"] == 2
    assert len(out) == N_FILES + 1 and peak[0] == 1


def test_marked_decoder_runs_concurrently(image_dir):
    """A decoder marked ``thread_safe`` runs for two batches at once: each
    of the first two calls waits for the other at a barrier (a serial
    decode would break it, and the row would come back None)."""
    barrier = threading.Barrier(2, timeout=10)
    calls = [0]
    lock = threading.Lock()

    def decode(raw):
        with lock:
            calls[0] += 1
            first_two = calls[0] <= 2
        if first_two:
            barrier.wait()
        return np.zeros((2, 2, 3), np.uint8)

    decode.thread_safe = True
    frame = imageIO.readImagesWithCustomFn(image_dir, decode,
                                           numPartition=N_FILES + 1)

    def pack(sl):
        return np.stack([imageIO.imageStructToArray(v) for v in sl])

    pack.thread_safe = True
    out = frame.map_batches(lambda x: x.sum(dim=(1, 2, 3)), ["image"], ["s"],
                            pack=pack, prepare_workers=2, prefetch_depth=2,
                            device="cpu")
    assert list(out["s"]) == [0] * (N_FILES + 1)


def test_default_decode_is_marked_and_keyed_as_tpudl():
    assert imageIO.default_decode.thread_safe is True
    assert jio.default_decode.thread_safe is True
    assert imageIO._callable_token(imageIO.default_decode) == \
        "tpudl.image.imageIO|default_decode"
    from tpudl.data.dataset import _callable_token

    assert _callable_token(jio.default_decode) == \
        imageIO._callable_token(imageIO.default_decode)


@pytest.mark.parametrize("index,count", [(0, 2), (1, 2), (3, 4)])
def test_host_sharded_files_are_tpudls_share(image_dir, monkeypatch, index,
                                             count):
    """``filesToFrame(host_sharded=True)`` (once refused, 'Training,
    rest') keeps process ``index`` of ``count``'s share of the file list,
    as tpudl's does; ``Frame.from_files`` passes it on."""
    import jax

    from tpudl_torch import distributed

    monkeypatch.setattr(distributed, "process_count", lambda: count)
    monkeypatch.setattr(distributed, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: count)
    monkeypatch.setattr(jax, "process_index", lambda: index)
    got = imageIO.filesToFrame(image_dir, host_sharded=True)
    want = jio.filesToFrame(image_dir, host_sharded=True)
    assert list(got["filePath"]) == list(want["filePath"])
    assert list(Frame.from_files(image_dir, host_sharded=True)[
        "filePath"]) == list(want["filePath"])
