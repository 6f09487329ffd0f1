"""The port's ``Frame`` surface against tpudl's on the same columns:
``fingerprint`` (hex-equal on numpy, object and lazy columns, so one
prepared-batch cache can later serve both packages), ``concat``,
``take``, ``limit``, ``with_column_renamed``, ``iter_batches``,
``rows``/``collect`` and the ``num_partitions`` hint through every
row operation. Exact equality throughout."""

import numpy as np
import pytest

from tpudl.frame import Frame as JaxFrame
from tpudl.frame import concat as jconcat
from tpudl.image import imageIO as jio
from tpudl_torch.frame import Frame, concat
from tpudl_torch.image import imageIO
from torch_native_fixture import private_tpudl_decoder  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")


def _cols():
    obj = np.empty(5, dtype=object)
    obj[:] = [{"origin": "a", "height": 1, "width": 2, "nChannels": 1,
               "mode": 0, "data": b"\x01\x02"}, b"raw", None,
              np.arange(3, dtype=np.int16), "text"]
    return {"f": np.array([1.0, np.nan, 3.0, 4.0, 5.0]),
            "i": np.arange(5, dtype=np.int64),
            "m": np.arange(10, dtype=np.float32).reshape(5, 2),
            "o": obj}


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (9 + i, 7, 3),
                                     dtype=np.uint8)).save(d / f"i{i}.png")
    (d / "broken.jpg").write_bytes(b"not an image")
    return str(d)


@pytest.mark.parametrize("cols", [None, ["f"], ["i", "m"], ["o"],
                                  ["o", "f"]])
def test_fingerprint_hex_equals_tpudl_eager(cols):
    assert Frame(_cols()).fingerprint(cols) == \
        JaxFrame(_cols()).fingerprint(cols)


def test_fingerprint_moves_with_content():
    a = Frame(_cols()).fingerprint()
    cols = _cols()
    cols["m"][2, 1] += 1
    assert Frame(cols).fingerprint() != a
    assert Frame(_cols()).fingerprint(["i", "f"]) != \
        Frame(_cols()).fingerprint(["f", "i"])


@pytest.mark.parametrize("view", ["whole", "dropna", "head", "take"])
@pytest.mark.parametrize("source", ["bytes", "readImages", "custom"])
def test_fingerprint_hex_equals_tpudl_lazy(image_dir, source, view):
    def custom(raw):
        return None

    if source == "bytes":
        got, want = (imageIO.filesToFrame(image_dir),
                     jio.filesToFrame(image_dir))
    elif source == "readImages":
        got, want = imageIO.readImages(image_dir), jio.readImages(image_dir)
    else:
        got = imageIO.readImagesWithCustomFn(image_dir, custom)
        want = jio.readImagesWithCustomFn(image_dir, custom)
    if view == "dropna":
        got, want = got.dropna(), want.dropna()
    elif view == "head":
        got, want = got.head(3), want.head(3)
    elif view == "take":
        got, want = got.take([4, 0, 0, 2]), want.take([4, 0, 0, 2])
    assert got.fingerprint() == want.fingerprint()
    # the fingerprint read no file (dropna's null scan read each once)
    col = got[got.columns[-1]]
    base = getattr(col, "_base", col)
    assert base.reads == (len(base) if view == "dropna"
                          and source != "bytes" else 0)


def test_lazy_column_without_fingerprint_raises():
    from tpudl_torch.frame import LazyColumn

    class Opaque(LazyColumn):
        def __len__(self):
            return 2

        def _get(self, idx):
            out = np.empty(len(idx), dtype=object)
            out[:] = [int(i) for i in idx]
            return out

    with pytest.raises(ValueError, match="cache_key"):
        Frame({"x": Opaque()}).fingerprint()
    assert Opaque().subset([1]).fingerprint() is None


@pytest.mark.parametrize("n_frames", [1, 2, 3])
def test_concat_matches_tpudl(image_dir, n_frames):
    parts = [(Frame(_cols(), num_partitions=4).take([k, 4 - k]),
              JaxFrame(_cols(), num_partitions=4).take([k, 4 - k]))
             for k in range(n_frames)]
    got = concat([p for p, _ in parts])
    want = jconcat([w for _, w in parts])
    assert got.columns == want.columns
    assert got.num_partitions == want.num_partitions == 4
    assert got.fingerprint() == want.fingerprint()
    lazy = concat([imageIO.filesToFrame(image_dir),
                   imageIO.filesToFrame(image_dir).head(2)])
    jlazy = jconcat([jio.filesToFrame(image_dir),
                     jio.filesToFrame(image_dir).head(2)])
    assert list(lazy["fileData"]) == list(jlazy["fileData"])
    with pytest.raises(ValueError, match="schema"):
        concat([Frame({"a": [1]}), Frame({"b": [1]})])
    with pytest.raises(ValueError, match="zero"):
        concat([])


@pytest.mark.parametrize("op", ["select", "with_column", "rename", "drop",
                                "filter_rows", "take", "dropna", "head",
                                "limit"])
def test_row_ops_match_tpudl_and_keep_num_partitions(op):
    calls = {
        "select": lambda f: f.select("i", "o"),
        "with_column": lambda f: f.with_column("z", np.ones(5)),
        "rename": lambda f: f.with_column_renamed("i", "k"),
        "drop": lambda f: f.drop("m"),
        "filter_rows": lambda f: f.filter_rows([1, 0, 1, 1, 0]),
        "take": lambda f: f.take([3, 3, 0]),
        "dropna": lambda f: f.dropna(["f", "o"]),
        "head": lambda f: f.head(-2),
        "limit": lambda f: f.limit(2),
    }
    got = calls[op](Frame(_cols(), num_partitions=3))
    want = calls[op](JaxFrame(_cols(), num_partitions=3))
    assert got.num_partitions == want.num_partitions == 3
    assert got.columns == want.columns and len(got) == len(want)
    assert got.fingerprint() == want.fingerprint()
    assert list(got.to_dict()) == list(want.to_dict())


def test_rows_collect_iter_batches_match_tpudl():
    got, want = Frame(_cols()), JaxFrame(_cols())
    assert list(got.iter_batches(2)) == list(want.iter_batches(2)) == \
        [(0, 2), (2, 4), (4, 5)]
    for g, w in zip(got.collect(), want.collect()):
        assert list(g) == list(w)
        assert g["i"] == w["i"] and np.array_equal(g["m"], w["m"])
    with pytest.raises(ValueError, match="existing"):
        got.with_column_renamed("i", "f")


def test_from_files_is_lazy_and_carries_num_partitions(image_dir):
    got = Frame.from_files(image_dir, num_partitions=2)
    want = JaxFrame.from_files(image_dir, num_partitions=2)
    assert got.num_partitions == want.num_partitions == 2
    assert got["fileData"].reads == 0
    assert got.fingerprint() == want.fingerprint()
    # host_sharded (once refused, 'Training, rest'): outside a process
    # group this process's share is every file, as in tpudl
    shard = Frame.from_files(image_dir, host_sharded=True)
    jshard = JaxFrame.from_files(image_dir, host_sharded=True)
    assert list(shard["filePath"]) == list(jshard["filePath"])
    assert shard.fingerprint() == jshard.fingerprint()
