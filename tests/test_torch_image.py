"""The port's image layer against tpudl's: the device prologue
(``tpudl_torch.image.ops``), image I/O (``tpudl_torch.image.imageIO``),
the host libjpeg decoder (``tpudl_torch.native``) and the lazy-column
parts of ``tpudl_torch.frame``, on the same seeded images and files.

Tolerances: the resize, 4e-3 absolute on values in [0, 255] — both
packages compute the antialiased triangle weights in f32; against the
exact result (the same weights in f64) both read up to 4.7e-3 off on a
480×640 → 299×299 shrink, and 1.8e-3 from each other (a resize without
antialiasing misses by tens). Everything else here — casts, flips,
structs, decodes, host resizes, row filters — is held exactly."""

import io

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from PIL import Image

from tpudl import native as jnative
from tpudl.frame import Frame as JaxFrame
from tpudl.image import imageIO as jio
from tpudl.image import ops as jops
from tpudl_torch import _build, native
from tpudl_torch.frame import Frame, LazyColumn
from tpudl_torch.image import imageIO, ops
from tpudl_torch.ml.tf_image import _pack_image_structs
from tpudl_torch.obs import metrics
from torch_native_fixture import private_tpudl_decoder  # noqa: F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")

torch.set_num_threads(1)

RESIZE_TOL = 4e-3


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _weights(n_in, n_out):
    """jax.image.resize's antialiased linear weights (in, out), in f64."""
    inv = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    return w / w.sum(axis=0, keepdims=True)


# (batch shape, target (h, w), channel orders in → out)
PROLOGUE_CASES = {
    "downscale 480x640": ((1, 480, 640, 3), (299, 299), ("BGR", "RGB")),
    "upscale 64x64": ((2, 64, 64, 3), (299, 299), ("BGR", "RGB")),
    "identity": ((2, 299, 299, 3), (299, 299), ("BGR", "RGB")),
    "BGRA keeps alpha": ((2, 40, 50, 4), (31, 77), ("BGR", "RGB")),
    "RGB in, no flip": ((1, 33, 20, 3), (16, 48), ("RGB", "RGB")),
}


@pytest.mark.parametrize("case", sorted(PROLOGUE_CASES))
def test_to_model_input_matches_tpudl(case):
    shape, (h, w), (cin, cout) = PROLOGUE_CASES[case]
    b = _u8(shape)
    want = np.asarray(jops.to_model_input(jnp.asarray(b), h, w, cin, cout))
    got = ops.to_model_input(torch.from_numpy(b), h, w, cin, cout)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == want.shape
    if (h, w) == shape[1:3]:
        np.testing.assert_array_equal(got, want)
        return
    assert np.abs(got - want).max() <= RESIZE_TOL
    # and against the exact weights (f64), which tpudl's result also meets
    flip = {3: [2, 1, 0], 4: [2, 1, 0, 3]}[shape[3]] if cin != cout else \
        list(range(shape[3]))
    exact = np.einsum("bhwc,hH,wW->bHWc", b[..., flip].astype(np.float64),
                      _weights(shape[1], h), _weights(shape[2], w),
                      optimize=True)
    assert np.abs(got - exact).max() <= 5e-3
    assert np.abs(want - exact).max() <= 5e-3


def test_resize_is_antialiased():
    """A plain bilinear shrink (no antialiasing) lands tens away from
    tpudl's on noise, far outside the tolerance the test above holds."""
    b = _u8((1, 480, 640, 3))
    want = np.asarray(jops.resize_bilinear(jnp.asarray(b), 299, 299))
    got = ops.resize_bilinear(torch.from_numpy(b), 299, 299).numpy()
    assert np.abs(got - want).max() <= RESIZE_TOL
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(b).float().permute(0, 3, 1, 2), size=(299, 299),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - want).max() > 10.0


def test_converter_flattener_and_refusals():
    b = _u8((2, 4, 5, 3))
    np.testing.assert_array_equal(
        ops.sp_image_converter(torch.from_numpy(b)).numpy(),
        np.asarray(jops.sp_image_converter(jnp.asarray(b))))
    np.testing.assert_array_equal(
        ops.flattener(torch.from_numpy(b)).numpy(),
        np.asarray(jops.flattener(jnp.asarray(b))))
    with pytest.raises(ValueError, match="grayscale"):
        ops.sp_image_converter(torch.from_numpy(b), "BGR", "L")
    with pytest.raises(ValueError, match="unsupported channel order"):
        ops.sp_image_converter(torch.from_numpy(b), "BGR", "XYZ")


# -- structs and decoding ------------------------------------------------

@pytest.mark.parametrize("mode", [t.name for t in jio.supportedImageTypes()])
def test_struct_round_trip_matches_tpudl(mode):
    t = imageIO.imageTypeByName(mode)
    assert (t.ord, t.nChannels, t.dtype) == tuple(
        getattr(jio.imageTypeByName(mode), k)
        for k in ("ord", "nChannels", "dtype"))
    shape = (5, 7, t.nChannels)
    arr = (_u8(shape) if t.dtype == "uint8"
           else np.random.default_rng(1).normal(size=shape).astype(np.float32))
    got = imageIO.imageArrayToStruct(arr, origin="o")
    assert got == jio.imageArrayToStruct(arr, origin="o")
    assert got["mode"] == t.ord
    np.testing.assert_array_equal(imageIO.imageStructToArray(got), arr)
    assert imageIO.imageTypeByOrdinal(t.ord) == t


def test_struct_refusals():
    with pytest.raises(KeyError):
        imageIO.imageTypeByOrdinal(99)
    with pytest.raises(KeyError):
        imageIO.imageTypeByName("CV_16UC3")
    with pytest.raises(ValueError, match="dtype"):
        imageIO.imageArrayToStruct(np.zeros((2, 2, 3), np.int16))
    with pytest.raises(ValueError, match="nChannels"):
        imageIO.imageArrayToStruct(np.zeros((2, 2, 2), np.uint8))
    assert imageIO.SPARK_MODE.BGR == "BGR" and imageIO.SPARK_MODE.GRAY == "L"


def _encoded(fmt, shape, seed=0, mode="RGB"):
    arr = _u8(shape, seed)
    buf = io.BytesIO()
    kw = {"quality": 90} if fmt == "JPEG" else {}
    Image.fromarray(arr, mode=mode).save(buf, format=fmt, **kw)
    return buf.getvalue()


BLOBS = {
    "jpeg": lambda: _encoded("JPEG", (37, 53, 3)),
    "jpeg gray": lambda: _encoded("JPEG", (24, 31), 1, mode="L"),
    "png": lambda: _encoded("PNG", (20, 30, 3), 2),
    "png rgba": lambda: _encoded("PNG", (9, 11, 4), 3, mode="RGBA"),
    "garbage": lambda: b"\xff\xd8 not an image",
    "truncated jpeg": lambda: _encoded("JPEG", (40, 40, 3), 4)[:200],
}


@pytest.mark.parametrize("blob", sorted(BLOBS))
def test_decoders_match_tpudl(blob):
    raw = BLOBS[blob]()
    assert imageIO._jpeg_dims(raw) == jio._jpeg_dims(raw)
    assert imageIO.default_probe(raw) == jio.default_probe(raw)
    for got, want in ((imageIO.PIL_decode(raw, "o"), jio.PIL_decode(raw, "o")),
                      (imageIO.default_decode(raw, "o"),
                       jio.default_decode(raw, "o")),
                      (imageIO.PIL_decode_and_resize(raw, (13, 17)),
                       jio.PIL_decode_and_resize(raw, (13, 17)))):
        assert got == want
    if blob in ("garbage", "truncated jpeg"):
        assert imageIO.default_decode(raw) is None
    if blob == "png":   # stored BGR
        rgb = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        np.testing.assert_array_equal(
            imageIO.imageStructToArray(imageIO.PIL_decode(raw)),
            rgb[:, :, ::-1])


@pytest.mark.parametrize("size", [None, (29, 31), (5, 80)])
def test_native_decoder_bit_equal_to_tpudl(size, private_tpudl_decoder):
    assert native.available() and jnative.available()
    assert jnative.lib_path() == str(private_tpudl_decoder)
    blobs = [_encoded("JPEG", (37, 53, 3), s) for s in range(3)]
    blobs.insert(1, b"garbage")
    blobs.append(_encoded("JPEG", (24, 31), 5, mode="L"))
    h, w = size or (37, 53)
    if size is None:
        blobs = [b for b in blobs if imageIO._jpeg_dims(b) in (None, (h, w))]
    got, ok = native.decode_resize_batch(blobs, h, w, n_threads=2)
    want, jok = jnative.decode_resize_batch(blobs, h, w, n_threads=2)
    np.testing.assert_array_equal(ok, jok)
    assert not ok[1] and ok[0]
    np.testing.assert_array_equal(got, want)
    # host code: built beside the kernels, but not one of them
    assert native.lib_path().parent == _build.BUILD_DIR
    assert "decode" not in _build.sources()


@pytest.mark.parametrize("channels,dtype", [(3, "uint8"), (4, "uint8"),
                                            (1, "uint8"), (3, "float32")])
def test_resize_image_matches_tpudl(channels, dtype):
    shape = (21, 34, channels)
    arr = (_u8(shape) if dtype == "uint8" else
           np.random.default_rng(2).uniform(0, 255, shape).astype(np.float32))
    row = imageIO.imageArrayToStruct(arr, origin="o")
    assert imageIO.resizeImage(row, 10, 13) == jio.resizeImage(row, 10, 13)
    assert imageIO.createResizeImageUDF((9, 5))(row) == \
        jio.createResizeImageUDF((9, 5))(row)
    assert imageIO.resizeImage(row, 21, 34) is row


# -- lazy reads ------------------------------------------------------------

@pytest.fixture
def image_dir(tmp_path):
    """5 JPEGs of two sizes, a PNG and a garbage file (7 files)."""
    for i in range(5):
        (tmp_path / f"img{i}.jpg").write_bytes(
            _encoded("JPEG", (30 + 4 * (i % 2), 40, 3), i))
    (tmp_path / "pic.png").write_bytes(_encoded("PNG", (30, 40, 3), 9))
    (tmp_path / "zz_bad.jpg").write_bytes(b"not an image at all")
    return tmp_path


def _rows(col):
    return [None if r is None else imageIO.imageStructToArray(r).tobytes()
            for r in col]


def test_read_images_matches_tpudl_and_stays_lazy(image_dir):
    got, want = imageIO.readImages(str(image_dir)), jio.readImages(
        str(image_dir))
    gcol, wcol = got["image"], want["image"]
    assert isinstance(gcol, LazyColumn) and len(gcol) == len(wcol) == 7
    assert gcol.reads == wcol.reads == 0
    assert [r["origin"] for r in gcol[0:3]] == [r["origin"] for r in
                                                wcol[0:3]]
    assert gcol.reads == wcol.reads == 3
    gcol[0:3]                       # the same small batch: memoized
    wcol[0:3]
    assert gcol.reads == wcol.reads == 3
    assert _rows(gcol[3:7]) == _rows(wcol[3:7])
    assert gcol.reads == wcol.reads == 7
    assert _rows(gcol[[6]]) == [None]


def test_dropna_probes_without_decoding(image_dir):
    decodes = []

    def decode(raw):
        decodes.append(1)
        return imageIO.default_decode(raw)

    frame = imageIO.readImagesWithCustomFn(str(image_dir), decode,
                                           probe_f=imageIO.default_probe)
    jframe = jio.readImagesWithCustomFn(str(image_dir), jio.default_decode,
                                        probe_f=jio.default_probe)
    kept = frame.dropna()
    assert len(kept) == len(jframe.dropna()) == 6
    assert decodes == [] and frame["image"].reads == 7
    assert isinstance(kept["image"], LazyColumn)
    assert _rows(kept["image"]) == _rows(jframe.dropna()["image"])
    assert len(decodes) == 6
    assert len(kept.head(2)) == 2 and len(kept.head(-1)) == 5


def test_decode_errors_are_counted(image_dir):
    before = metrics.counter("imageio.decode_errors").value
    frame = imageIO.readImages(str(image_dir))
    rows = list(frame["image"])
    assert rows[-1] is None and all(r is not None for r in rows[:-1])
    assert metrics.counter("imageio.decode_errors").value == before + 1


def test_files_to_frame_and_eager_reads_match_tpudl(image_dir):
    for lazy in (True, False):
        got = imageIO.filesToFrame(str(image_dir), lazy=lazy)
        want = jio.filesToFrame(str(image_dir), lazy=lazy)
        assert got.columns == want.columns == ["filePath", "fileData"]
        assert list(got["filePath"]) == list(want["filePath"])
        assert list(got["fileData"]) == list(want["fileData"])
        assert isinstance(got["fileData"], LazyColumn) == lazy
    eager = imageIO.readImagesWithCustomFn(str(image_dir),
                                           imageIO.default_decode, lazy=False)
    want = jio.readImagesWithCustomFn(str(image_dir), jio.default_decode,
                                      lazy=False)
    assert list(eager["image"]) == list(want["image"])
    paths = [str(image_dir / "img0.jpg"), str(image_dir / "pic.png")]
    assert list(imageIO.readImages(paths)["image"]) == list(
        jio.readImages(paths)["image"])


def _as_process(monkeypatch, index, count):
    """This test process as process ``index`` of ``count`` in both
    packages (the port's process group, jax's process count)."""
    import jax

    from tpudl_torch import distributed

    monkeypatch.setattr(distributed, "process_count", lambda: count)
    monkeypatch.setattr(distributed, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: count)
    monkeypatch.setattr(jax, "process_index", lambda: index)


@pytest.mark.parametrize("index", [0, 1, 2])
def test_read_images_host_sharded_keeps_this_process_share(
        image_dir, monkeypatch, index):
    """``host_sharded=True`` (once refused, 'Training, rest'): process
    ``index`` of 3 reads tpudl's ``host_shard`` of the sorted file list,
    the last share wrapping to the first file."""
    _as_process(monkeypatch, index, 3)
    got = imageIO.readImagesWithCustomFn(str(image_dir),
                                         imageIO.default_decode,
                                         host_sharded=True)
    want = jio.readImagesWithCustomFn(str(image_dir), jio.default_decode,
                                      host_sharded=True)
    assert len(got) == len(want) >= 1
    assert list(got["image"]) == list(want["image"])


def test_frame_row_filters_match_tpudl():
    cols = {"f": np.array([1.0, np.nan, 3.0, 4.0]),
            "o": np.array(["a", None, "c", None], dtype=object),
            "i": np.arange(4)}
    got, want = Frame(cols), JaxFrame(cols)
    for g, w in ((got.dropna(), want.dropna()),
                 (got.dropna(["f"]), want.dropna(["f"])),
                 (got.filter_rows([True, False, False, True]),
                  want.filter_rows([True, False, False, True])),
                 (got.head(3), want.head(3)), (got.head(-1), want.head(-1))):
        assert g.columns == w.columns and len(g) == len(w)
        for c in g.columns:
            assert list(g[c]) == list(w[c]) or np.allclose(
                g[c].astype(float), w[c].astype(float), equal_nan=True)


def test_pack_image_structs_refuses_mixed_shapes_and_nulls():
    a, b = (imageIO.imageArrayToStruct(_u8(s)) for s in ((4, 5, 3),
                                                         (5, 4, 3)))
    col = np.empty(2, dtype=object)
    col[:] = [a, dict(a)]
    assert _pack_image_structs(col).shape == (2, 4, 5, 3)
    col[:] = [a, b]
    with pytest.raises(ValueError, match="mixed image shapes"):
        _pack_image_structs(col)
    col[:] = [a, None]
    with pytest.raises(ValueError, match="dropna"):
        _pack_image_structs(col)
