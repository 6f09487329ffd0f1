"""``Frame.map_batches`` with the data layer, against tpudl's: the shard
cache cold then warm (a warm run packs nothing) and the device cache, with
outputs bit for bit equal across uncached, cold, warm and resident; a
cache directory either package's ``map_batches`` filled replayed by the
other with zero pack calls (the same key string); ``report.config``; and
the stages: ``KerasImageFileTransformer`` with a uint8 loader (its u8
codec installs itself) against tpudl's within 2e-5 of max |y|, the
estimator's second fit with ``cacheDir`` making no loader call and
equal losses, and ``LMFeaturizer(cacheDir=)`` against tpudl's within
1e-4, its warm run tokenizing nothing."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

import torch_keras_models as M  # noqa: E402
from PIL import Image  # noqa: E402

from tpudl.frame import Frame as JaxFrame  # noqa: E402
from tpudl.image import imageIO as jio  # noqa: E402
from tpudl.ml import KerasImageFileTransformer as JaxKIFT  # noqa: E402
from tpudl.ml import LMFeaturizer as JaxFeaturizer  # noqa: E402
from tpudl.text import ByteTokenizer as JaxByte  # noqa: E402
from tpudl.zoo.transformer import TinyCausalLM as JaxLM  # noqa: E402
from tpudl_torch.data import BF16Codec, Dataset, U8Codec  # noqa: E402
from tpudl_torch.data import device_cache as dc  # noqa: E402
from tpudl_torch.frame import Frame  # noqa: E402
from tpudl_torch.image import imageIO  # noqa: E402
from tpudl_torch.ml import (KerasImageFileEstimator,  # noqa: E402
                            KerasImageFileTransformer, LMFeaturizer)
from tpudl_torch.obs import last_pipeline_report, metrics  # noqa: E402
from tpudl_torch.text import ByteTokenizer  # noqa: E402
from tpudl_torch.zoo.transformer import TinyCausalLM  # noqa: E402
from torch_native_fixture import private_tpudl_decoder  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")

torch.set_num_threads(1)
IMAGE_RTOL = 2e-5
LM_TOL = 1e-4


def _snap(name):
    return metrics.snapshot().get(name, {}).get("value", 0.0)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("TPUDL_DATA_CACHE_DIR", "TPUDL_DATA_DEVICE_CACHE",
              "TPUDL_WIRE_CODEC", "TPUDL_DATA_HBM_BUDGET_MB"):
        monkeypatch.delenv(k, raising=False)
    dc.reset_device_cache()
    yield
    dc.reset_device_cache()


def _x(n=37):
    q = np.random.default_rng(2).integers(0, 256, (n, 3, 4), dtype=np.uint8)
    return q.astype(np.float32) * np.float32(1 / 255)


class _Pack:
    """A counting pack with a cache token (the same in both packages)."""

    cache_token = "test.pack.stack-v1"
    thread_safe = True

    def __init__(self):
        self.calls = 0

    def __call__(self, sl):
        self.calls += 1
        return np.asarray(sl, dtype=np.float32)


def _torch_fn(x):
    return (x * 2.0 + 1.0).reshape(x.shape[0], -1)


_jax_fn = jax.jit(lambda x: (x * 2.0 + 1.0).reshape(x.shape[0], -1))


def _ours(x, **kw):
    out = Frame({"x": x}).map_batches(_torch_fn, ["x"], ["y"], batch_size=8,
                                      device="cpu", **kw)
    return np.stack(list(out["y"]))


@pytest.mark.parametrize("codec", [None, "u8", "bf16", "auto"])
def test_cold_warm_resident_are_bitwise(tmp_path, codec):
    x = _x()
    base = _ours(x, wire_codec=codec)
    # the uncached run with a fixed codec against tpudl's on the same
    # input: bitwise, but for u8, whose prologue XLA fuses into fn
    # (reassociated). 'auto' picks from each package's own measured wire
    # (tpudl times a host-to-host device_put here; the port has no card)
    if codec != "auto":
        theirs = np.stack(list(JaxFrame({"x": x}).map_batches(
            _jax_fn, ["x"], ["y"], batch_size=8, wire_codec=codec,
            autotune=False)["y"]))
        if codec == "u8":
            np.testing.assert_allclose(base, theirs, rtol=2e-7, atol=0)
        else:
            assert np.array_equal(base, theirs)
    if codec == "bf16":   # lossy by design, within the codec's round trip
        plain = _ours(x)
        np.testing.assert_allclose(base, plain, rtol=BF16Codec.RTOL, atol=0)
        assert not np.array_equal(base, plain)
    pack = _Pack()
    kw = dict(wire_codec=codec, cache_dir=str(tmp_path), pack=pack)
    assert np.array_equal(_ours(x, **kw), base)           # cold
    cold = last_pipeline_report()
    assert pack.calls == 5 and cold["stage_calls"]["cache_misses"] == 5
    assert cold["batch_cache"] is True and cold["device_cache"] is False
    assert np.array_equal(_ours(x, **kw), base)           # warm
    warm = last_pipeline_report()
    assert pack.calls == 5 and warm["stage_calls"]["cache_hits"] == 5
    if codec is not None:   # a warm run adopts the manifest's codecs
        assert warm["wire_codec"] == {"u8": "u8", "bf16": "bf16",
                                      "auto": "identity"}[codec]
    kw["device_cache"] = True
    assert np.array_equal(_ours(x, **kw), base)           # resident, cold
    assert np.array_equal(_ours(x, **kw), base)           # resident, warm
    assert pack.calls == 5
    rep = last_pipeline_report()
    assert rep["stage_calls"].get("hbm_hits") == 5
    assert rep["device_cache"] is True and rep["fuse_steps"] == 1


def test_device_cache_is_keyed_by_device(monkeypatch):
    """A run on another device misses what this one left resident: the
    run key names the device (a hit would hand this run tensors on the
    wrong device)."""
    x = _x()
    base = _ours(x)
    pack = _Pack()
    real = dc.device_token
    monkeypatch.setattr(dc, "device_token", lambda d: "cuda:1")
    assert np.array_equal(_ours(x, pack=pack, device_cache=True), base)
    keys = list(dc.get_device_cache()._entries)
    assert keys and all(k[0].endswith("|mesh=single|dev=cuda:1")
                        for k in keys)
    monkeypatch.setattr(dc, "device_token", real)
    assert np.array_equal(_ours(x, pack=pack, device_cache=True), base)
    assert pack.calls == 10                # the CPU run packed anew
    assert not last_pipeline_report()["stage_calls"].get("hbm_hits")
    assert np.array_equal(_ours(x, pack=pack, device_cache=True), base)
    assert pack.calls == 10                # and its own entries hit
    assert last_pipeline_report()["stage_calls"]["hbm_hits"] == 5
    assert {k[0].rsplit("|dev=", 1)[1]
            for k in dc.get_device_cache()._entries} == {"cuda:1", "cpu"}
    ds = Dataset(Frame({"x": x}), ["x"], batch_size=8, device_cache=True,
                 device="cpu")
    assert ds._dkey.endswith("|mesh=single|dev=cpu")


def test_fuse_steps_and_env_knobs(tmp_path, monkeypatch):
    x = _x(40)
    base = _ours(x)
    assert np.array_equal(_ours(x, fuse_steps=2, device_cache=True), base)
    assert last_pipeline_report()["fuse_steps"] == 1      # residency wins
    assert np.array_equal(_ours(x, fuse_steps=2,
                                cache_dir=str(tmp_path)), base)
    assert last_pipeline_report()["fuse_steps"] == 2      # shards fuse
    assert np.array_equal(_ours(x, fuse_steps=2,
                                cache_dir=str(tmp_path)), base)
    assert last_pipeline_report()["stage_calls"]["cache_hits"] == 5
    monkeypatch.setenv("TPUDL_WIRE_CODEC", "u8")
    monkeypatch.setenv("TPUDL_DATA_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("TPUDL_DATA_DEVICE_CACHE", "1")
    assert np.array_equal(_ours(x), base)
    rep = last_pipeline_report()
    assert (rep["batch_cache"], rep["device_cache"]) == (True, True)
    assert os.listdir(tmp_path / "env")
    assert np.array_equal(_ours(x), base)
    assert last_pipeline_report()["wire_codec"] == "u8"


def test_cache_key_material_and_check_finite_rekey(tmp_path):
    x = _x()
    pack = _Pack()
    kw = dict(cache_dir=str(tmp_path), pack=pack)
    _ours(x, cache_key="k1", **kw)
    _ours(x, cache_key="k1", **kw)
    assert pack.calls == 5                       # same explicit key: warm
    _ours(x, cache_key="k2", **kw)
    assert pack.calls == 10                      # new key: cold
    _ours(x, cache_key="k1", check_finite=True, **kw)
    assert pack.calls == 15                      # the sanitizer re-keys
    assert len(os.listdir(tmp_path)) == 3


@pytest.mark.parametrize("writer", ["tpudl", "port"])
@pytest.mark.parametrize("codec", [None, "u8"])
def test_one_cache_dir_serves_both_executors(tmp_path, writer, codec):
    x = _x()
    base = _ours(x)
    ours, theirs = _Pack(), _Pack()
    d = str(tmp_path)
    jkw = dict(batch_size=8, pack=theirs, cache_dir=d, wire_codec=codec,
               autotune=False)
    if writer == "tpudl":
        JaxFrame({"x": x}).map_batches(_jax_fn, ["x"], ["y"], **jkw)
    else:
        _ours(x, pack=ours, cache_dir=d, wire_codec=codec)
    assert os.listdir(d) and len(os.listdir(d)) == 1
    if writer == "tpudl":
        got = _ours(x, pack=ours, cache_dir=d, wire_codec=codec)
        assert ours.calls == 0 and np.array_equal(got, base)
        assert last_pipeline_report()["stage_calls"]["cache_hits"] == 5
    else:
        out = JaxFrame({"x": x}).map_batches(_jax_fn, ["x"], ["y"], **jkw)
        assert theirs.calls == 0
        got = np.stack(list(out["y"]))
        if codec is None:
            assert np.array_equal(got, base)
        else:   # tpudl jits its u8 prologue into fn: XLA reassociates
            np.testing.assert_allclose(got, base, rtol=2e-7, atol=0)


def test_report_config_matches_tpudls(tmp_path):
    from tpudl import obs as jobs

    x = _x()
    kw = dict(batch_size=8, pack=_Pack(), cache_dir=str(tmp_path),
              wire_codec="u8")
    JaxFrame({"x": x}).map_batches(_jax_fn, ["x"], ["y"], autotune=False,
                                   **kw)
    want = jobs.last_pipeline_report()
    Frame({"x": x}).map_batches(_torch_fn, ["x"], ["y"], device="cpu", **kw)
    got = last_pipeline_report()
    for k in ("wire_codec", "batch_cache", "device_cache", "fuse_steps"):
        assert got[k] == want[k], k


# -- the stages ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    uris = []
    for i in range(10):
        p = str(d / f"im{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (40 + i, 50, 3),
                                     dtype=np.uint8)).save(p, quality=90)
        uris.append(p)
    return np.array(uris, dtype=object)


@pytest.fixture(scope="module")
def functional(tmp_path_factory):
    return M.saved("functional", tmp_path_factory.mktemp("kfiles"))


def test_uint8_loader_transformer_matches_tpudl(tmp_path, jpegs, functional):
    kw = dict(inputCol="uri", outputCol="out", modelFile=functional,
              batchSize=4)
    ours_u8 = imageIO.createNativeImageLoader(17, 15, scale=1 / 255,
                                              output_dtype="uint8")
    ours_f32 = imageIO.createNativeImageLoader(17, 15, scale=1 / 255)
    theirs = jio.createNativeImageLoader(17, 15, scale=1 / 255,
                                         output_dtype="uint8")
    frame = Frame({"uri": jpegs})
    f32 = np.stack(list(KerasImageFileTransformer(
        device="cpu", imageLoader=ours_f32, **kw).transform(frame)["out"]))
    stage = KerasImageFileTransformer(device="cpu", imageLoader=ours_u8,
                                      cacheDir=str(tmp_path), **kw)
    decodes = _snap("imageio.uris_loaded")
    got = np.stack(list(stage.transform(frame)["out"]))
    assert last_pipeline_report()["wire_codec"] == "u8"
    assert np.array_equal(got, f32)          # same restored pixels
    want = np.stack(list(JaxKIFT(imageLoader=theirs, **kw).transform(
        JaxFrame({"uri": jpegs}))["out"]))
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= IMAGE_RTOL
    assert _snap("imageio.uris_loaded") - decodes == 10
    again = np.stack(list(stage.transform(Frame({"uri": jpegs}))["out"]))
    assert _snap("imageio.uris_loaded") - decodes == 10   # warm: none
    assert np.array_equal(again, got)
    with pytest.raises(ValueError, match="skip it"):
        KerasImageFileTransformer(device="cpu", imageLoader=ours_u8,
                                  wireCodec="bf16", **kw).transform(frame)
    explicit = KerasImageFileTransformer(
        device="cpu", imageLoader=ours_u8, wireCodec=U8Codec(1 / 255), **kw)
    assert np.array_equal(np.stack(list(explicit.transform(frame)["out"])),
                          f32)


def test_device_cache_rekeys_an_image_rewritten_in_place(tmp_path,
                                                        functional):
    """With ``deviceCache`` alone, the resident batches are keyed on the
    files' path+size+mtime, as the shard cache is: an image rewritten at
    the same path is decoded anew, not replayed from the device."""
    rng = np.random.default_rng(5)
    uris = np.array([str(tmp_path / f"im{i}.jpg") for i in range(4)],
                    dtype=object)
    for u in uris:
        Image.fromarray(rng.integers(0, 256, (20, 24, 3),
                                     dtype=np.uint8)).save(u)
    loader = imageIO.createNativeImageLoader(17, 15, scale=1 / 255,
                                             output_dtype="uint8")
    kw = dict(inputCol="uri", outputCol="out", modelFile=functional,
              batchSize=4, device="cpu", imageLoader=loader)

    def run(**extra):
        return np.stack(list(KerasImageFileTransformer(**kw, **extra)
                             .transform(Frame({"uri": uris}))["out"]))

    first = run(deviceCache=True)
    assert np.array_equal(run(deviceCache=True), first)
    assert last_pipeline_report()["stage_calls"]["hbm_hits"] == 1
    Image.fromarray(rng.integers(0, 256, (30, 24, 3),
                                 dtype=np.uint8)).save(uris[0])
    st = os.stat(uris[0])
    os.utime(uris[0], ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    got = run(deviceCache=True)
    assert not last_pipeline_report()["stage_calls"].get("hbm_hits")
    assert np.array_equal(got, run())
    assert not np.array_equal(got, first)


@pytest.mark.parametrize("decoder", ["native", "PIL"])
def test_uint8_loader_pixels_equal_float32_loaders(jpegs, monkeypatch,
                                                   decoder):
    """uint8 pixels × scale equal the float32 loader's output bit for bit,
    through libjpeg (this host) and through PIL (the card's machine,
    which has no libjpeg headers)."""
    from tpudl_torch import native

    if decoder == "PIL":
        monkeypatch.setattr(native, "available", lambda: False)
    for side in ((17, 15), (299, 299)):
        u8 = imageIO.createNativeImageLoader(*side, scale=1 / 255,
                                             output_dtype="uint8")
        f32 = imageIO.createNativeImageLoader(*side, scale=1 / 255)
        raw = u8.batch_decode(list(jpegs))
        assert raw.dtype == np.uint8
        assert np.array_equal(U8Codec(1 / 255).decode_array(raw),
                              f32.batch_decode(list(jpegs)))
        if decoder == "native":
            assert np.array_equal(raw, jio.createNativeImageLoader(
                *side, scale=1 / 255, output_dtype="uint8").batch_decode(
                    list(jpegs)))
        assert np.array_equal(u8(jpegs[0]), raw[0])
        assert u8.cache_token == jio.createNativeImageLoader(
            *side, scale=1 / 255, output_dtype="uint8").cache_token


def test_estimator_second_fit_with_cache_decodes_nothing(tmp_path, jpegs):
    path = M.saved("cnn", tmp_path)
    loader = imageIO.createNativeImageLoader(32, 32, scale=1 / 255,
                                             output_dtype="uint8")
    labels = np.empty(len(jpegs), dtype=object)
    labels[:] = [np.eye(2, dtype=np.float32)[i % 2] for i in range(10)]
    frame = Frame({"uri": jpegs, "label": labels})
    kw = dict(inputCol="uri", outputCol="out", labelCol="label",
              imageLoader=loader, modelFile=path, kerasOptimizer="adam",
              kerasLoss="categorical_crossentropy",
              kerasFitParams={"epochs": 2, "batch_size": 4}, device="cpu")
    plain = KerasImageFileEstimator(**kw).fit(frame)
    est = KerasImageFileEstimator(cacheDir=str(tmp_path / "c"),
                                  deviceCache=True, **kw)
    decodes = _snap("imageio.uris_loaded")
    first = est.fit(frame)
    assert _snap("imageio.uris_loaded") - decodes == 10
    second = est.fit(frame)
    assert _snap("imageio.uris_loaded") - decodes == 10   # none again
    assert first.history == second.history == plain.history
    assert dc.get_device_cache().bytes_pinned == 0        # released
    assert (second.cacheDir, second.deviceCache) == (str(tmp_path / "c"),
                                                     True)


def test_lm_featurizer_cache_dir_matches_tpudl(tmp_path):
    arch = dict(vocab=260, dim=32, heads=4, layers=2, max_len=64)
    jlm = JaxLM(**arch)
    params = jlm.init(0)
    texts = np.array(["hello", "a much longer row of text here", "x",
                      "tpu to gpu", "short one", "the last, partial"],
                     dtype=object)
    want = np.stack(list(JaxFeaturizer(
        inputCol="text", outputCol="vec", model=jlm,
        weights=jax.tree.map(jnp.asarray, params),
        tokenizer=JaxByte(), batchSize=4).transform(
            JaxFrame({"text": texts}))["vec"]))
    spec = TinyCausalLM(device="meta", **arch)
    kw = dict(inputCol="text", outputCol="vec", model=spec, weights=params,
              tokenizer=ByteTokenizer(), batchSize=4, device="cpu")
    base = np.stack(list(LMFeaturizer(**kw).transform(
        Frame({"text": texts}))["vec"]))
    np.testing.assert_allclose(base, want, rtol=LM_TOL, atol=LM_TOL)
    stage = LMFeaturizer(cacheDir=str(tmp_path), wireCodec="tokens", **kw)
    calls = _snap("text.tokenize.calls")
    cold = np.stack(list(stage.transform(Frame({"text": texts}))["vec"]))
    assert _snap("text.tokenize.calls") - calls == 2
    warm = np.stack(list(stage.transform(Frame({"text": texts}))["vec"]))
    assert _snap("text.tokenize.calls") - calls == 2      # warm: none
    assert np.array_equal(cold, base) and np.array_equal(warm, base)
    assert last_pipeline_report()["stage_calls"]["cache_hits"] == 2
