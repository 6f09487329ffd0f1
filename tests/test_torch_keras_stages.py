"""The Keras surface's inference stages, held to tpudl on the CPU on the
same keras-written files and seeded inputs: ``KerasTransformer``
(configs[4]'s MLP), ``TFTransformer``, ``KerasImageFileTransformer`` in
both output modes, ``createNativeImageLoader``, ``params_from_keras`` and
the ``Pipeline`` of a featurizer and ``LogisticRegression``; and every
refusal by name. Outputs within 1e-5 of max |y| (f32 products in another
order; read ~3e-7); the loader and ``params_from_keras`` are bitwise."""

import numpy as np
import pytest

keras = pytest.importorskip("keras")

import torch_keras_models as M  # noqa: E402
from PIL import Image  # noqa: E402

from tpudl.frame import Frame as JaxFrame  # noqa: E402
from tpudl.image import imageIO as jax_imageIO  # noqa: E402
from tpudl.ml import KerasImageFileTransformer as JaxKIFT  # noqa: E402
from tpudl.ml import KerasTransformer as JaxKT  # noqa: E402
from tpudl.zoo.convert import params_from_keras as jax_params  # noqa: E402
from tpudl_torch.frame import Frame  # noqa: E402
from tpudl_torch.image import imageIO  # noqa: E402
from tpudl_torch.ingest import TFInputGraph  # noqa: E402
from tpudl_torch.ml import (DeepImageFeaturizer,  # noqa: E402
                            KerasImageFileTransformer, KerasTransformer,
                            LogisticRegression, Pipeline, TFTransformer)
from tpudl_torch.ml.image_params import load_uri_batch  # noqa: E402
from tpudl_torch.zoo.convert import (load_keras_model,  # noqa: E402
                                     params_from_keras, save_named_params)
from torch_native_fixture import private_tpudl_decoder  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")

RTOL = 1e-5


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stages")
    return {name: M.saved(name, d)
            for name in ("mlp", "cnn", "functional", "conv_image")}


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    uris = []
    for i in range(6):
        p = str(d / f"im{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (40 + i, 50, 3),
                                     dtype=np.uint8)).save(p, quality=90)
        uris.append(p)
    return np.array(uris, dtype=object)


def test_keras_transformer_matches_tpudl(files):
    x = np.random.default_rng(0).normal(size=(700, 100)).astype(np.float32)
    ours = KerasTransformer(inputCol="x", outputCol="y",
                            modelFile=files["mlp"], batchSize=256,
                            device="cpu")
    got = np.stack(list(ours.transform(Frame({"x": x}))["y"]))
    want = np.stack(list(JaxKT(inputCol="x", outputCol="y",
                               modelFile=files["mlp"], batchSize=256)
                         .transform(JaxFrame({"x": x}))["y"]))
    assert got.shape == want.shape == (700, 10)
    assert _rel(got, want) <= RTOL
    # the ingested graph and its batch function are kept across calls
    fn = ours._delegate[1]._fn_entry[1]
    ours.transform(Frame({"x": x[:10]}))
    assert ours._delegate[1]._fn_entry[1] is fn


def test_tf_transformer_runs_an_ingested_graph(files):
    x = np.random.default_rng(1).normal(size=(9, 32, 32, 3)).astype(
        np.float32)
    for gin in (TFInputGraph.fromKeras(files["cnn"]),
                TFInputGraph.fromKerasTrainable(files["cnn"])):
        tt = TFTransformer(tfInputGraph=gin,
                           inputMapping={"x": gin.input_names[0]},
                           outputMapping={gin.output_names[0]: "y"},
                           batchSize=4, device="cpu")
        got = np.stack(list(tt.transform(Frame({"x": x}))["y"]))
        want = keras.saving.load_model(files["cnn"]).predict(x, verbose=0)
        assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("mode", ["vector", "image"])
def test_keras_image_file_transformer_matches_tpudl(files, jpegs, mode):
    def loader(uri):
        img = Image.open(uri).convert("RGB").resize((15, 17), Image.BILINEAR)
        return np.asarray(img, dtype=np.float32) / 255.0

    model = files["functional" if mode == "vector" else "conv_image"]
    kw = dict(inputCol="uri", outputCol="out", modelFile=model,
              imageLoader=loader, outputMode=mode, batchSize=4)
    got = KerasImageFileTransformer(device="cpu", **kw).transform(
        Frame({"uri": jpegs}))["out"]
    want = JaxKIFT(**kw).transform(JaxFrame({"uri": jpegs}))["out"]
    if mode == "image":
        assert all(g["nChannels"] == w["nChannels"] == 4 and
                   g["mode"] == w["mode"] for g, w in zip(got, want))
        got = [imageIO.imageStructToArray(g) for g in got]
        want = [jax_imageIO.imageStructToArray(w) for w in want]
    got, want = np.stack(list(got)), np.stack(list(want))
    assert got.shape == want.shape
    assert _rel(got, want) <= RTOL


def test_native_image_loader_matches_tpudls(jpegs):
    ours = imageIO.createNativeImageLoader(23, 29, scale=1 / 255)
    theirs = jax_imageIO.createNativeImageLoader(23, 29, scale=1 / 255)
    got = load_uri_batch(ours, jpegs)
    assert got.dtype == np.float32 and got.shape == (6, 23, 29, 3)
    assert np.array_equal(got, np.asarray(theirs.batch_decode(list(jpegs))))
    assert np.array_equal(ours(jpegs[0]), theirs(jpegs[0]))
    assert ours.thread_safe and ours.cache_token == theirs.cache_token


def test_uint8_loaders_are_refused_by_name(jpegs, files):
    """A uint8 loader (once refused, 'Data layer') loads raw uint8 as
    tpudl's does; what is refused now, by name, is a ``wireCodec`` that
    would skip its deferred normalize."""
    ours = imageIO.createNativeImageLoader(8, 8, output_dtype="uint8")
    theirs = jax_imageIO.createNativeImageLoader(8, 8, output_dtype="uint8")
    got = load_uri_batch(ours, jpegs)
    assert got.dtype == np.uint8 and got.shape == (6, 8, 8, 3)
    assert np.array_equal(got, theirs.batch_decode(list(jpegs)))
    assert ours.cache_token == theirs.cache_token

    def u8(uri):
        return np.zeros((4, 4, 3), np.uint8)

    u8.output_dtype = "uint8"
    assert load_uri_batch(u8, jpegs).dtype == np.uint8
    with pytest.raises(ValueError, match="would skip it"):
        KerasImageFileTransformer(
            inputCol="uri", outputCol="o", modelFile=files["cnn"],
            imageLoader=ours, wireCodec="identity", device="cpu").transform(
                Frame({"uri": jpegs}))


@pytest.mark.parametrize("stage", ["KerasTransformer", "TFTransformer",
                                   "KerasImageFileTransformer"])
def test_stages_run_over_a_mesh_like_tpudls(files, jpegs, stage):
    """``mesh=`` (once refused, 'Training, rest'): the port over a mesh of
    4 host entries (each running its shard on its own per-batch function;
    the trainable graph's weights placed for it) against tpudl over 4 of
    its devices, and against the port without a mesh, within RTOL."""
    import jax

    from tpudl import mesh as jax_mesh
    from tpudl.ingest import TFInputGraph as JaxTFInputGraph
    from tpudl.ml import TFTransformer as JaxTT
    from tpudl_torch import mesh as port_mesh

    ours_mesh = port_mesh.build_mesh(devices=["cpu"] * 4)
    theirs_mesh = jax_mesh.build_mesh(devices=jax.devices()[:4])
    rng = np.random.default_rng(2)
    if stage == "KerasTransformer":
        cols = {"x": rng.normal(size=(30, 100)).astype(np.float32)}
        kw = dict(inputCol="x", outputCol="y", modelFile=files["mlp"],
                  batchSize=8)
        ours, theirs = KerasTransformer, JaxKT
    elif stage == "TFTransformer":
        cols = {"x": rng.normal(size=(10, 32, 32, 3)).astype(np.float32)}

        def graph_stage(cls, gin):
            return lambda **k: cls(  # noqa: E731
                tfInputGraph=gin, inputMapping={"x": gin.input_names[0]},
                outputMapping={gin.output_names[0]: "y"}, **k)

        ours = graph_stage(TFTransformer,
                           TFInputGraph.fromKerasTrainable(files["cnn"]))
        theirs = graph_stage(JaxTT, JaxTFInputGraph.fromKerasTrainable(
            files["cnn"]))
        kw = dict(batchSize=4)
    else:
        def loader(uri):
            img = Image.open(uri).convert("RGB").resize((15, 17))
            return np.asarray(img, dtype=np.float32) / 255.0

        cols = {"uri": jpegs}
        kw = dict(inputCol="uri", outputCol="y",
                  modelFile=files["functional"], imageLoader=loader,
                  batchSize=4)
        ours, theirs = KerasImageFileTransformer, JaxKIFT
    got = np.stack(list(ours(mesh=ours_mesh, **kw).transform(
        Frame(cols))["y"]))
    plain = np.stack(list(ours(device="cpu", **kw).transform(
        Frame(cols))["y"]))
    want = np.stack(list(theirs(mesh=theirs_mesh, **kw).transform(
        JaxFrame(cols))["y"]))
    assert got.shape == plain.shape == want.shape
    assert _rel(got, want) <= RTOL and _rel(got, plain) <= RTOL


@pytest.mark.parametrize("knob", ["cacheDir", "deviceCache", "wireCodec"])
def test_file_transformer_data_knobs_replay_bitwise(files, jpegs, tmp_path,
                                                    knob):
    """``KerasImageFileTransformer``'s data-layer knobs (once refused,
    'Data layer'): the same bits as without them, twice; the second
    ``cacheDir`` or ``deviceCache`` transform decodes nothing."""
    from tpudl_torch.data import device_cache
    from tpudl_torch.obs import metrics

    device_cache.reset_device_cache()
    loader = imageIO.createNativeImageLoader(32, 32, scale=1 / 255)
    kw = dict(inputCol="uri", outputCol="o", modelFile=files["cnn"],
              imageLoader=loader, batchSize=4, device="cpu")
    want = np.stack(list(KerasImageFileTransformer(**kw).transform(
        Frame({"uri": jpegs}))["o"]))
    value = {"cacheDir": str(tmp_path), "deviceCache": True,
             "wireCodec": "u8"}[knob]
    st = KerasImageFileTransformer(**{knob: value}, **kw)
    decodes = metrics.counter("imageio.uris_loaded").value
    for _ in range(2):
        got = np.stack(list(st.transform(Frame({"uri": jpegs}))["o"]))
        assert np.array_equal(got, want)
    loaded = metrics.counter("imageio.uris_loaded").value - decodes
    assert loaded == (6 if knob != "wireCodec" else 12)
    device_cache.reset_device_cache()


def test_params_from_keras_matches_tpudls(files):
    model = keras.saving.load_model(files["cnn"], compile=False)
    want = jax_params(model)
    got = params_from_keras(files["cnn"])
    assert got.keys() == want.keys()
    for layer in want:
        assert got[layer].keys() == want[layer].keys()
        for k in want[layer]:
            assert np.array_equal(got[layer][k], want[layer][k])
    config, weights = load_keras_model(files["cnn"])
    assert config["class_name"] == "Sequential" and len(weights) == 4
    with pytest.raises(TypeError, match="save the model"):
        load_keras_model(model)
    with pytest.raises(NotImplementedError, match="save_named_params"):
        save_named_params("InceptionV3", "x.npz")


def test_pipeline_featurizes_then_fits_logistic_regression():
    rng = np.random.default_rng(0)
    col = np.empty(8, dtype=object)
    labels = np.arange(8) % 2
    for i in range(8):
        arr = rng.integers(0, 256, (75, 75, 3), dtype=np.uint8)
        arr[:37] //= 4 if labels[i] else 1
        col[i] = imageIO.imageArrayToStruct(arr)
    frame = Frame({"image": col, "label": labels})
    pipe = Pipeline([DeepImageFeaturizer(inputCol="image",
                                         outputCol="features",
                                         modelName="InceptionV3",
                                         batchSize=4, device="cpu"),
                     LogisticRegression(maxIter=30, device="cpu")])
    model = pipe.fit(frame)
    out = model.transform(frame)
    probs = np.stack(list(out["probability"]))
    assert probs.shape == (8, 2)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)
    lr = model.getStages()[1]
    assert lr.history[-1] < lr.history[0]


def test_stages_default_to_the_card_and_raise_without_one(files, jpegs):
    """No stage drops to the CPU unasked: with no card, each raises."""
    x = np.zeros((2, 100), np.float32)
    gin = TFInputGraph.fromKeras(files["mlp"])
    feats = np.empty(2, dtype=object)
    feats[:] = [np.zeros(3, np.float32), np.ones(3, np.float32)]
    runs = [
        lambda: KerasTransformer(inputCol="x", outputCol="y",
                                 modelFile=files["mlp"]).transform(
            Frame({"x": x})),
        lambda: TFTransformer(tfInputGraph=gin,
                              inputMapping={"x": gin.input_names[0]},
                              outputMapping={gin.output_names[0]: "y"}
                              ).transform(Frame({"x": x})),
        lambda: KerasImageFileTransformer(
            inputCol="uri", outputCol="y", modelFile=files["functional"],
            imageLoader=imageIO.createNativeImageLoader(17, 15)).transform(
            Frame({"uri": jpegs})),
        lambda: LogisticRegression().fit(
            Frame({"features": feats, "label": np.array([0, 1])})),
    ]
    for run in runs:
        with pytest.raises(RuntimeError, match="cuda"):
            run()
