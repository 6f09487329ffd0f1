"""Keras 2-era legacy ``.h5`` model files, as tf_keras writes them, read
without keras (``tpudl_torch.ingest.keras_legacy``) and run by the Keras
evaluator; bfloat16 Keras 3 weights; the Keras graph's feed dtype; and
``keras2_h5_writer.py`` (keras 3's MobileNetV3 is in
``test_torch_keras_apps.py``).

- Every committed fixture of ``tests/fixtures/keras2`` (written by
  ``make_keras2_fixtures.py`` with tf_keras) within 2e-5 of max |y| of
  tf_keras's ``predict`` computed here, and of tpudl's
  ``TFInputGraph.fromKeras`` where tpudl loads the file. tpudl hands the
  file to keras 3's legacy loader, which raises on the ``groups`` key of
  tf_keras's depthwise, separable and transposed convolutions, on a layer
  name with a ``/``, on tf_keras's MultiHeadAttention config and on a
  nested model's BatchNormalization: there the port follows tf_keras and
  the test shows tpudl raising.
- tf_keras's InceptionV3 at 75×75, ResNet50 at 32×32 and ResNet50V2 at
  64×64 (``weights=None``, BN perturbed), written here, held the same way.
- What stays refused raises ``NotImplementedError`` naming it and ROADMAP
  Queue 1: a Keras 1-era file, ``TFOpLambda``, ``Lambda``, a custom
  class, a recurrent layer, a model with two inputs, ``groups`` on a
  depthwise convolution, an Embedding's ``mask_zero``.
- The surface: ``KerasTransformer``, ``KerasImageFileTransformer``,
  ``registerKerasImageUDF`` and ``KerasImageFileEstimator`` (2 sgd steps
  held to tpudl's, and the first step's gradients against float64) take a
  Keras 2 ``.h5``; a model read from one is written as a ``.keras`` that
  keras 3 loads; the named stages' ``params_from_keras`` reads one as
  tpudl does.
- An int64 or int32 ``Input`` reaches the graph in its own dtype (the port
  used to cast every Keras feed to float32).
- A bfloat16 ``.keras`` reads (it used to raise
  ``UnsupportedHDF5Feature: opaque datatype``) to keras's weights, runs
  within 1e-2 of keras, and is written back as bfloat16.
- ``keras2_h5_writer.write_keras2_h5`` on a tf_keras file's config and
  weights writes a file that reads back to the same config and weights
  bit for bit, and that tf_keras loads to the same predictions."""

import gzip
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

tf_keras = pytest.importorskip("tf_keras")
keras = pytest.importorskip("keras")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import keras2_h5_writer  # noqa: E402
from tpudl.ingest import TFInputGraph as JaxGraph  # noqa: E402
from tpudl_torch.frame import Frame  # noqa: E402
from tpudl_torch.ingest import TFInputGraph, hdf5  # noqa: E402
from tpudl_torch.ingest.kerasfile import (load_keras_file,  # noqa: E402
                                          save_keras_file)
from torch_native_fixture import private_tpudl_decoder  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "keras2"
sys.path.insert(0, str(FIXTURES))     # make_keras2_fixtures
RTOL = 2e-5
BF16_RTOL = 1e-2
# fixtures keras 3's legacy loader (so tpudl) refuses, and why
TPUDL_RAISES = {"attention": "MultiHeadAttention", "nested": "",
                "groups": "DepthwiseConv2D", "slash": "conv1/conv"}
RUNS = ("text_cnn", "text_layers", "image_layers", "attention", "nested",
        "groups", "slash")


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _x(model, n=3, seed=0):
    """Seeded inputs for a tf_keras model: ids in [0, 20) for an integer
    input, else normals times 3."""
    shape = (n,) + tuple(model.inputs[0].shape[1:])
    dtype = model.inputs[0].dtype.name
    rng = np.random.default_rng(seed)
    if "int" in dtype:
        return rng.integers(0, 20, shape).astype(dtype)
    return (3 * rng.normal(size=shape)).astype(np.float32)


def _tf_predict(path, x):
    return tf_keras.models.load_model(path, compile=False).predict(
        x, verbose=0)


def _tpudl(path, x):
    return np.asarray(jax.jit(JaxGraph.fromKeras(path).make_fn())(
        jnp.asarray(x)))


@pytest.mark.parametrize("name", RUNS)
def test_fixture_matches_tf_keras_and_tpudl(name):
    path = str(FIXTURES / f"{name}.h5")
    model = tf_keras.models.load_model(path, compile=False)
    x = _x(model)
    want = model.predict(x, verbose=0)
    got = TFInputGraph.fromKeras(path).make_fn()(torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= RTOL, name
    if name in TPUDL_RAISES:
        with pytest.raises((TypeError, ValueError),
                           match=TPUDL_RAISES[name]):
            JaxGraph.fromKeras(path)
        return
    assert _rel(got.numpy(), _tpudl(path, x)) <= RTOL, name


def _perturb(model, seed=1):
    rng = np.random.default_rng(seed)
    vals = []
    for w in model.weights:
        v, n = w.numpy(), w.name.split("/")[-1].split(":")[0]
        if n in ("moving_mean", "beta"):
            v = rng.normal(0, 0.1, v.shape)
        elif n in ("moving_variance", "gamma"):
            v = rng.uniform(0.5, 1.5, v.shape)
        vals.append(np.asarray(v, np.float32))
    model.set_weights(vals)
    return model


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """tf_keras applications saved as ``.h5`` (``weights=None``, BN
    perturbed, random seeded): ``{name: path}``."""
    d = tmp_path_factory.mktemp("keras2_apps")
    out = {}
    for name, side in (("InceptionV3", 75), ("ResNet50", 32),
                       ("ResNet50V2", 64)):
        tf_keras.backend.clear_session()
        tf_keras.utils.set_random_seed(0)
        model = getattr(tf_keras.applications, name)(
            weights=None, input_shape=(side, side, 3))
        out[name] = str(d / f"{name}.h5")
        _perturb(model).save(out[name])
    return out


@pytest.mark.parametrize("name", ["InceptionV3", "ResNet50", "ResNet50V2"])
def test_application_matches_tf_keras_and_tpudl(apps, name):
    path = apps[name]
    model = tf_keras.models.load_model(path, compile=False)
    x = np.random.default_rng(0).normal(
        size=(2,) + tuple(model.inputs[0].shape[1:])).astype(np.float32)
    want = model.predict(x, verbose=0)
    got = TFInputGraph.fromKeras(path).make_fn()(torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= RTOL
    assert _rel(got.numpy(), _tpudl(path, x)) <= RTOL


def _copy(src, dst, edit):
    Path(dst).write_bytes(Path(src).read_bytes())
    with h5py.File(dst, "r+") as f:
        edit(f)
    return str(dst)


def _edit_config(change):
    def edit(f):
        config = json.loads(f.attrs["model_config"])
        change(config)
        f.attrs["model_config"] = json.dumps(config)
    return edit


def _layer(config, cls):
    return next(layer for layer in config["config"]["layers"]
                if layer["class_name"] == cls)


def _keras1(f):
    f.attrs["keras_version"] = "1.2.2"


def _custom(config):
    _layer(config, "Conv2D")["class_name"] = "Custom>ScaleLayer"


def _depthwise_groups(config):
    _layer(config, "DepthwiseConv2D")["config"]["groups"] = 2


def _mask_zero(config):
    _layer(config, "Embedding")["config"]["mask_zero"] = True


@pytest.mark.parametrize("src,edit,match", [
    ("text_cnn", _keras1, "Keras 1.2.2-era .h5"),
    ("tfoplambda", None, "TFOpLambda"),
    ("lambda", None, "a Lambda layer"),
    ("lstm", None, "a recurrent layer \\(LSTM"),
    ("multi_input", None, "a model with 2 inputs"),
    ("slash", _edit_config(_custom), "'Custom>ScaleLayer'"),
    ("groups", _edit_config(_depthwise_groups), "DepthwiseConv2D with groups"),
    ("text_layers", _edit_config(_mask_zero), "mask_zero"),
])
def test_what_stays_refused_raises_by_name(src, edit, match, tmp_path):
    path = str(FIXTURES / f"{src}.h5")
    if edit is not None:
        path = _copy(path, tmp_path / f"{src}.h5", edit)
    with pytest.raises(NotImplementedError, match=match) as info:
        TFInputGraph.fromKeras(path)
    assert "ROADMAP Queue 1" in str(info.value)


class _Spy:
    """Records the dtype of every tensor a Keras graph's function gets."""

    def __init__(self, monkeypatch):
        self.dtypes = []
        make_fn = TFInputGraph.make_fn

        def spying(graph, *a, **k):
            fn = make_fn(graph, *a, **k)

            def run(*xs):
                self.dtypes.append(xs[-1].dtype)
                return fn(*xs)
            return run

        monkeypatch.setattr(TFInputGraph, "make_fn", spying)


@pytest.mark.parametrize("name,column_dtype,want", [
    ("text_cnn", np.int64, torch.int64),     # Input(dtype="int64")
    ("text_layers", np.int64, torch.int32),  # Input(dtype="int32")
])
def test_keras_transformer_feeds_the_input_layers_dtype(
        name, column_dtype, want, monkeypatch):
    from tpudl_torch.ml import KerasTransformer

    path = str(FIXTURES / f"{name}.h5")
    model = tf_keras.models.load_model(path, compile=False)
    x = _x(model, n=5)
    spy = _Spy(monkeypatch)
    kt = KerasTransformer(inputCol="x", outputCol="y", modelFile=path,
                          batchSize=2, device="cpu")
    out = np.stack(list(kt.transform(Frame({
        "x": x.astype(column_dtype)}))["y"]))
    assert spy.dtypes and set(spy.dtypes) == {want}
    assert _rel(out, model.predict(x, verbose=0)) <= RTOL


@pytest.fixture(scope="module")
def image_set(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("keras2_images")
    rng = np.random.default_rng(0)
    uris, labels = [], []
    for i in range(8):
        p = str(d / f"im{i}.png")
        Image.fromarray(rng.integers(0, 255, (20, 22, 3), np.uint8)).save(p)
        uris.append(p)
        labels.append(np.eye(2, dtype=np.float32)[i % 2])
    lab = np.empty(len(labels), dtype=object)
    lab[:] = labels
    return np.array(uris, dtype=object), lab


@pytest.fixture(scope="module")
def trainable_h5(tmp_path_factory):
    """A tf_keras image model whose new layers carry variables (PReLU,
    LayerNormalization) beside Conv2D and a softmax head, as ``.h5``."""
    L = tf_keras.layers
    tf_keras.backend.clear_session()
    tf_keras.utils.set_random_seed(0)
    inp = tf_keras.Input((16, 16, 3))
    x = L.Conv2D(4, 3, strides=2)(inp)
    x = L.PReLU(shared_axes=[1, 2])(x)
    x = L.LayerNormalization()(x)
    x = L.GlobalAveragePooling2D()(x)
    model = tf_keras.Model(inp, L.Dense(2, activation="softmax")(x))
    w = model.get_weights()
    w[2] = np.linspace(-0.3, 0.3, w[2].size).reshape(w[2].shape)
    model.set_weights(w)
    path = str(tmp_path_factory.mktemp("keras2_train") / "small.h5")
    model.save(path)
    return path


def _loader():
    from tpudl_torch.image.imageIO import createNativeImageLoader

    return createNativeImageLoader(16, 16, scale=1.0 / 255.0)


def _fit_kw(path):
    return dict(inputCol="uri", outputCol="out", labelCol="label",
                imageLoader=_loader(), modelFile=path,
                kerasOptimizer="sgd", kerasLoss="categorical_crossentropy",
                kerasFitParams={"epochs": 1, "batch_size": 4,
                                "shuffle": False})


def _tpudl_fit(path, uris, labels):
    """tpudl's per-step losses and last params (``_jax_fit``'s recording
    in ``test_torch_keras_train.py``)."""
    from tpudl.frame import Frame as JaxFrame
    from tpudl.image.imageIO import createNativeImageLoader
    from tpudl.ml import KerasImageFileEstimator as JaxEstimator

    kw = _fit_kw(path)
    kw["imageLoader"] = createNativeImageLoader(16, 16, scale=1.0 / 255.0)
    est = JaxEstimator(**kw)
    steps, last = [], {}
    get_step = est._get_step

    def recording(*a, **k):
        entry = get_step(*a, **k)
        inner = entry.step

        def step(p, s, xb, yb):
            out = inner(p, s, xb, yb)
            steps.append(float(out[2]))
            last["params"] = out[0]
            return out

        entry.step = step
        return entry

    est._get_step = recording
    est.fit(JaxFrame({"uri": uris, "label": labels}))
    return steps, {k: np.asarray(v) for k, v in last["params"].items()}


def test_estimator_fits_a_keras2_h5_as_tpudl_does(trainable_h5, image_set):
    """2 sgd steps of batch 4 from the ``.h5``: losses within 1e-5 of
    tpudl's, each trained variable within 1e-3 of the largest update, the
    trained file a ``.keras`` read back bit for bit; the returned
    transformer and ``registerKerasImageUDF`` over the ``.h5`` within
    2e-5 of max |y| of tf_keras's ``predict`` on the same pixels."""
    from tpudl_torch.image import imageArrayToStruct
    from tpudl_torch.ml import (KerasImageFileEstimator,
                                KerasImageFileTransformer)
    from tpudl_torch.udf import registerKerasImageUDF, unregister_udf

    uris, labels = image_set
    jsteps, jparams = _tpudl_fit(trainable_h5, uris, labels)
    fitted = KerasImageFileEstimator(device="cpu", **_fit_kw(
        trainable_h5)).fit(Frame({"uri": uris, "label": labels}))
    steps = fitted.history["step_loss"]
    np.testing.assert_allclose(steps, jsteps, atol=1e-5, rtol=0)
    _c, start = load_keras_file(trainable_h5)
    path = fitted.getModelFile()
    assert path.endswith(".keras")
    _c, trained = load_keras_file(path)
    assert list(trained) == list(start) and set(start) == set(jparams)
    top = max(np.abs(jparams[k] - start[k]).max() for k in start)
    for k in start:
        assert np.abs(trained[k] - jparams[k]).max() <= 1e-3 * top, k
    os.remove(path)
    # the inference stages over the .h5 itself
    model = tf_keras.models.load_model(trainable_h5, compile=False)
    tr = KerasImageFileTransformer(inputCol="uri", outputCol="out",
                                   modelFile=trainable_h5,
                                   imageLoader=_loader(), device="cpu")
    out = np.stack(list(tr.transform(Frame({"uri": uris}))["out"]))
    X, _y = KerasImageFileEstimator(device="cpu", **_fit_kw(
        trainable_h5))._getNumpyFeaturesAndLabels(
            Frame({"uri": uris, "label": labels}))
    assert out.shape == (8, 2)
    assert _rel(out, model.predict(X, verbose=0)) <= RTOL
    arrs = np.random.default_rng(3).integers(0, 255, (5, 16, 16, 3),
                                             dtype=np.uint8)
    structs = np.empty(5, dtype=object)
    structs[:] = [imageArrayToStruct(a) for a in arrs]
    udf = registerKerasImageUDF("keras2_small", trainable_h5,
                                lambda x: x / 255.0, batch_size=2,
                                device="cpu")
    try:
        got = np.stack(list(udf(Frame({"image": structs}))[
            udf.output_col]))
    finally:
        unregister_udf("keras2_small")
    want = model.predict(arrs[..., ::-1].astype(np.float32) / 255.0,
                         verbose=0)
    assert _rel(got, want) <= RTOL


def test_fit_multiple_over_a_keras2_h5_equals_plain_fits(trainable_h5,
                                                         image_set):
    """``fitMultiple`` over two learning rates from the ``.h5``: each
    trial's losses and trained weights equal a plain ``fit`` with that
    map, bit for bit."""
    from tpudl_torch.ml import KerasImageFileEstimator

    uris, labels = image_set
    frame = Frame({"uri": uris, "label": labels})
    est = KerasImageFileEstimator(device="cpu", **_fit_kw(trainable_h5))
    maps = [{est.kerasFitParams: {"epochs": 1, "batch_size": 4,
                                  "shuffle": False, "learning_rate": lr}}
            for lr in (1e-2, 1e-3)]
    swept = dict(est.fitMultiple(frame, maps))
    assert sorted(swept) == [0, 1]
    for i, pm in enumerate(maps):
        alone = est.fit(frame, pm)
        assert swept[i].history == alone.history
        a, b = (load_keras_file(m.getModelFile())[1] for m in
                (swept[i], alone))
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)
        for m in (swept[i], alone):
            os.remove(m.getModelFile())
    assert swept[0].history != swept[1].history


def test_first_step_gradients_against_float64(trainable_h5, image_set):
    """The estimator's first step on the ``.h5`` in f32 against the same
    step in float64, within 1e-2 of the largest gradient (phase 9's
    check)."""
    from tpudl_torch.ml import KerasImageFileEstimator
    from tpudl_torch.ml.losses import get_loss

    uris, labels = image_set
    est = KerasImageFileEstimator(device="cpu", **_fit_kw(trainable_h5))
    X, y = est._getNumpyFeaturesAndLabels(Frame({"uri": uris,
                                                 "label": labels}))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        gin = est._ingest()
        p = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
             for k, v in gin.params.items()}
        loss = get_loss("categorical_crossentropy")(
            gin.make_fn()(p, torch.tensor(X[:4], dtype=dtype)),
            torch.tensor(y[:4], dtype=dtype))
        loss.backward()
        grads[dtype] = {k: v.grad.double().numpy() for k, v in p.items()}
    top = max(np.abs(g).max() for g in grads[torch.float64].values())
    for k, g in grads[torch.float64].items():
        assert np.abs(grads[torch.float32][k] - g).max() <= 1e-2 * top, k


def test_trainable_keys_and_gradients_match_tpudl():
    """``fromKerasTrainable`` on a Keras 2 file: tpudl's keys, and every
    gradient (Embedding, Conv1D, LayerNormalization, Dense) within 1e-4
    of the largest of tpudl's."""
    path = str(FIXTURES / "text_layers.h5")
    x = _x(tf_keras.models.load_model(path, compile=False), seed=1)
    tg, jg = (TFInputGraph.fromKerasTrainable(path),
              JaxGraph.fromKerasTrainable(path))
    assert set(tg.params) == set(jg.params)
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in tg.params.items()}
    y = tg.make_fn()(params, torch.from_numpy(x))
    r = np.random.default_rng(2).normal(size=y.shape).astype(np.float32)
    (y * torch.from_numpy(r)).sum().backward()
    jf = jg.make_fn()
    want = jax.jit(jax.grad(lambda p: jnp.sum(jf(p, jnp.asarray(x)) * r)))(
        jax.tree.map(jnp.asarray, tg.params))
    top = max(float(np.abs(np.asarray(g)).max()) for g in want.values())
    for k, g in want.items():
        assert np.abs(params[k].grad.numpy() - np.asarray(g)).max() <= \
            1e-4 * top, k


@pytest.mark.parametrize("name", ["text_cnn", "image_layers", "attention",
                                  "groups"])
def test_keras2_model_written_as_keras_loads_in_keras3(name, tmp_path):
    """A model read from a Keras 2 ``.h5`` is written as ``.keras`` (as the
    estimator writes what it trained) that keras 3 loads, with the same
    weights and predictions (keras 3 cannot read the ``.h5`` of some of
    them)."""
    path = str(FIXTURES / f"{name}.h5")
    config, weights = load_keras_file(path)
    out = save_keras_file(tmp_path / f"{name}.keras", config, weights,
                          layout="h5")
    ours = keras.saving.load_model(out, compile=False)
    assert len(ours.weights) == len(weights)
    for w, v in zip(ours.weights, load_keras_file(out)[1].values()):
        assert np.array_equal(np.asarray(w.numpy()), v)
    x = _x(tf_keras.models.load_model(path, compile=False))
    assert _rel(ours.predict(x, verbose=0), _tf_predict(path, x)) <= RTOL


def test_named_stage_weights_from_a_keras2_h5_as_tpudl(apps):
    """``params_from_keras`` (a named stage's ``weights=``) reads tf_keras's
    ResNet50 ``.h5`` to tpudl's param pytree bit for bit."""
    from tpudl.zoo.convert import load_keras_model
    from tpudl.zoo.convert import params_from_keras as jax_params
    from tpudl_torch.zoo.convert import params_from_keras

    ours = params_from_keras(apps["ResNet50"])
    theirs = jax_params(load_keras_model(apps["ResNet50"]))
    assert set(ours) == set(theirs)
    for layer, leaves in theirs.items():
        assert set(ours[layer]) == set(leaves), layer
        for k, v in leaves.items():
            assert np.asarray(v).tobytes() == ours[layer][k].tobytes(), \
                (layer, k)


def test_bf16_keras_file_reads_runs_and_writes_back(tmp_path):
    """The committed ``bf16_policy.keras``: bfloat16 variables read (the
    HDF5 reader used to refuse their opaque datatype) to keras's values,
    the model within 1e-2 of max |y| of keras's ``predict`` and of
    tpudl's, and ``save_keras_file`` stores them as bfloat16 again: keras
    loads the written file to the same weights bit for bit."""
    path = str(FIXTURES / "bf16_policy.keras")
    config, weights = load_keras_file(path)
    model = keras.saving.load_model(path, compile=False)
    assert [w.path for w in model.weights] == list(weights)
    dtypes = {w.path: w.dtype for w in model.weights}
    assert "bfloat16" in dtypes.values()
    for w in model.weights:
        assert np.array_equal(np.asarray(w.numpy(), np.float32),
                              weights[w.path]), w.path
    x = (3 * np.random.default_rng(0).normal(size=(4, 8, 8, 3))).astype(
        np.float32)
    want = np.asarray(model.predict(x, verbose=0), np.float32)
    got = TFInputGraph.fromKeras(path).make_fn()(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= BF16_RTOL
    assert _rel(got, _tpudl(path, x)) <= BF16_RTOL
    out = save_keras_file(tmp_path / "again.keras", config, weights)
    again = keras.saving.load_model(out, compile=False)
    for a, b in zip(again.weights, model.weights):
        assert a.dtype == b.dtype and np.array_equal(
            np.asarray(a.numpy(), np.float32),
            np.asarray(b.numpy(), np.float32)), a.path


@pytest.mark.parametrize("name", ["text_cnn", "nested", "slash", "groups",
                                  "attention", "image_layers"])
def test_writer_matches_tf_keras(name, tmp_path):
    """The fixture's own config and weights through ``write_keras2_h5``:
    the same config and weights read back bit for bit, the same groups,
    datasets and ``weight_names`` as tf_keras wrote, and tf_keras loads it
    to the same predictions."""
    src = str(FIXTURES / f"{name}.h5")
    raw = json.loads(hdf5.read(Path(src).read_bytes()).attrs["model_config"])
    config, weights = load_keras_file(src)
    out = keras2_h5_writer.write_keras2_h5(tmp_path / f"{name}.h5", raw,
                                           weights)
    config2, weights2 = load_keras_file(out)
    assert config2 == config and list(weights2) == list(weights)
    for k in weights:
        assert weights[k].dtype == weights2[k].dtype
        assert weights[k].tobytes() == weights2[k].tobytes(), k

    def entries(path):
        found = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda n, o: found.__setitem__(n, [
                str(v) for v in o.attrs.get("weight_names", [])]))
            top = {k: str(v) for k, v in f.attrs.items()}
            mw = [str(v) for v in f["model_weights"].attrs["layer_names"]]
        return found, top, mw

    (a, ta, la), (b, tb, lb) = entries(src), entries(out)
    assert a == b and la == lb
    assert json.loads(ta.pop("model_config")) == json.loads(
        tb.pop("model_config")) and ta == tb
    model = tf_keras.models.load_model(out, compile=False)
    x = _x(model)
    assert np.array_equal(model.predict(x, verbose=0), _tf_predict(src, x))


def test_chip_configs_are_what_tf_keras_writes_and_key_phase_9s_weights():
    """``chip_smoke.py`` phase 12's tf_keras InceptionV3 + head config has
    the layer names (so the variable keys) of phase 9's keras 3 config,
    and the text classifier is keras-io's."""
    import make_keras2_fixtures as MK
    import torch_keras_models as M

    def gz(name):
        with gzip.open(FIXTURES / name, "rt") as f:
            return json.load(f)

    k2 = gz("inception_v3_tl.keras2.config.json.gz")
    assert k2 == MK.inception_config()
    from tpudl_torch.ingest.kerasfile import variable_paths
    from tpudl_torch.ingest.keras_legacy import keras3_config

    assert [p for *_r, p in variable_paths(keras3_config(k2), "h5")] == \
        [p for *_r, p in variable_paths(M.fixture_config())]
    text = gz("text_classifier.keras2.config.json.gz")
    assert text == MK.text_classifier_config()
