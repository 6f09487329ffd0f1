"""Nested models and legacy ``.h5`` model files, read without keras
(``tpudl_torch.ingest.kerasfile``) and run by the Keras evaluator, held to
keras and to tpudl on files keras writes here: each model saved both as
``.h5`` (``model.save("x.h5")``) and as ``.keras``.

- Both files read to the same weights bit for bit, each keyed as keras
  keys the model it loads from that file (a legacy ``.h5`` keys a
  Sequential's layers under the model's name, as tpudl does too).
- The ``.h5`` form through ``TFInputGraph.fromKeras`` within 1e-5 of max
  |y| of keras's ``predict`` and of tpudl's ``fromKeras`` on the same
  file.
- A model read from ``.h5`` is written as ``.keras`` (as tpudl's
  estimator writes whatever it read) that keras loads with the same
  weights and predictions.
- The transfer-learning form ``Sequential([MobileNetV2 base, head])``
  from ``.h5`` through ``KerasImageFileEstimator``: 2 sgd steps held to
  tpudl's (losses within 1e-5; each trained variable within 1e-3 of the
  largest update, and the whole update's cosine at least 0.9999).
- Keras 1/2-era files are refused by name; so is a nested model whose
  variables keras would key as one."""

import json
import os

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_keras_models as M  # noqa: E402
from test_torch_keras_train import _kw  # noqa: E402

from tpudl.ingest import TFInputGraph as JaxGraph  # noqa: E402
from tpudl_torch.frame import Frame  # noqa: E402
from tpudl_torch.ingest import TFInputGraph  # noqa: E402
from tpudl_torch.ingest.kerasfile import (file_layout,  # noqa: E402
                                          load_keras_file, save_keras_file)
from tpudl_torch.ml import KerasImageFileEstimator  # noqa: E402

RTOL = 1e-5
# 2 sgd steps through 52 BatchNormalizations (perturbed): each trained
# variable within 1e-3 of the largest update, as test_torch_keras_train.py
# holds the CNN, and the whole update by its cosine
UPDATE_RTOL = 1e-3
UPDATE_COSINE = 0.9999
MODELS = {"cnn": None, "functional": None, "nested": 32,
          "nested_functional": None, "nested_deep": None,
          "mobilenet_v2": 32, "efficientnet_b0": 32, "xception": 71}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``{model: {"keras": path, "h5": path}}``, one keras build each,
    BN statistics and shifts perturbed from a seed (at Keras's init a
    ReLU6 meets exact zeros, where tpudl's ``jnp.clip`` passes a gradient
    and TF's ``Relu6Grad``, which the port follows, does not)."""
    d = tmp_path_factory.mktemp("h5")
    out = {}
    for name, side in MODELS.items():
        model = M.build(name, side)
        if not model.built:
            model.build((None,) + tuple(model.inputs[0].shape[1:]))
        weights = M.perturbed({w.path: w.numpy() for w in model.weights})
        model.set_weights(list(weights.values()))
        out[name] = {}
        for ext in ("keras", "h5"):
            out[name][ext] = str(d / f"{name}.{ext}")
            model.save(out[name][ext])
    return out


def _x(path, seed=0):
    shape = keras.saving.load_model(path, compile=False).inputs[0].shape
    return np.random.default_rng(seed).normal(
        size=(2,) + tuple(shape[1:])).astype(np.float32)


@pytest.mark.parametrize("name", MODELS)
def test_h5_and_keras_files_read_to_equal_weights(files, name):
    ck, wk = load_keras_file(files[name]["keras"])
    ch, wh = load_keras_file(files[name]["h5"])
    assert file_layout(files[name]["h5"]) == "h5"
    assert file_layout(files[name]["keras"]) == "keras"
    assert len(wh) == len(wk)
    for (kk, a), (kh, b) in zip(wk.items(), wh.items()):
        assert kh.endswith(kk) and a.dtype == b.dtype, (kk, kh)
        assert a.tobytes() == b.tobytes(), kk
    for ext, weights in (("keras", wk), ("h5", wh)):
        model = keras.saving.load_model(files[name][ext], compile=False)
        assert list(weights) == [w.path for w in model.weights], ext
    assert ch["class_name"] == ck["class_name"]


@pytest.mark.parametrize("name", MODELS)
def test_h5_runs_as_keras_and_tpudl_read_it(files, name):
    path = files[name]["h5"]
    x = _x(path)
    got = TFInputGraph.fromKeras(path).make_fn()(torch.from_numpy(x))
    got = got.numpy()
    want = keras.saving.load_model(path, compile=False).predict(x, verbose=0)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    theirs = np.asarray(jax.jit(JaxGraph.fromKeras(path).make_fn())(
        jnp.asarray(x)))
    assert np.abs(got - theirs).max() <= RTOL * np.abs(theirs).max()


@pytest.mark.parametrize("name", ["cnn", "nested", "nested_deep",
                                  "efficientnet_b0"])
def test_h5_model_written_as_keras_loads_in_keras(files, name, tmp_path):
    config, weights = load_keras_file(files[name]["h5"])
    weights = M.perturbed(weights)
    path = save_keras_file(tmp_path / "from_h5.keras", config, weights,
                           layout="h5")
    ours = keras.saving.load_model(path, compile=False)
    ref = keras.saving.load_model(files[name]["h5"], compile=False)
    ref.set_weights([weights[w.path] for w in ref.weights])
    for a, b in zip(ours.weights, ref.weights):
        assert np.array_equal(np.asarray(a.numpy()), np.asarray(b.numpy()))
    x = _x(files[name]["h5"])
    assert np.array_equal(ours.predict(x, verbose=0),
                          ref.predict(x, verbose=0))


def test_nested_trainable_keys_and_gradients_match_tpudl(files):
    """A nested ``.keras`` model: the same keys as tpudl's params, and
    every variable's gradient within 1e-4 of the largest of tpudl's."""
    path = files["nested_functional"]["keras"]
    x = _x(path, seed=1)
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


@pytest.fixture(scope="module")
def nested_set(tmp_path_factory, files):
    from PIL import Image

    d = tmp_path_factory.mktemp("nested_fit")
    rng = np.random.default_rng(0)
    uris, labels = [], []
    for i in range(8):
        p = str(d / f"im{i}.png")
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8)).save(p)
        uris.append(p)
        labels.append(np.eye(2, dtype=np.float32)[i % 2])
    lab = np.empty(len(labels), dtype=object)
    lab[:] = labels
    return np.array(uris, dtype=object), lab


def _tpudl_sgd_fit(path, uris, labels, **fit):
    """tpudl's fit with sgd: its per-step losses and last trained params
    (``test_torch_keras_train._jax_fit``'s recording)."""
    from tpudl.frame import Frame as JaxFrame
    from tpudl.ml import KerasImageFileEstimator as JaxEstimator

    kw = _kw(path, **fit)
    kw["kerasOptimizer"] = "sgd"
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


def test_nested_h5_estimator_matches_tpudl(files, nested_set):
    """``Sequential([MobileNetV2 base, head])`` from ``.h5``: 2 sgd steps
    of batch 4; the trained file is a ``.keras`` of the same model."""
    uris, labels = nested_set
    path = files["nested"]["h5"]
    fit = {"epochs": 1, "batch_size": 4, "shuffle": False}
    jsteps, jparams = _tpudl_sgd_fit(path, uris, labels, **fit)
    kw = _kw(path, **fit)
    kw["kerasOptimizer"] = "sgd"
    model = KerasImageFileEstimator(device="cpu", **kw).fit(
        Frame({"uri": uris, "label": labels}))
    steps = model.history["step_loss"]
    assert len(steps) == len(jsteps) == 2
    np.testing.assert_allclose(steps, jsteps, atol=1e-5, rtol=0)
    _cfg, start = load_keras_file(path)
    assert set(start) == set(jparams)
    assert "sequential/dense/kernel" in start      # the .h5 layout's key
    _cfg, trained = load_keras_file(model.getModelFile())
    assert model.getModelFile().endswith(".keras")
    assert len(trained) == len(start)
    top = max(np.abs(jparams[k] - start[k]).max() for k in start)
    ours, theirs = [], []
    for k, kt in zip(start, trained):
        assert k.endswith(kt), (k, kt)
        err = np.abs(trained[kt] - jparams[k]).max() / top
        assert err <= UPDATE_RTOL, (k, err)
        ours.append((trained[kt] - start[k]).ravel())
        theirs.append((jparams[k] - start[k]).ravel())
    ours, theirs = np.concatenate(ours), np.concatenate(theirs)
    cos = ours @ theirs / np.linalg.norm(ours) / np.linalg.norm(theirs)
    assert cos >= UPDATE_COSINE, cos
    os.remove(model.getModelFile())


def test_committed_h5_fixture_reads_as_keras_reads_it():
    """``tests/fixtures/keras/cnn.h5`` (chip_smoke.py runs it on the
    card): keras's own file, read to keras's weights and outputs."""
    path = str(M.H5_FIXTURE)
    model = keras.saving.load_model(path, compile=False)
    _config, weights = load_keras_file(path)
    assert list(weights) == [w.path for w in model.weights]
    for w in model.weights:
        assert np.array_equal(weights[w.path], np.asarray(w.numpy()))
    x = np.random.default_rng(0).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    got = TFInputGraph.fromKeras(path).make_fn()(torch.from_numpy(x))
    want = model.predict(x, verbose=0)
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()

def test_committed_h5_fixture_is_what_keras_writes_today(tmp_path):
    fresh = M.saved("cnn", tmp_path, ext="h5")
    with h5py.File(M.H5_FIXTURE, "r") as f, h5py.File(fresh, "r") as g:
        assert json.loads(f.attrs["model_config"]) == json.loads(
            g.attrs["model_config"])
        assert f.attrs["keras_version"] == g.attrs["keras_version"]
    for a, b in zip(load_keras_file(M.H5_FIXTURE)[1].values(),
                    load_keras_file(fresh)[1].values()):
        assert a.tobytes() == b.tobytes()


def _legacy_copy(src, dst, edit):
    with open(src, "rb") as f, open(dst, "wb") as g:
        g.write(f.read())
    with h5py.File(dst, "r+") as f:
        edit(f)
    return dst


def test_keras2_era_files_are_refused_by_name(tmp_path):
    src = str(M.H5_FIXTURE)

    def weight_names(f):
        g = f["model_weights/conv2d"]
        g.attrs["weight_names"] = [b"conv2d/kernel:0", b"conv2d/bias:0"]

    def list_nodes(f):
        config = json.loads(f.attrs["model_config"])
        config["class_name"] = "Functional"
        config["config"]["input_layers"] = [["input_layer", 0, 0]]
        config["config"]["output_layers"] = [["dense", 0, 0]]
        prev = "input_layer"
        for layer in config["config"]["layers"]:
            layer["inbound_nodes"] = [] if prev == layer["config"]["name"] \
                else [[[prev, 0, 0, {}]]]
            prev = layer["config"]["name"]
        f.attrs["model_config"] = json.dumps(config)

    for edit, match in ((weight_names, "Keras 2-era weight names"),
                        (list_nodes, "Keras 2-era inbound nodes")):
        path = _legacy_copy(src, tmp_path / f"{edit.__name__}.h5", edit)
        with pytest.raises(NotImplementedError, match=match):
            TFInputGraph.fromKeras(path)
    path = _legacy_copy(src, tmp_path / "weights_only.h5",
                        lambda f: f.attrs.__delitem__("model_config"))
    with pytest.raises(ValueError, match="not a Keras model file"):
        load_keras_file(path)
