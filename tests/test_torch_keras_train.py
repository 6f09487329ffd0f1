"""The Keras surface's training half, held to tpudl on the CPU: the seven
optimizers against optax, the losses against ``tpudl.ml.losses``,
``KerasImageFileEstimator.fit`` against tpudl's fit, and
``LogisticRegression`` against tpudl's.

Tolerances:
- optimizers, 5 steps on the same gradients (sizes 1e-6 to 2), then a
  learning-rate change without a rebuild: parameters within 1e-4 of the
  total displacement (f32 steps in another order; read ≤ 3.6e-5, adam);
- losses within 1e-6 relative (the same f32 formulas);
- the estimator on ``bench.py``'s ``measure_estimator_fit`` set (32 PNGs,
  its CNN, 2 epochs of batch 16, adam): per-step losses within 1e-5,
  trained params within 1e-3 of the largest update, the returned
  transformers' outputs within 1e-5. Adam's first steps amplify rounding
  in tiny gradients (its update is ~lr·sign(g)); on this set the losses
  read 6e-8 apart and the params 6e-8 of their largest value;
- ``LogisticRegression``: per-iteration losses within 1e-5 and
  probabilities within 1e-5 (100 adam steps, f32)."""

import os

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch_keras_models as M  # noqa: E402
from PIL import Image  # noqa: E402

from tpudl.frame import Frame as JaxFrame  # noqa: E402
from tpudl.ml import KerasImageFileEstimator as JaxEstimator  # noqa: E402
from tpudl.ml import LogisticRegression as JaxLR  # noqa: E402
from tpudl.ml import losses as jax_losses  # noqa: E402
from tpudl_torch.frame import Frame  # noqa: E402
from tpudl_torch.ingest.kerasfile import load_keras_file  # noqa: E402
from tpudl_torch.ml import (KerasImageFileEstimator,  # noqa: E402
                            LogisticRegression)
from tpudl_torch.ml import losses  # noqa: E402

OPTIMIZERS = ("sgd", "adam", "rmsprop", "adagrad", "adadelta", "adamax",
              "nadam")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax_and_takes_a_new_rate(name):
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) * s
             for s in (1, 1e-3, 0.5, 2, 1e-6, 1, 1)]
    jopt, jlr = jax_losses.get_optimizer_dynamic(name)
    factory, lr = losses.get_optimizer_dynamic(name)
    assert lr == jlr
    pj = {"w": jnp.asarray(p0)}
    state = jopt.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = factory([pt])
    for i, g in enumerate(grads):
        if i == 5:   # a new learning rate, same optimizer and state
            state.hyperparams["learning_rate"] = jnp.asarray(0.05,
                                                             jnp.float32)
            losses.set_learning_rate(opt, 0.05)
        upd, state = jopt.update({"w": jnp.asarray(g)}, state, pj)
        pj = jax.tree.map(lambda a, u: a + u, pj, upd)
        pt.grad = torch.from_numpy(g.copy())
        opt.step()
        want = np.asarray(pj["w"])
        err = np.abs(pt.detach().numpy() - want).max() / \
            np.abs(want - p0).max()
        assert err <= 1e-4, (i, err)


def test_optimizer_names_and_defaults_are_tpudls():
    assert losses.OPTIMIZERS == jax_losses.OPTIMIZERS
    assert set(losses.LOSSES) == set(jax_losses.LOSSES)
    assert losses._OPT_DEFAULT_LR == jax_losses._OPT_DEFAULT_LR
    with pytest.raises(KeyError, match="unknown optimizer"):
        losses.get_optimizer("lamb")
    with pytest.raises(KeyError, match="unknown loss"):
        losses.get_loss("hinge")


@pytest.mark.parametrize("name", sorted(jax_losses.LOSSES))
def test_loss_matches_tpudl(name):
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, (6, 4)).astype(np.float32)
    pred[0, 0], pred[1, 1] = 0.0, 1.0      # the clip at 1e-7 and 1 - 1e-7
    pred /= pred.sum(axis=1, keepdims=True)
    if name == "sparse_categorical_crossentropy":
        y = rng.integers(0, 4, 6).astype(np.int32)
    elif name == "binary_crossentropy":
        y = rng.integers(0, 2, (6, 4)).astype(np.float32)
    else:
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    want = float(jax_losses.get_loss(name)(jnp.asarray(pred),
                                           jnp.asarray(y)))
    got = float(losses.get_loss(name)(torch.from_numpy(pred),
                                      torch.from_numpy(y)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


# -- the estimator on measure_estimator_fit's set ---------------------------
def _loader(uri):
    img = Image.open(uri).convert("RGB").resize((32, 32), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


@pytest.fixture(scope="module")
def fit_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("est")
    rng = np.random.default_rng(0)
    uris, labels = [], []
    for i in range(32):
        arr = rng.integers(0, 255, size=(48, 48, 3), dtype=np.uint8)
        p = str(d / f"im{i}.png")
        Image.fromarray(arr).save(p)
        uris.append(p)
        labels.append(np.eye(2, dtype=np.float32)[i % 2])
    lab = np.empty(len(labels), dtype=object)
    lab[:] = labels
    return M.saved("cnn", d), np.array(uris, dtype=object), lab


def _kw(path, **fit):
    return dict(inputCol="uri", outputCol="out", labelCol="label",
                imageLoader=_loader, modelFile=path, kerasOptimizer="adam",
                kerasLoss="categorical_crossentropy",
                kerasFitParams={"epochs": 2, "batch_size": 16, **fit})


def _jax_fit(path, uris, labels, **fit):
    """tpudl's fit, its per-step losses and its last trained params."""
    est = JaxEstimator(**_kw(path, **fit))
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
    model = est.fit(JaxFrame({"uri": uris, "label": labels}))
    return model, steps, {k: np.asarray(v) for k, v in last["params"].items()}


@pytest.mark.parametrize("fit", [{}, {"batch_size": 12, "seed": 3,
                                      "learning_rate": 0.01}])
def test_fit_matches_tpudl(fit_set, fit):
    """Per-step losses, trained params and the returned transformers'
    outputs; batch 12 over 32 rows also wraps the ragged tail."""
    path, uris, labels = fit_set
    jmodel, jsteps, jparams = _jax_fit(path, uris, labels, **fit)
    model = KerasImageFileEstimator(device="cpu", **_kw(path, **fit)).fit(
        Frame({"uri": uris, "label": labels}))
    assert len(model.history["step_loss"]) == len(jsteps) == \
        2 * -(-32 // fit.get("batch_size", 16))
    np.testing.assert_allclose(model.history["step_loss"], jsteps, atol=1e-5,
                               rtol=0)
    _cfg, trained = load_keras_file(model.getModelFile())
    _cfg, start = load_keras_file(path)
    assert list(trained) == list(start)
    top = max(np.abs(jparams[k] - start[k]).max() for k in start)
    for k in start:
        assert np.abs(trained[k] - jparams[k]).max() <= 1e-3 * top, k
    theirs = np.stack(list(jmodel.transform(JaxFrame({"uri": uris}))["out"]))
    ours = np.stack(list(model.transform(Frame({"uri": uris}))["out"]))
    assert ours.shape == theirs.shape == (32, 2)
    assert np.abs(ours - theirs).max() <= 1e-5
    # the artifact round-trips for a sparkdl user: keras reads it
    km = keras.saving.load_model(model.getModelFile(), compile=False)
    x = np.stack([_loader(u) for u in uris])
    assert np.abs(km.predict(x, verbose=0) - ours).max() <= 1e-5
    os.remove(model.getModelFile())


def test_fit_does_not_write_through_to_the_ingested_params(fit_set):
    path, uris, labels = fit_set
    est = KerasImageFileEstimator(device="cpu", **_kw(path, epochs=1))
    X, y = est._getNumpyFeaturesAndLabels(Frame({"uri": uris,
                                                 "label": labels}))
    gin = est._ingest()
    before = {k: v.copy() for k, v in gin.params.items()}
    params, epochs, steps = est._train_one(gin, X, y)
    assert len(epochs) == 1 and len(steps) == 2
    for k in before:
        assert np.array_equal(gin.params[k], before[k])
        assert not torch.equal(params[k].detach(), torch.from_numpy(before[k]))


def test_fit_params_are_validated(fit_set):
    path, uris, labels = fit_set
    est = KerasImageFileEstimator(device="cpu", **_kw(path, nonsense=True))
    with pytest.raises(ValueError, match="nonsense"):
        est.fit(Frame({"uri": uris, "label": labels}))
    with pytest.raises(ValueError, match="empty frame"):
        KerasImageFileEstimator(device="cpu", **_kw(path)).fit(
            Frame({"uri": uris[:0], "label": labels[:0]}))


@pytest.mark.parametrize("knob,item", [
    ("mesh", "Training, rest"), ("modelAxis", "LM parallelism"),
    ("paramShardings", "LM parallelism"), ("wireCodec", "Data layer"), ("cacheDir", "Data layer"),
    ("deviceCache", "Data layer")])
def test_unported_knobs_are_refused_by_name(fit_set, knob, item):
    with pytest.raises(NotImplementedError, match=item):
        KerasImageFileEstimator(device="cpu", **{knob: object()},
                                **_kw(fit_set[0]))


def test_fit_multiple_is_refused_by_name(fit_set):
    """fitMultiple and fit over a list of maps run (tests/
    test_torch_tuning.py holds them to tpudl); what is still refused by
    name is a mesh-wide trial, and the default device without a card."""
    path, uris, labels = fit_set
    frame = Frame({"uri": uris, "label": labels})
    with pytest.raises(NotImplementedError, match="Training, rest"):
        KerasImageFileEstimator(device="cpu", mesh=object(), **_kw(path))
    est = KerasImageFileEstimator(**_kw(path))            # device="cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        dict(est.fitMultiple(frame, [{}]))
    est = KerasImageFileEstimator(device="cpu", **_kw(path, epochs=1))
    models = est.fit(frame, [{}, {est.kerasFitParams: {"epochs": 1,
                                                       "batch_size": 8}}])
    assert [len(m.history["step_loss"]) for m in models] == [2, 4]
    for m in models:
        os.remove(m.getModelFile())


def test_missing_card_raises_instead_of_running_on_the_cpu(fit_set):
    path, uris, labels = fit_set
    est = KerasImageFileEstimator(**_kw(path))          # device="cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        est.fit(Frame({"uri": uris, "label": labels}))


# -- LogisticRegression -----------------------------------------------------
def test_logistic_regression_matches_tpudl():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 12)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 3] > 0).astype(np.int64) + \
        (X[:, 1] > 1).astype(np.int64)
    col = np.empty(64, dtype=object)
    col[:] = list(X)
    kw = dict(maxIter=40, regParam=0.01, learningRate=0.05)
    theirs = JaxLR(**kw).fit(JaxFrame({"features": col, "label": y}))
    ours = LogisticRegression(device="cpu", **kw).fit(
        Frame({"features": col, "label": y}))
    np.testing.assert_allclose(ours.history, theirs.history, atol=1e-5)
    assert ours.numClasses == theirs.numClasses == 3
    a = ours.transform(Frame({"features": col}))
    b = theirs.transform(JaxFrame({"features": col}))
    np.testing.assert_allclose(np.stack(list(a["probability"])),
                               np.stack(list(b["probability"])), atol=1e-5)
    assert np.array_equal(a["prediction"], b["prediction"])
    assert ours.history[-1] < ours.history[0]
