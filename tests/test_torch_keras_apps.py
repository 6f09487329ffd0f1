"""The named models' own Keras files — Keras Xception (71×71),
MobileNetV2 and EfficientNetB0 (32×32), ``weights=None``,
``include_top=False``, ``pooling="avg"``, BN statistics perturbed from a
seed — through the port's Keras evaluator, held to keras's ``predict``
on the file and to tpudl's ``TFInputGraph.fromKeras``; the first-step
f32 gradients of every variable against a float64 run of the port; and
``chip_smoke.keras_weights``'s seeded initialization of their configs
against keras's own ``weights=None`` statistics.

Tolerances: outputs within 1e-5 of max |y| (f32 convolutions summed in
other orders over 36–82 layers); f32 gradients within 1e-2 of the
largest gradient off float64 (phase 9's limit on the card; BN shifts sum
a layer's gradient over every position with cancellation); seeded
statistics within sampling (a kernel's standard deviation and mean within
5 standard errors of keras's draw, the deviations at least within 10%)."""

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_keras_models as M  # noqa: E402

from tpudl.ingest import TFInputGraph as JaxGraph  # noqa: E402
from tpudl_torch.ingest import TFInputGraph  # noqa: E402
from tpudl_torch.ingest.kerasfile import (load_keras_file,  # noqa: E402
                                          save_keras_file)

RTOL = 1e-5
GRAD_RTOL = 1e-2
SIDES = {"xception": 71, "mobilenet_v2": 32, "efficientnet_b0": 32}


@pytest.fixture(scope="module", params=sorted(SIDES))
def app(request, tmp_path_factory):
    """``(name, keras-written file, port-written file with perturbed BN
    statistics)``."""
    name = request.param
    d = tmp_path_factory.mktemp(name)
    path = M.saved(name, d, SIDES[name])
    config, weights = load_keras_file(path)
    return name, path, save_keras_file(d / f"{name}_p.keras", config,
                                       M.perturbed(weights))


def _x(name, seed=0):
    side = SIDES[name]
    return np.random.default_rng(seed).normal(
        size=(2, side, side, 3)).astype(np.float32)


def test_forward_matches_keras_and_tpudl(app):
    name, _path, path = app
    x = _x(name)
    got = TFInputGraph.fromKeras(path).make_fn()(torch.from_numpy(x))
    got = got.numpy()
    want = keras.saving.load_model(path).predict(x, verbose=0)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    theirs = np.asarray(jax.jit(JaxGraph.fromKeras(path).make_fn())(
        jnp.asarray(x)))
    assert np.abs(got - theirs).max() <= RTOL * np.abs(theirs).max()


def test_first_step_f32_gradients_against_float64(app):
    name, _path, path = app
    x = _x(name, seed=1)
    tg = TFInputGraph.fromKerasTrainable(path)
    fn = tg.make_fn()
    grads = {}
    for dtype in (torch.float32, torch.float64):
        p = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
             for k, v in tg.params.items() if v.dtype.kind == "f"}
        p.update({k: torch.tensor(v) for k, v in tg.params.items()
                  if v.dtype.kind != "f"})
        y = fn(p, torch.tensor(x, dtype=dtype))
        r = torch.tensor(np.random.default_rng(2).normal(size=y.shape),
                         dtype=dtype)
        (y * r).sum().backward()
        grads[dtype] = {k: t.grad.double().numpy() for k, t in p.items()
                        if t.requires_grad}
    ref = grads[torch.float64]
    top = max(np.abs(g).max() for g in ref.values())
    errs = {k: np.abs(grads[torch.float32][k] - g).max() / top
            for k, g in ref.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    assert len(ref) == sum(v.dtype.kind == "f" for v in tg.params.values())


def test_seeded_weights_follow_keras_initializers(app):
    """chip_smoke.py writes these models with seeded weights (the card's
    machine has no keras): each variable drawn from its layer's own
    initializer, as keras draws a ``weights=None`` model."""
    import chip_smoke

    name, path, _p = app
    config, theirs = load_keras_file(path)
    ours = chip_smoke.keras_weights(config, 0)
    assert list(ours) == list(theirs)
    for k, t in theirs.items():
        o = ours[k]
        assert o.shape == t.shape and o.dtype == t.dtype, k
        if t.size < 64 or np.all(t == t.flat[0]):
            np.testing.assert_array_equal(o, t, err_msg=k)
            continue
        # two samples of one law: 5 standard errors of their difference
        se = 1 / np.sqrt(t.size)
        assert abs(o.std() / t.std() - 1) <= max(0.1, 5 * se), (
            k, o.std(), t.std())
        assert abs(o.mean() - t.mean()) <= 5 * np.sqrt(2) * t.std() * se, k
