"""The Keras layer-graph evaluator (``tpudl_torch.ingest.keras_graph``) and
``TFInputGraph``'s Keras routes, held to tpudl's ``TFInputGraph`` (TF
GraphDef evaluated in jax) on the same ``.keras`` files and the same
seeded inputs.

Tolerances: forwards within 1e-5 of max |y| (f32 products and
convolutions summed in other orders; read ~2e-7); gradients of a seeded
scalar of the output, every variable included (BN's moving statistics
too, as tpudl differentiates them), within 1e-4 of the largest gradient.
BN statistics and shifts are perturbed from a seed, so the BN fold is
held where its errors show. Unsupported layers, activations and options
raise ``NotImplementedError`` naming them."""

import copy

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_keras_models as M  # noqa: E402

from tpudl.ingest import TFInputGraph as JaxGraph  # noqa: E402
from tpudl_torch.ingest import TFInputGraph  # noqa: E402
from tpudl_torch.ingest.keras_graph import build_torch_fn  # noqa: E402
from tpudl_torch.ingest.kerasfile import (load_keras_file,  # noqa: E402
                                          save_keras_file)

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
INPUTS = {"mlp": (5, 100), "cnn": (3, 32, 32, 3), "functional": (3, 17, 15, 3),
          "inception": (2, 75, 75, 3)}
# InceptionV3 is held in test_torch_keras_inception.py (its own file, so
# that parallel test workers run it beside this one)
MODELS = ("mlp", "cnn", "functional")


def perturbed_file(name, directory) -> str:
    """``name`` saved by keras, then re-saved by the port with perturbed BN
    statistics (one file feeds both packages)."""
    config, weights = load_keras_file(M.saved(name, directory))
    return save_keras_file(directory / f"{name}_p.keras", config,
                           M.perturbed(weights))


@pytest.fixture(scope="module")
def perturbed_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("keras_graph")
    return {name: perturbed_file(name, d) for name in MODELS}


def _x(name, seed=0):
    return np.random.default_rng(seed).normal(
        size=INPUTS[name]).astype(np.float32)


def _jax_out(y):
    return y[0] if isinstance(y, (tuple, list)) else y


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_tpudl(perturbed_files, name):
    check_forward(perturbed_files[name], name)


def check_forward(path, name):
    x = _x(name)
    want = np.asarray(_jax_out(jax.jit(JaxGraph.fromKeras(path).make_fn())(
        jnp.asarray(x))))
    got = TFInputGraph.fromKeras(path).make_fn()(torch.from_numpy(x))
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= FWD_RTOL, err


@pytest.mark.parametrize("name", ["cnn", "functional"])
def test_gradients_match_tpudl_in_every_param(perturbed_files, name):
    check_gradients(perturbed_files[name], name)


def check_gradients(path, name):
    x = _x(name)
    jg = JaxGraph.fromKerasTrainable(path)
    tg = TFInputGraph.fromKerasTrainable(path)
    # the carry is the identity on keys: one dict feeds both packages
    assert set(tg.params) == set(jg.params)
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in tg.params.items()}
    y = tg.make_fn()(params, torch.from_numpy(x))
    r = np.random.default_rng(1).normal(size=y.shape).astype(np.float32)
    (y * torch.from_numpy(r)).sum().backward()
    jf = jg.make_fn()

    def jloss(p):
        return jnp.sum(_jax_out(jf(p, jnp.asarray(x))) * r)

    want = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, tg.params))
    top = max(float(np.abs(np.asarray(g)).max()) for g in want.values())
    for k, g in want.items():
        err = np.abs(params[k].grad.numpy() - np.asarray(g)).max() / top
        assert err <= GRAD_RTOL, (k, err)
    assert name == "cnn" or any(k.endswith("moving_variance") for k in want)


def test_frozen_fn_keeps_its_weights_per_device(perturbed_files):
    g = TFInputGraph.fromKeras(perturbed_files["mlp"])
    fn = g.make_fn()
    x = torch.from_numpy(_x("mlp"))
    assert torch.equal(fn(x), fn(x))
    assert list(g._frozen) == [torch.device("cpu")]


def _mutated(config, layer_class, **changes):
    cfg = copy.deepcopy(config)
    for layer in cfg["config"]["layers"]:
        if layer["class_name"] == layer_class:
            layer["config"].update(changes)
            return cfg
    raise KeyError(layer_class)


@pytest.mark.parametrize("change,match", [
    (("Dense", {"activation": "gelu"}), "activation 'gelu'"),
    (("Conv2D", {"dilation_rate": [2, 2]}), "Conv2D dilation_rate"),
    (("Conv2D", {"groups": 2}), "Conv2D groups"),
    (("Conv2D", {"data_format": "channels_first"}),
     "data_format='channels_first'"),
    (("Dense", {"dtype": {"module": "keras", "class_name": "DTypePolicy",
                          "config": {"name": "mixed_float16"}}}),
     "dtype policy 'mixed_float16'"),
    (("Dense", {"lora_rank": 4}), "Dense lora_rank"),
])
def test_unsupported_options_raise_by_name(perturbed_files, change, match):
    config, _w = load_keras_file(perturbed_files["cnn"])
    cls, changes = change
    with pytest.raises(NotImplementedError, match=match):
        build_torch_fn(_mutated(config, cls, **changes))


def test_unsupported_layer_classes_raise_by_name(perturbed_files):
    config, _w = load_keras_file(perturbed_files["cnn"])
    cfg = copy.deepcopy(config)
    cfg["config"]["layers"][2]["class_name"] = "LeakyReLU"
    with pytest.raises(NotImplementedError, match="class 'LeakyReLU'"):
        build_torch_fn(cfg)
    nested = copy.deepcopy(config)
    nested["config"]["layers"].append(copy.deepcopy(config))
    with pytest.raises(NotImplementedError, match="nested model"):
        build_torch_fn(nested)


def test_proto_routes_and_live_models_are_refused(perturbed_files):
    for route in ("fromGraph", "fromGraphDef", "fromSavedModel",
                  "fromSavedModelWithSignature", "fromCheckpoint",
                  "fromCheckpointWithSignature"):
        with pytest.raises(NotImplementedError,
                           match=f"{route} needs TensorFlow protos"):
            getattr(TFInputGraph, route)("x", "y", "z")
    live = keras.saving.load_model(perturbed_files["mlp"], compile=False)
    with pytest.raises(TypeError, match="save the model"):
        TFInputGraph.fromKeras(live)
    g = TFInputGraph.fromKeras(perturbed_files["mlp"])
    with pytest.raises(NotImplementedError, match="feeds/fetches"):
        g.make_fn(["other:0"])


def test_graph_runs_convolutions_on_nchw_memory(perturbed_files, monkeypatch):
    """The evaluator hands convolutions NCHW-contiguous tensors: on NHWC
    (channels_last) memory cuDNN's FFT engines put an InceptionV3 training
    step's BN gradients 8.4e-2 of the largest off a float64 run on the
    H100, against 1.9e-3 on NCHW (PERF.md)."""
    import torch.nn.functional as F

    seen = []
    conv = F.conv2d

    def spy(x, *args, **kwargs):
        seen.append(x.is_contiguous())
        return conv(x, *args, **kwargs)

    monkeypatch.setattr(F, "conv2d", spy)
    TFInputGraph.fromKeras(perturbed_files["functional"]).make_fn()(
        torch.from_numpy(_x("functional")))
    assert len(seen) == 4 and all(seen)
