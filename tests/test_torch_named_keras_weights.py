"""A Keras model file as the named stages' ``weights=``: the port's
``params_from_keras`` reads ``.keras`` and legacy ``.h5`` files without
keras, bit for bit as tpudl's reads them with keras, and
``DeepImageFeaturizer``/``DeepImagePredictor(weights=<file>)`` equal
tpudl's stages on the same file and rows (within 2e-5 of max |y|, the
named-image tolerance of ``test_torch_named_image.py``). The files are
Keras's own MobileNetV2 and Xception, ``weights=None``, BN statistics
perturbed from a seed; a model's variables do not depend on the input
size it was built at, so they are built small and run at the stage's own
224×224 or 299×299."""

import os

import numpy as np
import pytest

keras = pytest.importorskip("keras")

import torch_keras_models as M  # noqa: E402

from tpudl.frame import Frame as JaxFrame  # noqa: E402
from tpudl.image import imageIO as jax_imageIO  # noqa: E402
from tpudl.ml import DeepImageFeaturizer as JaxFeaturizer  # noqa: E402
from tpudl.ml import DeepImagePredictor as JaxPredictor  # noqa: E402
from tpudl.zoo.convert import load_keras_model as jax_load  # noqa: E402
from tpudl.zoo.convert import params_from_keras as jax_params  # noqa: E402
from tpudl_torch.frame import Frame  # noqa: E402
from tpudl_torch.image import imageIO  # noqa: E402
from tpudl_torch.ml import (DeepImageFeaturizer,  # noqa: E402
                            DeepImagePredictor)
from tpudl_torch.ml.named_image import load_named_params  # noqa: E402
from tpudl_torch.zoo.convert import params_from_keras  # noqa: E402

TOL = 2e-5
FILES = {"mobilenet_v2": ("MobileNetV2", "mobilenet_v2", 32, "keras"),
         "mobilenet_v2_h5": ("MobileNetV2", "mobilenet_v2", 32, "h5"),
         "mobilenet_v2_top": ("MobileNetV2", "mobilenet_v2_top", 32,
                              "keras"),
         "xception_h5": ("Xception", "xception", 71, "h5")}


def _save_perturbed(name, side, path, seed=1):
    model = M.build(name, side)
    model.set_weights(list(M.perturbed(
        {w.path: w.numpy() for w in model.weights}, seed).values()))
    model.save(path)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("named_keras")
    return {key: _save_perturbed(name, side, d / f"{key}.{ext}")
            for key, (_m, name, side, ext) in FILES.items()}


@pytest.fixture(scope="module")
def rows():
    """3 seeded 40×50 uint8 images (the stage resizes them to the
    model's size), as each package's image structs."""
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
              for _ in range(3)]

    def col(io):
        out = np.empty(len(arrays), dtype=object)
        out[:] = [io.imageArrayToStruct(a) for a in arrays]
        return out

    return Frame({"image": col(imageIO)}), JaxFrame(
        {"image": col(jax_imageIO)})


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("key", sorted(FILES))
def test_params_from_keras_is_tpudls_bit_for_bit(files, key):
    got = params_from_keras(files[key])
    want = jax_params(jax_load(files[key]))
    assert list(got) == list(want)
    for layer, leaves in want.items():
        assert list(got[layer]) == list(leaves), layer
        for k, v in leaves.items():
            assert got[layer][k].tobytes() == np.asarray(v).tobytes(), \
                (layer, k)
    assert load_named_params(FILES[key][0], files[key]).keys() == got.keys()


@pytest.mark.parametrize("key", ["mobilenet_v2", "mobilenet_v2_h5",
                                 "xception_h5"])
def test_featurizer_with_keras_weights_matches_tpudl(files, rows, key):
    model = FILES[key][0]
    kw = dict(inputCol="image", outputCol="f", modelName=model,
              weights=files[key], batchSize=2)
    got = np.stack(list(DeepImageFeaturizer(device="cpu", **kw).transform(
        rows[0])["f"]))
    want = np.stack(list(JaxFeaturizer(**kw).transform(rows[1])["f"]))
    assert got.shape == want.shape == (3, 1280 if model == "MobileNetV2"
                                       else 2048)
    assert _rel(got, want) <= TOL


def test_predictor_with_keras_weights_matches_tpudl(files, rows):
    kw = dict(inputCol="image", outputCol="p", modelName="MobileNetV2",
              weights=files["mobilenet_v2_top"], batchSize=2)
    got = np.stack(list(DeepImagePredictor(device="cpu", **kw).transform(
        rows[0])["p"]))
    want = np.stack(list(JaxPredictor(**kw).transform(rows[1])["p"]))
    assert got.shape == want.shape == (3, 1000)
    assert _rel(got, want) <= TOL


def test_a_rewritten_weights_file_is_read_again(files, rows, tmp_path):
    path = str(tmp_path / "mnv2.keras")
    _save_perturbed("mobilenet_v2", 32, path, seed=1)
    feat = DeepImageFeaturizer(inputCol="image", outputCol="f",
                               modelName="MobileNetV2", weights=path,
                               batchSize=3, device="cpu")
    first = np.stack(list(feat.transform(rows[0])["f"]))
    assert np.array_equal(first, np.stack(list(feat.transform(rows[0])["f"])))
    _save_perturbed("mobilenet_v2", 32, path, seed=2)
    os.utime(path, (1, os.path.getmtime(path) + 10))
    second = np.stack(list(feat.transform(rows[0])["f"]))
    assert not np.allclose(first, second)
    want = np.stack(list(DeepImageFeaturizer(
        inputCol="image", outputCol="f", modelName="MobileNetV2",
        weights=path, batchSize=3, device="cpu").transform(rows[0])["f"]))
    assert np.array_equal(second, want)
