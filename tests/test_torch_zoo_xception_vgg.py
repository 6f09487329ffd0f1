"""The port's Xception (``tpudl_torch.zoo.xception``) and VGG16/VGG19
(``tpudl_torch.zoo.vgg``) against tpudl's, with the same ``init(0)``
weights and the same seeded inputs, and ``DeepImageFeaturizer``/
``DeepImagePredictor`` on Xception and VGG16 over ``readImages`` against
tpudl's stages (VGG16's features are the 4096-d post-ReLU ``fc2``).

Sizes: Xception at 71×71, the smallest it takes (tpudl's zoo tests use
it too). VGG at 64×64: its head flattens the last map in Keras's NHWC
order, and at 32×32 that map is 1×1×512, where NCHW and NHWC orders
agree and a wrong flatten cannot show; at 64×64 it is 2×2×512.

Tolerances, relative to max |y| (``init(0)`` features are tiny, so an
absolute bound would prove nothing): f32 on the CPU with sums in another
order, 2e-5 of max |y|, as for InceptionV3 — model outputs with
``init(0)`` and with seeded perturbed BN stats (read 1.2e-7 to 2.3e-6),
and stage outputs at each model's input size over decoded JPEGs."""

import numpy as np
import pytest

import torch
from PIL import Image

from test_torch_named_image import (TOL, _assert_forward_matches,
                                    _assert_init_bit_equal,
                                    _assert_maps_match, _perturbed, _rel_err,
                                    _tpudl_side)
from tpudl.image import imageIO as jio
from tpudl.ml import DeepImageFeaturizer as JaxFeaturizer
from tpudl.ml import DeepImagePredictor as JaxPredictor
from tpudl.zoo import registry as jreg
from tpudl_torch.image import imageIO
from tpudl_torch.ml import DeepImageFeaturizer, DeepImagePredictor
from tpudl_torch.zoo import convert, registry
from tpudl_torch.zoo import nn as zoo_nn
from tpudl_torch.zoo.registry import ImageModel
from torch_native_fixture import private_tpudl_decoder  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")

torch.set_num_threads(1)

SIZES = {"Xception": (71, 71), "VGG16": (64, 64), "VGG19": (64, 64)}


@pytest.fixture(scope="module")
def tpudl_side():
    """``get(name)``: tpudl's side at the model's size, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _tpudl_side(name, SIZES[name])
        return cache[name]

    return get


@pytest.mark.parametrize("include_top", [True, False])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_init_is_bit_equal_to_tpudl(name, include_top):
    _assert_init_bit_equal(name, SIZES[name], include_top)


def test_xception_projections_take_keras_auto_names():
    """The four unnamed residual projections and their BNs take Keras's
    auto names in creation order, each before its block's sepconvs."""
    names = list(registry.getKerasApplicationModel("Xception").init(
        0, image_size=SIZES["Xception"]))
    assert [n for n in names if n.startswith(("conv2d", "batch_norm"))] == [
        "conv2d", "batch_normalization", "conv2d_1", "batch_normalization_1",
        "conv2d_2", "batch_normalization_2", "conv2d_3",
        "batch_normalization_3"]
    assert names.index("conv2d_1") < names.index("block3_sepconv1")
    assert names.index("conv2d_3") < names.index("block13_sepconv1")


@pytest.mark.parametrize("head", ["featurize", "predict"])
@pytest.mark.parametrize("weights", ["init", "perturbed"])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_forward_matches_tpudl(tpudl_side, name, weights, head):
    _assert_forward_matches(tpudl_side(name), name, weights, head)


def test_vgg_flattens_in_nhwc_order(tpudl_side, monkeypatch):
    """At 64×64 the parity above sees the flatten order: a flatten of the
    NCHW map, in place of Keras's NHWC order, feeds ``fc1`` permuted
    inputs and misses by far."""
    side = tpudl_side("VGG16")
    net = ImageModel(registry.getKerasApplicationModel("VGG16"),
                     side["weights"]["perturbed"], device="cpu")
    monkeypatch.setattr(zoo_nn, "flatten_nhwc",
                        lambda t: t.reshape(t.shape[0], -1))
    with torch.inference_mode():
        got = net.featurize(torch.from_numpy(side["x"])).numpy()
    assert _rel_err(got, side["want"]["perturbed"]["featurize"]) > 1000 * TOL


@pytest.mark.parametrize("name,shape", [("Xception", (2, 3, 3, 2048)),
                                        ("VGG16", (2, 2, 2, 512)),
                                        ("VGG19", (2, 2, 2, 512))])
def test_apply_returns_nhwc_maps_like_tpudl(tpudl_side, name, shape):
    _assert_maps_match(tpudl_side(name), name, shape)


# -- the stages over readImages, at each model's input size --------------

@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """3 JPEGs and a garbage file; at batchSize 2 the first batch shrinks
    to the model's size and the second grows."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(5)
    for i, shape in enumerate([(320, 400, 3), (320, 400, 3), (120, 90, 3)]):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            d / f"img{i}.jpg", quality=90)
    (d / "zz_bad.jpg").write_bytes(b"not a jpeg")
    return str(d)


@pytest.fixture(scope="module")
def stage_outputs(image_dir, tmp_path_factory):
    """``get(name)``: features and decoded top-3 of the model's stages in
    both packages, built once. Xception runs ``init(0)`` with perturbed BN
    stats (an .npz both packages read): with ``init(0)`` alone its 1000
    class scores agree to 3e-8 of 1e-3, so the top-3 order is a tie-break
    of rounding. VGG16 (no BN) runs ``weights="random"``, over the first
    two files only: tpudl's CPU run of a 224×224 VGG16 costs seconds an
    image."""
    cache = {}

    def get(name):
        if name not in cache:
            weights = "random"
            frame = jio.readImages(image_dir).dropna()
            if name == "Xception":
                weights = convert.save_params_npz(
                    _perturbed(jreg.getKerasApplicationModel(name).init(0)),
                    str(tmp_path_factory.mktemp("w") / "xception.npz"))
            else:
                frame = frame.head(2)
            common = dict(inputCol="image", modelName=name, batchSize=2,
                          weights=weights)
            want = (np.stack(list(JaxFeaturizer(
                        outputCol="f", **common).transform(frame)["f"])),
                    list(JaxPredictor(
                        outputCol="p", decodePredictions=True, topK=3,
                        **common).transform(frame)["p"]))
            frame = imageIO.readImages(image_dir).dropna().head(len(frame))
            got = (np.stack(list(DeepImageFeaturizer(
                       outputCol="f", device="cpu", **common).transform(
                           frame)["f"])),
                   list(DeepImagePredictor(
                       outputCol="p", decodePredictions=True, topK=3,
                       device="cpu", **common).transform(frame)["p"]))
            cache[name] = want, got
        return cache[name]

    return get


@pytest.mark.parametrize("name,rows,dim", [("Xception", 3, 2048),
                                           ("VGG16", 2, 4096)])
def test_featurizer_over_read_images_matches_tpudl(stage_outputs, name, rows,
                                                   dim):
    (want, _), (got, _) = stage_outputs(name)
    assert registry.getKerasApplicationModel(name).feature_dim == dim
    assert got.shape == want.shape == (rows, dim) and got.dtype == np.float32
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("name,rows", [("Xception", 3), ("VGG16", 2)])
def test_predictor_decoded_matches_tpudl(stage_outputs, name, rows):
    (_, want), (_, got) = stage_outputs(name)
    assert len(got) == len(want) == rows
    scale = max(s for row in want for _, _, s in row)
    for g, w in zip(got, want):
        assert [e[:2] for e in g] == [e[:2] for e in w]
        assert max(abs(a[2] - b[2]) for a, b in zip(g, w)) <= TOL * scale
