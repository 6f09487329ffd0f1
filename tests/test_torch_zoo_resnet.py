"""The port's ResNet50, ResNet101 and ResNet152 (``tpudl_torch.zoo.resnet``)
against tpudl's, with the same ``init(0)`` weights and the same seeded
inputs, and ``DeepImageFeaturizer``/``DeepImagePredictor`` on ResNet50 over
``readImages`` against tpudl's stages.

ResNet101 and ResNet152 share ResNet50's skeleton (only the block counts
differ), so each gets one init test and one featurize comparison.

Tolerances, relative to max |y| (``init(0)`` features are tiny, so an
absolute bound would prove nothing): f32 on the CPU with sums in another
order, 2e-5 of max |y|, as for InceptionV3 — model outputs at 32×32 (the
smallest size tpudl's own zoo tests use) with ``init(0)`` and with seeded
perturbed BN stats (read 2.1e-7 to 2.9e-6, the deepest the largest), and
stage outputs at 224×224 over decoded JPEGs."""

import numpy as np
import pytest

import torch
from PIL import Image

from test_torch_named_image import (TOL, _assert_forward_matches,
                                    _assert_init_bit_equal,
                                    _assert_maps_match, _rel_err,
                                    _tpudl_side)
from tpudl.image import imageIO as jio
from tpudl.ml import DeepImageFeaturizer as JaxFeaturizer
from tpudl.ml import DeepImagePredictor as JaxPredictor
from tpudl_torch.image import imageIO
from tpudl_torch.ml import DeepImageFeaturizer, DeepImagePredictor
from torch_native_fixture import private_tpudl_decoder  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")

torch.set_num_threads(1)

SIZES = {"ResNet50": (32, 32), "ResNet101": (32, 32), "ResNet152": (32, 32)}


@pytest.fixture(scope="module")
def tpudl_side():
    """``get(name)``: tpudl's side at the model's size, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _tpudl_side(name, SIZES[name])
        return cache[name]

    return get


@pytest.mark.parametrize("name,include_top", [
    ("ResNet50", True), ("ResNet50", False), ("ResNet101", True),
    ("ResNet152", True)])
def test_init_is_bit_equal_to_tpudl(name, include_top):
    _assert_init_bit_equal(name, SIZES[name], include_top)


@pytest.mark.parametrize("name,weights,head", [
    *[("ResNet50", w, h) for w in ("init", "perturbed")
      for h in ("featurize", "predict")],
    ("ResNet101", "perturbed", "featurize"),
    ("ResNet152", "perturbed", "featurize")])
def test_forward_matches_tpudl(tpudl_side, name, weights, head):
    _assert_forward_matches(tpudl_side(name), name, weights, head)


def test_apply_returns_nhwc_maps_like_tpudl(tpudl_side):
    _assert_maps_match(tpudl_side("ResNet50"), "ResNet50", (2, 1, 1, 2048))


# -- the stages over readImages, at ResNet50's 224×224 --------------------

@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """3 JPEGs and a garbage file; at batchSize 2 the first batch shrinks
    to 224×224 and the second grows."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(5)
    for i, shape in enumerate([(240, 320, 3), (240, 320, 3), (120, 90, 3)]):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            d / f"img{i}.jpg", quality=90)
    (d / "zz_bad.jpg").write_bytes(b"not a jpeg")
    return str(d)


@pytest.fixture(scope="module")
def stage_outputs(image_dir):
    """Features and decoded top-3 of ResNet50's stages in both packages."""
    common = dict(inputCol="image", modelName="ResNet50", batchSize=2)
    frame = jio.readImages(image_dir).dropna()
    want = (np.stack(list(JaxFeaturizer(outputCol="f", **common).transform(
                frame)["f"])),
            list(JaxPredictor(outputCol="p", decodePredictions=True, topK=3,
                              **common).transform(frame)["p"]))
    frame = imageIO.readImages(image_dir).dropna()
    got = (np.stack(list(DeepImageFeaturizer(
                outputCol="f", device="cpu", **common).transform(frame)["f"])),
           list(DeepImagePredictor(
               outputCol="p", decodePredictions=True, topK=3, device="cpu",
               **common).transform(frame)["p"]))
    return want, got


def test_featurizer_over_read_images_matches_tpudl(stage_outputs):
    (want, _), (got, _) = stage_outputs
    assert got.shape == want.shape == (3, 2048) and got.dtype == np.float32
    assert _rel_err(got, want) <= TOL


def test_predictor_decoded_matches_tpudl(stage_outputs):
    (_, want), (_, got) = stage_outputs
    assert len(got) == len(want) == 3
    scale = max(s for row in want for _, _, s in row)
    for g, w in zip(got, want):
        assert [e[:2] for e in g] == [e[:2] for e in w]
        assert max(abs(a[2] - b[2]) for a, b in zip(g, w)) <= TOL * scale
