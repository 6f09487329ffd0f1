"""The port's MobileNetV2, DenseNet121 and EfficientNetB0
(``tpudl_torch.zoo.mobilenet_v2``, ``densenet``, ``efficientnet``) against
tpudl's, with the same ``init(0)`` weights and the same seeded inputs, and
``Store.norm_stats`` (EfficientNet's in-model ``Normalization``) alone.

Sizes: 32×32, tpudl's smallest, and for MobileNetV2 and EfficientNetB0
also 33×33 (case ``@33``). Their stride-2 blocks pad with Keras's
``correct_pad``, whose ``1 - h % 2`` takes one branch on even maps and the
other on odd ones; tpudl reads h off NHWC axis 1, which in NCHW holds the
channels, so both parities are run.

Tolerances, relative to max |y| (``init(0)`` features are tiny, so an
absolute bound would prove nothing): f32 on the CPU with sums in another
order, 2e-5 of max |y|, as for InceptionV3, with ``init(0)`` and with
seeded perturbed BN stats (and, for EfficientNetB0, a perturbed
``normalization`` layer): read up to 2.2e-6. ``init(0)`` features of
MobileNetV2 and EfficientNetB0 are tiny (~1e-12 and ~1e-17: their
activations shrink block by block), which the relative bound absorbs;
the perturbed weights hold them at ~0.3–0.7. ``norm_stats`` alone: 1e-6
of max |y|."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_named_image import (_assert_forward_matches,
                                    _assert_init_bit_equal,
                                    _assert_maps_match, _rel_err,
                                    _tpudl_side)
from tpudl.zoo import core as jcore
from tpudl_torch.zoo import convert, core

torch.set_num_threads(1)

# case -> (model, size)
CASES = {"MobileNetV2": ("MobileNetV2", (32, 32)),
         "MobileNetV2@33": ("MobileNetV2", (33, 33)),
         "DenseNet121": ("DenseNet121", (32, 32)),
         "EfficientNetB0": ("EfficientNetB0", (32, 32)),
         "EfficientNetB0@33": ("EfficientNetB0", (33, 33))}


@pytest.fixture(scope="module")
def tpudl_side():
    """``get(case)``: tpudl's side at the case's size, built once; the
    input is in [0, 255] for EfficientNetB0, which preprocesses inside the
    model."""
    cache = {}

    def get(case):
        if case not in cache:
            name, size = CASES[case]
            cache[case] = _tpudl_side(name, size, (0, 255) if
                                      name == "EfficientNetB0" else (-1, 1))
        return cache[case]

    return get


@pytest.mark.parametrize("include_top", [True, False])
@pytest.mark.parametrize("name", ["MobileNetV2", "DenseNet121",
                                  "EfficientNetB0"])
def test_init_is_bit_equal_to_tpudl(name, include_top):
    _assert_init_bit_equal(name, CASES[name][1], include_top)


@pytest.mark.parametrize("head", ["featurize", "predict"])
@pytest.mark.parametrize("weights", ["init", "perturbed"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_tpudl(tpudl_side, case, weights, head):
    _assert_forward_matches(tpudl_side(case), CASES[case][0], weights, head)


@pytest.mark.parametrize("case,shape", [
    ("MobileNetV2", (2, 1, 1, 1280)), ("MobileNetV2@33", (2, 2, 2, 1280)),
    ("DenseNet121", (2, 1, 1, 1024)), ("EfficientNetB0", (2, 1, 1, 1280)),
    ("EfficientNetB0@33", (2, 2, 2, 1280))])
def test_apply_returns_nhwc_maps_like_tpudl(tpudl_side, case, shape):
    _assert_maps_match(tpudl_side(case), CASES[case][0], shape)


def test_norm_stats_matches_tpudl():
    """``(x - mean) / max(sqrt(variance), 1e-7)`` over the channels: init
    is the identity, and a zero-variance channel divides by the 1e-7 clamp
    and stays finite."""
    x = np.random.default_rng(3).normal(size=(2, 5, 4, 3)).astype(np.float32)
    js = jcore.Store(rng=np.random.default_rng(0))
    ts = core.Store(rng=np.random.default_rng(0))
    np.testing.assert_array_equal(
        ts.norm_stats(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(),
        np.asarray(js.norm_stats(jnp.asarray(x))).transpose(0, 3, 1, 2))
    assert list(ts.params) == list(js.params) == ["normalization"]
    params = {"stats": {"mean": np.array([0.5, -1.0, 2.0], np.float32),
                        "variance": np.array([0.25, 0.0, 4.0], np.float32)}}
    want = np.asarray(jcore.Store(params=params).norm_stats(
        jnp.asarray(x), name="stats"))
    got = core.Store(params=convert.torch_params(params)).norm_stats(
        torch.from_numpy(x).permute(0, 3, 1, 2), name="stats")
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.isfinite(got).all() and np.abs(got[..., 1]).max() > 1e6
    assert _rel_err(got, want) <= 1e-6
