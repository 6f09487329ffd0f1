"""The zoo's training convolutions run on NCHW-contiguous memory, its
inference convolutions on channels_last: ``F.conv2d`` is spied on under
``torch.enable_grad()`` and under ``torch.inference_mode()``. On
channels_last memory cuDNN's engines (FFT on InceptionV3's 17×17 maps)
put the named InceptionV3's first f32 training step 8.93e-3 of the
largest gradient off float64 on the H100; on NCHW it read 9.53e-5
(chip_smoke phase 8, PERF.md)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpudl_torch.zoo.registry import ImageModel, getKerasApplicationModel


@pytest.fixture(scope="module")
def net():
    model = getKerasApplicationModel("MobileNetV2")
    return ImageModel(model, model.init(0, image_size=(32, 32)),
                      device="cpu")


def _spied(monkeypatch):
    seen = []
    conv = F.conv2d

    def spy(x, weight, *args, **kwargs):
        if x.shape[1] > 1 and x.shape[2] * x.shape[3] > 1:
            seen.append((x.is_contiguous(),
                         x.is_contiguous(memory_format=torch.channels_last),
                         weight.is_contiguous()))
        return conv(x, weight, *args, **kwargs)

    monkeypatch.setattr(F, "conv2d", spy)
    return seen


def test_training_convolutions_see_nchw_memory(net, monkeypatch):
    seen = _spied(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32))
    with torch.enable_grad():
        net.featurize(x).sum().backward()
    assert len(seen) > 20
    assert all(x_nchw and k_nchw for x_nchw, _cl, k_nchw in seen)
    assert any(p.grad is not None for p in net.parameters())


def test_inference_convolutions_keep_channels_last(net, monkeypatch):
    seen = _spied(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        y = net.featurize(x)
    assert len(seen) > 20 and torch.isfinite(y).all()
    assert all(cl and not x_nchw for x_nchw, cl, _k in seen)
    with torch.no_grad():
        net.featurize(x)
    assert all(cl and not x_nchw for x_nchw, cl, _k in seen)


def test_training_layout_leaves_the_values_alone(net):
    """The layout moves memory, not numbers: a training forward equals
    the inference forward on the same weights."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        want = net.featurize(x).clone()
    with torch.enable_grad():
        got = net.featurize(x).detach()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
