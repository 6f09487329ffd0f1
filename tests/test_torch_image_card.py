"""The image stages on the card, with PyTorch's process-wide settings left
at their defaults. Marked ``cuda``: they skip without an NVIDIA GPU. The
repo's ``conftest.py`` hides the card and imports jax, so run them on a
machine with a card as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_image_card.py

Tolerance: the card's float32 outputs against the port's CPU run on the
same rows, 2e-5 of max |y|, as ``chip_smoke.py`` phase 6 holds them. The
weights are ``init(0)`` with seeded perturbed BN stats (BN layers found by
their leaves, so ResNet's ``conv1_bn`` counts), so that the outputs are
not tiny. Each model runs at its own input size."""

import numpy as np
import pytest
import torch

from tpudl_torch.frame import Frame
from tpudl_torch.image import imageArrayToStruct
from tpudl_torch.ml import DeepImageFeaturizer, DeepImagePredictor
from tpudl_torch.zoo import getKerasApplicationModel, save_params_npz

TOL = 2e-5


def _perturbed_weights(name, path):
    params = getKerasApplicationModel(name).init(0)
    rng = np.random.default_rng(1)
    for leaves in params.values():
        if "moving_mean" in leaves:
            c = leaves["beta"].shape[0]
            leaves["moving_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            leaves["moving_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            leaves["beta"] = rng.normal(0, 0.1, c).astype(np.float32)
            if "gamma" in leaves:
                leaves["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return save_params_npz(params, str(path))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [DeepImageFeaturizer, DeepImagePredictor])
@pytest.mark.parametrize("name", ["InceptionV3", "ResNet50", "Xception"])
def test_float32_stage_on_card_computes_in_f32(tmp_path, stage, name):
    """cuDNN may run f32 convolutions in TF32 unless told not to, and
    PyTorch's default allows it; a float32 stage must compute in f32 all
    the same. TF32's 10-bit mantissa would put the outputs far outside the
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert torch.backends.cudnn.allow_tf32      # PyTorch's default
    weights = _perturbed_weights(name, tmp_path / "perturbed.npz")
    size = getKerasApplicationModel(name).input_size
    rng = np.random.default_rng(0)
    col = np.empty(4, dtype=object)
    col[:] = [imageArrayToStruct(rng.integers(0, 256, (*size, 3),
                                              dtype=np.uint8))
              for _ in range(4)]
    frame = Frame({"image": col})
    outs = {}
    for device in ("cuda", "cpu"):
        out = stage(inputCol="image", outputCol="y", modelName=name,
                    weights=weights, batchSize=4, device=device)
        outs[device] = np.stack(list(out.transform(frame)["y"]))
    want = outs["cpu"].astype(np.float64)
    err = np.abs(outs["cuda"] - want).max() / np.abs(want).max()
    assert err <= TOL, err
    assert torch.backends.cudnn.allow_tf32      # restored after the stage
