"""The Keras surface on the card, with the caller's TF32 switched on for
cuDNN and cuBLAS. Marked ``cuda``: they skip without an NVIDIA GPU. The
repo's ``conftest.py`` hides the card and imports jax, so run them on a
machine with a card as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_keras_card.py

The stages compute in f32 whatever the caller allows (``device.full_f32``
around each forward and each train step), so the card is held with
chip_smoke phase 9's limits: the MLP forward within 2e-5 of max |y| of
the port's CPU run; the estimator's first step (configs[2]'s InceptionV3
+ head from chip_smoke's seeded weights, batch 4 at 299×299): the loss
within 2e-5 of the CPU's and of a float64 run on the card, and every
gradient within 1e-2 of the largest of the float64 run's (these BN
gradients sum with cancellation; on NHWC memory cuDNN's FFT engines read
8.4e-2 there, PERF.md); TF32 is left as the caller set it."""

import numpy as np
import pytest
import torch

import chip_smoke
from tpudl_torch.frame import Frame
from tpudl_torch.image.imageIO import createNativeImageLoader
from tpudl_torch.ingest.kerasfile import save_keras_file
from tpudl_torch.ml import KerasTransformer


@pytest.fixture
def tf32_on():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def _tf32_left_on():
    return torch.backends.cudnn.allow_tf32 and \
        torch.backends.cuda.matmul.allow_tf32


@pytest.mark.cuda
def test_mlp_forward_on_card_matches_cpu(tf32_on, tmp_path):
    cfg = chip_smoke.keras_mlp_config()
    path = save_keras_file(tmp_path / "mlp.keras", cfg,
                           chip_smoke.keras_weights(cfg, 0))
    x = np.random.default_rng(0).normal(size=(64, 100)).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        kt = KerasTransformer(inputCol="x", outputCol="y", modelFile=path,
                              batchSize=32, device=device)
        outs[device] = np.stack(list(kt.transform(Frame({"x": x}))["y"]))
    err = np.abs(outs["cuda"] - outs["cpu"]).max() / np.abs(outs["cpu"]).max()
    assert err <= chip_smoke.KERAS_CPU_RTOL, err
    assert _tf32_left_on()


@pytest.mark.cuda
def test_estimator_first_step_on_card_matches_cpu_and_float64(tf32_on,
                                                             tmp_path):
    cfg = chip_smoke.keras_inception_config()
    path = save_keras_file(tmp_path / "inc.keras", cfg,
                           chip_smoke.keras_weights(cfg, 0))
    uris, labels = chip_smoke.keras_jpegs(str(tmp_path), 4, 0)
    loader = createNativeImageLoader(299, 299, scale=1 / 255)
    est = chip_smoke.keras_estimator(path, loader, device="cpu")
    X, y = est._getNumpyFeaturesAndLabels(chip_smoke.keras_frame(uris,
                                                                 labels))
    ref_loss, ref = chip_smoke.keras_first_gradient(
        path, loader, X, y, "cuda", torch.float64)
    cpu_loss, _g = chip_smoke.keras_first_gradient(
        path, loader, X, y, "cpu", torch.float32)
    loss, grads = chip_smoke.keras_first_gradient(path, loader, X, y, "cuda",
                                                  torch.float32)
    assert abs(loss - cpu_loss) <= chip_smoke.KERAS_LOSS_ATOL
    assert abs(loss - ref_loss) <= chip_smoke.KERAS_LOSS_ATOL
    top = max(np.abs(g).max() for g in ref.values())
    err = max(np.abs(grads[k] - ref[k]).max() for k in ref) / top
    assert err <= chip_smoke.KERAS_GRAD_RTOL, err
    assert _tf32_left_on()
