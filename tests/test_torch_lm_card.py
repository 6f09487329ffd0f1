"""The LM featurizer on the card with the caller's matmul TF32 switched on.
Marked ``cuda``: it skips without an NVIDIA GPU. The repo's
``conftest.py`` hides the card and imports jax, so run it on a machine
with a card as

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_lm_card.py

Tolerance: the card's float32 features against the port's CPU run on the
same rows, 1e-4 absolute, as ``chip_smoke.py`` phase 4 holds them (pooled
features up to ~3; phase 4 read 2.1e-6 and 1.7e-5 on two machines). The
model is the serving width of phase 4 (dim 1024, 16 heads) cut to 2
layers, so the CPU run stays short; ``-s`` shows what the same check
reads with the stage's TF32 switch removed."""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from tpudl_torch.frame import Frame
from tpudl_torch.ml import LMFeaturizer
from tpudl_torch.ml import lm as lm_stages
from tpudl_torch.text import ByteTokenizer
from tpudl_torch.zoo.transformer import TinyCausalLM

TOL = 1e-4
ARCH = dict(vocab=32000, dim=1024, heads=16, layers=2, max_len=1024)


@pytest.mark.cuda
@pytest.mark.parametrize("setting", ["allow_tf32", "precision_high"])
def test_featurizer_on_card_computes_in_f32_under_callers_tf32(setting):
    """A process that allows TF32 for matmuls (either way PyTorch offers)
    still gets tpudl's f32 features from LMFeaturizer, and keeps its
    setting after the stage ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec = TinyCausalLM(device="meta", **ARCH)
    rng = np.random.default_rng(0)
    texts = np.array([bytes(rng.integers(32, 127, n, dtype=np.uint8)).decode()
                      for n in (700, 1000)], dtype=object)
    frame = Frame({"text": texts})

    def features(device):
        out = LMFeaturizer(inputCol="text", outputCol="v", model=spec,
                           weights=spec.init(0), tokenizer=ByteTokenizer(),
                           batchSize=2, device=device).transform(frame)
        return np.stack(list(out["v"]))

    want = features("cpu")
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        if setting == "allow_tf32":
            matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        assert matmul.allow_tf32
        err = float(np.abs(features("cuda") - want).max())
        with mock.patch.object(lm_stages, "full_f32", contextlib.nullcontext):
            err_tf32 = float(np.abs(features("cuda") - want).max())
        assert matmul.allow_tf32          # the caller's setting came back
    finally:
        matmul.allow_tf32 = saved
    print(f"\n{setting}: card vs CPU {err:.3e} with the stage's switch, "
          f"{err_tf32:.3e} without it (max |y| {np.abs(want).max():.3f}; "
          f"{torch.cuda.get_device_name(0)})")
    assert err <= TOL, err
