"""The LM featurizer over a mesh of the card, against the same stage
without a mesh. Marked ``cuda``: it skips without an NVIDIA GPU. The
repo's ``conftest.py`` hides the card and imports jax, so run it on a
machine with a card as

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_mesh_card.py

A one-card mesh runs the same batches through the same weights and the
same kernels (the flash forward in every block) as the run without a
mesh, so the features are held bit for bit, and the forward kernel
launches 2 times a batch (2 layers) in both runs. A two-entry mesh of the
same card (``["cuda:0", "cuda:0"]``: two replicas, each on half of every
batch) is held within 1e-4 of max |y|, with twice the launches."""

import numpy as np
import pytest
import torch

from tpudl_torch import cuda_ops
from tpudl_torch import mesh as M
from tpudl_torch.frame import Frame
from tpudl_torch.ml import LMFeaturizer
from tpudl_torch.text import ByteTokenizer
from tpudl_torch.zoo.transformer import TinyCausalLM

ARCH = dict(vocab=32000, dim=1024, heads=16, layers=2, max_len=1024)
ROWS, BATCH = 8, 4
TOL = 1e-4


@pytest.mark.cuda
def test_one_card_mesh_is_the_run_without_a_mesh_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec = TinyCausalLM(device="meta", **ARCH)
    weights = spec.init(0)
    rng = np.random.default_rng(0)
    frame = Frame({"text": np.array(
        [bytes(rng.integers(32, 127, int(n), dtype=np.uint8)).decode()
         for n in rng.integers(300, 1000, ROWS)], dtype=object)})

    def features(**where):
        stage = LMFeaturizer(inputCol="text", outputCol="v", model=spec,
                             weights=weights, tokenizer=ByteTokenizer(),
                             batchSize=BATCH, **where)
        stage.transform(frame.head(BATCH))   # load, replicate, warm up
        cuda_ops.launch_counts["flash_attn_fwd"] = 0
        out = stage.transform(frame)
        launches = cuda_ops.launch_counts["flash_attn_fwd"]
        return np.stack(list(out["v"])), launches

    plain, n_plain = features(device="cuda")
    one, n_one = features(mesh=M.build_mesh(devices=["cuda:0"]))
    two, n_two = features(mesh=M.build_mesh(devices=["cuda:0", "cuda:0"]))
    batches = -(-ROWS // BATCH)
    assert np.array_equal(one, plain)
    assert n_plain == n_one == ARCH["layers"] * batches
    assert n_two == 2 * ARCH["layers"] * batches
    err = float(np.abs(two - plain).max() / np.abs(plain).max())
    print(f"\none-card mesh: bit for bit; two entries of one card: "
          f"{err:.3e} of max |y| ({torch.cuda.get_device_name(0)})")
    assert err <= TOL, err
