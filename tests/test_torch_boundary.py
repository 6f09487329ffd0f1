"""The boundary between the packages: ``tpudl_torch`` and ``chip_smoke.py``
import neither jax, keras (which imports jax), ml_dtypes nor tpudl, the
port's main paths (text serving, training and the image path) run with
both blocked, a rank that ``HorovodRunner`` spawns holds none of them,
and ``chip_smoke.py`` refuses to report without a card or without the
package beside it."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|keras|ml_dtypes|tpudl)(?:[.\s,]|$)",
    re.MULTILINE)

_BLOCKED_MAIN = r"""
import sys
sys.modules["jax"] = None
sys.modules["tpudl"] = None
import numpy as np
from tpudl_torch.frame import Frame
from tpudl_torch.ml import LMFeaturizer
from tpudl_torch.text import ByteTokenizer
from tpudl_torch.zoo.transformer import TinyCausalLM

spec = TinyCausalLM(vocab=260, dim=32, heads=4, layers=2, max_len=64,
                    device="meta")
feat = LMFeaturizer(inputCol="text", outputCol="vec", model=spec,
                    weights=spec.init(0), tokenizer=ByteTokenizer(),
                    batchSize=2, device="cpu")
out = feat.transform(Frame({"text": np.array(["abc", "de", "fghij"],
                                             dtype=object)}))
vecs = np.stack(list(out["vec"]))
assert vecs.shape == (3, 32) and np.isfinite(vecs).all()
assert not any(m == "jax" or m.startswith(("jax.", "tpudl."))
               for m, mod in sys.modules.items() if mod is not None)
print("BLOCKED_OK")
"""


_BLOCKED_TRAIN = r"""
import sys
sys.modules["jax"] = None
sys.modules["tpudl"] = None
import numpy as np
from tpudl_torch.train import Trainer, adamw
from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

lm = TinyCausalLM(vocab=260, dim=32, heads=4, layers=2, max_len=64,
                  device="cpu")
load_jax_params(lm, lm.init(0))
before = lm.blocks[0]["wq"].detach().clone()
tokens = np.random.default_rng(0).integers(0, 260, size=(2, 17))
model, opt, hist = Trainer(lm.loss_fn(), adamw(3e-4)).fit(
    lm, lambda step: tokens.astype(np.int32), steps=1)
assert model is lm and [h["step"] for h in hist] == [1]
assert np.isfinite(hist[0]["loss"])
assert not (lm.blocks[0]["wq"].detach() == before).all()
assert not any(m == "jax" or m.startswith(("jax.", "tpudl."))
               for m, mod in sys.modules.items() if mod is not None)
print("BLOCKED_OK")
"""


_BLOCKED_IMAGE = r"""
import sys, tempfile
sys.modules["jax"] = None
sys.modules["tpudl"] = None
import numpy as np
from PIL import Image
from tpudl_torch.image import readImages
from tpudl_torch.ml import DeepImageFeaturizer

d = tempfile.mkdtemp()
rng = np.random.default_rng(0)
for i in range(2):
    Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(
        f"{d}/img{i}.jpg")
open(f"{d}/bad.jpg", "wb").write(b"garbage")
feat = DeepImageFeaturizer(inputCol="image", outputCol="vec",
                           modelName="InceptionV3", batchSize=2,
                           device="cpu")
out = feat.transform(readImages(d).dropna())
vecs = np.stack(list(out["vec"]))
assert vecs.shape == (2, 2048) and np.isfinite(vecs).all()
assert not any(m == "jax" or m.startswith(("jax.", "tpudl."))
               for m, mod in sys.modules.items() if mod is not None)
print("BLOCKED_OK")
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_main_path_runs_with_jax_and_tpudl_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_MAIN], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BLOCKED_OK" in res.stdout


def test_training_runs_with_jax_and_tpudl_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_TRAIN], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BLOCKED_OK" in res.stdout


def test_image_path_runs_with_jax_and_tpudl_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMAGE], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BLOCKED_OK" in res.stdout


def test_no_source_imports_jax_or_tpudl():
    files = sorted((REPO / "tpudl_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    names = {str(f.relative_to(REPO)) for f in files}
    for sub in ("zoo/nn.py", "zoo/core.py", "zoo/inception_v3.py",
                "zoo/resnet.py", "zoo/xception.py", "zoo/vgg.py",
                "zoo/mobilenet_v2.py", "zoo/densenet.py",
                "zoo/efficientnet.py", "zoo/registry.py", "zoo/convert.py", "zoo/preprocessing.py",
                "image/ops.py", "image/imageIO.py", "native/__init__.py",
                "ml/named_image.py", "ml/tf_image.py", "frame/frame.py",
                "distributed.py", "mesh.py", "jobs/retry.py",
                "train/checkpoint.py", "train/runner.py", "train/step.py"):
        assert f"tpudl_torch/{sub}" in names
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_a_spawned_rank_imports_neither_jax_nor_tpudl():
    """The rank imports ``test_torch_horovod`` (torch, numpy and
    tpudl_torch only) to find its train_fn; this process holds jax and
    tpudl, the ranks must not."""
    from test_torch_horovod import loaded_modules

    from tpudl_torch.train import HorovodRunner

    assert HorovodRunner(np=-2, device="cpu").run(loaded_modules) == [[], []]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_package(where, tmp_path):
    if where == "repo":
        script, cwd = REPO / "chip_smoke.py", REPO
    else:
        script = tmp_path / "chip_smoke.py"
        shutil.copy(REPO / "chip_smoke.py", script)
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
