"""The boundary between the packages: ``tpudl_torch`` and ``chip_smoke.py``
import neither jax nor tpudl, the port's main paths (serving and training)
run with both blocked, and ``chip_smoke.py`` refuses to report without a card or without the
package beside it."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|tpudl)(?:[.\s,]|$)",
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


def test_no_source_imports_jax_or_tpudl():
    files = sorted((REPO / "tpudl_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


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
