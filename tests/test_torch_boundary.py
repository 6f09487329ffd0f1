"""The boundary between the packages: ``tpudl_torch`` and ``chip_smoke.py``
import neither jax, keras (which imports jax), ml_dtypes, tpudl, h5py,
tensorflow nor google.protobuf; the port's main paths (text serving,
training, the image path, the Keras surface, and the SQL, UDF and tuning
surface) run with them blocked, the top-level lazy names are tpudl's, a
rank that ``HorovodRunner`` spawns holds none of them, ``chip_smoke.py``
refuses to report without a card or without the package beside it, and
the InceptionV3 config fixture that ``chip_smoke.py`` reads is what keras
writes today."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|keras|ml_dtypes|tpudl|h5py|tensorflow|"
    r"google\.protobuf)(?:[.\s,]|$)", re.MULTILINE)

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


_BLOCKED_KERAS = r"""
import sys, tempfile
for name in ("jax", "tpudl", "keras", "h5py", "tensorflow", "ml_dtypes",
             "google.protobuf"):
    sys.modules[name] = None
import numpy as np
from PIL import Image
import chip_smoke
from tpudl_torch.frame import Frame
from tpudl_torch.image.imageIO import createNativeImageLoader
from tpudl_torch.ingest.kerasfile import save_keras_file
from tpudl_torch.ml import KerasImageFileEstimator, KerasTransformer

d = tempfile.mkdtemp()
cfg = chip_smoke.keras_mlp_config()
mlp = save_keras_file(f"{d}/mlp.keras", cfg, chip_smoke.keras_weights(cfg, 0))
x = np.random.default_rng(0).normal(size=(5, 100)).astype(np.float32)
y = np.stack(list(KerasTransformer(inputCol="x", outputCol="y", modelFile=mlp,
                                   device="cpu").transform(Frame({"x": x}))["y"]))
assert y.shape == (5, 10) and np.allclose(y.sum(axis=1), 1, atol=1e-5)
cfg = chip_smoke.keras_inception_config()
inc = save_keras_file(f"{d}/inc.keras", cfg, chip_smoke.keras_weights(cfg, 0))
uris, labels = chip_smoke.keras_jpegs(d, 2, 0)
lab = np.empty(2, dtype=object)
lab[:] = labels
est = KerasImageFileEstimator(
    inputCol="uri", outputCol="out", labelCol="label", modelFile=inc,
    imageLoader=createNativeImageLoader(75, 75, scale=1 / 255),
    kerasOptimizer="adam", kerasLoss="categorical_crossentropy",
    kerasFitParams={"batch_size": 2}, device="cpu")
model = est.fit(Frame({"uri": np.array(uris, dtype=object), "label": lab}))
out = np.stack(list(model.transform(Frame({"uri": np.array(uris,
                                                            dtype=object)}))["out"]))
assert out.shape == (2, 2) and np.isfinite(model.history["step_loss"]).all()
# a legacy .h5 model file, a named model's own Keras file and the same
# file as a named stage's weights
from tpudl_torch.ingest import TFInputGraph
from tpudl_torch.image import imageArrayToStruct
from tpudl_torch.ml import DeepImageFeaturizer
cnn = TFInputGraph.fromKeras("tests/fixtures/keras/cnn.h5").make_fn()
assert cnn(__import__("torch").zeros(1, 32, 32, 3)).shape == (1, 2)
cfg = chip_smoke.keras_app_config("mobilenet_v2")
mnv2 = save_keras_file(f"{d}/mnv2.keras", cfg, chip_smoke.keras_weights(cfg, 0))
img = np.empty(1, dtype=object)
img[0] = imageArrayToStruct(np.zeros((40, 50, 3), np.uint8))
f = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="MobileNetV2",
                        weights=mnv2, device="cpu").transform(Frame({"image": img}))
assert np.stack(list(f["f"])).shape == (1, 1280)
import os, shutil
os.remove(model.getModelFile())
shutil.rmtree(d)
assert not any(m == b or m.startswith(b + ".")
               for m, mod in sys.modules.items() if mod is not None
               for b in ("jax", "tpudl", "keras", "h5py", "tensorflow",
                         "ml_dtypes", "google.protobuf"))
print("BLOCKED_OK")
"""


_BLOCKED_SURFACE = r"""
import sys, tempfile
for name in ("jax", "tpudl", "keras", "h5py", "tensorflow", "ml_dtypes",
             "google.protobuf"):
    sys.modules[name] = None
import numpy as np
import chip_smoke
from tpudl_torch import sql, TFImageTransformer, TFInputGraph
from tpudl_torch.frame import Frame
from tpudl_torch.image import imageArrayToStruct
from tpudl_torch.image.imageIO import createNativeImageLoader
from tpudl_torch.ingest.kerasfile import save_keras_file
from tpudl_torch.ml import (CrossValidator, FunctionEvaluator,
                            KerasImageFileEstimator, ParamGridBuilder)
from tpudl_torch.text import ByteTokenizer
from tpudl_torch.udf import (makeGraphUDF, register_text_udfs,
                             registerKerasImageUDF)
from tpudl_torch.zoo.transformer import TinyCausalLM

d = tempfile.mkdtemp()
cfg = chip_smoke.keras_mlp_config()
mlp = save_keras_file(f"{d}/mlp.keras", cfg, chip_smoke.keras_weights(cfg, 0))
makeGraphUDF(TFInputGraph.fromKeras(mlp), "mlp_udf", device="cpu")
x = np.empty(6, dtype=object)
x[:] = list(np.random.default_rng(0).normal(size=(6, 100)).astype(np.float32))
out = sql("SELECT mlp_udf(x) AS y FROM t LIMIT 4",
          {"t": Frame({"x": x, "k": np.arange(6) % 2})})
assert np.stack(list(out["y"])).shape == (4, 10)
cfg = chip_smoke.keras_inception_config()
inc = save_keras_file(f"{d}/inc.keras", cfg, chip_smoke.keras_weights(cfg, 0))
rng = np.random.default_rng(0)
imgs = np.empty(3, dtype=object)
imgs[:] = [imageArrayToStruct(rng.integers(0, 256, (75, 75, 3), np.uint8))
           for _ in range(3)]
registerKerasImageUDF("inc_udf", inc, batch_size=2, device="cpu")
p = sql("SELECT inc_udf(image) AS p FROM images",
        {"images": Frame({"image": imgs})})
v = TFImageTransformer(inputCol="image", outputCol="p", device="cpu",
                       batchSize=2,
                       graph=TFInputGraph.fromKeras(inc)).transform(
    Frame({"image": imgs}))
assert np.array_equal(np.stack(list(p["p"])), np.stack(list(v["p"])))
spec = TinyCausalLM(vocab=260, dim=32, heads=4, layers=2, max_len=64,
                    device="meta")
register_text_udfs(model=spec, weights=spec.init(0), tokenizer=ByteTokenizer(),
                   classes=["yes", "no"], max_new=3, device="cpu")
docs = {"docs": Frame({"text": np.array(["abc", "de"], dtype=object)})}
for q in ("SELECT embed(text) AS v FROM docs",
          "SELECT classify(text) AS c FROM docs",
          "SELECT generate(text) AS g FROM docs"):
    assert len(sql(q, docs)) == 2
uris, labels = chip_smoke.keras_jpegs(d, 4, 0)
lab = np.empty(4, dtype=object)
lab[:] = labels
est = KerasImageFileEstimator(
    inputCol="uri", outputCol="out", labelCol="label", modelFile=inc,
    imageLoader=createNativeImageLoader(75, 75, scale=1 / 255),
    kerasOptimizer="adam", kerasLoss="categorical_crossentropy",
    kerasFitParams={"batch_size": 2}, device="cpu")
grid = ParamGridBuilder().addGrid(est.kerasFitParams, [
    {"batch_size": 2, "learning_rate": lr} for lr in (1e-3, 1e-4)]).build()
cv = CrossValidator(estimator=est, estimatorParamMaps=grid, numFolds=2,
                    evaluator=FunctionEvaluator(lambda f: len(f))).fit(
    Frame({"uri": np.array(uris, dtype=object), "label": lab}))
assert len(cv.avgMetrics) == 2 and cv.bestIndex in (0, 1)
import os, shutil
os.remove(cv.bestModel.getModelFile())
shutil.rmtree(d)
assert not any(m == b or m.startswith(b + ".")
               for m, mod in sys.modules.items() if mod is not None
               for b in ("jax", "tpudl", "keras", "h5py", "tensorflow",
                         "ml_dtypes", "google.protobuf"))
print("BLOCKED_OK")
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


_BLOCKED_GRAPH = r"""
import sys, gzip, json, tempfile
for name in ("jax", "tpudl", "keras", "h5py", "tensorflow", "ml_dtypes",
             "google.protobuf"):
    sys.modules[name] = None
import numpy as np
import torch
import chip_smoke
from tpudl_torch.frame import Frame, sql
from tpudl_torch.ingest import GraphFunction, TFInputGraph
from tpudl_torch.ml import TFTransformer
from tpudl_torch.udf import makeGraphUDF, unregister_udf

F = "tests/fixtures/tf/"
x = np.random.default_rng(0).normal(size=(4, 3))
graphs = [TFInputGraph.fromGraphDef(open(F + "factory.pb", "rb").read(),
                                    ["x"], ["z"]),
          TFInputGraph.fromSavedModel(F + "factory_saved_model", "serve",
                                      ["x:0"], ["z:0"]),
          TFInputGraph.fromSavedModelWithSignature(F + "factory_saved_model",
                                                   "serve", "my_sig"),
          TFInputGraph.fromCheckpoint(F + "factory_ckpt", ["x:0"], ["z:0"]),
          TFInputGraph.fromCheckpointWithSignature(F + "factory_ckpt",
                                                   "my_sig")]
for g in graphs:
    assert np.allclose(g.make_fn()(torch.from_numpy(x)).numpy(), 3 * x + 4)
cnn = TFInputGraph.fromSavedModelWithSignature(F + "keras_cnn", "serve",
                                               "serving_default")
assert cnn.make_fn()(torch.zeros(1, 16, 16, 3)).shape == (1, 5)
t = TFTransformer(tfInputGraph=graphs[-1], inputMapping={"v": "input_sig"},
                  outputMapping={"output_sig": "z"}, device="cpu")
assert np.allclose(np.stack(list(t.transform(Frame({"v": x}))["z"])),
                   3 * x + 4)
gf = GraphFunction.fromList([("g", GraphFunction.fromTFInputGraph(graphs[0])),
                             ("n", GraphFunction(lambda v: -v, ["z"], ["y"]))])
makeGraphUDF(gf, "neg_udf", feeds_to_fields_map={"g/x": "v"}, device="cpu")
try:
    y = np.stack(list(sql("SELECT neg_udf(v) AS y FROM t",
                          {"t": Frame({"v": x})})["y"]))
finally:
    unregister_udf("neg_udf")
assert np.allclose(y, -(3 * x + 4))
# the InceptionV3 + head SavedModel as chip_smoke phase 11 writes it
d = tempfile.mkdtemp()
import os
os.makedirs(d + "/sm")
open(d + "/sm/saved_model.pb", "wb").write(gzip.decompress(
    open(F + "inception_v3_tl/saved_model.pb.gz", "rb").read()))
import tf_bundle_writer
keys = json.loads(gzip.decompress(open(
    F + "inception_v3_tl/variables.json.gz", "rb").read()))
cfg = chip_smoke.keras_inception_config()
tf_bundle_writer.write_saved_model_variables(
    d + "/sm", keys, chip_smoke.keras_weights(cfg, 0), None)
inc = TFInputGraph.fromSavedModelWithSignature(d + "/sm", "serve",
                                               "serving_default")
assert inc.make_fn()(torch.zeros(1, 75, 75, 3)).shape == (1, 2)
import shutil
shutil.rmtree(d)
assert not any(m == b or m.startswith(b + ".")
               for m, mod in sys.modules.items() if mod is not None
               for b in ("jax", "tpudl", "keras", "h5py", "tensorflow",
                         "ml_dtypes", "google.protobuf"))
print("BLOCKED_OK")
"""


def test_graph_routes_run_with_jax_keras_tf_and_protobuf_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_GRAPH], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BLOCKED_OK" in res.stdout


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


def test_keras_surface_runs_with_jax_keras_h5py_and_tf_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_KERAS], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BLOCKED_OK" in res.stdout


def test_sql_udfs_and_tuning_run_with_jax_keras_h5py_and_tf_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_SURFACE], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BLOCKED_OK" in res.stdout


def test_lazy_names_resolve_and_are_tpudls():
    """The port's top-level lazy map is tpudl's ``_LAZY`` restricted to
    what is ported: every name resolves, under tpudl's spelling."""
    import tpudl

    import tpudl_torch

    assert set(tpudl_torch._LAZY) <= set(tpudl._LAZY)
    for name in ("sql", "register_udf", "registerKerasImageUDF",
                 "TFImageTransformer", "ParamGridBuilder", "CrossValidator",
                 "KerasImageFileEstimator", "LMFeaturizer",
                 "DeepImageFeaturizer", "GraphFunction", "IsolatedSession"):
        assert name in tpudl_torch._LAZY
    for name in tpudl_torch._LAZY:
        obj = getattr(tpudl_torch, name)
        assert getattr(obj, "__name__", name) == name
        assert obj.__module__.startswith("tpudl_torch.")
    assert set(dir(tpudl_torch)) >= set(tpudl_torch._LAZY)
    with pytest.raises(AttributeError):
        tpudl_torch.ring_attention


def test_no_source_imports_jax_or_tpudl():
    files = sorted((REPO / "tpudl_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tf_bundle_writer.py"]
    names = {str(f.relative_to(REPO)) for f in files}
    for sub in ("zoo/nn.py", "zoo/core.py", "zoo/inception_v3.py",
                "zoo/resnet.py", "zoo/xception.py", "zoo/vgg.py",
                "zoo/mobilenet_v2.py", "zoo/densenet.py",
                "zoo/efficientnet.py", "zoo/registry.py", "zoo/convert.py", "zoo/preprocessing.py",
                "image/ops.py", "image/imageIO.py", "native/__init__.py",
                "ml/named_image.py", "ml/tf_image.py", "frame/frame.py",
                "distributed.py", "mesh.py", "jobs/retry.py",
                "train/checkpoint.py", "train/runner.py", "train/step.py",
                "ingest/hdf5.py", "ingest/kerasfile.py",
                "ingest/keras_graph.py", "ingest/input.py",
                "ml/keras_tensor.py", "ml/tf_tensor.py", "ml/keras_image.py",
                "ml/estimator.py", "ml/classification.py", "ml/losses.py",
                "ml/image_params.py", "frame/sql.py", "udf/registry.py",
                "udf/tensorframes_udf.py", "udf/keras_image_model.py",
                "udf/text_udf.py", "ml/hpo.py", "ml/tuning.py",
                "ingest/protowire.py", "ingest/tensor_bundle.py",
                "ingest/graphdef.py", "ingest/savedmodel.py",
                "ingest/builder.py", "native/crc.py", "__init__.py"):
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


def test_inception_config_fixture_is_what_keras_writes_today():
    """``chip_smoke.py`` phase 9 builds configs[2]'s model from the
    committed ``config.json`` (the card's machine has no keras); keras on
    this host must write the same config for ``bench.py``'s
    ``measure_estimator_inception`` model (``shared_object_id`` values,
    Python ids at save time, renumbered)."""
    pytest.importorskip("keras")
    import torch_keras_models as M

    assert M.inception_config() == M.fixture_config()
