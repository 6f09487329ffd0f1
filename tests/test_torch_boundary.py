"""The boundary between the packages: ``tpudl_torch``, ``chip_smoke.py`` and
the writers beside it import neither jax, keras (which imports jax),
tf_keras, ml_dtypes, tpudl, h5py, tensorflow nor google.protobuf; the
port's main paths (text serving, training, the image path, the Keras
surface with Keras 2-era ``.h5`` files, and the SQL, UDF and tuning
surface) run with them blocked, the top-level lazy names are tpudl's, a
rank that ``HorovodRunner`` spawns holds none of them, ``chip_smoke.py``
refuses to report without a card or without the package beside it, and
the InceptionV3 config fixture that ``chip_smoke.py`` reads is what keras
writes today."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|keras|tf_keras|ml_dtypes|tpudl|h5py|"
    r"tensorflow|google\.protobuf)(?:[.\s,]|$)", re.MULTILINE)

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
for name in ("jax", "tpudl", "keras", "tf_keras", "h5py", "tensorflow",
             "ml_dtypes", "google.protobuf"):
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
# a Keras 2-era .h5 as tf_keras writes it (int64 ids in, in their dtype),
# and one written by keras2_h5_writer
import keras2_h5_writer
from tpudl_torch.ingest.kerasfile import load_keras_file
ids = np.random.default_rng(0).integers(0, 200, (3, 64))
text = "tests/fixtures/keras2/text_cnn.h5"
p = np.stack(list(KerasTransformer(inputCol="x", outputCol="y", modelFile=text,
                                   device="cpu").transform(Frame({"x": ids}))["y"]))
assert p.shape == (3, 1) and ((p > 0) & (p < 1)).all()
import json
from tpudl_torch.ingest import hdf5
raw = hdf5.read(open(text, "rb").read()).attrs["model_config"]
_c, w = load_keras_file(text)
again = keras2_h5_writer.write_keras2_h5(f"{d}/again.h5", json.loads(raw), w)
assert all(a.tobytes() == b.tobytes()
           for a, b in zip(w.values(), load_keras_file(again)[1].values()))
import os, shutil
os.remove(model.getModelFile())
shutil.rmtree(d)
assert not any(m == b or m.startswith(b + ".")
               for m, mod in sys.modules.items() if mod is not None
               for b in ("jax", "tpudl", "keras", "tf_keras", "h5py",
                         "tensorflow", "ml_dtypes", "google.protobuf"))
print("BLOCKED_OK")
"""


_BLOCKED_DATA = r"""
import sys, tempfile
for name in ("jax", "tpudl", "keras", "h5py", "tensorflow", "ml_dtypes",
             "google.protobuf"):
    sys.modules[name] = None
import numpy as np
from tpudl_torch.data import Dataset, cached_uri_load, reset_device_cache
from tpudl_torch.frame import Frame
from tpudl_torch.text import ByteTokenizer, lm_dataset
from tpudl_torch.train import Trainer, sgd
from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

d = tempfile.mkdtemp()
x = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32)
for codec in ("bf16", "u8", None):
    src = x if codec != "u8" else (np.abs(x) * 10).astype(np.uint8)
    outs = [np.stack(list(Frame({"x": src}).map_batches(
        lambda t: t * 2, ["x"], ["y"], batch_size=4, device="cpu",
        wire_codec=codec, cache_dir=d, device_cache=True)["y"]))
        for _ in range(2)]
    assert np.array_equal(outs[0], outs[1])
texts = np.empty(8, dtype=object)
texts[:] = [f"row {i} text" for i in range(8)]
ds = lm_dataset(Frame({"text": texts}), "text", ByteTokenizer(), seq_len=9,
                batch_size=4, cache_dir=d, device_cache=True, device="cpu")
lm = TinyCausalLM(vocab=260, dim=32, heads=4, layers=2, max_len=64,
                  device="cpu")
load_jax_params(lm, lm.init(0))
_, _, hist = Trainer(ds.wrap(lm.loss_fn()), sgd(0.1)).fit(
    lm, lambda s: ds.get_batch(s % ds.num_batches), 4)
assert np.isfinite(hist[-1]["loss"])
reset_device_cache()
assert not any(m == b or m.startswith(b + ".")
               for m, mod in sys.modules.items() if mod is not None
               for b in ("jax", "tpudl", "ml_dtypes"))
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


_BLOCKED_SERVE = r"""
import sys
for name in ("jax", "tpudl", "ml_dtypes"):
    sys.modules[name] = None
import numpy as np
import torch
from tpudl_torch.serve import (AdmissionError, ModelRegistry, RequestQueue,
                               RungBatcher, Server, run_closed_loop)
from tpudl_torch.zoo.transformer import TinyCausalLM

torch.set_num_threads(1)
spec = TinyCausalLM(vocab=64, dim=32, heads=4, layers=2, max_len=64,
                    device="meta")
reg = ModelRegistry()
entry = reg.add_model("default", spec, spec.init(0), slots=2, cache_len=32,
                      device="cpu")
assert entry.warm_signatures == 3
queue = RequestQueue(cap=4)
srv = Server(reg, queue).start_async()
out = run_closed_loop(srv, lambda i: np.arange(1, 3 + i % 5, dtype=np.int32),
                      requests=8, clients=2, max_new=3, timeout=60)
req = srv.submit([5, 6, 7], 4)
assert req.result(timeout=60).shape == (4,)
summary = srv.close(timeout=60)
assert out["completed"] == 8 and summary["completed"] == 9
try:
    reg.get("default").engine.insert(type("R", (), {
        "prompt": np.ones((1, 40), np.int32), "max_new": 4})())
except ValueError as e:
    assert "exceeds the" in str(e)
(y,) = RungBatcher(lambda x: x * 2).run([np.ones((3, 2), np.float32)])
assert y.shape == (3, 2) and AdmissionError("x", reason="queue_full").reason
assert not any(m == b or m.startswith(b + ".")
               for m, mod in sys.modules.items() if mod is not None
               for b in ("jax", "tpudl", "ml_dtypes"))
print("BLOCKED_OK")
"""


def test_serve_session_runs_with_jax_tpudl_and_ml_dtypes_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_SERVE], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BLOCKED_OK" in res.stdout


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


def test_data_layer_runs_with_jax_tpudl_and_ml_dtypes_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_DATA], cwd=REPO,
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
    files += [REPO / "chip_smoke.py", REPO / "tf_bundle_writer.py",
              REPO / "keras2_h5_writer.py"]
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
                "ingest/keras_legacy.py",
                "ingest/keras_graph.py", "ingest/input.py",
                "ml/keras_tensor.py", "ml/tf_tensor.py", "ml/keras_image.py",
                "ml/estimator.py", "ml/classification.py", "ml/losses.py",
                "ml/image_params.py", "frame/sql.py", "udf/registry.py",
                "udf/tensorframes_udf.py", "udf/keras_image_model.py",
                "udf/text_udf.py", "ml/hpo.py", "ml/tuning.py",
                "ingest/protowire.py", "ingest/tensor_bundle.py",
                "ingest/graphdef.py", "ingest/savedmodel.py",
                "ingest/builder.py", "native/crc.py", "__init__.py",
                "data/__init__.py", "data/codec.py", "data/shards.py",
                "data/device_cache.py", "data/dataset.py", "text/data.py",
                "serve/__init__.py", "serve/reqtrace.py", "serve/queue.py",
                "serve/batching.py", "serve/slots.py", "serve/registry.py",
                "serve/server.py", "serve/loadgen.py",
                "compile/__init__.py", "compile/buckets.py",
                "compile/cache.py", "compile/store.py",
                "compile/graphs.py", "collectives.py",
                "obs/tracer.py", "obs/watchdog.py", "obs/attribution.py",
                "obs/slo.py", "obs/trace.py", "obs/roofline.py",
                "obs/live.py", "obs/doctor.py", "obs/__main__.py"):
        assert f"tpudl_torch/{sub}" in names
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


_COPIED = re.compile(
    r"^[ \t]*# copied from (tpudl/[\w/]+\.py):([\w.]+)(?:\[(\w+)\])?[ \t]*$",
    re.MULTILINE)
# the data and serve slices' modules (every block) and the blocks they
# copied into older ones
_COPY_CHECKED = {"data/codec.py": None, "data/shards.py": None,
                 "data/device_cache.py": None, "data/dataset.py": None,
                 "text/data.py": None,
                 "text/codec.py": {"_wire_dtype", "lengths"},
                 "jobs/retry.py": {"_env_float", "io_policy"},
                 "ml/image_params.py": {"load_uri_batch"},
                 "ml/estimator.py": {"_train_codec"},
                 "serve/reqtrace.py": None, "serve/queue.py": None,
                 "serve/slots.py": None, "serve/registry.py": None,
                 "serve/server.py": None, "serve/loadgen.py": None,
                 "obs/pipeline.py": {"PipelineReport.finish"},
                 "obs/flight.py": None, "obs/tracer.py": None,
                 "obs/metrics.py": None, "obs/watchdog.py": None,
                 "obs/attribution.py": None, "obs/slo.py": None,
                 "obs/live.py": None, "obs/doctor.py": None,
                 "obs/roofline.py": None, "obs/trace.py": None,
                 "obs/__main__.py": None}


class _ServeHooks(ast.NodeTransformer):
    """tpudl's code with its lock sanitizer spelled as the port's: the
    port keeps every ``_tsan.named_lock(...)`` construction and ``if
    _tsan.ENABLED:`` guard check (:mod:`tpudl_torch.testing.tsan`), so a
    reference to ``tpudl.testing.tsan`` becomes one to
    ``tpudl_torch.testing.tsan`` and the blocks compare as they are
    (``_code_of`` then spells both packages' imports as tpudl's)."""

    def visit_ImportFrom(self, node):
        if node.module in ("tpudl.testing", "tpudl.testing.tsan"):
            node.module = "tpudl_torch" + node.module[len("tpudl"):]
        return node


def _code_of(tree, qualname, branch=None):
    """The def or class ``qualname`` of a parsed module (with ``branch``,
    its ``if`` statement whose test names that string), with docstrings
    dropped and the port's imports spelled as tpudl's: what a copy must
    keep identical."""
    def named(body, name):
        return [n for n in body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and n.name == name]

    node = tree
    for part in qualname.split("."):
        # a bare method name: the method of that name in any class
        found = named(node.body, part) or [
            m for c in node.body if isinstance(c, ast.ClassDef)
            for m in named(c.body, part)]
        node = found[0]
    if branch is not None:
        node = next(n for n in ast.walk(node) if isinstance(n, ast.If)
                    and repr(branch) in ast.unparse(n.test))
    node = ast.parse(ast.unparse(node)).body[0]     # a private copy
    for n in ast.walk(node):
        body = getattr(n, "body", None)
        if (isinstance(n, (ast.FunctionDef, ast.ClassDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            n.body = body[1:] or [ast.Pass()]
        if isinstance(n, ast.ImportFrom) and n.module and \
                n.module.startswith("tpudl_torch"):
            n.module = "tpudl" + n.module[len("tpudl_torch"):]
    return ast.dump(node)


def test_copied_blocks_equal_their_tpudl_source():
    """Every ``# copied from tpudl/<file>:<name>`` block of the data, serve
    and observability slices is its source's code, docstrings aside
    (``<name>[key]``: the branch of ``<name>`` on that key). The serve and
    obs blocks are held with tpudl's lock sanitizer spelled as the port's
    (``_ServeHooks``): both keep its hooks."""
    checked = []
    for sub, names in _COPY_CHECKED.items():
        text = (REPO / "tpudl_torch" / sub).read_text()
        ours = ast.parse(text)
        for src, qual, branch in _COPIED.findall(text):
            if names is not None and qual not in names:
                continue
            theirs = ast.parse((REPO / src).read_text())
            if sub.startswith(("serve/", "obs/")):
                theirs = _ServeHooks().visit(theirs)
            branch = branch or None
            assert _code_of(ours, qual, branch) == _code_of(
                theirs, qual, branch), \
                f"tpudl_torch/{sub}:{qual} drifted from {src}"
            checked.append(f"{sub}:{qual}")
    # + Server.__init__ and Server.run, copied with supervised serving;
    # + Server._harvest and obs/'s 115 blocks, with the observability slice
    assert len(checked) == 30 + 35 + 2 + 1 + 115, checked


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
