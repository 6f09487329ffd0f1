"""The stages and UDFs over a mesh, held to tpudl's over the same number
of its simulated devices on the same weights and inputs.

Each stage of the port loads its model once on the mesh's first entry,
replicates it to the others (:func:`tpudl_torch.mesh.replicate`), and
runs each entry's shard of a batch on that entry's replica. On the
host the entries are ``["cpu"] * n``. A model computes each shard at a
smaller batch than a run without a mesh, so image outputs are held within
2e-5 of max |y| and the LM's within 1e-4 (the limits the card holds
them to); a one-entry mesh is held to the run without one bit for bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl import mesh as jax_mesh
from tpudl.frame import Frame as JaxFrame
from tpudl.image import imageIO as jax_imageIO
from tpudl.ml import DeepImageFeaturizer as JaxFeaturizer
from tpudl.ml import LMClassifier as JaxClassifier
from tpudl.ml import LMFeaturizer as JaxLMFeaturizer
from tpudl.text import ByteTokenizer as JaxByteTokenizer
from tpudl.zoo.transformer import TinyCausalLM as JaxLM
from tpudl_torch import mesh as M
from tpudl_torch.frame import Frame
from tpudl_torch.image import imageIO
from tpudl_torch.ml import DeepImageFeaturizer, LMClassifier, LMFeaturizer
from tpudl_torch.obs import last_pipeline_report
from tpudl_torch.text import ByteTokenizer
from tpudl_torch.zoo.transformer import TinyCausalLM
from torch_native_fixture import private_tpudl_decoder  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")

torch.set_num_threads(1)

IMAGE_TOL = 2e-5
LM_TOL = 1e-4
ARCH = dict(vocab=260, dim=32, heads=4, layers=2, max_len=64)
TEXTS = np.array(["hello", "a much longer row of text here", "x",
                  "tpu to gpu", "short one", "the last, partial batch",
                  "seven", "and an eighth row"], dtype=object)
CLASSES = ["alpha", "beta", "gamma", "delta", "omega"]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _meshes(n):
    return (M.build_mesh(devices=["cpu"] * n),
            jax_mesh.build_mesh(devices=jax.devices()[:n]))


def _structs(module, n, shape=(48, 40, 3), seed=3):
    rng = np.random.default_rng(seed)
    col = np.empty(n, dtype=object)
    col[:] = [module.imageArrayToStruct(rng.integers(0, 256, shape,
                                                     dtype=np.uint8))
              for _ in range(n)]
    return col


@pytest.mark.parametrize("n", [2, 4])
def test_featurizer_over_a_mesh_matches_tpudl(n):
    """MobileNetV2 features of 6 rows at batch 4 (the tail of 2 pads to
    the axis) over ``n`` entries against tpudl's over ``n`` devices."""
    ours_mesh, theirs_mesh = _meshes(n)
    kw = dict(inputCol="image", outputCol="f", modelName="MobileNetV2",
              batchSize=4)
    got = DeepImageFeaturizer(mesh=ours_mesh, **kw).transform(
        Frame({"image": _structs(imageIO, 6)}))
    rep = last_pipeline_report()
    want = JaxFeaturizer(mesh=theirs_mesh, **kw).transform(
        JaxFrame({"image": _structs(jax_imageIO, 6)}))
    a, b = np.stack(list(got["f"])), np.stack(list(want["f"]))
    assert a.shape == b.shape == (6, 1280)
    assert _rel(a, b) <= IMAGE_TOL
    assert rep["mesh"] == {"data": n, "model": 1}
    assert rep["stage_calls"].get("pad_rows", 0) == (-2) % n


@pytest.fixture(scope="module")
def lm():
    jlm = JaxLM(**ARCH)
    params = jlm.init(0)
    # a 50x embedding spreads the tied-head logits so rows pick different
    # labels (at init scale every row picks the same one)
    sharp = dict(params, embed={"table": params["embed"]["table"] * 50})
    return (jlm, params, sharp, TinyCausalLM(device="meta", **ARCH))


def _lm_kw(spec, weights):
    return dict(inputCol="text", model=spec, weights=weights,
                tokenizer=ByteTokenizer(), batchSize=4)


@pytest.mark.parametrize("fuse", [1, 2])
def test_lm_featurizer_over_a_mesh_matches_tpudl(lm, fuse):
    jlm, params, _, spec = lm
    ours_mesh, theirs_mesh = _meshes(4)
    got = LMFeaturizer(outputCol="v", mesh=ours_mesh, fuseSteps=fuse,
                       **_lm_kw(spec, params)).transform(
                           Frame({"text": TEXTS}))
    assert last_pipeline_report()["fuse_steps"] == fuse
    want = JaxLMFeaturizer(
        inputCol="text", outputCol="v", model=jlm,
        weights=jax.tree.map(jnp.asarray, params),
        tokenizer=JaxByteTokenizer(), batchSize=4,
        mesh=theirs_mesh).transform(JaxFrame({"text": TEXTS}))
    a, b = np.stack(list(got["v"])), np.stack(list(want["v"]))
    assert a.shape == b.shape == (len(TEXTS), ARCH["dim"])
    np.testing.assert_allclose(a, b, rtol=LM_TOL, atol=LM_TOL)


def test_lm_classifier_over_a_mesh_matches_tpudl(lm):
    jlm, _, sharp, spec = lm
    ours_mesh, theirs_mesh = _meshes(2)
    got = LMClassifier(outputCol="label", classes=CLASSES, mesh=ours_mesh,
                       **_lm_kw(spec, sharp)).transform(
                           Frame({"text": TEXTS}))
    want = JaxClassifier(
        inputCol="text", outputCol="label", model=jlm,
        weights=jax.tree.map(jnp.asarray, sharp),
        tokenizer=JaxByteTokenizer(), classes=CLASSES, batchSize=4,
        mesh=theirs_mesh).transform(JaxFrame({"text": TEXTS}))
    assert list(got["label"]) == list(want["label"])
    assert len(set(got["label"])) > 1


def test_lm_featurizer_on_a_mesh_of_one_is_the_plain_run(lm):
    """A one-entry mesh: the same batches, weights and function as the
    run without a mesh, so the same bits."""
    _, params, _, spec = lm
    frame = Frame({"text": TEXTS})
    meshed = LMFeaturizer(outputCol="v", mesh=M.build_mesh(devices=["cpu"]),
                          **_lm_kw(spec, params)).transform(frame)
    plain = LMFeaturizer(outputCol="v", device="cpu",
                         **_lm_kw(spec, params)).transform(frame)
    assert np.array_equal(np.stack(list(meshed["v"])),
                          np.stack(list(plain["v"])))


def test_lm_stage_replicates_its_module_once(lm):
    """The stage loads the module on the first entry and the other
    distinct device gets one deep copy, reused by later transforms."""
    _, params, _, spec = lm
    stage = LMFeaturizer(outputCol="v", mesh=M.build_mesh(
        devices=["cpu", "meta"]), **_lm_kw(spec, params))
    net, _ = stage._require()
    assert net.device == torch.device("cpu")
    cpu_rep = stage._replica(net, "cpu")
    meta_rep = stage._replica(net, "meta")
    assert cpu_rep is net and meta_rep.device == torch.device("meta")
    assert stage._replica(net, "meta") is meta_rep


def test_text_udfs_over_a_mesh_equal_the_stages(lm):
    """``register_text_udfs(mesh=)``: ``embed`` and ``classify`` run the
    stages over the mesh (bit for bit the stages under the same mesh),
    ``generate`` decodes on the first entry."""
    from tpudl_torch.udf import register_text_udfs

    _, _, sharp, spec = lm
    mesh = M.build_mesh(devices=["cpu"] * 2)
    gen, embed, classify = register_text_udfs(
        model=spec, weights=sharp, tokenizer=ByteTokenizer(),
        classes=CLASSES, max_new=4, batch_size=4, mesh=mesh, register=False)
    frame = Frame({"text": TEXTS})
    got_v = np.stack(list(embed(frame)[embed.output_col]))
    want_v = np.stack(list(LMFeaturizer(
        outputCol="v", mesh=mesh, **_lm_kw(spec, sharp)).transform(
            frame)["v"]))
    assert np.array_equal(got_v, want_v)
    got_l = list(classify(frame)[classify.output_col])
    want_l = list(LMClassifier(outputCol="l", classes=CLASSES, mesh=mesh,
                               **_lm_kw(spec, sharp)).transform(frame)["l"])
    assert got_l == want_l
    assert len(gen(Frame({"text": TEXTS[:2]}))[gen.output_col]) == 2


def test_keras_image_udf_over_a_mesh_matches_tpudl(tmp_path):
    keras = pytest.importorskip("keras")
    import torch_keras_models as KM

    from tpudl.udf import registry as jax_registry
    from tpudl.udf.keras_image_model import \
        registerKerasImageUDF as jax_keras_image_udf
    from tpudl_torch.udf import registerKerasImageUDF, unregister_udf

    assert keras is not None
    path = KM.saved("cnn", tmp_path)
    ours_mesh, theirs_mesh = _meshes(4)
    ours = registerKerasImageUDF("mesh_cnn", path, batch_size=8,
                                 mesh=ours_mesh)
    theirs = jax_keras_image_udf("mesh_cnn", path, batch_size=8,
                                 mesh=theirs_mesh)
    try:
        got = ours.fn(Frame({"image": _structs(imageIO, 10, (32, 32, 3))}))
        want = theirs.fn(JaxFrame({"image": _structs(jax_imageIO, 10,
                                                     (32, 32, 3))}))
    finally:
        unregister_udf("mesh_cnn")
        jax_registry.unregister_udf("mesh_cnn")
    a = np.stack(list(got[ours.output_col]))
    b = np.stack(list(want[theirs.output_col]))
    assert a.shape == b.shape == (10, 2)
    assert _rel(a, b) <= 1e-5
