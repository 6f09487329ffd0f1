"""The port's text stages (``tpudl_torch.ml.lm``) and serial executor
(``tpudl_torch.frame``) against tpudl's, on the same ragged strings and
the same ``init(0)`` weights at a small width. tpudl's stages get ``jnp``
weights: its featurize/classify forward indexes the embedding table with
traced ids, which numpy arrays do not support.

Tolerances: pooled features to 2e-5 absolute (f32 on the CPU through two
layers, sums in another order); labels, completions and executor rows
exact."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl.frame import Frame as JaxFrame
from tpudl.ml import LMClassifier as JaxClassifier
from tpudl.ml import LMFeaturizer as JaxFeaturizer
from tpudl.ml import LMGenerator as JaxGenerator
from tpudl.text import ByteTokenizer as JaxByteTokenizer
from tpudl.zoo.transformer import TinyCausalLM as JaxLM
from tpudl_torch.frame import Frame
from tpudl_torch.ml import LMClassifier, LMFeaturizer, LMGenerator
from tpudl_torch.obs import metrics
from tpudl_torch.text import ByteTokenizer
from tpudl_torch.zoo.transformer import TinyCausalLM

# the suite runs several pytest workers on the same cores: one torch
# thread per worker avoids oversubscribing them
torch.set_num_threads(1)

ARCH = dict(vocab=260, dim=32, heads=4, layers=2, max_len=64)
TOL = 2e-5
# ragged lengths; 6 rows at batchSize=4 leave a partial last batch
TEXTS = np.array(["hello", "a much longer row of text here", "x",
                  "tpu to gpu", "short one", "the last, partial batch"],
                 dtype=object)
CLASSES = ["alpha", "beta", "gamma", "delta", "omega"]


@pytest.fixture(scope="module")
def lm():
    jlm = JaxLM(**ARCH)
    params = jlm.init(0)
    spec = TinyCausalLM(device="meta", **ARCH)
    return jlm, params, jax.tree.map(jnp.asarray, params), spec


def _stage_kw(spec, params):
    return dict(inputCol="text", model=spec, weights=params,
                tokenizer=ByteTokenizer(), device="cpu")


def test_featurizer_matches_tpudl(lm):
    jlm, params, jparams, spec = lm
    want = JaxFeaturizer(inputCol="text", outputCol="vec", model=jlm,
                         weights=jparams, tokenizer=JaxByteTokenizer(),
                         batchSize=4).transform(JaxFrame({"text": TEXTS}))
    got = LMFeaturizer(outputCol="vec", batchSize=4,
                       **_stage_kw(spec, params)).transform(
                           Frame({"text": TEXTS}))
    assert got.columns == ["text", "vec"]
    a, b = np.stack(list(got["vec"])), np.stack(list(want["vec"]))
    assert a.shape == (len(TEXTS), ARCH["dim"])
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_classifier_matches_tpudl(lm):
    jlm, params, _, spec = lm
    # a 50x embedding spreads the tied-head logits enough that the rows
    # pick different labels (at init scale every row picks the same one)
    sharp = dict(params, embed={"table": params["embed"]["table"] * 50})
    want = JaxClassifier(inputCol="text", outputCol="label", model=jlm,
                         weights=jax.tree.map(jnp.asarray, sharp),
                         tokenizer=JaxByteTokenizer(), classes=CLASSES,
                         batchSize=4).transform(JaxFrame({"text": TEXTS}))
    got = LMClassifier(outputCol="label", classes=CLASSES, batchSize=4,
                       **_stage_kw(spec, sharp)).transform(
                           Frame({"text": TEXTS}))
    assert list(got["label"]) == list(want["label"])
    assert len(set(got["label"])) > 1   # the rows do not all tie
    with pytest.raises(ValueError, match="distinct"):
        LMClassifier(outputCol="l", classes=["go", "gone"],
                     **_stage_kw(spec, params))._class_ids(ByteTokenizer())


@pytest.mark.parametrize("batch_size", [1, 4])
def test_greedy_generator_matches_tpudl(lm, batch_size):
    jlm, params, _, spec = lm
    texts = np.array(["ab", "cd", "efgh", "ij", "a longer prompt"],
                     dtype=object)
    want = JaxGenerator(inputCol="text", outputCol="gen", model=jlm,
                        weights=params, tokenizer=JaxByteTokenizer(),
                        maxNew=6, batchSize=batch_size).transform(
                            JaxFrame({"text": texts}))
    got = LMGenerator(outputCol="gen", maxNew=6, batchSize=batch_size,
                      **_stage_kw(spec, params)).transform(
                          Frame({"text": texts}))
    assert list(got["gen"]) == list(want["gen"])


def test_sampling_generator_is_seeded(lm):
    _, params, _, spec = lm
    frame = Frame({"text": TEXTS[:3]})

    def run(seed):
        return list(LMGenerator(outputCol="gen", maxNew=8, temperature=1.0,
                                seed=seed, **_stage_kw(spec, params))
                    .transform(frame)["gen"])

    assert run(3) == run(3)
    assert run(3) != run(4)


def test_stages_count_rows(lm):
    _, params, _, spec = lm
    frame = Frame({"text": TEXTS})

    def value(name):
        return metrics.counter(name).value

    before = {n: value(n) for n in ("lm.embed.rows", "lm.classify.rows",
                                    "lm.generate.requests",
                                    "ml.LMFeaturizer.transforms")}
    LMFeaturizer(outputCol="v", batchSize=4,
                 **_stage_kw(spec, params)).transform(frame)
    LMClassifier(outputCol="l", classes=CLASSES, batchSize=4,
                 **_stage_kw(spec, params)).transform(frame)
    LMGenerator(outputCol="g", maxNew=2,
                **_stage_kw(spec, params)).transform(frame)
    assert value("lm.embed.rows") - before["lm.embed.rows"] == len(TEXTS)
    assert value("lm.classify.rows") - before["lm.classify.rows"] == len(TEXTS)
    assert (value("lm.generate.requests")
            - before["lm.generate.requests"]) == len(TEXTS)
    assert (value("ml.LMFeaturizer.transforms")
            - before["ml.LMFeaturizer.transforms"]) == 1


@pytest.mark.parametrize("knob", ["mesh", "tp", "prefetchDepth",
                                  "prepareWorkers", "fuseSteps",
                                  "dispatchDepth", "cacheDir",
                                  "deviceCache", "wireCodec"])
def test_unported_executor_knobs_raise(lm, knob):
    _, params, _, spec = lm
    value = {"tp": True, "wireCodec": "u16", "cacheDir": "/nonexistent",
             "deviceCache": True, "mesh": object()}.get(knob, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LMFeaturizer(outputCol="v", **{knob: value},
                     **_stage_kw(spec, params))


def test_map_batches_rows_match_tpudl():
    """Order and count of output rows, ragged last batch, 1-D and 2-D
    outputs, through both executors with the same arithmetic."""
    x = np.arange(22 * 3, dtype=np.float32).reshape(22, 3)
    col = np.empty(22, dtype=object)
    col[:] = list(x)
    want = JaxFrame({"x": col}).map_batches(
        jax.jit(lambda t: (t * 2.0 + 1.0, t.sum(axis=1))), ["x"],
        ["y", "s"], batch_size=5)
    got = Frame({"x": col}).map_batches(
        lambda t: (t * 2.0 + 1.0, t.sum(dim=1)), ["x"], ["y", "s"],
        batch_size=5, device="cpu")
    assert got.columns == want.columns == ["x", "y", "s"]
    np.testing.assert_array_equal(np.stack(list(got["y"])),
                                  np.stack(list(want["y"])))
    np.testing.assert_array_equal(got["s"], np.asarray(want["s"]))
    assert got.select("s").columns == ["s"]
    assert got.drop("y").columns == ["x", "s"]
