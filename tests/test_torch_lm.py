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


@pytest.mark.parametrize("stage,method", [
    ("featurizer", "hidden"), ("classifier", "apply"),
    ("generator", "decode_step")])
def test_stages_switch_tf32_off_while_they_run(lm, monkeypatch, stage,
                                               method):
    """A caller may allow TF32 for f32 products (``allow_tf32``, or
    ``set_float32_matmul_precision("high")``, which sets it). tpudl
    computes the LM in f32, so each stage switches TF32 off for cuBLAS and
    cuDNN while its model runs and restores the caller's setting after."""
    _, params, _, spec = lm
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    original = getattr(TinyCausalLM, method)

    def spy(self, *args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return original(self, *args, **kwargs)

    monkeypatch.setattr(TinyCausalLM, method, spy)
    kw = dict(outputCol="y", **_stage_kw(spec, params))
    make = {"featurizer": lambda: LMFeaturizer(batchSize=4, **kw),
            "classifier": lambda: LMClassifier(classes=CLASSES, batchSize=4,
                                               **kw),
            "generator": lambda: LMGenerator(maxNew=2, **kw)}[stage]
    make().transform(Frame({"text": TEXTS}))
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


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


@pytest.mark.parametrize("knob", ["tp"])
def test_unported_executor_knobs_raise(lm, knob):
    """``tp`` (once refused, 'LM parallelism') is ported: without a mesh
    it raises tpudl's ValueError at transform, as tpudl's forward does
    (tests/test_torch_parallel_stages.py runs it over a mesh)."""
    _, params, _, spec = lm
    value = {"tp": True}[knob]
    stage = LMFeaturizer(outputCol="v", **{knob: value},
                         **_stage_kw(spec, params))
    with pytest.raises(ValueError, match="'model' axis"):
        stage.transform(Frame({"text": TEXTS[:2]}))


def test_generator_under_a_mesh_runs_on_its_first_entry(lm):
    """``mesh`` (once refused, 'Training, rest') without ``tp`` shards
    batches only; the generator, which runs no batches through the
    executor, decodes on the mesh's first entry as tpudl's does on its
    default device: the same completions."""
    from tpudl_torch import mesh as port_mesh

    _, params, _, spec = lm
    kw = _stage_kw(spec, params)
    kw.pop("device")
    texts = Frame({"text": TEXTS[:3]})
    got = LMGenerator(outputCol="gen", maxNew=5,
                      mesh=port_mesh.build_mesh(devices=["cpu"] * 2),
                      **kw).transform(texts)
    want = LMGenerator(outputCol="gen", maxNew=5, device="cpu",
                       **kw).transform(texts)
    assert list(got["gen"]) == list(want["gen"])


@pytest.mark.parametrize("knob", ["cacheDir", "deviceCache", "wireCodec"])
def test_data_layer_knobs_replay_bitwise(lm, tmp_path, knob):
    """The data layer's knobs (once refused, 'Data layer'): the
    featurizer's rows are the plain stage's bit for bit, twice, and a
    second transform under ``cacheDir`` or ``deviceCache`` tokenizes
    nothing."""
    from tpudl_torch.data import device_cache

    _, params, _, spec = lm
    device_cache.reset_device_cache()
    value = {"cacheDir": str(tmp_path), "deviceCache": True,
             "wireCodec": "tokens"}[knob]
    want = np.stack(list(LMFeaturizer(
        outputCol="v", batchSize=4, **_stage_kw(spec, params)).transform(
            Frame({"text": TEXTS}))["v"]))
    st = LMFeaturizer(outputCol="v", batchSize=4, **{knob: value},
                      **_stage_kw(spec, params))
    calls = metrics.counter("text.tokenize.calls").value
    for _ in range(2):
        got = np.stack(list(st.transform(Frame({"text": TEXTS}))["v"]))
        assert np.array_equal(got, want)
    made = metrics.counter("text.tokenize.calls").value - calls
    assert made == (2 if knob != "wireCodec" else 4)
    device_cache.reset_device_cache()


@pytest.mark.parametrize("stage", ["featurize", "classify"])
def test_executor_knobs_reach_map_batches_bitwise(lm, stage):
    """prefetchDepth, prepareWorkers, fuseSteps and dispatchDepth pass to
    the executor (its report shows them) and change no bit of the
    output; the stage builds its per-batch function once."""
    from tpudl_torch.obs import last_pipeline_report

    _, params, _, spec = lm
    texts = np.array(["abcdefg"[: 1 + i % 7] * 3 for i in range(10)],
                     dtype=object)
    cls, extra = ((LMFeaturizer, {}) if stage == "featurize" else
                  (LMClassifier, {"classes": CLASSES}))
    outs, configs = [], []
    for knobs in ({"fuseSteps": 1, "dispatchDepth": 1},
                  {"prefetchDepth": 3, "prepareWorkers": 2, "fuseSteps": 2,
                   "dispatchDepth": 3}):
        st = cls(outputCol="y", batchSize=2, **knobs, **extra,
                 **_stage_kw(spec, params))
        out = st.transform(Frame({"text": texts}))
        configs.append(last_pipeline_report())
        fn = st._fn_entry[1]
        st.transform(Frame({"text": texts[:4]}))
        assert st._fn_entry[1] is fn
        outs.append(np.stack(list(out["y"])) if stage == "featurize"
                    else list(out["y"]))
    assert configs[1]["fuse_steps"] == 2
    assert configs[1]["dispatch_depth"] == 3
    assert configs[1]["prefetch_depth"] == 3
    assert configs[1]["prepare_workers"] == 2
    # tokenize_pack is not marked thread-safe: one worker unless asked
    assert configs[0]["prepare_workers"] == 1
    assert configs[1]["stage_calls"].get("fused_dispatches", 0) >= 1
    if stage == "featurize":
        assert np.array_equal(outs[0], outs[1])
    else:
        assert outs[0] == outs[1]


@pytest.mark.parametrize("stage", ["featurize", "classify"])
def test_reload_frees_the_old_module(lm, stage):
    """New weights reload the module; the stage keeps one per-batch
    function, so the old function, and the module it closes over, go."""
    import gc
    import weakref

    _, params, _, spec = lm
    cls, extra = ((LMFeaturizer, {}) if stage == "featurize" else
                  (LMClassifier, {"classes": CLASSES}))
    st = cls(outputCol="y", batchSize=2, **extra, **_stage_kw(spec, params))
    frame = Frame({"text": np.array(["abc", "de", "f"], dtype=object)})
    want = list(st.transform(frame)["y"])
    old_net, old_fn = weakref.ref(st._loaded[2]), weakref.ref(
        st._fn_entry[1])
    st.weights = dict(params)  # the same values in a new pytree
    got = list(st.transform(frame)["y"])
    gc.collect()
    assert old_net() is None and old_fn() is None
    assert st._loaded[2] is not None and st._fn_entry[1] is not None
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


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
