"""The port's model UDFs held to tpudl's on the CPU, through each
package's ``sql`` on the same inputs: ``makeGraphUDF`` over configs[4]'s
MLP (frozen and trainable graphs, ``fetches``, ``feeds_to_fields_map``,
``register=False``), ``registerKerasImageUDF`` over ``bench.py``'s CNN
(with and without a ``preprocessor``), and ``register_text_udfs`` over a
2-layer ``TinyCausalLM``. The Keras models are the same keras-written
``.keras`` files in both packages; the LM's ``init(0)`` params go to
both (tpudl's stages take them as ``jnp`` arrays).

Tolerances: model outputs within 1e-5 of max |y| (f32 products in another
order; as the Keras stages' tests); the LM's pooled features within
2e-5 absolute (``test_torch_lm.py``'s), labels and completions exact."""

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_keras_models as M  # noqa: E402

from tpudl.frame import Frame as JaxFrame  # noqa: E402
from tpudl.frame import sql as jax_sql  # noqa: E402
from tpudl.image import imageIO as jax_imageIO  # noqa: E402
from tpudl.ingest import TFInputGraph as JaxTFInputGraph  # noqa: E402
from tpudl.text import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from tpudl.udf import makeGraphUDF as jax_makeGraphUDF  # noqa: E402
from tpudl.udf import register_text_udfs as jax_text_udfs  # noqa: E402
from tpudl.udf.keras_image_model import \
    registerKerasImageUDF as jax_keras_image_udf  # noqa: E402
from tpudl.zoo.transformer import TinyCausalLM as JaxLM  # noqa: E402
from tpudl_torch.frame import Frame, sql  # noqa: E402
from tpudl_torch.image import imageIO  # noqa: E402
from tpudl_torch.ingest import TFInputGraph  # noqa: E402
from tpudl_torch.obs import metrics  # noqa: E402
from tpudl_torch.text import ByteTokenizer  # noqa: E402
from tpudl_torch.udf import (get_udf, makeGraphUDF,  # noqa: E402
                             register_text_udfs, registerKerasImageUDF,
                             unregister_udf)
from tpudl_torch.zoo.transformer import TinyCausalLM  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-5
LM_TOL = 2e-5
ARCH = dict(vocab=260, dim=32, heads=4, layers=2, max_len=64)
TEXTS = np.array(["hello", "a much longer row of text here", "x",
                  "tpu to gpu", "short one", "the last, partial batch"],
                 dtype=object)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _stack(col):
    return np.stack([np.asarray(v) for v in col])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("udf")
    return {name: M.saved(name, d) for name in ("mlp", "cnn")}


@pytest.mark.parametrize("case", ["frozen", "trainable", "fetches",
                                  "fields", "unregistered"])
def test_make_graph_udf_matches_tpudl(files, case):
    x = np.random.default_rng(0).normal(size=(300, 100)).astype(np.float32)
    col = np.empty(len(x), dtype=object)
    col[:] = list(x)
    name = f"mlp_{case}"
    route = "fromKerasTrainable" if case == "trainable" else "fromKeras"
    ours_g = getattr(TFInputGraph, route)(files["mlp"])
    theirs_g = getattr(JaxTFInputGraph, route)(files["mlp"])
    kw = [{}, {}]
    if case == "fetches":
        kw = [dict(fetches=[g.output_names[0]]) for g in (ours_g, theirs_g)]
    if case == "fields":
        kw = [dict(feeds_to_fields_map={g.input_names[0]: "feat"})
              for g in (ours_g, theirs_g)]
    register = case != "unregistered"
    ours = makeGraphUDF(ours_g, name, register=register, batch_size=128,
                        device="cpu", **kw[0])
    theirs = jax_makeGraphUDF(theirs_g, name, register=register,
                              batch_size=128, **kw[1])
    assert ours.output_col == theirs.output_col == f"{name}_out"
    try:
        if case == "fields":
            assert ours.input_col == theirs.input_col == "feat"
        if register:
            assert get_udf(name) is ours
            q = f"SELECT {name}(v) AS y FROM t WHERE k < 250"
            k = np.arange(len(x))
            got = _stack(sql(q, {"t": Frame({"v": col, "k": k})})["y"])
            want = _stack(jax_sql(q, {"t": JaxFrame({"v": col, "k": k})})
                          ["y"])
            assert metrics.counter(f"udf.{name}.rows").value == 250
            assert metrics.counter(f"udf.{name}.calls").value == 1
        else:
            with pytest.raises(KeyError):
                get_udf(name)
            got = _stack(ours(Frame({ours.input_col: col}))[ours.output_col])
            want = _stack(theirs(JaxFrame({theirs.input_col: col}))
                          [theirs.output_col])
    finally:
        unregister_udf(name)
        from tpudl.udf import registry as jax_registry

        jax_registry.unregister_udf(name)
    assert got.shape == want.shape and got.shape[1] == 10
    assert _rel(got, want) <= RTOL


def test_make_graph_udf_refusals(files):
    g = TFInputGraph.fromKeras(files["mlp"])
    with pytest.raises(TypeError, match="wrap it"):
        makeGraphUDF(g, "bad", fetches="dense_2:0", device="cpu")
    with pytest.raises(TypeError, match="GraphFunction"):
        makeGraphUDF(lambda x: x, "bad", device="cpu")
    for knob, item in (("mesh", "Training, rest"),
                       ("cache_dir", "Data layer"),
                       ("device_cache", "Data layer"),
                       ("wire_codec", "Data layer")):
        value = "u8" if knob == "wire_codec" else object()
        with pytest.raises(NotImplementedError, match=item):
            makeGraphUDF(g, "bad", device="cpu", **{knob: value})
    with pytest.raises(RuntimeError, match="cuda"):   # default: the card
        makeGraphUDF(g, "on_card", register=False)(
            Frame({"input_layer": np.zeros((2, 100), np.float32)}))


def _structs(n, seed, module):
    rng = np.random.default_rng(seed)
    col = np.empty(n, dtype=object)
    col[:] = [module.imageArrayToStruct(
        rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)) for _ in range(n)]
    return col


@pytest.mark.parametrize("pre", [None, "scale"])
def test_register_keras_image_udf_matches_tpudl(files, pre):
    name = f"cnn_udf_{pre}"
    ours_pre = theirs_pre = None
    if pre == "scale":
        ours_pre = lambda x: x / 127.5 - 1.0         # noqa: E731
        theirs_pre = lambda x: x / 127.5 - 1.0       # noqa: E731
    ours = registerKerasImageUDF(name, files["cnn"], ours_pre,
                                 channel_order="BGR", batch_size=4,
                                 device="cpu")
    jax_keras_image_udf(name, files["cnn"], theirs_pre, channel_order="BGR",
                        batch_size=4)
    q = f"SELECT {name}(image) AS p FROM images LIMIT 7"
    try:
        got = _stack(sql(q, {"images": Frame(
            {"image": _structs(10, 0, imageIO)})})["p"])
        want = _stack(jax_sql(q, {"images": JaxFrame(
            {"image": _structs(10, 0, jax_imageIO)})})["p"])
    finally:
        unregister_udf(name)
        from tpudl.udf import registry as jax_registry

        jax_registry.unregister_udf(name)
    assert ours.input_col == "image" and got.shape == want.shape == (7, 2)
    assert _rel(got, want) <= RTOL
    assert metrics.counter(f"udf.{name}.rows").value == 7


@pytest.fixture(scope="module")
def lm():
    jlm = JaxLM(**ARCH)
    params = jlm.init(0)
    # a 50x embedding spreads the tied-head logits so rows pick different
    # labels (at init scale every row picks the same one)
    params = dict(params, embed={"table": params["embed"]["table"] * 50})
    return jlm, params, jax.tree.map(jnp.asarray, params), \
        TinyCausalLM(device="meta", **ARCH)


def test_text_udfs_match_tpudl(lm):
    jlm, params, jparams, spec = lm
    classes = ["alpha", "beta", "gamma", "delta", "omega"]
    ours = register_text_udfs(model=spec, weights=params,
                              tokenizer=ByteTokenizer(), classes=classes,
                              max_new=6, batch_size=4, prefix="tu_",
                              device="cpu")
    jax_text_udfs(model=jlm, weights=jparams, tokenizer=JaxByteTokenizer(),
                  classes=classes, max_new=6, batch_size=4, prefix="tu_")
    assert [u.name for u in ours] == ["tu_generate", "tu_embed",
                                      "tu_classify"]
    q = ("SELECT tu_embed(doc) AS v FROM docs",
         "SELECT tu_classify(doc) AS label FROM docs",
         "SELECT tu_generate(doc) AS story FROM docs LIMIT 4")
    try:
        got = [sql(s, {"docs": Frame({"doc": TEXTS})}) for s in q]
        want = [jax_sql(s, {"docs": JaxFrame({"doc": TEXTS})}) for s in q]
    finally:
        from tpudl.udf import registry as jax_registry

        for u in ours:
            unregister_udf(u.name)
            jax_registry.unregister_udf(u.name)
    a, b = _stack(got[0]["v"]), _stack(want[0]["v"])
    assert a.shape == (len(TEXTS), ARCH["dim"])
    np.testing.assert_allclose(a, b, rtol=LM_TOL, atol=LM_TOL)
    assert list(got[1]["label"]) == list(want[1]["label"])
    assert len(set(got[1]["label"])) > 1
    assert list(got[2]["story"]) == list(want[2]["story"])
    assert metrics.counter("udf.tu_generate.rows").value == 4
    assert metrics.counter("udf.tu_embed.calls").value == 1


def test_text_udfs_unregistered_and_refusals(lm):
    _jlm, params, _jp, spec = lm
    udfs = register_text_udfs(model=spec, weights=params,
                              tokenizer=ByteTokenizer(), prefix="tr_",
                              register=False, device="cpu")
    assert [u.name for u in udfs] == ["tr_generate", "tr_embed"]
    with pytest.raises(KeyError):
        get_udf("tr_embed")
    out = udfs[1](Frame({"text": TEXTS[:2]}))
    assert np.stack(list(out["tr_embed_out"])).shape == (2, ARCH["dim"])
    with pytest.raises(NotImplementedError, match="LM parallelism"):
        register_text_udfs(model=spec, weights=params,
                           tokenizer=ByteTokenizer(), tp=True,
                           register=False, device="cpu")
