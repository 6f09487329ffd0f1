"""The port's LM stages, text UDFs and serving registry under ``mesh=`` and
``tp=True`` against tpudl's.

tpudl runs on conftest's (4, 2) host mesh (the batch over 4 data
entries, heads and MLP over 2 model entries); the port runs on a local
``["cpu"] * 8`` mesh of the same shape, each data row tensor-parallel
over its two entries. Both read the same ``init(0)`` pytree at vocab 260,
dim 32, 2 heads (head_dim 16), 2 layers, and the same strings (byte
tokens, padded to 64 by the ``pow2`` ladder).

Tolerances: pooled features within 1e-4 of max |y|; labels, completions,
UDF rows and greedy serve streams equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import tpudl.serve as jserve
from tpudl.frame import Frame as JaxFrame
from tpudl.frame import sql as jax_sql
from tpudl.ml import LMClassifier as JaxClassifier
from tpudl.ml import LMFeaturizer as JaxFeaturizer
from tpudl.ml import LMGenerator as JaxGenerator
from tpudl.text import ByteTokenizer as JaxByteTokenizer
from tpudl.udf import registry as jax_registry
from tpudl.udf import register_text_udfs as jax_text_udfs
from tpudl.zoo.transformer import TinyCausalLM as JaxLM
import tpudl_torch.serve as tserve
from tpudl_torch import mesh as M
from tpudl_torch.frame import Frame, sql
from tpudl_torch.ml import LMClassifier, LMFeaturizer, LMGenerator
from tpudl_torch.text import ByteTokenizer
from tpudl_torch.udf import register_text_udfs, unregister_udf
from tpudl_torch.zoo.transformer import TinyCausalLM

torch.set_num_threads(1)

ARCH = dict(vocab=260, dim=32, heads=2, layers=2, max_len=64)
TOL = 1e-4   # of max |y|
TEXTS = np.array(["hello", "a much longer row of text here", "x",
                  "tpu to gpu", "short one", "the last, partial batch"],
                 dtype=object)
CLASSES = ["alpha", "beta", "gamma", "delta", "omega"]


@pytest.fixture(scope="module")
def lm():
    jlm = JaxLM(**ARCH)
    params = jlm.init(0)
    # a 50x embedding spreads the tied-head logits, so rows pick
    # different labels
    sharp = dict(params, embed={"table": params["embed"]["table"] * 50})
    return jlm, sharp, TinyCausalLM(device="meta", **ARCH)


@pytest.fixture(scope="module")
def mesh():
    return M.build_mesh(4, 2, devices=["cpu"] * 8)


def _stages(jlm, params, spec, jmesh, mesh):
    """(tpudl stage, port stage) pairs over the same weights, tp=True."""
    jw = jax.tree.map(jnp.asarray, params)
    common = dict(inputCol="text", batchSize=4, tp=True)
    return [
        (JaxFeaturizer(outputCol="out", model=jlm, weights=jw,
                       tokenizer=JaxByteTokenizer(), mesh=jmesh, **common),
         LMFeaturizer(outputCol="out", model=spec, weights=params,
                      tokenizer=ByteTokenizer(), mesh=mesh, device="cpu",
                      **common)),
        (JaxClassifier(outputCol="out", model=jlm, weights=jw,
                       tokenizer=JaxByteTokenizer(), classes=CLASSES,
                       mesh=jmesh, **common),
         LMClassifier(outputCol="out", model=spec, weights=params,
                      tokenizer=ByteTokenizer(), classes=CLASSES, mesh=mesh,
                      device="cpu", **common)),
        (JaxGenerator(outputCol="out", model=jlm, weights=params,
                      tokenizer=JaxByteTokenizer(), maxNew=6, mesh=jmesh,
                      **common),
         LMGenerator(outputCol="out", model=spec, weights=params,
                     tokenizer=ByteTokenizer(), maxNew=6, mesh=mesh,
                     device="cpu", **common))]


def test_lm_stages_under_tp_match_tpudl(lm, mesh4x2, mesh):
    jlm, params, spec = lm
    for jstage, stage in _stages(jlm, params, spec, mesh4x2, mesh):
        want = list(jstage.transform(JaxFrame({"text": TEXTS}))["out"])
        got = list(stage.transform(Frame({"text": TEXTS}))["out"])
        if isinstance(stage, LMFeaturizer):
            a, b = np.stack(got), np.stack(want)
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=TOL * float(np.abs(b).max()))
        else:
            assert got == want, type(stage).__name__
            assert len(set(got)) > 1


def test_text_udfs_under_tp_match_tpudl(lm, mesh4x2, mesh):
    jlm, params, spec = lm
    kw = dict(tokenizer=None, prefix="tp_", max_new=5, batch_size=4, tp=True)
    ours = register_text_udfs(model=spec, weights=params, mesh=mesh,
                              device="cpu",
                              **dict(kw, tokenizer=ByteTokenizer()))
    theirs = jax_text_udfs(model=jlm, weights=jax.tree.map(jnp.asarray,
                                                           params),
                           mesh=mesh4x2,
                           **dict(kw, tokenizer=JaxByteTokenizer()))
    queries = ("SELECT tp_embed(doc) AS v FROM docs",
               "SELECT tp_generate(doc) AS story FROM docs LIMIT 2")
    try:
        got = [sql(q, {"docs": Frame({"doc": TEXTS})}) for q in queries]
        want = [jax_sql(q, {"docs": JaxFrame({"doc": TEXTS})})
                for q in queries]
    finally:
        for u in ours:
            unregister_udf(u.name)
        for u in theirs:
            jax_registry.unregister_udf(u.name)
    a, b = np.stack(list(got[0]["v"])), np.stack(list(want[0]["v"]))
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=TOL * float(np.abs(b).max()))
    assert list(got[1]["story"]) == list(want[1]["story"])


def test_registry_tp_engine_streams_match_tpudl(lm, mesh4x2, mesh):
    """``ModelRegistry.add_model(tp=True)``: three greedy requests through
    each package's slot engine give the same streams."""
    jlm, params, spec = lm
    prompts = ([3, 5, 7, 9], [11, 2], [40, 41, 42, 43, 44, 45])
    streams = {}
    for side, serve in (("tpudl", jserve), ("port", tserve)):
        reg = serve.ModelRegistry()
        if side == "port":
            eng = reg.add_model("m", spec, params, slots=2, cache_len=32,
                                mesh=mesh, tp=True, device="cpu").engine
        else:
            eng = reg.add_model("m", jlm, jlm.shard_params(params, mesh4x2),
                                slots=2, cache_len=32, mesh=mesh4x2,
                                tp=True, warm=False).engine
        reqs = [serve.ServeRequest(p, 6) for p in prompts]
        pending, done = list(reqs), {}
        while pending or eng.active():
            while pending and eng.free():
                eng.insert(pending.pop(0))
            eng.step()
            done.update({id(r): t.tolist() for r, t in eng.pop_completed()})
        streams[side] = [done[id(r)] for r in reqs]
    assert streams["port"] == streams["tpudl"]
