"""The LM paths through the program store, on the CPU, at small width:
``generate(prompt_buckets=)`` armed against tpudl's bucketed ``generate``
and the port's eager run on the same ``init(seed)`` params, one program a
rung, a fresh store's restore through the model's rebuild,
``precompile_generate`` / ``precompile_serve`` armed and unarmed beside
tpudl's, invalidation by ``shard_params`` and ``.to()``, sampled calls
staying eager, and the stages, the serve registry and ``RungBatcher``
through the store."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpudl.compile import store as jstore
from tpudl.zoo.transformer import TinyCausalLM as JaxLM

from tpudl_torch import mesh as M
from tpudl_torch.compile import store as cstore
from tpudl_torch.obs import metrics as tmetrics
from tpudl_torch.zoo.transformer import TinyCausalLM

ARCH = dict(vocab=64, dim=32, heads=4, layers=2, max_len=128)
RAGGED = (9, 10, 11, 13, 14, 16)      # one pow2 rung: 16


@pytest.fixture(autouse=True)
def arm(tmp_path, monkeypatch):
    """``arm(True)`` / ``arm(False)``: the store knob, armed at start."""
    def set_(on):
        monkeypatch.setenv("TPUDL_COMPILE_AOT",
                           str(tmp_path / "programs") if on else "0")
    set_(True)
    cstore.reset_program_store()
    jstore.reset_program_store()
    yield set_
    cstore.reset_program_store()
    jstore.reset_program_store()


@pytest.fixture(scope="module")
def params():
    return JaxLM(**ARCH).init(0)


def _lm(params):
    return TinyCausalLM.from_jax_params(params, device="cpu", **ARCH)


def _count(name):
    return tmetrics.counter(name).value


def _prompt(plen, b=2, seed=0):
    return np.random.default_rng(seed + plen).integers(
        1, ARCH["vocab"], size=(b, plen)).astype(np.int32)


def test_bucketed_generate_equals_tpudl_and_eager_one_program(params, arm):
    jlm = JaxLM(**ARCH)
    lm = _lm(params)
    arm(False)
    eager = [lm.generate(_prompt(n), 8, prompt_buckets="pow2").numpy()
             for n in RAGGED]
    want = [np.asarray(jlm.generate(params, _prompt(n), 8,
                                    prompt_buckets="pow2")) for n in RAGGED]
    arm(True)
    h0, m0 = _count("compile.hits"), _count("compile.misses")
    got = [lm.generate(_prompt(n), 8, prompt_buckets="pow2").numpy()
           for n in RAGGED]
    for g, e, w in zip(got, eager, want):
        np.testing.assert_array_equal(g, e)
        np.testing.assert_array_equal(g, w)
    # the six ragged lengths share ONE padded-16 program
    assert cstore.get_program_store().programs() == 1
    assert (_count("compile.misses") - m0, _count("compile.hits") - h0) == \
        (1, len(RAGGED) - 1)
    (entry,) = cstore.get_program_store().entries().values()
    assert entry["leaves"][0][:2] == [[2, 16], "int32"]
    assert entry["program"] == {"owner": lm.aot_token, "kind": "generate",
                                "batch": 2, "padded": 16, "max_new": 8}


def test_precompile_then_a_fresh_store_restores(params):
    lm = _lm(params)
    assert lm.precompile_generate(2, 13, 8, prompt_buckets="pow2") is True
    h0, m0 = _count("compile.hits"), _count("compile.misses")
    out = lm.generate(_prompt(13), 8, prompt_buckets="pow2").numpy()
    assert (_count("compile.hits") - h0, _count("compile.misses")) == (1, m0)
    # a new process: a new store and a new model of the same architecture
    cstore.reset_program_store()
    lm2 = _lm(params)
    r0 = _count("compile.programs_restored")
    assert cstore.warm_start(block=True) == 1   # lm2 rebuilds its graph
    assert _count("compile.programs_restored") - r0 == 1
    h1 = _count("compile.hits")
    np.testing.assert_array_equal(
        lm2.generate(_prompt(13), 8, prompt_buckets="pow2").numpy(), out)
    assert _count("compile.hits") - h1 == 1


def test_precompile_returns_as_tpudls(params, arm):
    """Unarmed both return False / 0. Armed, ``precompile_generate`` is
    True in both; ``precompile_serve`` counts what it made ready: tpudl's
    one step program and one prefill program a rung (2 for one rung), the
    port's step, prefill and insert graphs (one batch-1 prefill serves
    every length)."""
    jlm, lm = JaxLM(**ARCH), _lm(params)
    jparams = jax.tree.map(jnp.asarray, params)
    arm(False)
    assert lm.precompile_generate(1, 4, 2) is jlm.precompile_generate(
        jparams, 1, 4, 2) is False
    assert lm.precompile_serve(slots=2, cache_len=32, prompt_rungs=[8]) == \
        jlm.precompile_serve(jparams, slots=2, cache_len=32,
                             prompt_rungs=[8]) == 0
    arm(True)
    assert lm.precompile_generate(1, 4, 2) is True
    assert jlm.precompile_generate(jparams, 1, 4, 2) is True
    assert jlm.precompile_serve(jparams, slots=2, cache_len=32,
                                prompt_rungs=[8]) == 2
    assert lm.precompile_serve(slots=2, cache_len=32, prompt_rungs=[8]) == 3
    with pytest.raises(NotImplementedError, match="'Compile'"):
        lm.precompile_generate(1, 4, 2, temperature=0.7)


@pytest.mark.parametrize("how", ["shard_params", "to"])
def test_replacing_parameters_drops_the_modules_graphs(params, how):
    lm = _lm(params)
    want = lm.generate(_prompt(5), 4).numpy()
    store = cstore.get_program_store()
    assert store.programs() == 1
    if how == "shard_params":
        lm.shard_params(M.build_mesh(1, 2, devices=["cpu"] * 2))
    else:
        lm.to(torch.float32)
    assert store.programs() == 0 and lm._gen_fns == {}
    np.testing.assert_array_equal(lm.generate(_prompt(5), 4).numpy(), want)


def test_other_weights_never_replay_a_graph(params):
    """Two modules of one architecture share a manifest entry, never a
    graph: each replays its own."""
    other = JaxLM(**ARCH).init(1)
    a, b = _lm(params), _lm(other)
    want_b = b.generate(_prompt(7), 6).numpy()
    a.generate(_prompt(7), 6)
    got_b = b.generate(_prompt(7), 6).numpy()
    np.testing.assert_array_equal(got_b, want_b)
    store = cstore.get_program_store()
    assert store.programs() == 2 and len(store.entries()) == 1


def test_sampled_generate_stays_eager_and_counts_a_miss(params, arm):
    lm = _lm(params)

    def run():
        gen = torch.Generator().manual_seed(5)
        return lm.generate(_prompt(6), 5, temperature=0.8,
                           generator=gen).numpy()

    m0 = _count("compile.misses")
    got = run()
    assert _count("compile.misses") == m0 + 1
    assert cstore.get_program_store().programs() == 0
    arm(False)
    np.testing.assert_array_equal(got, run())


def test_stages_through_the_store_equal_unarmed(arm):
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import LMFeaturizer, LMGenerator
    from tpudl_torch.obs.pipeline import last_pipeline_report
    from tpudl_torch.text import ByteTokenizer

    arch = dict(ARCH, vocab=260)   # the byte tokenizer's
    spec = TinyCausalLM(device="meta", **arch)
    frame = Frame({"t": np.array(["one", "a longer row", "mid", "x" * 20,
                                  "last row"], dtype=object)})
    kw = dict(inputCol="t", model=spec, weights=spec.init(0),
              tokenizer=ByteTokenizer(), device="cpu")

    def run():
        f = np.stack(list(LMFeaturizer(outputCol="v", batchSize=2, **kw)
                          .transform(frame)["v"]))
        rep = last_pipeline_report()
        g = list(LMGenerator(outputCol="g", maxNew=4, **kw)
                 .transform(frame)["g"])
        return f, g, rep

    armed = run()
    assert armed[2]["aot"] is True
    calls = armed[2]["stage_calls"]
    assert calls.get("aot_hits", 0) + calls["aot_misses"] == calls["dispatch"]
    # a new stage over the same weights: its function is new, its
    # manifest entries are not, so run setup captures them and all hit
    again = run()
    assert again[2]["stage_calls"]["aot_hits"] == calls["dispatch"]
    assert "aot_misses" not in again[2]["stage_calls"]
    arm(False)
    plain = run()
    assert plain[2]["aot"] is False
    for got in (armed, again):
        np.testing.assert_array_equal(got[0], plain[0])
        assert got[1] == plain[1]


def test_registry_and_rung_batcher_through_the_store(params):
    from tpudl_torch.serve import ModelRegistry, RungBatcher
    from tpudl_torch.serve.queue import ServeRequest

    lm = _lm(params)
    entry = ModelRegistry().add_model("m", lm, slots=2, cache_len=32,
                                      prompt_rungs=[8], warm=True)
    assert entry.warm_signatures == 3
    store = cstore.get_program_store()
    assert sum(e["bound"] for e in store.entries().values()) == 3
    eng = entry.engine
    prompt = _prompt(6, b=1)
    h0, m0 = _count("compile.hits"), _count("compile.misses")
    eng.insert(ServeRequest(prompt, max_new=5))
    done = []
    while not done:
        eng.step()
        done = eng.pop_completed()
    # 6 prefill steps, the insert and 4 decode steps: all readied
    assert (_count("compile.hits") - h0, _count("compile.misses")) == (11, m0)
    np.testing.assert_array_equal(done[0][1], lm.generate(prompt, 5)[0])

    def embed(tokens):
        return lm.hidden(torch.as_tensor(tokens)).mean(dim=1)

    rows = [np.random.default_rng(i).integers(1, 64, (n, 8)).astype(np.int64)
            for i, n in enumerate((1, 2, 3))]
    with torch.inference_mode():
        plain = RungBatcher(embed).run(rows)
        m0 = _count("compile.misses")
        got = RungBatcher(embed, device="cpu").run(rows)
        again = RungBatcher(embed, device="cpu").run(rows)
    assert _count("compile.misses") == m0 + 1
    for a, b, c in zip(plain, got, again):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
