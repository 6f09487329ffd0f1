"""The LM half of ``tpudl_torch.serve`` against ``tpudl.serve``: the slot
decode step, the slot decoder's verbs, the server loop through churn, the
registry's warm-up and ``add_generator``, and sampled slots.

tpudl's own test size: ``TinyCausalLM(vocab=64, dim=32, heads=4,
layers=2, max_len=64)``, ``cache_len=32``, the same numpy ``init(0)``
params in both packages (``jnp`` arrays on tpudl's side). Tolerances:
``decode_step_slots`` logits within 1e-5 of max |logit| (f32 through two
layers, the frameworks sum in other orders); greedy token streams equal,
to tpudl's slots and to the port's serial batch-1 ``generate``. Each
paired scenario runs through both packages and holds the typed errors,
the tokens and the ``serve.*`` counter deltas equal. Every wait is
bounded."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import tpudl.serve as jserve
from tpudl.obs import metrics as jmetrics
from tpudl.zoo.transformer import TinyCausalLM as JaxLM

import tpudl_torch.serve as tserve
from tpudl_torch.obs import metrics as tmetrics
from tpudl_torch.zoo.transformer import TinyCausalLM

torch.set_num_threads(1)

ARCH = dict(vocab=64, dim=32, heads=4, layers=2, max_len=64)
CACHE_LEN = 32
LOGIT_RTOL = 1e-5
COUNTERS = ("serve.requests", "serve.rejects", "serve.deadline_sheds",
            "serve.inserts", "serve.steps", "serve.tokens",
            "serve.evictions", "serve.completed")


@pytest.fixture(scope="module")
def lm():
    """(tpudl's model, its jnp params, the numpy params, the port's spec,
    the port's module on the CPU)."""
    jlm = JaxLM(**ARCH)
    params = jlm.init(0)
    spec = TinyCausalLM(device="meta", **ARCH)
    tlm = TinyCausalLM.from_jax_params(params, device="cpu", **ARCH)
    return jlm, jax.tree.map(jnp.asarray, params), params, spec, tlm


def _prompt(rng, n):
    return rng.integers(1, 64, size=n).astype(np.int32)


def _serial(tlm, prompt, max_new, **kw):
    return tlm.generate(np.asarray(prompt)[None, :], max_new,
                        **kw).numpy()[0]


class Side:
    """One package's serve module, metrics and ``add_model`` call."""

    def __init__(self, name, lm):
        jlm, jparams, _, spec, _ = lm
        self.name = name
        self.serve, self.metrics = ((jserve, jmetrics) if name == "tpudl"
                                    else (tserve, tmetrics))
        self._model = (jlm, jparams) if name == "tpudl" else (spec, lm[2])

    def add(self, reg, name="default", **kw):
        kw.setdefault("cache_len", CACHE_LEN)
        kw.setdefault("warm", False)
        if self.name == "port":
            kw["device"] = "cpu"
        return reg.add_model(name, *self._model, **kw)

    def engine(self, slots, **kw):
        return self.add(self.serve.ModelRegistry(), "m", slots=slots,
                        **kw).engine

    def counts(self):
        return {n: self.metrics.counter(n).value for n in COUNTERS}


def _paired(lm, scenario):
    """``scenario(side)`` through both packages; the outcomes and counter
    deltas must be equal. Returns the port's outcome."""
    out = {}
    for name in ("tpudl", "port"):
        side = Side(name, lm)
        before = side.counts()
        got = scenario(side)
        after = side.counts()
        out[name] = (got, {n: after[n] - before[n] for n in COUNTERS
                           if after[n] != before[n]})
    assert out["port"] == out["tpudl"]
    return out["port"]


# ---------------------------------------------------------------------------
# the slot decode step
# ---------------------------------------------------------------------------

def test_decode_step_slots_matches_tpudl_at_mixed_positions(lm):
    """Four slots at positions 0, 5, 17 and 31 over a cache of random
    history: logits within 1e-5 of max |logit| for two steps, and the
    caches the steps wrote."""
    jlm, jparams, _, _, tlm = lm
    rng = np.random.default_rng(0)
    s, dh = 4, ARCH["dim"] // ARCH["heads"]
    hist = [{kv: rng.normal(size=(s, CACHE_LEN, ARCH["heads"], dh)).astype(
        np.float32) for kv in ("k", "v")} for _ in range(ARCH["layers"])]
    jcache = [{kv: jnp.asarray(h[kv]) for kv in h} for h in hist]
    tcache = [{kv: torch.from_numpy(h[kv].copy()) for kv in h}
              for h in hist]
    pos = np.array([0, 5, 17, 30], np.int32)
    tok = _prompt(rng, s)
    for step in range(2):
        want, jcache = jlm.decode_step_slots(
            jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
        with torch.inference_mode():
            got, tcache = tlm.decode_step_slots(
                torch.from_numpy(tok).long(), tcache,
                torch.from_numpy(pos).long())
        want = np.asarray(want)
        assert got.shape == want.shape == (s, ARCH["vocab"])
        err = float(np.abs(got.numpy() - want).max())
        assert err <= LOGIT_RTOL * float(np.abs(want).max()), (step, err)
        assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))
        tok, pos = want.argmax(-1).astype(np.int32), pos + 1
    for jl, tl in zip(jcache, tcache):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tl[kv].numpy(), np.asarray(jl[kv]),
                                       rtol=0, atol=2e-5)


def test_a_slot_decodes_as_a_batch_one_step(lm):
    """A slot's logits are those of ``decode_step`` on its row alone at
    the same position: the neighbours at other depths do not leak in."""
    *_, tlm = lm
    rng = np.random.default_rng(1)
    with torch.inference_mode():
        cache = tlm.init_cache(3, CACHE_LEN)
        for layer in cache:
            for kv in ("k", "v"):
                layer[kv].copy_(torch.from_numpy(rng.normal(
                    size=layer[kv].shape).astype(np.float32)))
        row = [{kv: layer[kv][1:2].clone() for kv in layer}
               for layer in cache]
        tok = torch.tensor([3, 9, 27])
        got, _ = tlm.decode_step_slots(tok, cache, torch.tensor([2, 11, 20]))
        one, _ = tlm.decode_step(tok[1:2], row, 11)
    torch.testing.assert_close(got[1:2], one, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the slot decoder's verbs, paired with tpudl's
# ---------------------------------------------------------------------------

def _all_slots_full(side):
    eng = side.engine(2)
    rng = np.random.default_rng(0)
    slots = [eng.insert(side.serve.ServeRequest(_prompt(rng, 3 + i), 4))
             for i in range(2)]
    with pytest.raises(side.serve.AdmissionError) as ei:
        eng.insert(side.serve.ServeRequest(_prompt(rng, 5), 4))
    return {"slots": slots, "reason": ei.value.reason,
            "occupancy": eng.occupancy()}


def _evict_while_decoding(side):
    eng = side.engine(2)
    rng = np.random.default_rng(1)
    keep = side.serve.ServeRequest(_prompt(rng, 5), 6)
    drop = side.serve.ServeRequest(_prompt(rng, 7), 6)
    eng.insert(keep)
    s_drop = eng.insert(drop)
    eng.step()
    eng.evict(s_drop, side.serve.Evicted("request cancelled mid-decode"))
    with pytest.raises(side.serve.Evicted):
        drop.result(timeout=0.5)
    free = eng.free()
    while not (done := eng.pop_completed()):
        eng.step()
    ((req, toks),) = done
    return {"free": free, "keep": req is keep, "tokens": toks.tolist(),
            "prompt": keep.prompt[0].tolist()}


def _slot_reuse(side):
    eng = side.engine(1)
    rng = np.random.default_rng(2)
    out = []
    for plen in (9, 4, 13):          # three occupants of the one slot
        req = side.serve.ServeRequest(_prompt(rng, plen), 5)
        eng.insert(req)
        while not (done := eng.pop_completed()):
            eng.step()
        ((_, toks),) = done
        out.append((req.prompt[0].tolist(), toks.tolist()))
    return out


def _cancel(side):
    eng = side.engine(2)
    req = side.serve.ServeRequest(_prompt(np.random.default_rng(7), 4), 8)
    eng.insert(req)
    first = eng.cancel(req)
    again = eng.cancel(req)
    with pytest.raises(side.serve.Evicted, match="cancelled"):
        req.result(timeout=0.5)
    with pytest.raises(KeyError, match="not occupied"):
        eng.evict(0)
    return {"first": first, "again": again}


def _rung_overflow(side):
    eng = side.engine(1)
    with pytest.raises(ValueError, match="exceeds the") as ei:
        eng.rung_for(30, 8)
    return {"msg": str(ei.value), "rungs": [eng.rung_for(n, 4)
                                            for n in (3, 5, 9, 17, 27)]}


@pytest.mark.parametrize("scenario", [_all_slots_full, _evict_while_decoding,
                                      _slot_reuse, _cancel, _rung_overflow],
                         ids=lambda f: f.__name__.strip("_"))
def test_slot_decoder_scenario_matches_tpudl(lm, scenario):
    _paired(lm, scenario)


def test_all_slots_full_is_a_typed_reject(lm):
    out, deltas = _paired(lm, _all_slots_full)
    assert out == {"slots": [0, 1], "reason": "slots_full",
                   "occupancy": 1.0}
    assert deltas == {"serve.inserts": 2}


def test_evicted_neighbour_leaves_the_stream_equal_to_serial(lm):
    *_, tlm = lm
    out, deltas = _paired(lm, _evict_while_decoding)
    assert out["free"] == [1] and out["keep"]
    assert out["tokens"] == _serial(tlm, out["prompt"], 6).tolist()
    assert deltas["serve.evictions"] == 1


def test_reused_slot_streams_equal_serial_generate(lm):
    *_, tlm = lm
    out, _ = _paired(lm, _slot_reuse)
    for prompt, toks in out:
        assert toks == _serial(tlm, prompt, 5).tolist()


# ---------------------------------------------------------------------------
# the server loop
# ---------------------------------------------------------------------------

def _drain(srv):
    """Deterministic synchronous drain of everything queued."""
    srv._stop.set()
    try:
        return srv.run()
    finally:
        srv._stop.clear()


def _ragged_churn(side):
    """8 ragged prompts through 2 slots: at least 3 insert/complete
    cycles a slot."""
    reg = side.serve.ModelRegistry()
    side.add(reg, slots=2)
    srv = side.serve.Server(reg, side.serve.RequestQueue(cap=16))
    rng = np.random.default_rng(3)
    reqs = [srv.submit(_prompt(rng, n), 6)
            for n in (3, 5, 7, 11, 2, 9, 13, 4)]
    summary = _drain(srv)
    assert all(r.ttft_s is not None and r.latency_s is not None
               for r in reqs)
    return {"summary": {k: summary[k] for k in ("completed", "admitted",
                                                  "models")},
            "streams": [(r.prompt[0].tolist(),
                         r.result(timeout=1).tolist()) for r in reqs]}


def _deadline_mid_decode(side):
    """The doomed request is admitted beside its peer on tick 1; a slow
    first step ages it past its deadline, and the sweep of tick 2 evicts
    it typed. tpudl delays its ``serve.dispatch`` fault point at tick 2;
    the port has no fault points yet, so its engine's first step sleeps."""
    from tpudl.testing import faults

    reg = side.serve.ModelRegistry()
    eng = side.add(reg, slots=2).engine
    srv = side.serve.Server(reg, side.serve.RequestQueue(cap=16))
    rng = np.random.default_rng(4)
    doomed = srv.submit(_prompt(rng, 5), 20, deadline_s=0.25)
    ok = srv.submit(_prompt(rng, 8), 20)
    if side.name == "tpudl":
        faults.arm(faults.FaultPlan([{
            "point": "serve.dispatch", "action": "delay", "seconds": 0.4,
            "at_call": 2}]))
    else:
        step, calls = eng.step, []

        def slow_first_step():
            calls.append(1)
            if len(calls) == 1:
                import time
                time.sleep(0.4)
            return step()

        eng.step = slow_first_step
    try:
        _drain(srv)
    finally:
        faults.disarm()
    with pytest.raises(side.serve.DeadlineExceeded, match="mid-decode"):
        doomed.result(timeout=1)
    return {"doomed_tokens": doomed.tokens,
            "ok": (ok.prompt[0].tolist(), ok.result(timeout=1).tolist())}


@pytest.mark.parametrize("scenario", [_ragged_churn, _deadline_mid_decode],
                         ids=lambda f: f.__name__.strip("_"))
def test_server_scenario_matches_tpudl(lm, scenario):
    _paired(lm, scenario)


def test_ragged_churn_streams_equal_serial_generate(lm):
    *_, tlm = lm
    out, deltas = _paired(lm, _ragged_churn)
    assert out["summary"]["completed"] == 8
    for prompt, toks in out["streams"]:
        assert toks == _serial(tlm, prompt, 6).tolist()
    assert deltas == {"serve.requests": 8, "serve.inserts": 8,
                      "serve.completed": 8,
                      "serve.steps": deltas["serve.steps"],
                      "serve.tokens": 8 * 5}


def test_deadline_shed_mid_decode_spares_the_peer(lm):
    *_, tlm = lm
    out, deltas = _paired(lm, _deadline_mid_decode)
    assert out["doomed_tokens"] is None
    prompt, toks = out["ok"]
    assert toks == _serial(tlm, prompt, 20).tolist()
    assert deltas["serve.deadline_sheds"] == 1
    assert deltas["serve.evictions"] == 1


def test_unknown_model_is_an_immediate_key_error(lm):
    for name in ("tpudl", "port"):
        side = Side(name, lm)
        reg = side.serve.ModelRegistry()
        side.add(reg, slots=1)
        with pytest.raises(KeyError, match="nope"):
            side.serve.Server(reg).submit([1, 2], 4, model="nope")


def test_threaded_lifecycle_and_close(lm):
    *_, tlm = lm
    side = Side("port", lm)
    reg = side.serve.ModelRegistry()
    side.add(reg, slots=2)
    srv = side.serve.Server(reg).start_async()
    rng = np.random.default_rng(5)
    reqs = [srv.submit(_prompt(rng, n), 4) for n in (3, 6, 10)]
    outs = [r.result(timeout=60) for r in reqs]
    summary = srv.close(timeout=60)
    assert summary["completed"] >= len(reqs)
    assert srv._thread is None
    for req, out in zip(reqs, outs):
        assert out.tolist() == _serial(tlm, req.prompt[0], 4).tolist()


def test_a_dead_loop_fails_every_pending_request_typed(lm):
    side = Side("port", lm)
    reg = side.serve.ModelRegistry()
    eng = side.add(reg, slots=1).engine

    def broken():
        raise RuntimeError("device lost")

    eng.step = broken
    srv = side.serve.Server(reg).start_async()
    reqs = [srv.submit([1, 2, 3], 4), srv.submit([4, 5], 4)]
    for req in reqs:
        with pytest.raises(RuntimeError, match="device lost"):
            req.result(timeout=30)
    with pytest.raises(RuntimeError, match="device lost"):
        srv.close(timeout=30)


# ---------------------------------------------------------------------------
# warm-up, churn, the registry's generator route, sampling
# ---------------------------------------------------------------------------

def test_warm_registration_builds_every_program(lm):
    _, _, params, spec, tlm = lm
    reg = tserve.ModelRegistry()
    entry = reg.add_model("warmed", spec, params, slots=2,
                          cache_len=CACHE_LEN, device="cpu")
    assert entry.warm_signatures == 3 and entry.warm_s > 0
    assert entry.model is spec and entry.params is params
    assert sorted(k[0] for k in entry.engine.programs) == [
        "slot_insert", "slot_prefill", "slot_step"]
    srv = tserve.Server(reg, tserve.RequestQueue(cap=8))
    req = srv.submit(_prompt(np.random.default_rng(6), 5), 4,
                     model="warmed")
    _drain(srv)
    assert req.result(timeout=1).tolist() == _serial(
        tlm, req.prompt[0], 4).tolist()
    assert entry.engine.captures == 0      # no graphs on the CPU


def test_warm_with_every_slot_occupied_leaves_the_insert_to_later(lm):
    """``warm()`` while every slot is occupied readies the step and
    prefill programs only: the insert program's warm-up would write the
    row cache into a slot, which must be a free one. The next insert
    builds it, and every stream still equals the serial ``generate``."""
    _, _, params, spec, tlm = lm
    eng = tserve.ModelRegistry().add_model(
        "cold", spec, params, slots=2, cache_len=CACHE_LEN, warm=False,
        device="cpu").engine
    rng = np.random.default_rng(11)
    reqs = [tserve.ServeRequest(_prompt(rng, n), 5) for n in (4, 9, 6)]
    for req in reqs[:2]:
        eng.insert(req)              # builds the prefill and insert programs
    del eng.programs[eng._key("insert")]   # as if the insert were cold
    assert eng.warm() == 1           # the step program only
    assert sorted(k[0] for k in eng.programs) == ["slot_prefill",
                                                  "slot_step"]
    done = {}
    while len(done) < 3:
        eng.step()
        for req, toks in eng.pop_completed():
            done[id(req)] = toks.tolist()
        if eng.free() and len(eng.active()) + len(done) < 3:
            eng.insert(reqs[2])
    assert len(eng.programs) == 3
    for req in reqs:
        assert done[id(req)] == _serial(tlm, req.prompt[0], 5).tolist()


def test_churn_builds_no_program_after_warmup(lm):
    """The counterpart of tpudl's zero-retrace pin: 6 ragged prompt
    lengths through 2 slots, 3 insert/complete cycles a slot, after a
    warm drain of the same mix: the engine's program table does not grow
    and the tokens equal the warm drain's and tpudl's slots'."""
    jlm, jparams, params, spec, _ = lm
    plens = [3, 5, 7, 11, 14, 18]

    def prompts():
        rng = np.random.default_rng(0)
        return [_prompt(rng, n) for n in plens]

    def run(serve, reg):
        srv = serve.Server(reg, serve.RequestQueue(cap=32))
        reqs = [srv.submit(p, 6) for p in prompts()]
        _drain(srv)
        return [r.result(timeout=1).tolist() for r in reqs]

    reg = tserve.ModelRegistry()
    eng = reg.add_model("default", spec, params, slots=2,
                        cache_len=CACHE_LEN, device="cpu").engine
    warm = run(tserve, reg)
    table, captures = dict(eng.programs), eng.captures
    steady = run(tserve, reg)
    assert eng.programs == table and eng.captures == captures
    jreg = jserve.ModelRegistry()
    jreg.add_model("default", jlm, jparams, slots=2, cache_len=CACHE_LEN,
                   warm=False)
    assert steady == warm == run(jserve, jreg)


def test_add_generator_files_the_tokenizer_like_tpudl(lm):
    """tpudl's ``TestServeRegistration`` case with the port's
    ``LMGenerator``; the entry then serves the generator's model."""
    from tpudl.ml import LMGenerator as JaxGenerator
    from tpudl.text import ByteTokenizer as JaxTokenizer

    from tpudl_torch.ml import LMGenerator
    from tpudl_torch.text import ByteTokenizer

    arch = dict(ARCH, vocab=260)
    jlm = JaxLM(**arch)
    w = jlm.init(0)
    spec = TinyCausalLM(device="meta", **arch)
    tok, jtok = ByteTokenizer(), JaxTokenizer()
    gen = LMGenerator(inputCol="text", outputCol="gen", model=spec,
                      weights=w, tokenizer=tok, maxNew=4, device="cpu")
    reg = tserve.ModelRegistry()
    entry = reg.add_generator("story", gen, slots=2, cache_len=32,
                              warm=False)
    assert entry.tokenizer is tok and entry.model is spec
    assert reg.get("story") is entry
    assert entry.engine.temperature == 0.0
    with pytest.raises(ValueError, match="fully-bound"):
        reg.add_generator("bad", LMGenerator(inputCol="text",
                                             outputCol="gen"))
    jreg = jserve.ModelRegistry()
    jentry = jreg.add_generator("story", JaxGenerator(
        inputCol="text", outputCol="gen", model=jlm,
        weights=jax.tree.map(jnp.asarray, w), tokenizer=jtok, maxNew=4),
        slots=2, cache_len=32, warm=False)
    assert jentry.tokenizer is jtok and jentry.model is jlm
    prompt = tok.encode("abc", bos=True)
    outs = []
    for serve, r in ((tserve, reg), (jserve, jreg)):
        srv = serve.Server(r)
        req = srv.submit(prompt, 4, model="story")
        _drain(srv)
        outs.append(req.result(timeout=1).tolist())
    assert outs[0] == outs[1]


def test_sampled_slots_follow_their_generators(lm):
    """``temperature > 0``: each slot draws from its own generator, seeded
    from its request's ``rng``, in ``generate(generator=)``'s order — two
    slots decoding side by side equal two serial calls."""
    _, _, params, spec, tlm = lm
    reg = tserve.ModelRegistry()
    reg.add_model("s", spec, params, slots=2, cache_len=CACHE_LEN,
                  temperature=0.8, warm=False, device="cpu")
    srv = tserve.Server(reg)
    rng = np.random.default_rng(8)
    given = torch.Generator()
    given.manual_seed(12)
    reqs = [srv.submit(_prompt(rng, 4), 8, model="s", rng=11),
            srv.submit(_prompt(rng, 9), 8, model="s", rng=given),
            srv.submit(_prompt(rng, 2), 8, model="s")]
    _drain(srv)
    for req, seed in zip(reqs, (11, 12, 0)):
        g = torch.Generator()
        g.manual_seed(seed)
        want = _serial(tlm, req.prompt[0], 8, temperature=0.8, generator=g)
        assert req.result(timeout=1).tolist() == want.tolist()
    with pytest.raises(TypeError, match="int seed or a torch.Generator"):
        reg.get("s").engine._generator(jax.random.PRNGKey(0))
