"""The host half of ``tpudl_torch.serve`` against ``tpudl.serve``: the
admission queue, the rung batcher (also over the LM embed function, which
runs the flash forward), the registry's lookups, the closed-loop load
generator, the serve branch of ``PipelineReport.finish`` and the refusals.

Each paired case runs one scenario through both packages on the same
inputs and holds the outcomes equal: the typed errors and their
``reason``s, the outputs, and the deltas of the ``serve.*`` counters. The
slot decoder and the server are held in ``test_torch_serve_slots.py``.
Every wait is bounded, so a fault fails a test instead of hanging it."""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import tpudl.serve as jserve
from tpudl.obs import metrics as jmetrics
from tpudl.zoo.transformer import TinyCausalLM as JaxLM

import tpudl_torch.serve as tserve
from tpudl_torch import mesh as M
from tpudl_torch.obs import metrics as tmetrics
from tpudl_torch.obs import pipeline as tpipeline
from tpudl_torch.zoo.transformer import TinyCausalLM

torch.set_num_threads(1)

ARCH = dict(vocab=64, dim=32, heads=4, layers=2, max_len=64)
COUNTERS = ("serve.requests", "serve.rejects", "serve.deadline_sheds",
            "serve.inserts", "serve.steps", "serve.tokens",
            "serve.evictions", "serve.completed", "serve.batches",
            "compile.bucket_pad_rows")
SIDES = {"tpudl": (jserve, jmetrics), "port": (tserve, tmetrics)}


def _counts(metrics) -> dict:
    return {n: metrics.counter(n).value for n in COUNTERS}


def _both(scenario):
    """``scenario(serve, metrics)`` through each package: ``{side:
    (outcome, counter deltas)}``."""
    out = {}
    for side, (serve, metrics) in SIDES.items():
        before = _counts(metrics)
        got = scenario(serve, metrics)
        after = _counts(metrics)
        out[side] = (got, {n: after[n] - before[n] for n in COUNTERS
                           if after[n] != before[n]})
    return out


def _paired(scenario):
    out = _both(scenario)
    assert out["port"] == out["tpudl"]
    return out["port"]


# ---------------------------------------------------------------------------
# the queue: typed admission, deadlines, bounded waits
# ---------------------------------------------------------------------------

def _queue_full(serve, metrics):
    q = serve.RequestQueue(cap=2)
    q.submit(serve.ServeRequest([1, 2], 4))
    q.submit(serve.ServeRequest([3], 4))
    with pytest.raises(serve.AdmissionError) as ei:
        q.submit(serve.ServeRequest([4], 4))
    return {"reason": ei.value.reason, "depth": q.depth(),
            "gauge": metrics.gauge("serve.queue_depth").value}


def _hbm_budget(serve, metrics):
    # ~1 KB: one 200-token int32 prompt fits, a second does not
    q = serve.RequestQueue(cap=64, hbm_budget_mb=1e-3)
    q.submit(serve.ServeRequest(np.ones(200, np.int32), 4))
    with pytest.raises(serve.AdmissionError) as ei:
        q.submit(serve.ServeRequest(np.ones(200, np.int32), 4))
    return {"reason": ei.value.reason, "depth": q.depth()}


def _deadline_shed(serve, metrics):
    q = serve.RequestQueue(cap=8)
    dead = q.submit(serve.ServeRequest([1, 2, 3], 4, deadline_s=0.0))
    live = q.submit(serve.ServeRequest([4, 5], 4, deadline_s=60.0))
    time.sleep(0.005)
    taken = q.take(4)
    with pytest.raises(serve.DeadlineExceeded, match="before dispatch"):
        dead.result(timeout=0.5)
    return {"taken_live": taken == [live], "depth": q.depth()}


def _default_deadline(serve, metrics):
    q = serve.RequestQueue(cap=8)
    req = q.submit(serve.ServeRequest([1], 2))
    return {"deadline_after_submit": round(req.deadline - req.submitted, 6)}


def _requeue_front(serve, metrics):
    q = serve.RequestQueue(cap=8)
    a, b, c = [q.submit(serve.ServeRequest([i], 2)) for i in (1, 2, 3)]
    taken = q.take(2)
    first = taken == [a, b]
    q.requeue_front(taken)
    return {"first": first, "again": q.take(3) == [a, b, c]}


def _fail_all(serve, metrics):
    q = serve.RequestQueue(cap=8)
    req = q.submit(serve.ServeRequest([1], 2))
    n = q.fail_all(RuntimeError("server died"))
    with pytest.raises(RuntimeError, match="server died"):
        req.result(timeout=0.5)
    return {"failed": n, "depth": q.depth()}


def _take_by_model(serve, metrics):
    q = serve.RequestQueue(cap=8)
    a = q.submit(serve.ServeRequest([1], 2, model="a"))
    b = q.submit(serve.ServeRequest([2], 2, model="b"))
    return {"b": q.take(4, model="b") == [b], "a": q.take(4) == [a]}


@pytest.mark.parametrize("scenario", [
    _queue_full, _hbm_budget, _deadline_shed, _requeue_front, _fail_all,
    _take_by_model], ids=lambda f: f.__name__.strip("_"))
def test_queue_scenario_matches_tpudl(scenario):
    _paired(scenario)


def test_queue_full_reject_is_typed_and_counted():
    out, deltas = _paired(_queue_full)
    assert out == {"reason": "queue_full", "depth": 2, "gauge": 2}
    assert deltas == {"serve.requests": 2, "serve.rejects": 1}


def test_environment_sets_cap_budget_and_deadline(monkeypatch):
    monkeypatch.setenv("TPUDL_SERVE_QUEUE_CAP", "3")
    monkeypatch.setenv("TPUDL_SERVE_HBM_MB", "2")
    monkeypatch.setenv("TPUDL_SERVE_DEADLINE_S", "7.5")
    for serve, _ in SIDES.values():
        q = serve.RequestQueue()
        assert (q.cap, q.budget_bytes) == (3, 2 << 20)
    out, _ = _paired(_default_deadline)
    assert out == {"deadline_after_submit": 7.5}


@pytest.mark.parametrize("side", ["tpudl", "port"])
def test_result_timeout_is_typed(side):
    serve, _ = SIDES[side]
    req = serve.ServeRequest([1], 2)
    with pytest.raises(TimeoutError):
        req.result(timeout=0.05)


@pytest.mark.parametrize("prompt,max_new,match", [
    (np.zeros((2, 3), np.int32), 4, "prompt must be"),
    ([1, 2], 0, "max_new must be"),
])
def test_request_validation_matches_tpudl(prompt, max_new, match):
    for serve, _ in SIDES.values():
        with pytest.raises(ValueError, match=match):
            serve.ServeRequest(prompt, max_new)


def test_request_trace_decomposes_like_tpudl():
    """The copied lifecycle trace: the same events in the same order and
    segments that telescope to the latency."""
    events = {}
    for side, (serve, _) in SIDES.items():
        q = serve.RequestQueue(cap=4)
        req = q.submit(serve.ServeRequest([1, 2, 3], 2))
        q.take(1)
        for name in ("rung_pack", "first_token"):
            req.trace.stamp(name)
        req.finish([7, 8])
        segs = req.trace.segments()
        assert set(segs) == set(serve.reqtrace.SEGMENTS)
        assert abs(sum(segs.values())
                   - (req.trace.t("complete") - req.trace.t("submit"))) \
            < 1e-9
        rec = serve.reqtrace.request_record(req)
        events[side] = ([n for n, _ in req.trace.events], sorted(rec),
                        rec["prompt_len"], rec["outcome"])
    assert events["port"] == events["tpudl"]


# ---------------------------------------------------------------------------
# the rung batcher
# ---------------------------------------------------------------------------

def _ragged_split(serve, metrics):
    calls = []

    def spy(x):
        calls.append(int(x.shape[0]))
        return np.asarray(x) * 2.0

    rb = serve.RungBatcher(spy, buckets=True)
    payloads = [np.full((n, 3), n, np.float32) for n in (3, 5, 2)]
    outs = rb.run(payloads)
    return {"calls": calls, "rung": rb.rung_for(10),
            "shapes": [o.shape for o in outs],
            "exact": all(np.array_equal(o, p * 2.0)
                         for p, o in zip(payloads, outs)),
            "occupancy": metrics.gauge("serve.batch_occupancy").value}


def _empty_and_single(serve, metrics):
    rb = serve.RungBatcher(lambda x: np.asarray(x) + 1, buckets=True)
    empty = rb.run([])
    (out,) = rb.run([np.ones((4, 2), np.float32)])
    return {"empty": empty, "out": out.tolist()}


def _unbucketed(serve, metrics):
    calls = []
    rb = serve.RungBatcher(lambda x: calls.append(len(x)) or x,
                           buckets=False)
    outs = rb.run([np.arange(3), np.arange(4)])
    return {"calls": calls, "outs": [o.tolist() for o in outs]}


@pytest.mark.parametrize("scenario", [_ragged_split, _empty_and_single,
                                      _unbucketed],
                         ids=lambda f: f.__name__.strip("_"))
def test_batcher_scenario_matches_tpudl(scenario):
    _paired(scenario)


def test_batcher_dispatches_once_per_rung():
    out, deltas = _paired(_ragged_split)
    assert out["calls"] == [12] and out["exact"]
    assert out["occupancy"] == pytest.approx(10 / 12)
    assert deltas == {"serve.batches": 1, "compile.bucket_pad_rows": 2}


def test_batcher_takes_a_function_answering_on_a_device():
    """``fn`` may answer with a tensor (the card's, in a real server): the
    batcher copies it to the host before it splits."""
    rb = tserve.RungBatcher(lambda x: torch.from_numpy(x) + 1)
    a, b = rb.run([np.zeros((2, 3), np.float32), np.ones((3, 3),
                                                          np.float32)])
    assert isinstance(a, np.ndarray)
    np.testing.assert_array_equal(a, np.ones((2, 3)))
    np.testing.assert_array_equal(b, np.full((3, 3), 2.0))


def test_batcher_over_the_lm_embed_function_matches_tpudl():
    """The serve plane's kernel leg: the LM embed function (what
    ``LMFeaturizer`` maps; on the card its attention is the flash forward
    kernel) behind ``RungBatcher``, over ragged payloads, against tpudl's
    batcher over tpudl's embed function, within 2e-5 of max |y|."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.text import pad_mask

    jlm = JaxLM(**ARCH)
    params = jlm.init(0)
    jparams = jax.tree.map(jnp.asarray, params)
    tlm = TinyCausalLM.from_jax_params(params, device="cpu", **ARCH)
    rng = np.random.default_rng(0)
    payloads = [rng.integers(1, 64, size=(n, 16)).astype(np.int32)
                for n in (3, 5, 2)]
    for p in payloads:
        p[:, 12:] = 0                        # right padding, as packed

    @jax.jit
    def jembed(tokens):
        mask = (tokens != 0).astype(jnp.float32)
        h = jlm.hidden(jparams, tokens)
        return (h * mask[..., None]).sum(1) / jnp.maximum(
            mask.sum(1, keepdims=True), 1.0)

    calls = []

    def tembed(tokens):
        tokens = torch.from_numpy(tokens)
        calls.append(len(tokens))
        mask = pad_mask(tokens)
        with torch.inference_mode():
            h = tlm.hidden(tokens)
        return (h * mask[..., None]).sum(1) / mask.sum(
            1, keepdim=True).clamp_min(1.0)

    plain = []
    real = cuda_ops.flash_attention_plain

    def counted(*a, **k):
        plain.append(1)
        return real(*a, **k)

    cuda_ops.flash_attention_plain = counted
    try:
        got = tserve.RungBatcher(tembed).run(payloads)
    finally:
        cuda_ops.flash_attention_plain = real
    want = jserve.RungBatcher(jembed).run(payloads)
    assert calls == [12] and len(plain) == ARCH["layers"]
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= 2e-5 * scale


# ---------------------------------------------------------------------------
# the registry's lookups, the load generator, the serve report, refusals
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spec():
    return TinyCausalLM(device="meta", **ARCH)


def test_get_unknown_lists_names_like_tpudl(spec):
    params = spec.init(0)
    msgs = {}
    for side, (serve, _) in SIDES.items():
        reg = serve.ModelRegistry()
        if side == "port":
            reg.add_model("a", spec, params, slots=1, cache_len=32,
                          warm=False, device="cpu")
        else:
            reg.add_model("a", JaxLM(**ARCH), params, slots=1,
                          cache_len=32, warm=False)
        with pytest.raises(KeyError, match="not registered") as ei:
            reg.get("b")
        msgs[side] = (str(ei.value), reg.names(),
                      [e.name for e in reg.entries()])
    assert msgs["port"] == msgs["tpudl"]


def test_closed_loop_reports_tpudls_summary(spec):
    reg = tserve.ModelRegistry()
    reg.add_model("default", spec, spec.init(0), slots=2, cache_len=32,
                  warm=False, device="cpu")
    srv = tserve.Server(reg, tserve.RequestQueue(cap=8)).start_async()
    try:
        out = tserve.run_closed_loop(
            srv, lambda i: np.arange(1, 3 + i % 4, dtype=np.int32),
            requests=6, clients=3, max_new=3, timeout=60)
    finally:
        srv.close(timeout=60)
    assert out["completed"] == 6 and out["rejected"] == 0
    assert out["deadline_shed"] == 0
    assert out["p50_ms"] <= out["p99_ms"]
    assert out["ttft_p50_s"] <= out["ttft_p99_s"]
    # tpudl's summary keys, with a server that answers at once
    fake = jserve.Server.__new__(jserve.Server)
    fake.submit = lambda *a, **k: (_ for _ in ()).throw(
        jserve.AdmissionError("full", reason="queue_full"))
    want = jserve.run_closed_loop(fake, lambda i: [1], requests=2,
                                  clients=1, timeout=5)
    assert sorted(out) == sorted(want) and want["rejected"] == 2


def test_closed_loop_counts_typed_rejects():
    class Full:
        def submit(self, *a, **k):
            raise tserve.AdmissionError("full", reason="queue_full")

    out = tserve.run_closed_loop(Full(), lambda i: [1], requests=5,
                                 clients=2, timeout=5)
    assert (out["completed"], out["rejected"]) == (0, 5)
    assert out["p50_ms"] is None and out["ttft_p99_s"] is None


def test_serve_session_report_publishes_occupancy_and_token_rate(spec):
    reg = tserve.ModelRegistry()
    reg.add_model("default", spec, spec.init(0), slots=2, cache_len=32,
                  warm=False, device="cpu")
    srv = tserve.Server(reg, tserve.RequestQueue(cap=8))
    for n in (3, 4, 5):
        srv.submit(np.arange(1, n + 1, dtype=np.int32), 4)
    srv._stop.set()
    summary = srv.run()
    rep = tpipeline.last_pipeline_report()
    assert summary["completed"] == 3
    assert rep["serve"] is True and rep["dispatch_depth"] == 2
    assert rep["stage_calls"]["tokens"] == 3 * 4 - 3   # first tokens aside
    assert rep["stage_calls"]["dispatch"] >= 3
    assert rep["rows_done"] == 3
    occ = tmetrics.gauge("serve.batch_occupancy").value
    assert occ == pytest.approx(rep["slot_occupancy_mean"], abs=0.01)
    assert tmetrics.gauge("serve.tokens_per_s").value == pytest.approx(
        9 / rep["wall_seconds"], rel=0.01)


def test_supervised_sessions_are_refused(spec, monkeypatch):
    """A supervised session (once refused, 'Jobs, faults and the
    supervisor'), by ``supervise=True`` and by ``TPUDL_FRAME_DEGRADE=1``:
    a fault at the third tick's ``serve.dispatch`` requeues the in-flight
    requests, the retry narrows the admission width by one rung, and
    every stream equals the unsupervised session's. ``supervise=False``
    wins over the variable."""
    from tpudl_torch.testing import faults

    params = spec.init(0)
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (3, 4, 5)]

    def session(plan=None, **kw):
        reg = tserve.ModelRegistry()
        reg.add_model("default", spec, params, slots=2, cache_len=32,
                      warm=False, device="cpu")
        srv = tserve.Server(reg, tserve.RequestQueue(cap=8), **kw)
        reqs = [srv.submit(p, 4) for p in prompts]
        srv._stop.set()
        if plan is None:
            summary = srv.run()
        else:
            with plan.armed():
                summary = srv.run()
        return summary, [r.result(timeout=30).tolist() for r in reqs]

    _, want = session(supervise=False)
    for kw in ({"supervise": True}, {}):
        if not kw:
            monkeypatch.setenv("TPUDL_FRAME_DEGRADE", "1")
        plan = faults.FaultPlan([{"point": "serve.dispatch",
                                  "action": "raise", "at_call": 3}])
        summary, got = session(plan, **kw)
        assert [f["tick"] for f in plan.fired] == [3]
        assert summary["degraded_to"] == "dispatch_depth=1"
        assert got == want
    with pytest.raises(faults.FaultInjected):
        session(faults.FaultPlan([{"point": "serve.dispatch",
                                   "action": "raise", "at_call": 2}]),
                supervise=False)


def test_closed_loop_tenant_is_refused(spec):
    """Once refused ('The rest of observability'): ``tenant=("a", "b")``
    round-robins the clients over two attribution scopes, as tpudl's does;
    each tenant's ledger row counts its own completions and prompt tokens,
    and the ledger reconciles exactly with the global counters."""
    from tpudl_torch.obs import attribution as attr

    reg = tserve.ModelRegistry()
    reg.add_model("default", spec, spec.init(0), slots=2, cache_len=32,
                  warm=False, device="cpu")
    prompt = lambda i: np.arange(1, 3 + i % 4, dtype=np.int32)  # noqa: E731
    before = attr.ledger_snapshot()["scopes"]
    srv = tserve.Server(reg, tserve.RequestQueue(cap=8)).start_async()
    try:
        out = tserve.run_closed_loop(srv, prompt, requests=8, clients=2,
                                     max_new=3, timeout=60,
                                     tenant=("a", "b"))
    finally:
        srv.close(timeout=60)
    assert out["completed"] == 8
    rows = attr.ledger_snapshot()["scopes"]
    # client c takes requests in turn, so the split of the 8 follows the
    # clients' pace: count each tenant's delta against its own charges
    done = {k: rows[k]["serve_completed"]
            - before.get(k, {}).get("serve_completed", 0)
            for k in ("tenant=a", "tenant=b")}
    toks = {k: rows[k]["tokens_out"]
            - before.get(k, {}).get("tokens_out", 0)
            for k in ("tenant=a", "tenant=b")}
    assert sum(done.values()) == 8 and min(done.values()) >= 1
    assert toks == {k: 3 * v for k, v in done.items()}
    assert all(c["ok"] for c in attr.reconcile()["checks"]
               if c["field"] in ("serve_completed", "slo_samples"))


@pytest.mark.parametrize("kw,item", [({"tp": True}, "LM parallelism"),
                                     ({"mesh": object()}, "LM parallelism")])
def test_parallel_engines_are_refused(spec, kw, item):
    """Once refused ('LM parallelism'): ``tp=True`` over a local mesh now
    decodes tensor-parallel with its cache split over heads, and greedy
    streams equal the one-device engine's; ``tp=True`` without a mesh
    raises tpudl's ValueError, and a mesh that is no local mesh is
    refused."""
    params = spec.init(0)
    mesh = M.build_mesh(1, 2, devices=["cpu"] * 2)
    if "mesh" in kw:
        with pytest.raises(ValueError, match="local mesh"):
            tserve.ModelRegistry().add_model("m", spec, params,
                                             device="cpu", **kw)
        return
    with pytest.raises(ValueError, match="'model' axis"):
        tserve.ModelRegistry().add_model("m", spec, params, device="cpu",
                                         **kw)
    streams = []
    for extra in ({}, dict(mesh=mesh, **kw)):
        eng = tserve.ModelRegistry().add_model(
            "m", spec, params, device="cpu", slots=2, cache_len=32,
            **extra).engine
        reqs = [tserve.ServeRequest(p, 6) for p in ([3, 5, 7, 9], [11, 2])]
        for r in reqs:
            eng.insert(r)
        done = {}
        while eng.active():
            eng.step()
            done.update({id(r): t.tolist() for r, t in eng.pop_completed()})
        streams.append([done[id(r)] for r in reqs])
    assert isinstance(eng._cache[0]["k"], tuple)
    assert eng._cache[0]["k"][0].shape[2] == spec.heads // 2
    assert streams[0] == streams[1]


def test_precompile_serve_is_refused(spec, tmp_path, monkeypatch):
    """Once refused ('Compile'), ``precompile_serve`` now runs as tpudl's:
    0 unarmed; armed, it readies the step, prefill and insert programs
    through the program store (their signatures in its manifest)."""
    from tpudl_torch.compile import store as cstore

    monkeypatch.delenv("TPUDL_COMPILE_AOT", raising=False)
    lm = TinyCausalLM.from_jax_params(spec.init(0), device="cpu", **ARCH)
    assert lm.precompile_serve(slots=2, cache_len=32, prompt_rungs=[8]) == 0
    monkeypatch.setenv("TPUDL_COMPILE_AOT", str(tmp_path / "programs"))
    assert lm.precompile_serve(slots=2, cache_len=32, prompt_rungs=[8]) == 3
    entries = cstore.get_program_store().entries().values()
    assert sum(e["bound"] for e in entries) == 3


def test_exports_tpudls_names():
    assert tserve.__all__ == jserve.__all__
    for name in tserve.__all__:
        assert getattr(tserve, name).__module__.startswith(
            "tpudl_torch.serve.")
