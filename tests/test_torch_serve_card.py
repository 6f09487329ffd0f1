"""The slot decoder's CUDA graphs on the card. Marked ``cuda``: it skips
without an NVIDIA GPU. The repo's ``conftest.py`` hides the card and
imports jax, so run it on a machine with a card as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_serve_card.py

The model is the serving width of ``chip_smoke.py`` phase 15 (vocab
32000, dim 1024, 16 heads) cut to 2 layers. A replay of the step graph
must equal the same step run eagerly bit for bit (same kernels, same
inputs), and a churning request mix after warm-up must capture no new
graph while every stream equals the serial batch-1 ``generate``.
``warm()`` with every slot occupied must leave the live slots' caches as
they were."""

import numpy as np
import pytest
import torch

from tpudl_torch import cuda_ops
from tpudl_torch.device import full_f32
from tpudl_torch.serve import ModelRegistry, RequestQueue, Server
from tpudl_torch.zoo.transformer import TinyCausalLM

ARCH = dict(vocab=32000, dim=1024, heads=16, layers=2, max_len=1024)
SLOTS, CACHE_LEN = 4, 256


@pytest.fixture(scope="module")
def served():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec = TinyCausalLM(device="meta", **ARCH)
    reg = ModelRegistry()
    entry = reg.add_model("default", spec, spec.init(0), slots=SLOTS,
                          cache_len=CACHE_LEN, device="cuda")
    return reg, entry


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, ARCH["vocab"], size=n).astype(np.int32)
            for n in lengths]


@pytest.mark.cuda
def test_step_graph_replay_is_its_eager_step_bit_for_bit(served):
    _, entry = served
    eng = entry.engine
    assert entry.warm_signatures == 3 and eng.captures == 3
    for p in _prompts(0, (5, 17, 40)):
        eng.insert(type("R", (), {"prompt": p[None, :], "max_new": 8,
                                  "rng": None, "trace": None})())
    eng.step()
    state = (eng._cache, eng._tok, eng._pos, eng._steps, eng._live,
             eng._logits)
    with torch.inference_mode():
        twin = ([{kv: c[kv].clone() for kv in c} for c in eng._cache],
                *(t.clone() for t in state[1:]))
        with full_f32():
            eng.model._slot_step_program(0.0)(*twin)
        eng._program("step")()
        torch.cuda.synchronize()
    for got, want in zip(state[1:], twin[1:]):
        assert torch.equal(got, want)
    for got, want in zip(eng._cache, twin[0]):
        assert all(torch.equal(got[kv], want[kv]) for kv in ("k", "v"))
    eng.evict_all()


@pytest.mark.cuda
def test_churn_captures_no_graph_after_warmup(served):
    reg, entry = served
    eng = entry.engine
    net = eng.model
    lengths = (3, 9, 17, 33, 60, 100)
    srv = Server(reg, RequestQueue(cap=64))
    before = dict(cuda_ops.launch_counts)
    reqs = [srv.submit(p, 12) for _ in range(3)
            for p in _prompts(1, lengths)]
    srv._stop.set()
    srv.run()
    assert eng.captures == 3 and len(eng.programs) == 3
    assert cuda_ops.launch_counts == before          # no flash launch
    for req in reqs:
        with torch.inference_mode(), full_f32():
            want = net.generate(req.prompt, 12).cpu().numpy()[0]
        np.testing.assert_array_equal(req.result(timeout=1), want)


@pytest.mark.cuda
def test_warm_with_every_slot_occupied_spares_the_live_caches(served):
    _, entry = served
    spec = TinyCausalLM(device="meta", **ARCH)
    eng = ModelRegistry().add_model(
        "cold", spec, entry.params, slots=2, cache_len=CACHE_LEN,
        warm=False, device="cuda").engine
    net = eng.model
    reqs = [type("R", (), {"prompt": p[None, :], "max_new": 10, "rng": None,
                           "trace": None})()
            for p in _prompts(2, (6, 21, 13))]
    for req in reqs[:2]:
        eng.insert(req)          # captures the prefill and insert graphs
    eng._program("insert").graph = None   # as if the insert were cold
    with torch.inference_mode():
        eng._slot.fill_(0)                # a live slot
    assert eng.warm() == 1                # the step graph only
    assert eng._program("insert").graph is None
    done = {}
    while len(done) < 3:
        eng.step()
        for req, toks in eng.pop_completed():
            done[id(req)] = toks
        if eng.free() and len(eng.active()) + len(done) < 3:
            eng.insert(reqs[2])
    for req in reqs:
        with torch.inference_mode(), full_f32():
            want = net.generate(req.prompt, 10).cpu().numpy()[0]
        np.testing.assert_array_equal(done[id(req)], want)
