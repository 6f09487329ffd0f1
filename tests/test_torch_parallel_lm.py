"""The port's TinyCausalLM over a local mesh against tpudl's over its mesh:
the ring forward (``apply``/``hidden(mesh=)``), tensor parallelism
(``param_shardings``, ``shard_params``, ``apply``/``generate``/
``decode_step_slots(tp=True)``) and the experts (``experts=4``, held
with and without ``tp``, routing included).

tpudl runs on conftest's 8 host devices (a 4-entry data axis, and the
(4, 2) mesh for ``tp``), jitted, its ring through the Pallas kernel in
interpret mode where ``use_pallas``; the port runs on ``["cpu"] * n``
meshes with the plain kernels. Both read the same ``init(0)`` pytree at
vocab 64, dim 32, 2 heads (head_dim 16), 2 layers, and the same seeded
numpy tokens ``[2, 64]``.

Tolerances: hidden states and logits within 1e-4 of their max |value|;
greedy tokens and expert choices equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl import mesh as JM
from tpudl.zoo.transformer import TinyCausalLM as JaxLM
from tpudl_torch import mesh as M
from tpudl_torch.zoo.transformer import TinyCausalLM, to_jax_params

torch.set_num_threads(1)

ARCH = dict(vocab=64, dim=32, heads=2, layers=2, max_len=96)
TOL = 1e-4   # of max |logit| (or |hidden|)


def _tokens(seed=0, b=2, s=64):
    return np.random.default_rng(seed).integers(
        0, ARCH["vocab"], size=(b, s)).astype(np.int32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def dense():
    jlm = JaxLM(**ARCH)
    params = jlm.init(0)
    return jlm, params, TinyCausalLM.from_jax_params(params, device="cpu",
                                                     **ARCH)


@pytest.fixture(scope="module")
def moe():
    arch = dict(ARCH, experts=4)
    jlm = JaxLM(**arch)
    params = jlm.init(0)
    return jlm, params, TinyCausalLM.from_jax_params(params, device="cpu",
                                                     **arch)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ring_forward_matches_tpudl(dense, use_pallas):
    jlm, params, tlm = dense
    jmesh = JM.build_mesh(devices=jax.devices()[:4])
    toks = _tokens()
    want_h, want = jax.jit(lambda p, t: (
        jlm.hidden(p, t, mesh=jmesh, use_pallas=use_pallas),
        jlm.apply(p, t, mesh=jmesh, use_pallas=use_pallas)))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(toks))
    mesh = M.build_mesh(devices=["cpu"] * 4)
    with torch.no_grad():
        t = torch.from_numpy(toks)
        _close(tlm.hidden(t, mesh=mesh, use_pallas=use_pallas), want_h)
        _close(tlm.apply(t, mesh=mesh, use_pallas=use_pallas), want)


def test_tp_forward_matches_tpudl_with_sharded_params(dense, mesh4x2):
    jlm, params, _ = dense
    sp = jlm.shard_params(params, mesh4x2)
    toks = _tokens(1)
    want = jax.jit(lambda p, t: jlm.apply(p, t, mesh=mesh4x2, tp=True))(
        sp, jnp.asarray(toks))
    mesh = M.build_mesh(4, 2, devices=["cpu"] * 8)
    # tpudl's sharded jax arrays load as they are
    tlm = TinyCausalLM.from_jax_params(sp, device="cpu", **ARCH)
    tlm.shard_params(mesh)
    assert tlm.tp_shards[1][0]["wq"].shape == \
        sp["block_0"]["wq"].addressable_shards[0].data.shape == (32, 16)
    with torch.no_grad():
        _close(tlm.apply(torch.from_numpy(toks), mesh=mesh, tp=True), want)


@pytest.mark.parametrize("experts", [0, 4])
def test_param_shardings_are_tpudls_and_shards_hold_one_nth(experts,
                                                            mesh4x2):
    arch = dict(ARCH, experts=experts)
    jlm = JaxLM(**arch)
    params = jlm.init(0)
    mesh = M.build_mesh(4, 2, devices=["cpu"] * 8)
    tlm = TinyCausalLM.from_jax_params(params, device="cpu", **arch)
    got = tlm.param_shardings(mesh)
    want = jlm.param_shardings(mesh4x2)
    assert sorted(got) == sorted(want)
    for group in want:
        assert sorted(got[group]) == sorted(want[group])
        for key, sh in want[group].items():
            spec = tuple(sh.spec) + (None,) * (
                params[group][key].ndim - len(sh.spec))
            assert got[group][key].spec == spec, (group, key)
    tlm.shard_params(mesh)
    for i in range(ARCH["layers"]):
        for key, whole in params[f"block_{i}"].items():
            dim = got[f"block_{i}"][key].dim()
            if dim is None:
                assert tlm.blocks[i][key].shape == whole.shape
                continue
            for j in range(2):
                part = tlm.tp_shards[j][i][key]
                assert part.numel() * 2 == whole.size
                np.testing.assert_array_equal(
                    part.detach().numpy(),
                    np.split(whole, 2, axis=dim)[j])
    back = to_jax_params(tlm)
    for group in params:
        for key in params[group]:
            np.testing.assert_array_equal(back[group][key],
                                          params[group][key])


def test_tp_generate_and_slot_decode_match_tpudl(dense, mesh4x2):
    jlm, params, _ = dense
    sp = jlm.shard_params(params, mesh4x2)
    prompt = _tokens(2, b=2, s=5)
    want = np.asarray(jlm.generate(sp, prompt, 8, mesh=mesh4x2, tp=True))
    mesh = M.build_mesh(4, 2, devices=["cpu"] * 8)
    tlm = TinyCausalLM.from_jax_params(params, device="cpu", **ARCH)
    tlm.shard_params(mesh)
    got = tlm.generate(prompt, 8, mesh=mesh, tp=True).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, tlm.generate(prompt, 8).numpy())

    # three slot steps at per-slot positions on a head-split cache
    tok = np.array([3, 9, 17], np.int32)
    pos = np.array([0, 4, 2], np.int32)

    @jax.jit
    def jax_steps(p, tok, pos):
        cache = jlm.init_cache(3, 16, mesh=mesh4x2, tp=True)
        out = []
        for _ in range(3):
            logits, cache = jlm.decode_step_slots(p, tok, cache, pos,
                                                  mesh=mesh4x2, tp=True)
            out.append(logits)
            tok, pos = jnp.argmax(logits, -1).astype(jnp.int32), pos + 1
        return jnp.stack(out)

    want = jax_steps(sp, jnp.asarray(tok), jnp.asarray(pos))
    cache = tlm.init_cache(3, 16, mesh=mesh, tp=True)
    assert [c.shape for c in cache[0]["k"]] == [(3, 16, 1, 16)] * 2
    t, p, out = torch.from_numpy(tok).long(), torch.from_numpy(pos).long(), []
    with torch.no_grad():
        for _ in range(3):
            logits, cache = tlm.decode_step_slots(t, cache, p, mesh=mesh,
                                                  tp=True)
            out.append(logits)
            t, p = logits.argmax(-1), p + 1
    _close(torch.stack(out), want)


def _jax_routes(jlm, params, toks):
    """tpudl's expert choice a layer (its eager single-device apply, with
    ``_moe_ffn`` wrapped) and its logits."""
    routes, orig = [], jlm._moe_ffn

    def spy(h, p, *rest):
        probs = jax.nn.softmax((h @ p["w_gate"]).astype(jnp.float32), -1)
        routes.append(np.asarray(jnp.argmax(probs, -1)))
        return orig(h, p, *rest)

    jlm._moe_ffn = spy
    try:
        logits = jlm.apply(jax.tree.map(jnp.asarray, params),
                           jnp.asarray(toks))
    finally:
        jlm._moe_ffn = orig
    return routes, logits


def test_moe_matches_tpudl_with_equal_routing(moe):
    """tpudl's unsplit MoE forward is the yardstick of the port's three
    layouts (tpudl's own ``tp=True`` equals it within its tests')."""
    jlm, params, tlm = moe
    toks = _tokens(3)
    want_routes, want = _jax_routes(jlm, params, toks)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        for mesh, tp in ((None, False),
                         (M.build_mesh(1, 2, devices=["cpu"] * 2), True)):
            tlm.moe_routes = []
            _close(tlm.apply(t, mesh=mesh, tp=tp), want)
            got_routes, tlm.moe_routes = tlm.moe_routes, None
            assert len(got_routes) == ARCH["layers"]
            for (choice, kept), w in zip(got_routes, want_routes):
                assert np.array_equal(choice.numpy(), w)
                assert kept.dtype == torch.bool
        # ring over 4 sequence blocks × experts over 2 cards
        got_tp = tlm.apply(t, mesh=M.build_mesh(4, 2, devices=["cpu"] * 8),
                           tp=True)
    _close(got_tp, want)


def test_parallel_refusals(dense, moe):
    _, _, tlm = dense
    t = torch.from_numpy(_tokens(4, s=8))
    with pytest.raises(ValueError, match="'model' axis"):
        tlm.apply(t, tp=True)
    odd = TinyCausalLM(vocab=8, dim=24, heads=3, layers=1, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        odd.param_shardings(M.build_mesh(4, 2, devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="not divisible by ring size 3"):
        tlm.apply(t, mesh=M.build_mesh(devices=["cpu"] * 3))
    _, _, tmoe = moe
    with pytest.raises(NotImplementedError, match="MoE"):
        tmoe.generate(_tokens(4, b=1, s=3), 2)
    with pytest.raises(NotImplementedError, match="pipelined MoE"):
        tmoe.apply_pipelined(t, M.build_mesh(1, 2, devices=["cpu"] * 2))
