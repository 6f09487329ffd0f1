"""The port's TinyCausalLM (``tpudl_torch.zoo.transformer``) against
tpudl's, from the same ``init(0)`` pytree at a small width (vocab 64,
dim 32, heads 4, layers 2).

Tolerances: hidden/apply/decode_step to 2e-5 absolute (f32 on the CPU
through two layers; the two frameworks sum products in other orders);
greedy generate token-exact; ``init`` bit-equal."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl.zoo.transformer import TinyCausalLM as JaxLM
from tpudl_torch import mesh as M
from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

# the suite runs several pytest workers on the same cores: one torch
# thread per worker avoids oversubscribing them
torch.set_num_threads(1)

ARCH = dict(vocab=64, dim=32, heads=4, layers=2, max_len=64)
TOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    jlm = JaxLM(**ARCH)
    params = jlm.init(0)
    tlm = TinyCausalLM.from_jax_params(params, device="cpu", **ARCH)
    return jlm, jax.tree.map(jnp.asarray, params), params, tlm


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(
        0, ARCH["vocab"], size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 7])
def test_init_is_bit_equal(seed):
    want = JaxLM(**ARCH).init(seed)
    got = TinyCausalLM(device="meta", **ARCH).init(seed)
    assert sorted(got) == sorted(want)
    for group in want:
        assert sorted(got[group]) == sorted(want[group])
        for name in want[group]:
            assert got[group][name].dtype == want[group][name].dtype
            np.testing.assert_array_equal(got[group][name],
                                          want[group][name])


@pytest.mark.parametrize("method", ["hidden", "apply"])
def test_forward_matches_tpudl(pair, method):
    jlm, jparams, _, tlm = pair
    toks = _tokens(1, 3, 20)
    want = np.asarray(getattr(jlm, method)(jparams, jnp.asarray(toks)))
    with torch.no_grad():
        got = getattr(tlm, method)(torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_decode_step_matches_tpudl(pair):
    jlm, jparams, _, tlm = pair
    toks = _tokens(2, 3, 2)
    jcache = jlm.init_cache(3, 16)
    tcache = tlm.init_cache(3, 16)
    with torch.no_grad():
        for pos in range(2):
            want, jcache = jlm.decode_step(jparams, jnp.asarray(toks[:, pos]),
                                           jcache, pos)
            got, tcache = tlm.decode_step(torch.from_numpy(toks[:, pos]),
                                          tcache, pos)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
    for jl, tl in zip(jcache, tcache):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tl[kv].numpy(), np.asarray(jl[kv]),
                                       rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="out of range"):
        tlm.decode_step(torch.zeros(3, dtype=torch.int32), tcache, 16)


@pytest.mark.parametrize("buckets", [None, "pow2"])
def test_greedy_generate_is_token_exact(pair, buckets):
    jlm, _, params, tlm = pair
    prompt = _tokens(3, 3, 5)
    want = np.asarray(jlm.generate(params, prompt, 9,
                                   prompt_buckets=buckets))
    got = tlm.generate(prompt, 9, prompt_buckets=buckets)
    assert got.dtype == torch.int32 and got.shape == (3, 9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_follows_its_generator(pair):
    *_, tlm = pair
    prompt = _tokens(4, 2, 4)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tlm.generate(prompt, 8, temperature=0.9, generator=g)

    assert torch.equal(run(11), run(11))
    assert not torch.equal(run(11), run(12))
    with pytest.raises(ValueError, match="generator"):
        tlm.generate(prompt, 2, temperature=0.9)


@pytest.mark.parametrize("call", ["experts", "mesh", "tp", "pipelined",
                                  "aot", "shard"])
def test_unported_parallelism_raises(pair, call, tmp_path, monkeypatch):
    """These once-refused options run. AOT precompilation (ROADMAP Queue
    1, 'Compile') returns False unarmed and True armed, and still raises
    for sampled decoding, which stays eager; the LM parallelism ones are
    each held here to the port's one-device forward
    (tests/test_torch_parallel_*.py hold them to tpudl)."""
    *_, params, tlm = pair
    toks = torch.from_numpy(_tokens(5, 2, 8))
    mesh = M.build_mesh(2, 2, devices=["cpu"] * 4)
    with torch.no_grad():
        if call == "aot":
            monkeypatch.delenv("TPUDL_COMPILE_AOT", raising=False)
            assert tlm.precompile_generate(1, 4, 2) is False
            monkeypatch.setenv("TPUDL_COMPILE_AOT", str(tmp_path / "p"))
            assert tlm.precompile_generate(1, 4, 2) is True
            with pytest.raises(NotImplementedError, match="'Compile'"):
                tlm.precompile_generate(1, 4, 2, temperature=0.5)
            return
        want = tlm.apply(toks).numpy()
        if call == "experts":
            moe = TinyCausalLM(experts=2, device="cpu", **ARCH)
            load_jax_params(moe, moe.init(0))
            assert moe.apply(toks).shape == (2, 8, ARCH["vocab"])
            return
        if call == "mesh":
            got = tlm.apply(toks, mesh=mesh)
        elif call == "tp":
            got = tlm.apply(toks, mesh=mesh, tp=True)
        elif call == "pipelined":
            got = tlm.apply_pipelined(toks, mesh, n_micro=2)
        else:
            lay = TinyCausalLM.from_jax_params(params, device="cpu", **ARCH)
            lay.shard_params(mesh)
            assert lay.tp_shards[1][0]["wq"].shape == (32, 16)
            got = lay.apply(toks, mesh=mesh, tp=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_load_jax_params_checks_names_and_shapes(pair):
    *_, params, _ = pair
    fresh = TinyCausalLM(device="cpu", **ARCH)
    with pytest.raises(KeyError):
        load_jax_params(fresh, {k: v for k, v in params.items()
                                if k != "block_1"})
    bad = dict(params, embed={"table": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(fresh, bad)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TinyCausalLM(device="cuda", **ARCH)
