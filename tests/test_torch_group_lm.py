"""The port's TinyCausalLM over a process group's mesh — one gloo process a
rank, each running only its own entry of the ``(data, model)`` grid —
against tpudl's LM over its mesh of conftest's host devices.

Two grids, one spawn each, several checks a spawn:

- ``(2, 2)``: ``HorovodRunner(np=4)`` under ``TPUDL_MESH_MODEL=2``, the
  ring over the data axis and ``tp=True`` over the model axis (the heads
  and the MLP split, or the experts and their ``all_to_all``), held to
  tpudl's ``(2, 2)`` mesh with ``tp=True``;
- ``(4, 1)``: four ranks started by hand, ``initialize`` then
  ``build_mesh(4, 1)`` (the ring alone), held to tpudl's ``(4, 1)`` mesh.

Both read tpudl's ``init(0)`` params at vocab 64, dim 32, 4 heads, 2
layers, and the seeded rows ``[4, 65]`` of ``tests/torch_group_fns.py``;
the dense model and the MoE model (``experts=4``). Tolerances: hidden
states and logits within 1e-4 of their max |value|, losses within 2e-5,
expert choices equal (to tpudl's unsplit forward, as
``tests/test_torch_parallel_lm.py`` holds the local mesh).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_group_fns as G
from tpudl import mesh as JM
from tpudl.zoo.transformer import TinyCausalLM as JaxLM
from tpudl_torch.train import HorovodRunner

torch.set_num_threads(1)

TOL = 1e-4        # of max |logit| (or |hidden|)
LOSS_TOL = 2e-5
EXPERTS = (0, 4)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def grid_2x2():
    mp = pytest.MonkeyPatch()
    mp.setenv("TPUDL_MESH_MODEL", "2")
    try:
        return HorovodRunner(np=-4, device="cpu").run(G.forward_fn)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def grid_4x1(tmp_path_factory):
    return G.run_initialized(G.forward_fn, 4, 1,
                             str(tmp_path_factory.mktemp("grid4x1")))


def _tpudl(experts, n_data, n_model):
    """tpudl's hidden states, logits and loss over its ``(n_data,
    n_model)`` mesh (``tp`` under a model axis), and its expert choices
    from the unsplit forward."""
    jlm = JaxLM(**G.ARCH, experts=experts)
    params = jax.tree.map(jnp.asarray, jlm.init(0))
    jm = JM.build_mesh(n_data, n_model, devices=jax.devices()[:4])
    tp = n_model > 1
    toks = jnp.asarray(G.tokens(0))
    hidden, logits, loss = jax.jit(lambda p, t: (
        jlm.hidden(p, t[:, :-1], mesh=jm, tp=tp),
        jlm.apply(p, t[:, :-1], mesh=jm, tp=tp),
        jlm.loss_fn(mesh=jm, tp=tp)(p, t)))(params, toks)
    routes, orig = [], jlm._moe_ffn

    def spy(h, p, *rest):
        probs = jax.nn.softmax((h @ p["w_gate"]).astype(jnp.float32), -1)
        routes.append(np.asarray(jnp.argmax(probs, -1)))
        return orig(h, p, *rest)

    if experts:
        jlm._moe_ffn = spy
        try:
            jlm.apply(params, toks[:, :-1])
        finally:
            jlm._moe_ffn = orig
    return np.asarray(hidden), np.asarray(logits), float(loss), routes


def _blocks(ranks, experts, key, n_data, n_model):
    """The ranks' sequence blocks of ``key`` joined in data-axis order (the
    first rank of each row)."""
    return np.concatenate([ranks[r * n_model][experts][key]
                           for r in range(n_data)], axis=1)


@pytest.mark.parametrize("experts", EXPERTS)
def test_2x2_grid_matches_tpudls_2x2_mesh(grid_2x2, experts):
    want_h, want, want_loss, want_routes = _tpudl(experts, 2, 2)
    _close(_blocks(grid_2x2, experts, "hidden", 2, 2), want_h)
    _close(_blocks(grid_2x2, experts, "logits", 2, 2), want)
    for rank in grid_2x2:
        assert abs(rank[experts]["loss"] - want_loss) <= LOSS_TOL
    if experts:
        for layer, w in enumerate(want_routes):
            got = np.concatenate([grid_2x2[r * 2][experts]["routes"][layer]
                                  for r in range(2)], axis=1)
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("experts", EXPERTS)
def test_4x1_ring_matches_tpudls_4x1_mesh(grid_4x1, experts):
    want_h, want, want_loss, want_routes = _tpudl(experts, 4, 1)
    _close(_blocks(grid_4x1, experts, "hidden", 4, 1), want_h)
    _close(_blocks(grid_4x1, experts, "logits", 4, 1), want)
    for rank in grid_4x1:
        assert abs(rank[experts]["loss"] - want_loss) <= LOSS_TOL
    if experts:
        for layer, w in enumerate(want_routes):
            got = np.concatenate([r[experts]["routes"][layer]
                                  for r in grid_4x1], axis=1)
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("experts", EXPERTS)
def test_a_row_computes_alike_and_holds_one_nth_of_the_split_leaves(
        grid_2x2, experts):
    """Every rank of a row returns the same block, bit for bit, and holds
    half of the split leaves' bytes."""
    for r in range(2):
        first, second = grid_2x2[2 * r][experts], grid_2x2[2 * r + 1][experts]
        for key in ("hidden", "logits"):
            np.testing.assert_array_equal(first[key], second[key])
    for rank in grid_2x2:
        assert rank[experts]["split_bytes"] * 2 == \
            rank[experts]["whole_bytes"] > 0


def test_the_grid_is_row_major_and_ctx_size_is_the_data_axis(grid_2x2,
                                                               grid_4x1):
    """tpudl's layout: rank ``r * n_model + j`` is entry ``(r, j)``;
    ``ctx.size`` is the data axis (tpudl's ``mesh.shape['data']``) and
    ``ctx.rank`` the process rank. No rank holds jax or tpudl (this
    process does)."""
    assert [g["coords"] for g in grid_2x2] == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]
    assert [(g["rank"], g["size"]) for g in grid_2x2] == [
        (0, 2), (1, 2), (2, 2), (3, 2)]
    assert [g["coords"] for g in grid_4x1] == [(i, 0) for i in range(4)]
    assert {g["size"] for g in grid_4x1} == {4}
    for rank in grid_4x1:   # no model axis: nothing is split
        assert rank[0]["split_bytes"] == 0
    assert all(g["loaded"] == [] for g in (*grid_2x2, *grid_4x1))
