"""Training the port's TinyCausalLM over a process group's mesh (one gloo
process a rank) against the port's local mesh and tpudl's mesh.

Two grids, one spawn each (``tests/torch_group_fns.py:train_scenario_fn``:
the dense model and the MoE model with ``experts=4``, one step's
gradients and two ``Trainer`` sgd steps each):

- ``(2, 2)``: ``HorovodRunner(np=4)`` under ``TPUDL_MESH_MODEL=2``,
  ``loss_fn(mesh=, tp=True)`` and ``param_shardings=`` (the ring over the
  data axis, the heads, MLP and experts split over the model axis);
- ``(4, 1)``: four ranks joined by ``initialize`` and ``build_mesh(4,
  1)``, README's long-context loss (the ring alone).

The gradients, after the step's mean over the data axis (the ring's loss
sums its blocks over the data axis with ``psum``, whose backward sums the
ranks' seeds), are held to the port's local mesh of the same shape within
1e-5 of the largest gradient: a leaf whole on every rank to the whole
gradient, a split leaf's slice to that slice; also a model that
``shard_params`` has not laid out, every leaf whole on every rank.
Leaves whole on every rank of a row come out equal there, bit for bit.
The losses of two sgd steps are held to tpudl's within 2e-5, the weights
after them within 1e-4 of the largest weight change. ``remat=True``
gives the same gradients bit for bit. A ring loss fed each rank's own
rows raises, and ``with_compute_dtype`` keeps its ``whole_batch``.
"""

import numpy as np
import optax
import pytest

import jax
import torch

import torch_group_fns as G
from tpudl import mesh as JM
from tpudl.train import Trainer as JaxTrainer
from tpudl.train import make_train_step as jax_train_step
from tpudl.zoo.transformer import TinyCausalLM as JaxLM
from tpudl_torch import mesh as M
from tpudl_torch.train import HorovodRunner

torch.set_num_threads(1)

GRAD_TOL = 1e-5     # of the largest gradient
LOSS_TOL = 2e-5
WEIGHT_TOL = 1e-4   # of the largest weight change
EXPERTS = (0, 4)


@pytest.fixture(scope="module")
def grid_2x2():
    mp = pytest.MonkeyPatch()
    mp.setenv("TPUDL_MESH_MODEL", "2")
    try:
        return HorovodRunner(np=-4, device="cpu").run(G.train_scenario_fn)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def grid_4x1(tmp_path_factory):
    return G.run_initialized(G.train_scenario_fn, 4, 1,
                             str(tmp_path_factory.mktemp("train4x1")))


def _local_grads(experts, n_data, n_model):
    """The port's local-mesh gradients of the whole leaves, by name."""
    net = G.lm("cpu", experts)
    mesh = M.build_mesh(n_data, n_model, devices=["cpu"] * 4)
    net.loss_fn(mesh=mesh, tp=n_model > 1)(
        net, torch.from_numpy(G.tokens(0))).backward()
    return {n: p.grad.numpy() for n, p in net.named_parameters()}


def _check_grads(ranks, experts, n_data, n_model):
    want = _local_grads(experts, n_data, n_model)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for rank in ranks:
        got, dims = rank[experts]["grads"], rank[experts]["dims"]
        assert sorted(got) == sorted(want)
        j = rank["coords"][1]
        for name, g in got.items():
            w = want[name]
            if name in dims:
                w = np.split(w, n_model, axis=dims[name])[j]
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale,
                                       err_msg=name)


def _tpudl_steps(experts, n_data, n_model):
    """tpudl's two sgd steps over its ``(n_data, n_model)`` mesh: (losses,
    params before, params after)."""
    jlm = JaxLM(**G.ARCH, experts=experts)
    params = jlm.init(0)
    jm = JM.build_mesh(n_data, n_model, devices=jax.devices()[:4])
    if n_model == 1:
        p, _, hist = JaxTrainer(jlm.loss_fn(mesh=jm), optax.sgd(G.LR),
                                mesh=jm, log_every=1).fit(params, G.tokens, 2)
        return [h["loss"] for h in hist], params, p
    opt = optax.sgd(G.LR)
    step = jax_train_step(jlm.loss_fn(mesh=jm, tp=True), opt, mesh=jm,
                          param_shardings=jlm.param_shardings(jm))
    p = jlm.shard_params(params, jm)
    o = opt.init(p)
    losses = []
    with JM.use_mesh(jm):
        for s in range(2):
            p, o, loss = step(p, o, JM.shard_batch(G.tokens(s), jm))
            losses.append(float(loss))
    return losses, params, p


def _check_training(ranks, experts, n_data, n_model):
    want, before, after = _tpudl_steps(experts, n_data, n_model)
    for rank in ranks:
        np.testing.assert_allclose(rank[experts]["losses"], want, rtol=0,
                                   atol=LOSS_TOL)
    got = ranks[0][experts]["params"]
    moved = max(float(np.abs(np.asarray(after[g][k]) - before[g][k]).max())
                for g in before for k in before[g])
    for g in before:
        for k in before[g]:
            np.testing.assert_allclose(got[g][k], np.asarray(after[g][k]),
                                       rtol=0, atol=WEIGHT_TOL * moved,
                                       err_msg=f"{g}.{k}")


@pytest.mark.parametrize("experts", EXPERTS)
def test_2x2_gradients_match_the_local_mesh(grid_2x2, experts):
    _check_grads(grid_2x2, experts, 2, 2)


@pytest.mark.parametrize("experts", EXPERTS)
def test_4x1_ring_gradients_match_the_local_mesh(grid_4x1, experts):
    _check_grads(grid_4x1, experts, 4, 1)


@pytest.mark.parametrize("experts", EXPERTS)
def test_2x2_unsplit_model_gets_the_whole_gradients(grid_2x2, experts):
    """``make_train_step(loss_fn(mesh=, tp=True))`` on a model left whole:
    each rank runs its slice of every split leaf, and the whole leaf on
    every rank gets the gradient of all the row's slices, so the copies
    along a row stay equal."""
    _check_grads([{"coords": r["coords"], experts: r[experts]["unsplit"]}
                  for r in grid_2x2], experts, 2, 2)


@pytest.mark.parametrize("grid", ["grid_2x2", "grid_4x1"])
def test_a_ring_loss_fed_each_ranks_rows_raises(request, grid):
    for rank in request.getfixturevalue(grid):
        got = rank["wrong_batch"]
        assert got["kept"] is True
        assert got["raised"] is not None and "whole_batch" in got["raised"]


@pytest.mark.parametrize("experts", EXPERTS)
def test_whole_leaves_get_equal_gradients_along_a_row(grid_2x2, experts):
    """Embedding, norms, the tied head, ``b_down`` and ``w_gate`` are whole
    on both ranks of a row; their gradients there are the same bits."""
    for r in range(2):
        first = grid_2x2[2 * r][experts]
        second = grid_2x2[2 * r + 1][experts]
        whole = [n for n in first["grads"] if n not in first["dims"]]
        assert "embed.table" in whole and "final_norm.gamma" in whole
        assert ("blocks.0.w_gate" in whole) == bool(experts)
        for name in whole:
            np.testing.assert_array_equal(first["grads"][name],
                                          second["grads"][name], name)
        assert set(first["dims"]) and all(
            not np.array_equal(first["grads"][n], second["grads"][n])
            for n in first["dims"])


@pytest.mark.parametrize("grid", ["grid_2x2", "grid_4x1"])
def test_remat_recomputes_the_same_gradients(request, grid):
    """``loss_fn(remat=True)`` checkpoints each block; its recompute runs
    the block's collectives again inside the backward, and the gradients
    come out the same bits."""
    for rank in request.getfixturevalue(grid):
        assert rank[0]["remat_equal"] and rank[4]["remat_equal"]


@pytest.mark.parametrize("experts", EXPERTS)
def test_2x2_trainer_matches_tpudls_param_shardings_step(grid_2x2, experts):
    _check_training(grid_2x2, experts, 2, 2)


@pytest.mark.parametrize("experts", EXPERTS)
def test_4x1_long_context_trainer_matches_tpudl(grid_4x1, experts):
    _check_training(grid_4x1, experts, 4, 1)
