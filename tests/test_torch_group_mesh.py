"""The process group's grid and its collectives, on the CPU: four gloo
ranks joined by ``initialize`` and ``build_mesh(2, 2)`` (one spawn:
``tests/torch_group_fns.py:mesh_fn``), and a world of one in this process.

- :mod:`tpudl_torch.collectives` over the row: forward values and the
  gradients that come back, against plain sums of the ranks' inputs
  (each rank's input is made from its rank, so every value is exact);
- ``replicate``, ``all_reduce_mean`` over either axis and ``shard_batch``
  by the data-axis index;
- ``ring_attention`` over the data axis with the heads split over the
  model axis, against dense attention on the whole sequence (1e-5 of
  max |value|);
- the Trainer's checkpointed state: the split leaves gathered over each
  row and saved whole by rank 0, read back as each rank's slices,
  optimizer state included, bit for bit;
- tpudl's ``ValueError`` for a grid that does not fit the group, and the
  parts still refused over a group ('LM parallelism').
"""

import os

import numpy as np
import pytest

import torch
import torch.distributed as dist

import torch_group_fns as G
from tpudl_torch import distributed as D
from tpudl_torch import mesh as M
from tpudl_torch.attention import attention_reference
from tpudl_torch.train import CheckpointManager

torch.set_num_threads(1)

RING_TOL = 1e-5   # of max |value|


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh2x2"))
    out = G.run_initialized(G.mesh_fn, 4, 2, tmp,
                            directory=os.path.join(tmp, "ck"))
    return out["collectives"], out["checkpoint"], os.path.join(tmp, "ck")


def test_row_collectives_and_their_gradients(spawned):
    ranks, _, _ = spawned
    for rank, got in enumerate(ranks):
        r, j = got["coords"]
        row = [2 * r, 2 * r + 1]     # the process ranks of this row
        # reduce_sum: the row's sum forward, the gradient unchanged
        y, g = got["reduce_sum"]
        np.testing.assert_array_equal(y, sum(x + 1.0 for x in row))
        np.testing.assert_array_equal(g, rank + 1.0)
        # copy_in: itself forward, the row's gradients summed back
        y, g = got["copy_in"]
        np.testing.assert_array_equal(y, rank + 1.0)
        np.testing.assert_array_equal(g, sum(x + 1.0 for x in row))
        # psum: the row's sum forward, the row's gradients summed back
        y, g = got["psum"]
        np.testing.assert_array_equal(y, sum(x + 1.0 for x in row))
        np.testing.assert_array_equal(g, sum(x + 1.0 for x in row))
        # gather along dim 1: the row's blocks in rank order; each rank
        # gets back its own columns of the gradient
        y, g = got["gather"]
        np.testing.assert_array_equal(
            y, np.concatenate([np.full((2, 3), x + 1.0) for x in row], 1))
        np.testing.assert_array_equal(
            g, np.arange(12.0).reshape(2, 6)[:, 3 * j:3 * j + 3])
        # all_to_all: block k of dim 0 to rank k; the gradient comes back
        # weighted by the rank that holds it
        y, g = got["all_to_all"]
        want = np.concatenate([np.repeat(
            np.arange(4.0)[2 * j:2 * j + 2] + 10 * x, 3).reshape(2, 3)
            for x in row])
        np.testing.assert_array_equal(y, want)
        np.testing.assert_array_equal(
            g, np.repeat(np.repeat([x + 1.0 for x in row], 2), 3)
            .reshape(4, 3))


def test_replicate_reductions_and_batch_go_by_axis(spawned):
    ranks, _, _ = spawned
    for rank, got in enumerate(ranks):
        r, j = got["coords"]
        np.testing.assert_array_equal(got["replicate"], j)   # column's first
        np.testing.assert_array_equal(got["mean_model"], 2 * r + 0.5)
        np.testing.assert_array_equal(got["mean_data"], (j + j + 2) / 2)
        np.testing.assert_array_equal(got["batch"], np.arange(4 * r,
                                                              4 * r + 4))


def test_ring_attention_over_the_group_matches_dense(spawned):
    ranks, _, _ = spawned
    q, k, v, go = (t.clone().requires_grad_() for t in G.ring_inputs())
    want = attention_reference(q, k, v, causal=True)
    (want * go).sum().backward()
    rows = [ranks[0], ranks[2]]   # one rank a data index; heads whole
    for i, want_t in enumerate((want.detach(), q.grad, k.grad, v.grad)):
        got = np.concatenate([rk["ring"][i] for rk in rows], axis=1)
        if i:    # gradients: each rank's heads; the others' are 0
            got = sum(np.concatenate([ranks[2 * r + j]["ring"][i]
                                      for r in range(2)], axis=1)
                      for j in range(2))
        w = want_t.numpy()
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=RING_TOL * np.abs(w).max())


def test_sharded_checkpoint_is_whole_on_disk_and_slices_come_back(spawned):
    _, ranks, directory = spawned
    whole = CheckpointManager(directory).restore()
    assert whole["params"]["blocks.0.wq"].shape == (32, 32)
    wq = ranks[0]["wq"]   # blocks.0.wq's index among the parameters
    assert whole["opt_state"]["state"][wq]["exp_avg"].shape == (32, 32)
    for got in ranks:
        j = got["coords"][1]
        for key, mine in got["params"].items():
            np.testing.assert_array_equal(got["restored"][key], mine, key)
            saved = whole["params"][key].numpy()
            if saved.shape != mine.shape:   # a split leaf: slice j of it
                axis = [a != b for a, b in zip(saved.shape,
                                               mine.shape)].index(True)
                saved = np.split(saved, 2, axis=axis)[j]
            np.testing.assert_array_equal(saved, mine, key)
        for key, mine in got["opt_wq"].items():
            np.testing.assert_array_equal(got["restored_opt_wq"][key], mine,
                                          key)
        np.testing.assert_array_equal(
            np.split(whole["opt_state"]["state"][wq]["exp_avg"].numpy(), 2,
                     axis=1)[j], got["opt_wq"]["exp_avg"])
    assert sorted(os.listdir(directory)) == ["ckpt-00000001.npz",
                                             "ckpt-manifest.json"]


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_grid_must_hold_the_group_and_stays_refused_where_unported(
        world_of_one):
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 1"):
        M.build_mesh(2, 2)
    mesh = M.build_mesh(1, 1)
    assert (mesh.shape, mesh.coords, mesh.world) == (
        {"data": 1, "model": 1}, (0, 0), 1)
    assert mesh.axis_group("data") is dist.group.WORLD
    net = G.lm("cpu")
    with pytest.raises(NotImplementedError, match="'LM parallelism'"):
        net.generate(torch.zeros((1, 2), dtype=torch.int32), 2, mesh=mesh)
    with pytest.raises(NotImplementedError, match="'LM parallelism'"):
        net.apply_pipelined(torch.zeros((2, 4), dtype=torch.int64), mesh)
    # a world of one over the group equals the run without a mesh
    t = torch.from_numpy(G.tokens(0))
    with torch.no_grad():
        np.testing.assert_array_equal(net.apply(t, mesh=mesh).numpy(),
                                      net.apply(t).numpy())
    assert D.process_count() == 1
