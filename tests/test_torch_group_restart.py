"""A gang restart under a model axis: ``HorovodRunner(np=4)`` under
``TPUDL_MESH_MODEL=2`` (four gloo ranks in a ``(2, 2)`` grid) trains the
MoE LM's (``experts=4``: attention and experts split) ``loss_fn(mesh=,
tp=True)`` with ``param_shardings=`` and a checkpoint every step; the last rank fails once mid-run, every rank is
relaunched (its sub-groups made anew) and resumes from the checkpoint,
whose split leaves were gathered over rank 0's row and written whole.
The resumed run is held to an uninterrupted one bit for bit: the
checkpoint holds every bit of the state, and the same ops run on the same
inputs in the same order.
"""

import numpy as np
import pytest

import torch

import torch_group_fns as G
from tpudl_torch.obs import metrics
from tpudl_torch.train import HorovodRunner, RestartsExhausted

torch.set_num_threads(1)


def test_gang_restart_under_a_model_axis_equals_an_uninterrupted_run(
        tmp_path, monkeypatch, experts=4):
    monkeypatch.setenv("TPUDL_MESH_MODEL", "2")
    monkeypatch.setenv("TPUDL_TRAIN_RESTART_BACKOFF_S", "0")
    restarts = metrics.counter("train.restarts").value
    resumed = HorovodRunner(np=-4, device="cpu", max_restarts=1,
                            checkpoint_dir=str(tmp_path / "ck")).run(
        G.train_fn, experts=experts, steps=4, fail_at=2)
    assert metrics.counter("train.restarts").value == restarts + 1
    straight = HorovodRunner(np=-4, device="cpu").run(
        G.train_fn, experts=experts, steps=4)
    for got, want in zip(resumed, straight):
        assert got["coords"] == want["coords"]
        assert len(got["losses"]) == 2   # steps 3..4; 1..2 were restored
        assert got["losses"] == want["losses"][2:]
    for g, group in straight[0]["params"].items():
        for k, want in group.items():
            np.testing.assert_array_equal(resumed[0]["params"][g][k], want,
                                          err_msg=f"{g}.{k}")


def test_a_failing_grid_exhausts_its_restarts(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDL_MESH_MODEL", "2")
    monkeypatch.setenv("TPUDL_TRAIN_RESTART_BACKOFF_S", "0")
    with pytest.raises(RestartsExhausted) as info:
        HorovodRunner(np=-4, device="cpu", max_restarts=0).run(
            G.train_fn, steps=2, fail_at=0)
    assert "injected failure at step 0" in str(info.value)
