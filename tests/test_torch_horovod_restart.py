"""The port's ``HorovodRunner`` across failures, on the CPU with two gloo
ranks: a preemption is never restarted and its checkpoint resumes; a
gang restart resumes from the newest checkpoint; an exhausted restart
budget names its cause. Like ``tests/test_torch_horovod.py``, this file
imports only torch, numpy and ``tpudl_torch`` (a spawned rank imports
it).

A resumed run is held to an uninterrupted one bit for bit: the
checkpoint holds every bit of the state, and the same ops run on the
same inputs in the same order."""

import numpy as np
import pytest

import torch
import torch.distributed as dist

from test_torch_horovod import lm_train_fn
from tpudl_torch.obs import metrics
from tpudl_torch.train import HorovodRunner, Preempted, RestartsExhausted

torch.set_num_threads(1)


class RankFailure(Exception):
    """Raised on one rank: its type must survive the trip to the runner."""


def failing_rank_fn(ctx):
    if ctx.rank == 1:
        raise RankFailure("rank 1 gave up")
    dist.barrier()  # rank 0 waits for its sibling, which never comes


def test_preempted_is_not_restarted_and_its_checkpoint_resumes(tmp_path):
    restarts = metrics.counter("train.restarts").value
    runner = HorovodRunner(np=-2, device="cpu", max_restarts=3,
                           checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(Preempted) as info:
        runner.run(lm_train_fn, steps=6, stop_at=3)
    assert info.value.step == 3 and info.value.saved
    assert "NOT saved" not in str(info.value)
    assert metrics.counter("train.restarts").value == restarts
    resumed_loss, resumed = runner.run(lm_train_fn, steps=6)
    assert len(resumed_loss) == 3  # steps 4..6 ran; 1..3 were restored
    _, straight = HorovodRunner(np=-2, device="cpu").run(lm_train_fn,
                                                          steps=6)
    for k in straight:
        np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)


def test_gang_restart_resumes_from_the_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDL_TRAIN_RESTART_BACKOFF_S", "0")
    restarts = metrics.counter("train.restarts").value
    backoffs = metrics.histogram("train.restart_backoff_s").count
    runner = HorovodRunner(np=-2, device="cpu", max_restarts=1,
                           checkpoint_dir=str(tmp_path / "ck"))
    losses, recovered = runner.run(lm_train_fn, steps=8, fail_at=5)
    assert [len(losses)] == [4]  # resumed at the step-4 checkpoint
    assert metrics.counter("train.restarts").value == restarts + 1
    assert metrics.histogram("train.restart_backoff_s").count == backoffs + 1
    _, straight = HorovodRunner(np=-2, device="cpu").run(lm_train_fn,
                                                          steps=8)
    for k in straight:
        np.testing.assert_array_equal(recovered[k], straight[k], err_msg=k)


def test_restarts_exhausted_carries_its_cause(monkeypatch):
    monkeypatch.setenv("TPUDL_TRAIN_RESTART_BACKOFF_S", "0")
    restarts = metrics.counter("train.restarts").value
    with pytest.raises(RestartsExhausted, match="rank 1 gave up") as info:
        HorovodRunner(np=-2, device="cpu", max_restarts=1).run(
            failing_rank_fn)
    assert info.value.attempts == 2
    cause = info.value.__cause__
    assert isinstance(cause, RankFailure) and cause is info.value.last_cause
    assert any("raised on rank 1" in n for n in cause.__notes__)
    assert metrics.counter("train.restarts").value == restarts + 1


def test_ranks_failing_in_one_clock_tick_raise_the_first_ranks():
    """Two spawned ranks preempted in the same clock tick: the runner
    raises rank 0's exception (it once sorted the exceptions themselves
    on the tie, and raised ``TypeError``)."""
    import pickle

    from tpudl_torch.train.runner import _earliest_failure

    done = {1: ("err", 5.0, pickle.dumps(Preempted(3, saved=True))),
            0: ("err", 5.0, pickle.dumps(Preempted(2, saved=True))),
            2: ("ok", 4.0, pickle.dumps(None))}
    first = _earliest_failure(done)
    assert isinstance(first, Preempted) and first.step == 2
    done[1] = ("err", 4.5, done[1][2])
    assert _earliest_failure(done).step == 3
    assert _earliest_failure({0: ("ok", 1.0, pickle.dumps(7))}) is None
