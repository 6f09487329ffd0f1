"""The host-only pieces the training slice copies from tpudl, held to
their sources on the same inputs: the retry policy that paces gang
restarts, ``host_shard``, ``pad_batch``/``unpad_batch``,
``model_axis_size``, the checkpoint crc32, and the messages of
``Preempted`` and ``RestartsExhausted``."""

import pickle

import numpy as np
import pytest

from tpudl import distributed as jax_distributed
from tpudl import mesh as jax_mesh
from tpudl.data.shards import _crc32_file as jax_crc32_file
from tpudl.jobs import retry as jax_retry
from tpudl.train import Preempted as JaxPreempted
from tpudl.train import RestartsExhausted as JaxRestartsExhausted
from tpudl_torch import distributed, mesh
from tpudl_torch.jobs import retry
from tpudl_torch.train import Preempted, RestartsExhausted
from tpudl_torch.train.checkpoint import _crc32_file

POLICIES = [dict(), dict(backoff_s=0.3, backoff_factor=3.0, jitter=0.0),
            dict(max_attempts=5, backoff_s=2.0, max_backoff_s=5.0,
                 transient="all"),
            dict(transient=(ValueError,)),
            dict(classify=lambda e: "again" in str(e))]
ERRORS = [OSError("disk"), TimeoutError(), ValueError("again"),
          RuntimeError("x"), TypeError("bug"), KeyboardInterrupt(),
          MemoryError()]


@pytest.mark.parametrize("kw", POLICIES)
def test_retry_policy_matches_tpudl(kw):
    ours = retry.RetryPolicy(seed=3, **kw)
    theirs = jax_retry.RetryPolicy(seed=3, **kw)
    assert ([ours.backoff_s(a) for a in range(1, 8)]
            == [theirs.backoff_s(a) for a in range(1, 8)])
    assert ([ours.is_transient(e) for e in ERRORS]
            == [theirs.is_transient(e) for e in ERRORS])
    assert ours.max_attempts == theirs.max_attempts


def test_is_fatal_matches_tpudl():
    errors = ERRORS + [Preempted(3), JaxPreempted(3), SystemExit()]
    assert ([retry.is_fatal(e) for e in errors]
            == [jax_retry.is_fatal(e) for e in errors])
    assert retry.is_fatal(Preempted(3))


def test_record_counts_retries():
    from tpudl_torch.obs import metrics

    before = metrics.counter("retry.attempts").value
    retry.RetryPolicy().record("train.restart", RuntimeError("x"),
                               attempt=1, backoff_s=0.5)
    assert metrics.counter("retry.attempts").value == before + 1
    assert metrics.counter("retry.train.restart").value >= 1


@pytest.mark.parametrize("n,count", [(10, 3), (7, 2), (2, 4), (0, 3),
                                     (5, 1)])
def test_host_shard_matches_tpudl(n, count):
    items = [f"f{i}" for i in range(n)]
    for index in range(count):
        assert (distributed.host_shard(items, index=index, count=count)
                == jax_distributed.host_shard(items, index=index,
                                              count=count))


def test_global_batch_takes_this_ranks_rows():
    x = np.arange(12).reshape(6, 2)
    parts = [distributed.global_batch(x, index=i, count=3) for i in range(3)]
    np.testing.assert_array_equal(np.concatenate(parts), x)
    # outside a process group there is one rank: the whole batch
    np.testing.assert_array_equal(distributed.global_batch(x), x)
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        distributed.global_batch(x, index=0, count=4)


@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (0, 3), (1, 1)])
def test_pad_and_unpad_match_tpudl(n, multiple):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got, got_pad = mesh.pad_batch(x, multiple)
    want, want_pad = jax_mesh.pad_batch(x, multiple)
    assert got_pad == want_pad
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mesh.unpad_batch(got, got_pad),
                                  jax_mesh.unpad_batch(want, want_pad))


@pytest.mark.parametrize("value", [None, "1", "2", "0", "x"])
def test_model_axis_size_matches_tpudl(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("TPUDL_MESH_MODEL", raising=False)
    else:
        monkeypatch.setenv("TPUDL_MESH_MODEL", value)
    assert mesh.model_axis_size() == jax_mesh.model_axis_size()


def test_crc32_matches_tpudl(tmp_path):
    path = tmp_path / "blob"
    path.write_bytes(np.random.default_rng(0).bytes(3 << 20 | 17))
    assert _crc32_file(str(path)) == jax_crc32_file(str(path))
    assert _crc32_file(str(path), chunk=4096) == jax_crc32_file(str(path))


@pytest.mark.parametrize("saved", [True, False])
def test_preempted_matches_tpudl_and_survives_pickling(saved):
    ours = Preempted(7, saved=saved)
    assert str(ours) == str(JaxPreempted(7, saved=saved))
    back = pickle.loads(pickle.dumps(ours))
    assert (type(back), back.step, back.saved, str(back)) == (
        Preempted, 7, saved, str(ours))
    assert back.tpudl_fatal


def test_restarts_exhausted_matches_tpudl():
    cause = RuntimeError("boom")
    ours, theirs = RestartsExhausted(3, cause), JaxRestartsExhausted(3, cause)
    assert str(ours) == str(theirs)
    assert ours.attempts == 3 and ours.last_cause is cause
    assert isinstance(ours, RuntimeError)
