"""The port's ``CheckpointManager`` against tpudl's: one on-disk format, so
a directory written by either package restores in the other, bit for bit
(f32, int64 and bfloat16 leaves in nested dicts and sequences); tpudl's
cadence, ``max_to_keep``, fallback from a corrupt newest step and
``validate``; and the port's ``Trainer`` saving and resuming a model and
its optimizer exactly where they were."""

import json
import os

import ml_dtypes
import numpy as np
import pytest

import torch

from tpudl.train import CheckpointManager as JaxCheckpointManager
from tpudl_torch.obs import metrics
from tpudl_torch.train import (CheckpointManager, Preempted, Trainer, adam,
                               sgd)
from tpudl_torch.train.checkpoint import as_numpy_state
from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

torch.set_num_threads(1)

ARCH = dict(vocab=64, dim=32, heads=4, layers=2, max_len=64)
MANAGERS = {"tpudl": JaxCheckpointManager, "port": CheckpointManager}


def _numpy_tree():
    """A state tree as tpudl holds it: f32, int64, int32 and bfloat16
    leaves, nested dicts, a list and a tuple, a 0-d step."""
    rng = np.random.default_rng(0)
    return {
        "params": {"dense": {"kernel": rng.normal(size=(3, 4)).astype(
                       np.float32),
                   "bias": rng.normal(size=(4,)).astype(ml_dtypes.bfloat16)},
                   "conv": {"kernel": rng.normal(size=(2, 2, 3, 5)).astype(
                       np.float32)}},
        "opt_state": [{"count": np.asarray(3, np.int32)},
                      (rng.normal(size=(7,)).astype(np.float32),)],
        "step": np.asarray(7, np.int64)}


def _torch_leaf(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return _torch_leaf(np.asarray(tree))


def _bits(leaf) -> tuple:
    """(shape, dtype name, raw bytes) of a numpy or torch leaf."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return (tuple(leaf.shape), "bfloat16",
                    leaf.view(torch.int16).numpy().tobytes())
        leaf = leaf.numpy()
    a = np.asarray(leaf)
    return a.shape, str(a.dtype), a.tobytes()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _leaves(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, x in enumerate(tree)
                for k2, v in _leaves(x, f"{path}/{i}").items()}
    return {path: _bits(tree)}


def _meta(directory, step):
    with np.load(os.path.join(directory, f"ckpt-{step:08d}.npz")) as z:
        return json.loads(bytes(z["__meta__"]).decode())


@pytest.mark.parametrize("writer,reader", [("tpudl", "port"),
                                           ("port", "tpudl")])
def test_a_directory_restores_bit_for_bit_in_the_other_package(
        tmp_path, writer, reader):
    want = _numpy_tree()
    state = want if writer == "tpudl" else _as_torch(want)
    d = str(tmp_path / "c")
    assert MANAGERS[writer](d, save_every=1).save(7, state, force=True)
    got = MANAGERS[reader](d).restore()
    # the like-less rebuild turns the tuple into a list in both packages
    assert _leaves(got) == _leaves(want)


def test_the_port_writes_tpudls_keys_paths_and_manifest(tmp_path):
    want = _numpy_tree()
    JaxCheckpointManager(str(tmp_path / "j"), save_every=1).save(
        7, want, force=True)
    CheckpointManager(str(tmp_path / "p"), save_every=1).save(
        7, _as_torch(want), force=True)
    assert _meta(tmp_path / "p", 7) == _meta(tmp_path / "j", 7)
    for sub in ("j", "p"):
        with open(tmp_path / sub / "ckpt-manifest.json") as f:
            m = json.load(f)
        assert m["schema"] == "tpudl-checkpoint-manifest"
        assert m["version"] == 1 and list(m["checkpoints"]) == ["7"]
        assert m["checkpoints"]["7"]["n_leaves"] == 6


def test_restore_like_places_each_leaf_like_its_reference(tmp_path):
    state = _as_torch(_numpy_tree())
    state["step"] = np.asarray(7, np.int64)
    mgr = CheckpointManager(str(tmp_path / "c"), save_every=1)
    mgr.save(7, state, force=True)
    got = mgr.restore(like=state)
    assert isinstance(got["opt_state"][1], tuple)
    assert isinstance(got["step"], np.ndarray) and int(got["step"]) == 7
    assert got["params"]["dense"]["bias"].dtype == torch.bfloat16
    assert _leaves(got) == _leaves(state)
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(like={"params": state["params"]})


@pytest.mark.parametrize("package", sorted(MANAGERS))
def test_cadence_and_max_to_keep(tmp_path, package):
    mgr = MANAGERS[package](str(tmp_path / "c"), save_every=5,
                            max_to_keep=2)
    state = {"x": np.zeros((), np.float32)}
    assert not mgr.maybe_save(3, state)
    for step in (5, 10, 15):
        assert mgr.maybe_save(step, state)
    assert mgr.latest_step() == 15
    assert sorted(os.listdir(tmp_path / "c")) == [
        "ckpt-00000010.npz", "ckpt-00000015.npz", "ckpt-manifest.json"]


@pytest.mark.parametrize("damage", ["truncate", "bit flip"])
def test_a_corrupt_newest_step_falls_back_to_its_predecessor(tmp_path,
                                                             damage):
    d = tmp_path / "c"
    mgr = CheckpointManager(str(d), save_every=1)
    mgr.save(5, {"w": torch.full((64,), 5.0)}, force=True)
    mgr.save(10, {"w": torch.full((64,), 10.0)}, force=True)
    newest = d / "ckpt-00000010.npz"
    blob = bytearray(newest.read_bytes())
    if damage == "truncate":
        blob = blob[: len(blob) // 2]
    else:
        blob[len(blob) // 2] ^= 0x40
    newest.write_bytes(bytes(blob))
    errs = CheckpointManager(str(d)).validate()
    assert len(errs) == 1 and "ckpt-00000010.npz" in errs[0]
    corrupt = metrics.counter("train.checkpoint.corrupt").value
    got = CheckpointManager(str(d)).restore()
    assert torch.equal(got["w"], torch.full((64,), 5.0))
    assert metrics.counter("train.checkpoint.corrupt").value == corrupt + 1
    assert not newest.exists()
    assert CheckpointManager(str(d)).validate() == []
    # tpudl reads the repaired directory the same way
    np.testing.assert_array_equal(
        JaxCheckpointManager(str(d)).restore()["w"], np.full(64, 5.0,
                                                             np.float32))


def test_nothing_to_restore_is_none(tmp_path):
    assert CheckpointManager(str(tmp_path / "empty")).restore() is None


def test_as_numpy_state():
    state = {"w": torch.ones(2), "h": torch.ones(2, dtype=torch.bfloat16),
             "n": 3}
    got = as_numpy_state(state)
    assert isinstance(got["w"], np.ndarray) and got["w"].dtype == np.float32
    assert got["h"].dtype == torch.bfloat16 and int(got["n"]) == 3


def _lm():
    lm = TinyCausalLM(**ARCH, device="cpu")
    return load_jax_params(lm, lm.init(0))


def _tokens(step):
    return np.random.default_rng(step).integers(
        0, ARCH["vocab"], size=(4, 17)).astype(np.int32)


def _opt_bits(opt):
    return {(i, k): _bits(v) for i, s in opt.state_dict()["state"].items()
            for k, v in s.items()}


def test_the_optimizer_round_trips_bit_for_bit(tmp_path):
    """Adam's step count and both moments come back exactly, and the
    resumed fit continues as an uninterrupted one does."""
    d = str(tmp_path / "c")
    a = _lm()
    _, opt_a, _ = Trainer(a.loss_fn(), adam(1e-2), checkpoint_dir=d,
                          save_every=100).fit(a, _tokens, 3)
    b = _lm()
    restores = metrics.histogram("train.checkpoint_restore_seconds").count
    _, opt_b, hist = Trainer(b.loss_fn(), adam(1e-2), checkpoint_dir=d,
                             save_every=100).fit(b, _tokens, 3)
    assert hist == []  # nothing left to run: all 3 steps were restored
    assert metrics.histogram(
        "train.checkpoint_restore_seconds").count == restores + 1
    assert _opt_bits(opt_b) == _opt_bits(opt_a)
    assert float(opt_b.state_dict()["state"][0]["step"]) == 3.0
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    # 3 + 3 more resumed steps end where 6 straight steps do
    Trainer(b.loss_fn(), adam(1e-2), checkpoint_dir=d,
            save_every=100).fit(b, _tokens, 6)
    c = _lm()
    Trainer(c.loss_fn(), adam(1e-2)).fit(c, _tokens, 6)
    for x, y in zip(b.parameters(), c.parameters()):
        assert torch.equal(x, y)


def test_fit_saves_on_cadence_and_at_the_end(tmp_path):
    d = tmp_path / "c"
    saves = metrics.histogram("train.checkpoint_save_seconds").count
    lm = _lm()
    Trainer(lm.loss_fn(), sgd(0.1), checkpoint_dir=str(d),
            save_every=2).fit(lm, _tokens, 5)
    assert CheckpointManager(str(d))._candidate_steps() == [5, 4, 2]
    assert metrics.histogram(
        "train.checkpoint_save_seconds").count == saves + 3


def test_stop_force_saves_and_raises_preempted(tmp_path):
    d = str(tmp_path / "c")
    lm = _lm()
    seen = []

    def data_fn(step):
        seen.append(step)
        return _tokens(step)

    with pytest.raises(Preempted) as info:
        Trainer(lm.loss_fn(), sgd(0.1), checkpoint_dir=d,
                save_every=100).fit(lm, data_fn, 5,
                                    stop=lambda: len(seen) == 2)
    assert info.value.step == 2 and info.value.saved
    assert str(info.value) == "preempted at step 2"
    assert CheckpointManager(d).latest_step() == 2
    resumed = _lm()
    Trainer(resumed.loss_fn(), sgd(0.1), checkpoint_dir=d).fit(
        resumed, data_fn, 5)
    assert seen == [0, 1, 2, 3, 4]
    straight = _lm()
    Trainer(straight.loss_fn(), sgd(0.1)).fit(straight, _tokens, 5)
    for x, y in zip(resumed.parameters(), straight.parameters()):
        assert torch.equal(x, y)
