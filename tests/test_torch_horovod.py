"""The port's ``HorovodRunner`` on the CPU: ranks as real processes (gloo),
the data-parallel step and the runner's contract (checkpoints across a
preemption and gang restarts: ``tests/test_torch_horovod_restart.py``).
This file imports only torch, numpy and ``tpudl_torch``: a spawned rank
imports it to find its ``train_fn``, and must not pull in jax or tpudl
(``tests/test_torch_boundary.py`` checks that).

Tolerances (readings on these inputs when the file was written):
- 2 ranks against 1 rank on the global batch: the gradient is the mean
  of two half-batch gradients instead of one mean over the batch, so
  sums run in another order. The small LM (adam, lr 1e-2, 4 steps):
  losses within 1e-5 (read 4.8e-7), parameters within 1e-5 (read
  1.9e-6; adam divides by √v̂, so rounding moves an update by up to its
  relative error times lr). ResNet50 at 32×32 (sgd 0.05, 2 steps):
  losses within 1e-5 (read 9.5e-7), parameters within 1e-6 (read
  1.5e-8).
"""

import numpy as np
import pytest

import torch
import torch.distributed as dist

from tpudl_torch import distributed as D
from tpudl_torch import mesh as M
from tpudl_torch.train import HorovodRunner, RestartsExhausted, adam, sgd
from tpudl_torch.zoo.registry import ImageModel, getKerasApplicationModel
from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

torch.set_num_threads(1)

ARCH = dict(vocab=64, dim=32, heads=4, layers=2, max_len=64)
LM_TOL = 1e-5
RESNET_LOSS_TOL = 1e-5
RESNET_PARAM_TOL = 1e-6


def _tokens(step):
    return np.random.default_rng(step).integers(
        0, ARCH["vocab"], size=(4, 17)).astype(np.int32)


def _lm(device):
    lm = TinyCausalLM(**ARCH, device=device)
    return load_jax_params(lm, lm.init(0))


def _numpy(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


# -- train_fns (module level: a spawned rank imports them by name) -------
def lm_train_fn(ctx, steps=4, stop_at=None, fail_at=None):
    """The small LM under adam; returns (losses, params) of rank 0.
    ``fail_at`` raises on rank ``ctx.size - 1`` at that step on the first
    attempt only; ``stop_at`` asks to stop before that step."""
    lm = _lm(ctx.device)

    def data_fn(step):
        if (fail_at is not None and step == fail_at and ctx.attempt == 0
                and ctx.rank == ctx.size - 1):
            raise RuntimeError(f"injected failure at step {step}")
        return _tokens(step)

    calls = []

    def stop():
        calls.append(None)
        return stop_at is not None and len(calls) > stop_at

    _, _, hist = ctx.trainer(lm.loss_fn(), adam(1e-2), log_every=1,
                             save_every=2).fit(lm, data_fn, steps, stop=stop)
    return [h["loss"] for h in hist], _numpy(lm)


def resnet_train_fn(ctx, steps=2):
    model = getKerasApplicationModel("ResNet50")
    net = ImageModel(model, model.init(0, image_size=(32, 32)),
                     device=ctx.device)
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 256, size=(steps, 2, 32, 32, 3), dtype=np.uint8)
    ys = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, (steps, 2))]

    def loss_fn(net, x, y):
        x = (x.float() - 127.5) / 127.5
        logp = torch.log(torch.clamp(net.predict(x), 1e-7, 1.0))
        return -torch.mean(torch.sum(y * logp, dim=-1))

    _, _, hist = ctx.trainer(loss_fn, sgd(0.05), log_every=1).fit(
        net, lambda s: (xs[s], ys[s]), steps)
    return [h["loss"] for h in hist], _numpy(net)


def rank_report(ctx, a, b=0):
    """Every rank's (rank, size, a + b), gathered to rank 0."""
    out = [None] * ctx.size
    dist.all_gather_object(out, (ctx.rank, ctx.size, a + b))
    return out


def loaded_modules(ctx):
    """The jax, tpudl, ml_dtypes and keras modules each rank holds."""
    import sys

    bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                 and m.split(".")[0] in ("jax", "tpudl", "ml_dtypes",
                                         "keras"))
    out = [None] * ctx.size
    dist.all_gather_object(out, bad)
    return out


def uneven_batch_fn(ctx):
    lm = _lm(ctx.device)
    ctx.trainer(lm.loss_fn(), sgd(0.1)).fit(lm, lambda s: _tokens(s)[:3], 1)


# -- tests ------------------------------------------------------------------
def _close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_two_ranks_equal_one_rank_on_the_global_batch_lm():
    one_loss, one = HorovodRunner(np=-1, device="cpu").run(lm_train_fn)
    two_loss, two = HorovodRunner(np=-2, device="cpu").run(lm_train_fn)
    np.testing.assert_allclose(two_loss, one_loss, rtol=0, atol=LM_TOL)
    _close(two, one, LM_TOL)
    assert not np.array_equal(one["blocks.0.wq"],
                              _numpy(_lm("cpu"))["blocks.0.wq"])


def test_two_ranks_equal_one_rank_on_the_global_batch_resnet50():
    one_loss, one = HorovodRunner(np=-1, device="cpu").run(resnet_train_fn)
    two_loss, two = HorovodRunner(np=-2, device="cpu").run(resnet_train_fn)
    np.testing.assert_allclose(two_loss, one_loss, rtol=0,
                               atol=RESNET_LOSS_TOL)
    _close(two, one, RESNET_PARAM_TOL)
    # the moving statistics are trained like every other leaf
    init = getKerasApplicationModel("ResNet50").init(0)
    moved = one["layers.conv1_bn.moving_mean"] - init["conv1_bn"][
        "moving_mean"]
    assert np.abs(moved).max() > 0


def test_rank_size_and_kwargs_contract():
    assert HorovodRunner(np=-2, device="cpu").run(
        rank_report, a=1, b=2) == [(0, 2, 3), (1, 2, 3)]
    assert HorovodRunner(device="cpu").run(rank_report, a=1) == [(0, 1, 1)]


def test_np_too_large_raises():
    with pytest.raises(ValueError, match="needs 4096 devices, have"):
        HorovodRunner(np=4096, device="cpu").run(rank_report, a=0)


def test_card_is_the_default_and_is_never_replaced(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        HorovodRunner(np=1).run(rank_report, a=0)


def test_a_batch_that_does_not_split_raises():
    with pytest.raises(RestartsExhausted) as info:
        HorovodRunner(np=-2, device="cpu").run(uneven_batch_fn)
    cause = info.value.__cause__
    assert isinstance(cause, ValueError) and cause is info.value.last_cause
    assert "does not split over 2 ranks" in str(cause)


def test_a_model_axis_is_refused(monkeypatch):
    """A model axis over ranks (once refused, 'LM parallelism') folds the
    ranks into a ``(np/m, m)`` grid, tpudl's ``_build_mesh``: ``np=-4``
    under ``TPUDL_MESH_MODEL=2`` runs four ranks at the entries ``(r, j)``
    of rank ``2r + j``, ``ctx.size`` the data axis. What stays refused is
    an ``np`` the model axis does not divide (tpudl's ``ValueError``); and
    ``build_mesh()`` outside a group is a local grid of the visible cards,
    which raises on a host with none."""
    from torch_group_fns import grid_report

    monkeypatch.setenv("TPUDL_MESH_MODEL", "2")
    assert HorovodRunner(np=-4, device="cpu").run(grid_report) == [
        (2 * r + j, 2, (r, j), {"data": 2, "model": 2}, "cpu")
        for r in range(2) for j in range(2)]
    with pytest.raises(ValueError, match="3 devices do not divide into "
                       "TPUDL_MESH_MODEL=2 model shards"):
        HorovodRunner(np=-3, device="cpu").run(rank_report, a=0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        M.build_mesh()
    assert M.build_mesh(devices=["cpu"] * 4).shape == {"data": 2,
                                                       "model": 2}


def test_initialize_refuses_another_machine_and_no_args_is_a_no_op():
    D.initialize()
    assert not dist.is_initialized() and D.process_count() == 1
    assert D.is_primary()
    # a coordinator on another machine is accepted now (once refused,
    # 'Training, rest'; tests/test_torch_mesh_data.py joins one); what is
    # refused is a rendezvous that is neither tcp, file nor env
    with pytest.raises(ValueError, match="tcp://<host>:<port>"):
        D.initialize("udp://10.1.2.3:29500", 2, 0)
    assert not dist.is_initialized()


def test_run_refuses_a_process_that_holds_a_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="already holds one"):
            HorovodRunner(device="cpu").run(rank_report, a=0)
        assert dist.is_initialized()  # the caller's group is left alone
    finally:
        dist.destroy_process_group()
