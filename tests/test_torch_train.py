"""The port's LM training path against tpudl's, from the same ``init(0)``
pytree at a small width (vocab 64, dim 32, heads 4, layers 2, tokens
[4, 33]): ``TinyCausalLM.loss_fn`` value and gradients, the optimizers,
and ``Trainer`` runs of 5 steps under adamw, adam and sgd.

Tolerances, all f32 on the CPU with sums in another order (readings
taken on this test's inputs when it was written):
- loss within 5e-6 absolute (losses near 4.17 differed by up to 9.5e-7);
- parameter gradients within 1e-6 absolute (up to 8.6e-8; gradients up
  to 0.12);
- Trainer losses within 5e-6 (up to 9.5e-7); final params within 5e-5
  under adam/adamw at lr 1e-2 (up to 9.9e-6: adam divides by √v̂, so a
  small gradient's rounding moves its update by up to its relative
  error times lr) and within 2e-6 under sgd (up to 2.5e-7);
- the optimizers alone, on the same gradients: 1e-6 (one update of
  O(1) params in another order of operations);
- ``remat=True`` against ``remat=False``: equal, bit for bit (the
  recomputed forward runs the same ops on the same inputs)."""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl.train import Trainer as JaxTrainer
from tpudl.zoo.transformer import TinyCausalLM as JaxLM
from tpudl_torch import cuda_ops
from tpudl_torch.obs import metrics
from tpudl_torch.train import (Preempted, Trainer, adam, adamw,
                               make_train_step, sgd)
from tpudl_torch.zoo.transformer import (TinyCausalLM, _param_groups,
                                         to_jax_params)

# the suite runs several pytest workers on the same cores: one torch
# thread per worker avoids oversubscribing them
torch.set_num_threads(1)

ARCH = dict(vocab=64, dim=32, heads=4, layers=2, max_len=64)
LOSS_TOL = 5e-6
GRAD_TOL = 1e-6
OPTIMIZERS = {  # name → (optax, port, final-param tolerance)
    "adamw": (optax.adamw(1e-2), adamw(1e-2), 5e-5),
    "adam": (optax.adam(1e-2), adam(1e-2), 5e-5),
    "sgd": (optax.sgd(0.5), sgd(0.5), 2e-6),
}


@pytest.fixture(scope="module")
def params():
    return JaxLM(**ARCH).init(0)


def _model(params):
    return TinyCausalLM.from_jax_params(params, device="cpu", **ARCH)


def _tokens(seed, b=4, s=33):
    return np.random.default_rng(seed).integers(
        0, ARCH["vocab"], size=(b, s)).astype(np.int32)


def _grads(model):
    return {name: {k: p.grad.numpy() for k, p in group.items()}
            for name, group in _param_groups(model).items()}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_grads_match_tpudl(params, use_pallas):
    jlm = JaxLM(**ARCH)
    toks = _tokens(0)
    want_loss, want_grads = jax.value_and_grad(
        jlm.loss_fn(use_pallas=use_pallas))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(toks))
    model = _model(params)
    loss = model.loss_fn(use_pallas=use_pallas)(model, torch.from_numpy(toks))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    got = _grads(model)
    assert sorted(got) == sorted(want_grads)
    for name in want_grads:
        for key, w in want_grads[name].items():
            np.testing.assert_allclose(got[name][key], np.asarray(w),
                                       rtol=0, atol=GRAD_TOL,
                                       err_msg=f"{name}.{key}")


def test_remat_equals_no_remat_and_reruns_the_forward(params, monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = (cuda_ops.flash_attention_plain,
                cuda_ops.flash_attention_bwd_plain)

    def count_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(cuda_ops, "flash_attention_plain", count_fwd)
    monkeypatch.setattr(cuda_ops, "flash_attention_bwd_plain", count_bwd)
    toks = torch.from_numpy(_tokens(1))
    runs = {}
    for remat in (False, True):
        calls.update(fwd=0, bwd=0)
        model = _model(params)
        loss = model.loss_fn(remat=remat)(model, toks)
        loss.backward()
        runs[remat] = (loss.detach(), _grads(model), dict(calls))
    layers = ARCH["layers"]
    assert runs[False][2] == {"fwd": layers, "bwd": layers}
    assert runs[True][2] == {"fwd": 2 * layers, "bwd": layers}
    assert torch.equal(runs[False][0], runs[True][0])
    for name, group in runs[False][1].items():
        for key, g in group.items():
            np.testing.assert_array_equal(runs[True][1][name][key], g)


def _data_fn(step):
    return _tokens(100 + step)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_trainer_matches_tpudl(params, name):
    jax_opt, port_opt, param_tol = OPTIMIZERS[name]
    jlm = JaxLM(**ARCH)
    want_params, _, want_hist = JaxTrainer(
        jlm.loss_fn(), jax_opt, log_every=1).fit(params, _data_fn, 5)
    model = _model(params)
    got_model, optimizer, got_hist = Trainer(
        model.loss_fn(), port_opt, log_every=1).fit(model, _data_fn, 5)
    assert got_model is model and isinstance(optimizer, torch.optim.Optimizer)
    assert [h["step"] for h in got_hist] == [h["step"] for h in want_hist]
    assert all(h["examples_per_sec"] > 0 for h in got_hist)
    np.testing.assert_allclose([h["loss"] for h in got_hist],
                               [h["loss"] for h in want_hist], rtol=0,
                               atol=LOSS_TOL)
    got_params = to_jax_params(model)
    for group in want_params:
        for key, w in want_params[group].items():
            np.testing.assert_allclose(got_params[group][key],
                                       np.asarray(w), rtol=0,
                                       atol=param_tol,
                                       err_msg=f"{group}.{key}")


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_optax(name):
    jax_opt, port_opt, _ = OPTIMIZERS[name]
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(3, 5)).astype(np.float32)
    grads = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(3)]
    want, state = jnp.asarray(p0), jax_opt.init(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = port_opt([param])
    for g in grads:
        updates, state = jax_opt.update(jnp.asarray(g), state, want)
        want = want + updates
        param.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def test_adamw_carries_optax_decay():
    opt = adamw(3e-4)([torch.nn.Parameter(torch.zeros(1))])
    assert opt.defaults["weight_decay"] == 1e-4
    assert opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["eps"] == 1e-8


@pytest.mark.parametrize("log_every,steps,logged", [(0, 5, [5]),
                                                    (2, 5, [2, 4, 5]),
                                                    (1, 3, [1, 2, 3]),
                                                    (0, 0, [])])
def test_history_cadence_matches_tpudl(params, log_every, steps, logged):
    model = _model(params)
    _, _, hist = Trainer(model.loss_fn(), sgd(0.1),
                         log_every=log_every).fit(model, _data_fn, steps)
    assert [h["step"] for h in hist] == logged
    _, _, want = JaxTrainer(JaxLM(**ARCH).loss_fn(), optax.sgd(0.1),
                            log_every=log_every).fit(params, _data_fn, steps)
    assert [h["step"] for h in want] == logged


def test_opt_state_continues_a_run(params):
    """Two fits of 2 and 3 steps, the second given the first's optimizer,
    end where one fit of 5 steps does (adam's moments carry over)."""
    whole = _model(params)
    Trainer(whole.loss_fn(), adam(1e-2)).fit(whole, _data_fn, 5)
    split = _model(params)
    trainer = Trainer(split.loss_fn(), adam(1e-2))
    _, opt, _ = trainer.fit(split, _data_fn, 2)
    trainer.fit(split, lambda s: _data_fn(s + 2), 3, opt_state=opt)
    for a, b in zip(whole.parameters(), split.parameters()):
        assert torch.equal(a, b)


def test_stop_raises_preempted(params):
    model = _model(params)
    seen = []

    def data_fn(step):
        seen.append(step)
        return _data_fn(step)

    trainer = Trainer(model.loss_fn(), sgd(0.1), log_every=1)
    with pytest.raises(Preempted) as info:
        trainer.fit(model, data_fn, 5, stop=lambda: len(seen) == 2)
    assert info.value.step == 2 and info.value.saved is False
    assert "NOT saved" in str(info.value)
    assert seen == [0, 1] and [h["step"] for h in trainer.history] == [1, 2]


def test_fit_publishes_train_metrics(params):
    before = {k: metrics.counter(k).value
              for k in ("train.steps", "train.examples")}
    steps_seen = metrics.histogram("train.step_seconds").count
    model = _model(params)
    Trainer(model.loss_fn(), sgd(0.1)).fit(model, _data_fn, 3)
    assert metrics.counter("train.steps").value - before["train.steps"] == 3
    assert (metrics.counter("train.examples").value
            - before["train.examples"]) == 12
    assert metrics.histogram("train.step_seconds").count - steps_seen == 3
    assert metrics.gauge("train.last_step").value == 3


def test_train_step_returns_a_detached_loss(params):
    model = _model(params)
    step = make_train_step(model.loss_fn())
    opt = sgd(0.1)(model.parameters())
    before = model.embed["table"].detach().clone()
    loss = step(model, opt, torch.from_numpy(_tokens(3)))
    assert not loss.requires_grad and loss.shape == ()
    assert not torch.equal(before, model.embed["table"])


def test_float32_step_switches_tf32_off_while_it_runs(params, monkeypatch):
    """tpudl's train step computes in f32: a float32 model's step (forward,
    backward and update) runs with TF32 off for cuBLAS and cuDNN, whatever
    the caller allowed, and the caller's setting comes back after."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    model = _model(params)
    loss_fn = model.loss_fn()
    seen = []

    def spy(m, *batch):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return loss_fn(m, *batch)

    Trainer(spy, sgd(0.1)).fit(model, _tokens, 2)
    assert seen == [(False, False)] * 2
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_to_jax_params_inverts_load(params):
    got = to_jax_params(_model(params))
    assert sorted(got) == sorted(params)
    for group in params:
        assert sorted(got[group]) == sorted(params[group])
        for key, w in params[group].items():
            assert got[group][key].dtype == w.dtype
            np.testing.assert_array_equal(got[group][key], w)


@pytest.mark.parametrize("call,item", [
    ("trainer_param_shardings", "LM parallelism"),
    ("step_param_shardings", "LM parallelism"),
    ("loss_tp", "LM parallelism"),
    ("loss_mesh", "LM parallelism")])
def test_unported_training_options_raise(params, call, item):
    model = _model(params)
    loss = model.loss_fn()
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1, '{item}'"):
        if call.startswith("trainer_"):
            Trainer(loss, sgd(0.1), **{call[8:]: object()})
        elif call.startswith("step_"):
            make_train_step(loss, **{call[5:]: object()})
        elif call == "loss_tp":
            model.loss_fn(tp=True)
        else:
            model.loss_fn(mesh=object())
