"""Training the port's TinyCausalLM over a local mesh against tpudl's over
its mesh: the ring loss and its gradients (``loss_fn(mesh=, remat=True)``;
without ``remat`` through the Trainer), README's long-context recipe
(``Trainer(lm.loss_fn(mesh=mesh), ..., mesh=mesh)``) and the
tensor/expert-parallel step (``make_train_step``/``Trainer``
``(param_shardings=)``).

tpudl runs on conftest's 8 host devices (a 4-entry data axis, the (4, 2)
mesh for ``param_shardings``), jitted, its ring through the Pallas kernel
in interpret mode; the port runs on ``["cpu"] * n`` meshes with the plain
kernels. Both read the same ``init(0)`` pytree at vocab 64, dim 32, 2
heads (head_dim 16), 2 layers, and the same seeded numpy rows of 65
tokens (64 in, 64 targets).

Tolerances: losses within 1e-5 of the loss, gradients within 1e-4 of the
largest gradient, weights after sgd steps within 1e-4 of the largest
weight change.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl import mesh as JM
from tpudl.train import Trainer as JaxTrainer
from tpudl.train import make_train_step as jax_train_step
from tpudl.zoo.transformer import TinyCausalLM as JaxLM
from tpudl_torch import mesh as M
from tpudl_torch.train import Trainer, make_train_step, sgd
from tpudl_torch.zoo.transformer import TinyCausalLM, to_jax_params

torch.set_num_threads(1)

ARCH = dict(vocab=64, dim=32, heads=2, layers=2, max_len=96)
LOSS_TOL = 1e-5   # of the loss
GRAD_TOL = 1e-4   # of the largest gradient / weight change
LR = 0.1


def _tokens(step, b=4, s=65):
    return np.random.default_rng(step).integers(
        0, ARCH["vocab"], size=(b, s)).astype(np.int32)


def _close_tree(got, want, tol, scale=None):
    scale = scale or max(float(np.abs(np.asarray(w)).max())
                         for g in want.values() for w in g.values())
    for group in want:
        for key in want[group]:
            np.testing.assert_allclose(np.asarray(got[group][key]),
                                       np.asarray(want[group][key]),
                                       rtol=0, atol=tol * scale,
                                       err_msg=f"{group}.{key}")


def _grads(model):
    out = {"embed": {"table": model.embed["table"].grad.numpy()},
           "final_norm": {k: p.grad.numpy()
                          for k, p in model.final_norm.items()}}
    for i, p in enumerate(model.blocks):
        out[f"block_{i}"] = {k: t.grad.numpy() for k, t in p.items()}
    return out


def test_ring_loss_and_grads_match_tpudl(remat=True):
    jlm = JaxLM(**ARCH)
    params = jlm.init(0)
    jmesh = JM.build_mesh(devices=jax.devices()[:4])
    toks = _tokens(0)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        jlm.loss_fn(mesh=jmesh, use_pallas=True, remat=remat)))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(toks))
    tlm = TinyCausalLM.from_jax_params(params, device="cpu", **ARCH)
    loss = tlm.loss_fn(mesh=M.build_mesh(devices=["cpu"] * 4),
                       use_pallas=True, remat=remat)(
        tlm, torch.from_numpy(toks))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL * float(want_loss)
    _close_tree(_grads(tlm), want_g, GRAD_TOL)


def test_long_context_trainer_matches_tpudl():
    """README's recipe: ``Trainer(lm.loss_fn(mesh=mesh), opt, mesh=mesh)``,
    3 sgd steps; the port steps once over the whole batch with the ring
    inside the loss."""
    jlm = JaxLM(**ARCH)
    params = jlm.init(0)
    jmesh = JM.build_mesh(devices=jax.devices()[:4])
    want_p, _, want_hist = JaxTrainer(
        jlm.loss_fn(mesh=jmesh), optax.sgd(LR), mesh=jmesh,
        log_every=1).fit(params, _tokens, 3)
    mesh = M.build_mesh(devices=["cpu"] * 4)
    tlm = TinyCausalLM.from_jax_params(params, device="cpu", **ARCH)
    _, _, hist = Trainer(tlm.loss_fn(mesh=mesh), sgd(LR), mesh=mesh,
                         log_every=1).fit(tlm, _tokens, 3)
    got = [h["loss"] for h in hist]
    want = [h["loss"] for h in want_hist]
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=0)
    moved = max(float(np.abs(np.asarray(want_p[g][k]) - params[g][k]).max())
                for g in params for k in params[g])
    _close_tree(to_jax_params(tlm), want_p, GRAD_TOL, scale=moved)


_TPUDL_TP_STEPS: dict = {}


def _tpudl_tp_steps(experts, mesh4x2):
    """tpudl's two ``param_shardings`` sgd steps (made once an arch):
    (params, losses, params after)."""
    if experts not in _TPUDL_TP_STEPS:
        jlm = JaxLM(**dict(ARCH, experts=experts))
        params = jlm.init(0)
        opt = optax.sgd(LR)
        step = jax_train_step(jlm.loss_fn(mesh=mesh4x2, tp=True), opt,
                              mesh=mesh4x2,
                              param_shardings=jlm.param_shardings(mesh4x2))
        p = jlm.shard_params(params, mesh4x2)
        o = opt.init(p)
        losses = []
        with JM.use_mesh(mesh4x2):
            for s in range(2):
                p, o, loss = step(p, o, JM.shard_batch(_tokens(s), mesh4x2))
                losses.append(float(loss))
        _TPUDL_TP_STEPS[experts] = params, losses, p
    return _TPUDL_TP_STEPS[experts]


@pytest.mark.parametrize("experts,trainer", [(0, False), (0, True),
                                             (4, False)])
def test_param_shardings_step_matches_tpudl(mesh4x2, experts, trainer):
    arch = dict(ARCH, experts=experts)
    params, want, p = _tpudl_tp_steps(experts, mesh4x2)
    mesh = M.build_mesh(4, 2, devices=["cpu"] * 8)
    tlm = TinyCausalLM.from_jax_params(params, device="cpu", **arch)
    shardings = tlm.param_shardings(mesh)
    loss_fn = tlm.loss_fn(mesh=mesh, tp=True)
    if trainer:
        _, _, hist = Trainer(loss_fn, sgd(LR), mesh=mesh, log_every=1,
                             param_shardings=shardings).fit(tlm, _tokens, 2)
        got = [h["loss"] for h in hist]
    else:
        tstep = make_train_step(loss_fn, mesh=mesh,
                                param_shardings=shardings)
        with pytest.raises(ValueError, match="build it after"):
            tstep(tlm, sgd(LR)(tlm.parameters()),
                  torch.from_numpy(_tokens(0)))
        topt = sgd(LR)(tlm.parameters())   # over the laid-out shards
        got = [float(tstep(tlm, topt, torch.from_numpy(_tokens(s))))
               for s in range(2)]
    assert tlm.tp_shards[1][0]["wq"].shape == (32, 16)
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=0)
    moved = max(float(np.abs(np.asarray(p[g][k]) - params[g][k]).max())
                for g in params for k in params[g])
    _close_tree(to_jax_params(tlm), p, GRAD_TOL, scale=moved)
