"""ResNet50 training through the port's ``HorovodRunner`` against tpudl's
(BASELINE.json configs[3], ``bench.py``'s ``measure_train_step``
``train_fn``) from the same ``init(0)``, at 64×64 with a batch of 2 and 3
steps of ``sgd(0.05)``: the clipped-log cross-entropy of ``predict`` over
uint8 images normalized as ``(x - 127.5) / 127.5``. tpudl runs as its
own tests run it, on the simulated CPU mesh (``HorovodRunner(np=1)``);
the port runs ``HorovodRunner(np=-1, device="cpu")``, a one-rank gloo
group. Parameters come back through ``keras_params`` (the inverse of
``torch_params``), moving statistics included. Then tpudl's two
mixed-precision tests and the eval step.

Tolerances (readings on these inputs when the file was written). One
step's f32 gradients agree to 2e-6 of each layer's largest gradient
except where an activation within rounding of 0 falls on the other side
of a ReLU in the two packages: here one channel of
``conv4_block3_2_conv`` then takes 1e-2. Three steps at lr 0.05 carry
such differences on, so the parameters are held by their whole update
``Δ = p_after - init(0)`` over the tree, moving statistics included:
- f32: losses within 2e-4 (read 4.8e-7, 3.3e-6, 4.4e-5 at steps 1-3);
  max |Δ_port - Δ_tpudl| within 5e-2 of max |Δ_tpudl| (read 1.4e-2,
  against a largest update of 2.5e-2) and the cosine of the two updates
  at least 0.999 (read 0.99971);
- bf16 compute on f32 masters: both packages round each weight and each
  op's output to bf16 (2^-8 = 3.9e-3 relative), in other orders: losses
  within 3e-2 (read 6.2e-3), the update within 0.1 (read 3.1e-2), cosine
  at least 0.98 (read 0.9919); the masters stay float32.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl.train import HorovodRunner as JaxRunner
from tpudl.train import make_eval_step as jax_make_eval_step
from tpudl.train import with_compute_dtype as jax_with_compute_dtype
from tpudl.zoo.registry import getKerasApplicationModel as jax_model
from tpudl_torch.train import (HorovodRunner, make_eval_step,
                               make_train_step, sgd, with_compute_dtype)
from tpudl_torch.zoo.convert import keras_params
from tpudl_torch.zoo.registry import ImageModel, getKerasApplicationModel

torch.set_num_threads(1)

SIZE, BATCH, STEPS, LR = 64, 2, 3, 0.05
TOL = {"float32": {"loss": 2e-4, "update": 5e-2, "cosine": 0.999},
       "bfloat16": {"loss": 3e-2, "update": 0.1, "cosine": 0.98}}


def _data():
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 256, size=(STEPS, BATCH, SIZE, SIZE, 3),
                      dtype=np.uint8)
    ys = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000,
                                                     (STEPS, BATCH))]
    return xs, ys


def _jax_loss(model, dtype):
    def loss_fn(p, x, y):
        x = (x.astype(jnp.dtype(dtype)) - 127.5) / 127.5
        logp = jnp.log(jnp.clip(model.predict(p, x), 1e-7, 1.0))
        return -jnp.mean(jnp.sum(y * logp, axis=-1))

    return loss_fn


def _port_loss(dtype):
    def loss_fn(net, x, y):
        x = (x.to(dtype) - 127.5) / 127.5
        logp = torch.log(torch.clamp(net.predict(x), 1e-7, 1.0))
        return -torch.mean(torch.sum(y * logp, dim=-1))

    return loss_fn


def _tpudl_run(dtype):
    xs, ys = _data()
    model = jax_model("ResNet50")

    def train_fn(ctx):
        loss = _jax_loss(model, dtype)
        if dtype != "float32":
            loss = jax_with_compute_dtype(loss, jnp.bfloat16)
        params, _, hist = ctx.trainer(loss, optax.sgd(LR), log_every=1).fit(
            model.init(0), lambda s: (xs[s], ys[s]), STEPS)
        return ([h["loss"] for h in hist],
                jax.tree.map(np.asarray, params))

    return JaxRunner(np=1).run(train_fn)


def resnet_train_fn(ctx, dtype_name):
    """``bench.py``'s configs[3] train_fn on the port, at the test's size."""
    xs, ys = _data()
    model = getKerasApplicationModel("ResNet50")
    net = ImageModel(model, model.init(0), device=ctx.device)
    loss = _port_loss(getattr(torch, dtype_name))
    if dtype_name != "float32":
        loss = with_compute_dtype(loss, torch.bfloat16)
    _, _, hist = ctx.trainer(loss, sgd(LR), log_every=1).fit(
        net, lambda s: (xs[s], ys[s]), STEPS)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    return [h["loss"] for h in hist], keras_params(net.tree())


@pytest.fixture(scope="module")
def init():
    return jax_model("ResNet50").init(0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_horovod_runner_resnet50_matches_tpudl(init, dtype):
    tol = TOL[dtype]
    want_loss, want = _tpudl_run(dtype)
    got_loss, got = HorovodRunner(np=-1, device="cpu").run(
        resnet_train_fn, dtype_name=dtype)
    np.testing.assert_allclose(got_loss, want_loss, rtol=0,
                               atol=tol["loss"])
    assert sorted(got) == sorted(want)
    got_d, want_d = [], []
    for layer, leaves in want.items():
        assert sorted(got[layer]) == sorted(leaves)
        for k in sorted(leaves):
            assert got[layer][k].dtype == np.float32
            want_d.append((leaves[k] - init[layer][k]).ravel())
            got_d.append((got[layer][k] - init[layer][k]).ravel())
            # every leaf trains, BN's moving statistics too
            assert np.abs(want_d[-1]).max() > 0, (layer, k)
            assert np.abs(got_d[-1]).max() > 0, (layer, k)
    got_d, want_d = np.concatenate(got_d), np.concatenate(want_d)
    err = np.abs(got_d - want_d).max() / np.abs(want_d).max()
    cosine = got_d @ want_d / np.linalg.norm(got_d) / np.linalg.norm(want_d)
    assert err <= tol["update"] and cosine >= tol["cosine"], (err, cosine)


class _W(torch.nn.ParameterDict):
    """A one-leaf model, ``{"w": ...}``, as tpudl's tests use a dict."""


def test_bf16_master_loses_small_updates_fp32_master_keeps_them():
    """tpudl's TestMixedPrecision: an SGD update below bf16's ULP rounds
    to nothing on bf16 masters but accumulates on f32 masters computing
    in bf16."""
    # loss = 1e-4 * w -> grad = 1e-4; lr 1e-2 -> update 1e-6, far below
    # bf16's ULP at 1.0 (~7.8e-3)
    def loss(model, _x):
        return 1e-4 * torch.sum(model["w"])

    x = torch.zeros(1)
    bf = _W({"w": torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))})
    make_train_step(loss)(bf, sgd(1e-2)(bf.parameters()), x)
    assert torch.equal(bf["w"].float(), torch.ones(4))  # the update vanished

    fp = _W({"w": torch.nn.Parameter(torch.ones(4))})
    make_train_step(with_compute_dtype(loss, torch.bfloat16))(
        fp, sgd(1e-2)(fp.parameters()), x)
    assert fp["w"].dtype == torch.float32
    np.testing.assert_allclose(fp["w"].detach().numpy(),
                               np.full(4, 1.0 - 1e-6, np.float32), rtol=0,
                               atol=1e-9)  # the f32 master kept it


def test_compute_really_runs_in_bf16():
    seen = {}

    def loss(model, x):
        seen["dtype"] = model["w"].dtype
        return torch.sum(model["w"]) + torch.sum(x)

    m = _W({"w": torch.nn.Parameter(torch.ones(3))})
    with_compute_dtype(loss, torch.bfloat16)(m, torch.zeros(2)).backward()
    assert seen["dtype"] == torch.bfloat16
    assert m["w"].grad.dtype == torch.float32  # grads land on the masters
    assert isinstance(m._parameters["w"], torch.nn.Parameter)  # restored


def test_eval_step_matches_tpudl_and_records_no_graph(init):
    xs, ys = _data()
    jm = jax_model("ResNet50")
    want = jax_make_eval_step(_jax_loss(jm, "float32"))(init, xs[0], ys[0])
    net = ImageModel(getKerasApplicationModel("ResNet50"), init,
                     device="cpu")
    got = make_eval_step(_port_loss(torch.float32))(net, xs[0], ys[0])
    assert not got.requires_grad and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=0,
                               atol=TOL["float32"]["loss"])
    # the eval step is the train step's loss without the update
    step = make_train_step(_port_loss(torch.float32))
    loss = step(net, sgd(LR)(net.parameters()), torch.from_numpy(xs[0]),
                torch.from_numpy(ys[0]))
    assert float(loss) == float(got)


def test_keras_params_inverts_torch_params(init):
    net = ImageModel(getKerasApplicationModel("ResNet50"), init,
                     device="cpu")
    got = keras_params(net.tree())
    assert sorted(got) == sorted(init)
    for layer, leaves in init.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(got[layer][k], v)


def test_training_leaves_the_callers_params_alone(init):
    """The module owns copies of the weights: training it in place does
    not write through to the numpy tree it was built from."""
    before = {layer: {k: v.copy() for k, v in leaves.items()}
              for layer, leaves in init.items()}
    net = ImageModel(getKerasApplicationModel("ResNet50"), init,
                     device="cpu")
    xs, ys = _data()
    make_train_step(_port_loss(torch.float32))(
        net, sgd(LR)(net.parameters()), torch.from_numpy(xs[0]),
        torch.from_numpy(ys[0]))
    assert not torch.equal(net.layers["conv1_bn"].beta,
                           torch.from_numpy(before["conv1_bn"]["beta"]))
    for layer, leaves in before.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(init[layer][k], v)
