"""The port's pipeline parallelism (``tpudl_torch.pipeline.
pipeline_blocks``, ``TinyCausalLM.apply_pipelined``) against tpudl's.

tpudl runs on conftest's (4, 2) host mesh (2 pipeline stages on the model
axis; with ``data_axis``, 4 data entries), jitted; the port runs on a
local ``["cpu"] * 8`` mesh of the same shape. Both read the same seeded
numpy blocks and activations (4 affine blocks of width 16, ``[4, 4, 16]``
microbatches) and, for the LM, the same ``init(0)`` pytree at vocab 64,
dim 32, 2 heads (head_dim 16), 2 layers, on seeded tokens ``[8, 64]``.

Tolerances: outputs and logits within 1e-4 of their max |value|,
gradients within 1e-4 of the largest gradient.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl.pipeline import pipeline_blocks as jax_pipeline
from tpudl.zoo.transformer import TinyCausalLM as JaxLM
from tpudl_torch import mesh as M
from tpudl_torch.pipeline import pipeline_blocks
from tpudl_torch.zoo.transformer import TinyCausalLM

torch.set_num_threads(1)

TOL = 1e-4
ARCH = dict(vocab=64, dim=32, heads=2, layers=2, max_len=96)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def mesh():
    return M.build_mesh(4, 2, devices=["cpu"] * 8)


@pytest.mark.parametrize("remat,data_axis", [(True, None),
                                             (False, "data")])
def test_pipeline_blocks_matches_tpudl(mesh4x2, mesh, remat, data_axis):
    rng = np.random.default_rng(0)
    stacked = {"w": rng.normal(size=(4, 16, 16)).astype(np.float32) * 0.3,
               "b": rng.normal(size=(4, 16)).astype(np.float32)}
    x = rng.normal(size=(4, 4, 16)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)

    @jax.jit
    def jax_side(p, x):
        out, vjp = jax.vjp(lambda p, x: jax_pipeline(
            lambda h, q: jnp.tanh(h @ q["w"] + q["b"]), p, x, mesh4x2,
            axis="model", data_axis=data_axis, remat=remat), p, x)
        return out, vjp(jnp.asarray(g))

    want, (want_p, want_x) = jax_side(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in stacked.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = pipeline_blocks(lambda h, q: torch.tanh(h @ q["w"] + q["b"]), tp,
                          tx, mesh, axis="model", data_axis=data_axis,
                          remat=remat)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), want)
    _close(tx.grad, want_x)
    for k in stacked:
        _close(tp[k].grad, want_p[k])


def test_pipeline_refusals(mesh):
    with pytest.raises(ValueError, match="divisible"):
        pipeline_blocks(lambda h, p: h, {"w": torch.zeros(3, 4, 4)},
                        torch.zeros(2, 2, 4), mesh, axis="model")
    with pytest.raises(ValueError, match="no leaves"):
        pipeline_blocks(lambda h, p: h, {}, torch.zeros(2, 2, 4), mesh,
                        axis="model")


@pytest.mark.parametrize("remat,data_axis", [(False, None),
                                             (True, "data")])
def test_apply_pipelined_matches_tpudl(mesh4x2, mesh, remat, data_axis):
    jlm = JaxLM(**ARCH)
    params = jlm.init(0)
    toks = np.random.default_rng(1).integers(
        0, ARCH["vocab"], size=(8, 64)).astype(np.int32)
    g = np.random.default_rng(2).normal(
        size=(8, 64, ARCH["vocab"])).astype(np.float32)

    @jax.jit
    def jax_side(p, t):
        out, vjp = jax.vjp(lambda p: jlm.apply_pipelined(
            p, t, mesh4x2, n_micro=2, data_axis=data_axis, remat=remat), p)
        return out, vjp(jnp.asarray(g))[0]

    want, want_g = jax_side(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(toks))
    tlm = TinyCausalLM.from_jax_params(params, device="cpu", **ARCH)
    out = tlm.apply_pipelined(torch.from_numpy(toks), mesh, n_micro=2,
                              data_axis=data_axis, remat=remat)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), want)
    scale = max(float(np.abs(np.asarray(w)).max())
                for grp in want_g.values() for w in grp.values())
    for i, p in enumerate(tlm.blocks):
        for k, t in p.items():
            np.testing.assert_allclose(
                t.grad.numpy(), np.asarray(want_g[f"block_{i}"][k]), rtol=0,
                atol=TOL * scale, err_msg=k)
    np.testing.assert_allclose(tlm.embed["table"].grad.numpy(),
                               np.asarray(want_g["embed"]["table"]), rtol=0,
                               atol=TOL * scale)
