"""The port's ring attention (``tpudl_torch.attention``) against tpudl's.

tpudl runs ``ring_attention`` on conftest's 8 host devices (a 4-entry
data axis; with ``head_axis``, the (4, 2) mesh), its ``use_pallas`` ring
through the Pallas kernel in interpret mode; the port runs on a local
mesh of ``["cpu"] * n`` with the plain kernels. Both read the same seeded
numpy q, k, v ``[2, 64, 2, 16]`` (the 2×2 grid case ``[2, 64, 4, 16]``)
and cotangent.

Tolerances: outputs within 1e-5 of max |y|; gradients within 1e-4 of the
largest gradient.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl import mesh as JM
from tpudl.attention import ring_attention as jax_ring
from tpudl_torch import attention as A
from tpudl_torch import cuda_ops
from tpudl_torch import mesh as M

torch.set_num_threads(1)

OUT_TOL = 1e-5     # of max |y|
GRAD_TOL = 1e-4    # of the largest gradient


def _qkv(heads=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 64, heads, 16)).astype(np.float32)
            for _ in range(4)]          # q, k, v and the cotangent


def _close(got, want, tol):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale)


def _jax_side(arrays, mesh, **kw):
    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda *a: jax_ring(*a, mesh, **kw), q, k, v)
        return out, vjp(g)

    return run(*(jnp.asarray(a) for a in arrays))


def _port_side(arrays, mesh, **kw):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    out = A.ring_attention(q, k, v, mesh, **kw)
    (out * torch.from_numpy(arrays[3])).sum().backward()
    return out.detach(), (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_tpudl(causal, use_pallas):
    arrays = _qkv()
    want, want_g = _jax_side(arrays,
                             JM.build_mesh(devices=jax.devices()[:4]),
                             causal=causal, use_pallas=use_pallas)
    got, got_g = _port_side(arrays, M.build_mesh(devices=["cpu"] * 4),
                            causal=causal, use_pallas=use_pallas)
    _close(got, want, OUT_TOL)
    for a, b in zip(got_g, want_g):
        _close(a, b, GRAD_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ring_times_heads_matches_tpudl(mesh4x2, use_pallas):
    arrays = _qkv(heads=4, seed=1)
    want, want_g = _jax_side(arrays, mesh4x2, head_axis="model",
                             causal=True, use_pallas=use_pallas)
    got, got_g = _port_side(arrays, M.build_mesh(4, 2, devices=["cpu"] * 8),
                            head_axis="model", causal=True,
                            use_pallas=use_pallas)
    _close(got, want, OUT_TOL)
    for a, b in zip(got_g, want_g):
        _close(a, b, GRAD_TOL)


def test_causal_ring_launches_each_kernel_n_n_plus_1_over_2(monkeypatch):
    """A causal ring over 4 entries runs 10 hops (future ones are not
    launched) and, under autograd, 10 backward calls; on the CPU the
    plain versions stand where the card launches the kernels."""
    calls = {"fwd": 0, "bwd": 0}
    fwd = cuda_ops.flash_attention_plain
    bwd = cuda_ops.flash_attention_bwd_plain

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(cuda_ops, "flash_attention_plain", count_fwd)
    monkeypatch.setattr(cuda_ops, "flash_attention_bwd_plain", count_bwd)
    arrays = _qkv()
    _port_side(arrays, M.build_mesh(devices=["cpu"] * 4), causal=True,
               use_pallas=True)
    assert calls == {"fwd": 10, "bwd": 10}


def test_shard_sequence_blocks_in_blocks_out():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv())
    mesh = M.build_mesh(devices=["cpu"] * 4)
    qs, ks, vs = A.shard_sequence((q, k, v), mesh)
    assert isinstance(qs, M.Sharded) and [t.shape[1] for t in qs] == [16] * 4
    out = A.ring_attention(qs, ks, vs, mesh, causal=True, use_pallas=True)
    assert isinstance(out, M.Sharded)
    whole = A.ring_attention(q, k, v, mesh, causal=True, use_pallas=True)
    assert torch.equal(torch.cat(list(out), dim=1), whole)


def test_ring_refusals_keep_tpudls_messages():
    q = torch.zeros(1, 30, 3, 16)
    with pytest.raises(ValueError, match="not divisible by ring size 4"):
        A.ring_attention(q, q, q, M.build_mesh(devices=["cpu"] * 4))
    q = torch.zeros(1, 32, 3, 16)
    with pytest.raises(ValueError, match="heads 3 not divisible by mesh "
                       "axis 'model' size 2"):
        A.ring_attention(q, q, q, M.build_mesh(4, 2, devices=["cpu"] * 8),
                         head_axis="model")
