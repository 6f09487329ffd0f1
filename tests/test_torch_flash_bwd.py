"""The port's flash-attention gradient (``tpudl_torch.cuda_ops``) against
tpudl's: ``jax.vjp`` of the Pallas kernel run as tpudl's own tests run it
on the CPU (``interpret=True``), under both cotangents (dO and a nonzero
dlse), on every case of tests/test_torch_flash.py. On CPU tensors the
autograd Function runs the plain forward and the plain backward; the CUDA
dq and dk/dv kernels are held against that plain backward on the card by
chip_smoke.py.

Tolerances: against tpudl 1e-5 absolute and relative — both sides
compute in f32 on the CPU, and a gradient sums up to 200 products of
O(1) terms in another order (grads here reach about 4.4; the errors read
up to 2.4e-6 when this test was written). The plain
backward against autograd through the plain forward: 2e-5, as tpudl's
own ``test_grad_matches_dense`` holds its kernel to the dense oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl.pallas_ops import flash_attention as jax_flash
from tpudl_torch import cuda_ops

from test_torch_flash import CASES, _qkv, _torch

# the suite runs several pytest workers on the same cores: one torch
# thread per worker avoids oversubscribing them
torch.set_num_threads(1)

TOL = 1e-5
DENSE_TOL = 2e-5


def _cotangents(seed, b, s_q, h, d):
    rng = np.random.default_rng(seed)
    do = rng.normal(size=(b, s_q, h, d)).astype(np.float32)
    dlse = rng.normal(size=(b, s_q, h)).astype(np.float32)
    return do, dlse


def _port_grads(q, k, v, do, dlse, **kw):
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    out, lse = cuda_ops.flash_attention(tq, tk, tv, return_lse=True, **kw)
    torch.autograd.backward([out, lse], list(_torch(do, dlse)))
    return tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_pallas_interpret(case):
    (b, s_q, h, d), s_k, causal, q_off, k_off = CASES[case]
    q, k, v = _qkv(1, b, s_q, s_k, h, d)
    do, dlse = _cotangents(2, b, s_q, h, d)

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal,
                         q_offset=jnp.asarray(q_off, jnp.int32),
                         k_offset=k_off, block_q=8, block_k=8,
                         interpret=True, return_lse=True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    got = _port_grads(q, k, v, do, dlse, causal=causal, q_offset=q_off,
                      k_offset=k_off)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"d{name}")
    if case == "fully_future_k":
        for g in got:
            np.testing.assert_array_equal(g.numpy(), 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_autograd_of_plain_forward(case):
    """An independent dense check: the plain backward against torch
    autograd through the plain forward."""
    (b, s_q, h, d), s_k, causal, q_off, k_off = CASES[case]
    q, k, v = _torch(*_qkv(3, b, s_q, s_k, h, d))
    do, dlse = _torch(*_cotangents(4, b, s_q, h, d))
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = cuda_ops.flash_attention_plain(tq, tk, tv, return_lse=True,
                                              **kw)
    torch.autograd.backward([out, lse], [do, dlse])
    got = cuda_ops.flash_attention_bwd_plain(q, k, v, out.detach(),
                                             lse.detach(), do, dlse, **kw)
    for name, g, w in zip("qkv", got, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=DENSE_TOL,
                                   atol=DENSE_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("used", ["out", "lse"])
def test_absent_cotangent_counts_as_zeros(used):
    q, k, v = _qkv(5, 2, 24, 24, 2, 16)
    do, dlse = _cotangents(6, 2, 24, 2, 16)
    if used == "out":
        dlse = np.zeros_like(dlse)
    else:
        do = np.zeros_like(do)
    want = _port_grads(q, k, v, do, dlse, causal=True)
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    out, lse = cuda_ops.flash_attention(tq, tk, tv, causal=True,
                                        return_lse=True)
    if used == "out":
        out.backward(torch.from_numpy(do))
    else:
        lse.backward(torch.from_numpy(dlse))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(g, w)


def test_non_contiguous_cotangent():
    q, k, v = _torch(*_qkv(7, 2, 40, 40, 2, 16))
    out, lse = cuda_ops.flash_attention(q, k, v, causal=True,
                                        return_lse=True)
    do_bhsd = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 2, 40, 16)).astype(np.float32))
    do = do_bhsd.transpose(1, 2)           # [B, S, H, D] view, strided
    assert not do.is_contiguous() and do.stride(-1) == 1
    dlse = torch.ones(2, 40, 2)
    got = cuda_ops.flash_attention_bwd(q, k, v, out, lse, do, dlse,
                                       causal=True)
    want = cuda_ops.flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                        dlse, causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bf16_grads_keep_their_dtype():
    """bf16 inputs: the gradients are the f32 gradients of the same
    bf16 values, rounded once to bf16."""
    q, k, v = (t.to(torch.bfloat16) for t in _torch(*_qkv(9, 1, 32, 32, 2,
                                                          32)))
    do, dlse = _torch(*_cotangents(10, 1, 32, 2, 32))
    out, lse = cuda_ops.flash_attention(q, k, v, causal=True,
                                        return_lse=True)
    got = cuda_ops.flash_attention_bwd(q, k, v, out, lse,
                                       do.to(torch.bfloat16), dlse,
                                       causal=True)
    want = cuda_ops.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), lse,
        do.to(torch.bfloat16).float(), dlse, causal=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


def test_cpu_backward_counts_no_launch():
    before = dict(cuda_ops.launch_counts)
    _port_grads(*_qkv(11, 1, 16, 16, 1, 16), *_cotangents(12, 1, 16, 1, 16),
                causal=True)
    assert cuda_ops.launch_counts == before


@pytest.mark.parametrize("bad", ["do_shape", "lse_shape", "lse_dtype"])
def test_bwd_refuses_mismatched_inputs(bad):
    q, k, v = _torch(*_qkv(13, 1, 8, 8, 2, 16))
    out, lse = cuda_ops.flash_attention(q, k, v, return_lse=True)
    do, dlse = torch.ones_like(out), torch.zeros_like(lse)
    if bad == "do_shape":
        do = do[:, :4]
    elif bad == "lse_shape":
        lse = lse[..., :1]
    else:
        lse = lse.double()
    with pytest.raises(ValueError):
        cuda_ops.flash_attention_bwd(q, k, v, out, lse, do, dlse)
