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
own ``test_grad_matches_dense`` holds its kernel to the dense oracle.

The CUDA kernels take every product on the tensor cores as three TF32
passes (3xTF32, csrc/flash_attn_mma.cuh). ``_tf32_bwd`` repeats their
seven products with that split in torch, so the CPU shows that the
scheme holds f32 accuracy: on every case above at 1e-5, and on "large
scores" (q and k drawn ×3, scores with a standard deviation near 9),
where f32 rounding of s itself moves the plain version past 1e-5, at the
card's f32 tolerance, 2e-5·max(1, max|grad|), which the plain version
meets there too. One TF32 pass misses that tolerance by far."""

import functools

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
# chip_smoke.py's f32 tolerance for the backward kernels, relative to
# max(1, max |grad|)
CARD_TOL = 2e-5
# (q shape [B, Sq, H, D], Sk, causal, q_offset, k_offset); q and k ×3
LARGE_SCORES = ((2, 130, 3, 64), 130, True, 0, 0)


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


def _tf32(x):
    """Round f32 to TF32 as the kernels do (cvt.rna.tf32.f32): add half a
    TF32 ulp to the magnitude bits, clear the 13 low mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(eq, a, b, passes):
    """einsum ``eq`` of f32 a and b on TF32 operands: with 3 passes
    a_small·b_big + a_big·b_small + a_big·b_big, small terms first, each
    product of two TF32 values exact in f32; with 1 pass a_big·b_big."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return torch.einsum(eq, a_big, b_big)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return (torch.einsum(eq, a_small, b_big)
            + torch.einsum(eq, a_big, b_small)
            + torch.einsum(eq, a_big, b_big))


def _tf32_bwd(q, k, v, o, lse, do, dlse, *, causal, q_offset, k_offset,
              passes=3):
    """(dq, dk, dv) as the dq and dk/dv kernels compute them, with every
    one of their seven products on TF32 passes: S = QKᵀ, dP = dO·Vᵀ and
    dQ = dS·K in dq; Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dV = Pᵀ·dO and dK = dSᵀ·Q in
    dk/dv. p = exp(s·scale − lse) on visible pairs of live rows, else 0;
    ds = p·(dp − dlt)·scale with dlt = rowsum(dO ⊙ O) − dlse."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s_q, s_k = q.shape[1], k.shape[1]
    lse_t = lse.transpose(1, 2)[..., None]                 # [B, H, Sq, 1]
    dlt_t = ((do * o).sum(dim=-1) - dlse).transpose(1, 2)[..., None]
    seen = lse_t > cuda_ops.NEG_INF * 0.5
    if causal:
        seen = seen & ((q_offset + torch.arange(s_q))[:, None]
                       >= (k_offset + torch.arange(s_k))[None, :])
    lse_live = torch.where(seen, lse_t, 0.0)

    def p_ds(s, dp, seen, lse_live, dlt):
        p = torch.where(seen, torch.exp(s * scale - lse_live), 0.0)
        return p, p * (dp - dlt) * scale

    # the dq kernel: rows are queries
    _, ds = p_ds(_mm("bqhd,bkhd->bhqk", q, k, passes),
                 _mm("bqhd,bkhd->bhqk", do, v, passes), seen, lse_live,
                 dlt_t)
    dq = _mm("bhqk,bkhd->bqhd", ds, k, passes)
    # the dk/dv kernel: rows are keys, lse and dlt index by column
    def tr(x):
        return x.transpose(-1, -2)

    p_t, ds_t = p_ds(_mm("bkhd,bqhd->bhkq", k, q, passes),
                     _mm("bkhd,bqhd->bhkq", v, do, passes), tr(seen),
                     tr(lse_live), tr(dlt_t))
    dv = _mm("bhkq,bqhd->bkhd", p_t, do, passes)
    dk = _mm("bhkq,bqhd->bkhd", ds_t, q, passes)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _tf32_inputs_and_pallas_grads(case):
    """Inputs (q, k, v, dO, dlse as torch tensors), the port's plain
    forward outputs (o, lse), and tpudl's gradients (jax.vjp of the Pallas
    kernel in interpret mode) for a case of CASES or "large_scores"."""
    if case == "large_scores":
        (b, s_q, h, d), s_k, causal, q_off, k_off = LARGE_SCORES
        block = s_q           # one block a side: interpret mode stays quick
    else:
        (b, s_q, h, d), s_k, causal, q_off, k_off = CASES[case]
        block = 8
    q, k, v = _qkv(1, b, s_q, s_k, h, d)
    if case == "large_scores":
        q, k = q * 3, k * 3
    do, dlse = _cotangents(2, b, s_q, h, d)

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal,
                         q_offset=jnp.asarray(q_off, jnp.int32),
                         k_offset=k_off, block_q=block, block_k=block,
                         interpret=True, return_lse=True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = tuple(np.asarray(w) for w in vjp((jnp.asarray(do),
                                             jnp.asarray(dlse))))
    mask = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    tq, tk, tv, tdo, tdlse = _torch(q, k, v, do, dlse)
    o, lse = cuda_ops.flash_attention_plain(tq, tk, tv, return_lse=True,
                                            **mask)
    return (tq, tk, tv, o, lse, tdo, tdlse), mask, want


def _card_tol_ratio(got, want):
    """Largest |got − want| over CARD_TOL·max(1, max |want|), per grad."""
    return [float(np.abs(g.numpy() - w).max()
                  / (CARD_TOL * max(1.0, float(np.abs(w).max()))))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("case", sorted(CASES) + ["large_scores"])
def test_3xtf32_products_match_pallas_interpret(case):
    args, mask, want = _tf32_inputs_and_pallas_grads(case)
    got = _tf32_bwd(*args, **mask)
    if case in CASES:
        for name, g, w in zip("qkv", got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                       err_msg=f"d{name}")
    else:
        plain = cuda_ops.flash_attention_bwd_plain(*args, **mask)
        assert max(_card_tol_ratio(plain, want)) <= 1.0
        assert max(_card_tol_ratio(got, want)) <= 1.0
    if case == "fully_future_k":
        for g in got:
            np.testing.assert_array_equal(g.numpy(), 0.0)


def test_one_tf32_pass_misses_f32_tolerance():
    """The split is what holds f32 accuracy: a single TF32 pass over the
    same products misses the card's f32 tolerance on large scores by more
    than tenfold (it read about 150–220× when this test was written)."""
    args, mask, want = _tf32_inputs_and_pallas_grads("large_scores")
    ratios = _card_tol_ratio(_tf32_bwd(*args, **mask, passes=1), want)
    assert min(ratios) > 10.0, ratios


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


@pytest.mark.parametrize("view, aligned", [
    ("contiguous f32", True), ("contiguous bf16", True),
    ("[B, H, S, D] seen as [B, S, H, D]", True),
    ("one element into a D+1-wide buffer", False),
    ("one row into the buffer", True)])
def test_rows_aligned16(view, aligned):
    """The backward kernels copy rows in 16-byte chunks; the wrapper copies
    an operand whose rows do not all start on a 16-byte boundary."""
    if view == "contiguous bf16":
        t = torch.zeros(2, 8, 3, 16, dtype=torch.bfloat16)
    elif view.startswith("[B, H, S, D]"):
        t = torch.zeros(2, 3, 8, 16).transpose(1, 2)
    elif view.startswith("one element"):
        t = torch.zeros(2, 8, 3, 17)[..., 1:]
    elif view.startswith("one row"):
        t = torch.zeros(2, 9, 3, 16)[:, 1:]
    else:
        t = torch.zeros(2, 8, 3, 16)
    assert cuda_ops._rows_aligned16(t) is aligned


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
