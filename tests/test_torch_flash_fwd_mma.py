"""The arithmetic of the port's tensor-core forward kernel
(``csrc/flash_attn_fwd.cu``) on the CPU, against tpudl's Pallas kernel run
as tpudl's own tests run it (``interpret=True``).

The kernel takes both of its products, S = QKᵀ and O += P·V, on the tensor
cores as three TF32 passes (3xTF32, csrc/flash_attn_mma.cuh) and runs the
softmax online, chunk by chunk over the keys, in registers. ``_tf32_fwd``
repeats that in torch: the same split, the same chunks (``sub_cols`` in the
kernel: min(64, 2048 / D) keys), the running max and sum rescaled once a
chunk, and the dead-row rule (p = 0 while the running max is the −1e30
stand-in; a row that saw no key gives O = 0 and lse = −1e30). The kernel
takes its exponentials with ``__expf``, a few ulps from ``exp`` at the
arguments ≤ 0 it sees; the emulation takes ``torch.exp``.

Tolerances: 2e-6 absolute and relative against tpudl on the cases of
tests/test_torch_flash.py, as that file holds the plain version: both
sides compute in f32 on the CPU, sums in another order, and the split's
error (about 2⁻²²·|s| in each score) stays below it at these magnitudes.
On "large scores" (q and k drawn ×3, scores with a standard deviation near
9) f32 rounding of s itself moves both the plain version and the emulation
past 2e-6, so both are held at chip_smoke's f32 tolerance for the forward,
2e-5 on O and lse; one TF32 pass misses that by far."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpudl.pallas_ops import flash_attention as jax_flash
from tpudl_torch import cuda_ops

from test_torch_flash import CASES, _qkv, _torch
from test_torch_flash_bwd import LARGE_SCORES, _mm

# the suite runs several pytest workers on the same cores: one torch
# thread per worker avoids oversubscribing them
torch.set_num_threads(1)

TOL = 2e-6
CARD_TOL = 2e-5   # chip_smoke.py's f32 tolerance for the forward, O and lse


def _products(eq, a, b, passes):
    """einsum on TF32 passes as the kernel takes it, or (passes=0) in
    plain f32."""
    return torch.einsum(eq, a, b) if passes == 0 else _mm(eq, a, b, passes)


def _tf32_fwd(q, k, v, *, causal, q_offset, k_offset, passes=3, chunk=None):
    """(O, lse) as the forward kernel computes them: q ``[B, Sq, H, D]``,
    k/v ``[B, Sk, H, D]`` f32; the keys in chunks of ``chunk`` (default:
    the kernel's SUB for this head_dim), each chunk's scores s = (Q·Kᵀ)·
    scale on ``passes`` TF32 passes (0: plain f32), masked causally on
    global positions, then the online softmax and O += P·V."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    chunk = chunk or min(64, 2048 // d)
    scale = 1.0 / d ** 0.5
    neg = cuda_ops.NEG_INF
    q_pos = q_offset + torch.arange(s_q)
    m = torch.full((b, h, s_q), neg)
    l = torch.zeros(b, h, s_q)
    acc = torch.zeros(b, h, s_q, d)
    for c0 in range(0, s_k, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = _products("bqhd,bkhd->bhqk", q, kc, passes) * scale
        if causal:
            k_pos = k_offset + torch.arange(c0, c0 + kc.shape[1])
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where((m_new <= neg * 0.5)[..., None], 0.0,
                        torch.exp(s - m_new[..., None]))
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr[..., None]
               + _products("bhqk,bkhd->bhqd", p, vc, passes))
        m = m_new
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe_l[..., None]).transpose(1, 2)
    lse = torch.where(l == 0.0, torch.full_like(l, neg), m + torch.log(safe_l))
    return out, lse.transpose(1, 2)


def _inputs_and_pallas(case):
    """torch q, k, v, the mask, and tpudl's (O, lse) — the Pallas kernel in
    interpret mode — for a case of CASES or "large_scores"."""
    if case == "large_scores":
        (b, s_q, h, d), s_k, causal, q_off, k_off = LARGE_SCORES
        block = s_q           # one block a side: interpret mode stays quick
    else:
        (b, s_q, h, d), s_k, causal, q_off, k_off = CASES[case]
        block = 8
    q, k, v = _qkv(1, b, s_q, s_k, h, d)
    if case == "large_scores":
        q, k = q * 3, k * 3
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, q_offset=jnp.asarray(q_off, jnp.int32),
                     k_offset=k_off, block_q=block, block_k=block,
                     interpret=True, return_lse=True)
    mask = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    return _torch(q, k, v), mask, tuple(np.asarray(w) for w in want)


def _err(got, want):
    return max(float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want))


@pytest.mark.parametrize("case", sorted(CASES) + ["large_scores"])
def test_3xtf32_forward_matches_pallas_interpret(case):
    (q, k, v), mask, want = _inputs_and_pallas(case)
    got = _tf32_fwd(q, k, v, **mask)
    assert got[0].shape == q.shape and got[1].shape == q.shape[:3]
    if case in CASES:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
    else:
        plain = cuda_ops.flash_attention_plain(q, k, v, return_lse=True,
                                               **mask)
        assert _err(plain, want) <= CARD_TOL
        assert _err(got, want) <= CARD_TOL
    if case == "fully_future_k":
        np.testing.assert_array_equal(got[0].numpy(), 0.0)
        assert np.all(got[1].numpy() < -1e29)


def test_one_tf32_pass_misses_f32_tolerance():
    """The split is what holds f32 accuracy: one TF32 pass over the same
    products misses the card's f32 tolerance on large scores by more than
    tenfold."""
    (q, k, v), mask, want = _inputs_and_pallas("large_scores")
    err = _err(_tf32_fwd(q, k, v, **mask, passes=1), want)
    assert err > 10 * CARD_TOL, err


@pytest.mark.parametrize("shape, s_k, q_offset, k_offset", [
    ((1, 96, 2, 16), 200, 0, 40),     # rows 0..39 see no key at all
    ((2, 130, 2, 32), 130, 0, 70),    # the first two 64-row tiles all dead
    ((1, 64, 3, 16), 150, 10, 200),   # every row dead
])
def test_online_softmax_equals_dense_with_dead_rows(shape, s_k, q_offset,
                                                    k_offset):
    """The kernel's online softmax over 64-key chunks, with plain f32
    products, against the dense softmax of the plain version, on causal
    cases where q_offset < k_offset leaves rows that see no key beside
    rows that do."""
    b, s_q, h, d = shape
    q, k, v = _torch(*_qkv(5, b, s_q, s_k, h, d))
    mask = dict(causal=True, q_offset=q_offset, k_offset=k_offset)
    got = _tf32_fwd(q, k, v, **mask, passes=0, chunk=64)
    want = cuda_ops.flash_attention_plain(q, k, v, return_lse=True, **mask)
    dead = want[1] < -1e29
    assert bool(dead.any())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)
    assert bool((got[1][dead] == cuda_ops.NEG_INF).all())
    assert bool((got[0][dead] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_rows_give_the_contiguous_answer(dtype):
    """Views one element into a D+1-wide buffer (no row on a 16-byte
    boundary, which the kernel's cp.async loads need) give the O and lse of
    their contiguous copies."""
    q, k, v = (t.to(dtype) for t in _torch(*_qkv(6, 2, 40, 40, 2, 17)))
    q, k, v = q[..., 1:], k[..., 1:], v[..., 1:]
    assert not any(cuda_ops._rows_aligned16(t) for t in (q, k, v))
    got = cuda_ops.flash_attention(q, k, v, causal=True, return_lse=True)
    want = cuda_ops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True,
                                    return_lse=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_aligned_rows_copies_only_unaligned_operands():
    """The wrapper's copy before a launch: an aligned operand passes
    through as the same tensor, an unaligned one comes back contiguous."""
    aligned = torch.zeros(2, 8, 3, 16)
    unaligned = torch.zeros(2, 8, 3, 17)[..., 1:]
    a, u = cuda_ops._aligned_rows(aligned, unaligned)
    assert a is aligned
    assert u is not unaligned and u.is_contiguous()
    assert cuda_ops._rows_aligned16(u) and torch.equal(u, unaligned)
