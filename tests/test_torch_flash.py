"""The port's flash attention (``tpudl_torch.cuda_ops``) against tpudl's
Pallas kernel, run as tpudl's own tests run it on the CPU
(``interpret=True``), on the cases of tests/test_pallas_ops.py. On CPU
tensors the wrapper runs the plain version; the CUDA kernel itself is held
against that plain version on the card by chip_smoke.py.

Tolerance: 2e-6 absolute, as tests/test_pallas_ops.py holds the Pallas
kernel to the dense oracle — both sides compute in f32 on the CPU, with
sums in another order."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpudl.attention import attention_reference as jax_reference
from tpudl.pallas_ops import flash_attention as jax_flash
from tpudl_torch import cuda_ops
from tpudl_torch.attention import attention_reference

# the suite runs several pytest workers on the same cores: one torch
# thread per worker avoids oversubscribing them
torch.set_num_threads(1)

TOL = 2e-6


def _qkv(seed, b, s_q, s_k, h, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s_q, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s_k, h, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# (q shape [B, Sq, H, D], Sk, causal, q_offset, k_offset)
CASES = {
    "dense": ((2, 64, 2, 32), 64, False, 0, 0),
    "causal": ((2, 64, 2, 32), 64, True, 0, 0),
    "shifted_q_offset": ((2, 32, 2, 32), 32, True, 32, 0),
    "fully_future_k": ((2, 16, 2, 32), 16, True, 0, 1000),
    "sq_ne_sk": ((2, 48, 2, 32), 80, True, 0, 0),
    "length_200": ((1, 200, 2, 16), 200, True, 0, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    (b, s_q, h, d), s_k, causal, q_off, k_off = CASES[case]
    q, k, v = _qkv(1, b, s_q, s_k, h, d)
    want_o, want_lse = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=jnp.asarray(q_off, jnp.int32), k_offset=k_off,
        block_q=8, block_k=8, interpret=True, return_lse=True)
    got_o, got_lse = cuda_ops.flash_attention_plain(
        *_torch(q, k, v), causal=causal, q_offset=q_off, k_offset=k_off,
        return_lse=True)
    assert got_o.shape == (b, s_q, h, d) and got_lse.shape == (b, s_q, h)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=TOL, atol=TOL)
    if case == "fully_future_k":
        np.testing.assert_array_equal(got_o.numpy(), 0.0)
        assert np.all(got_lse.numpy() < -1e29)


def test_lse_makes_blocks_composable():
    """The ring contract: two half-K calls merge into the full answer
    through their lse weights."""
    q, k, v = _torch(*_qkv(2, 2, 64, 64, 2, 32))
    o1, l1 = cuda_ops.flash_attention(q, k[:, :32], v[:, :32],
                                      return_lse=True)
    o2, l2 = cuda_ops.flash_attention(q, k[:, 32:], v[:, 32:],
                                      return_lse=True)
    m = torch.maximum(l1, l2)
    w1, w2 = torch.exp(l1 - m)[..., None], torch.exp(l2 - m)[..., None]
    merged = ((o1 * w1 + o2 * w2) / (w1 + w2)).numpy()
    want = np.asarray(jax_reference(*(jnp.asarray(a.numpy())
                                      for a in (q, k, v))))
    np.testing.assert_allclose(merged, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_tpudl(causal):
    q, k, v = _qkv(3, 2, 40, 40, 2, 16)
    want = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal))
    got = attention_reference(*_torch(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    flash = cuda_ops.flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(flash.numpy(), got, rtol=TOL, atol=TOL)


def test_cpu_tensors_route_to_plain_and_count_no_launch():
    q, k, v = _torch(*_qkv(4, 1, 24, 24, 2, 8))
    before = dict(cuda_ops.launch_counts)
    out, lse = cuda_ops.flash_attention(q, k, v, causal=True,
                                        return_lse=True)
    want_o, want_lse = cuda_ops.flash_attention_plain(
        q, k, v, causal=True, return_lse=True)
    assert cuda_ops.launch_counts == before
    assert torch.equal(out, want_o) and torch.equal(lse, want_lse)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_mismatched_inputs_are_refused(bad):
    q, k, v = _torch(*_qkv(6, 1, 8, 8, 2, 16))
    if bad == "shape":
        k = k[:, :, :1]
    else:
        v = v.double()
    with pytest.raises(ValueError):
        cuda_ops.flash_attention(q, k, v)
