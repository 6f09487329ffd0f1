"""Hand-written CUDA kernels for the hot attention op — the counterpart of
``tpudl/pallas_ops.py``.

:func:`flash_attention` is the forward of tiled flash attention
(``csrc/flash_attn_fwd.cu``, built by :mod:`tpudl_torch._build`): it
never materialises the ``[Sq, Sk]`` score matrix, returns the per-row
log-sum-exp for exact partial-softmax merges, and masks causally on
global positions ``q_offset``/``k_offset`` so a caller holding a shard of
the sequence stays correct.

Routing is by the tensors' device, with no fallback: a CPU tensor runs
:func:`flash_attention_plain` (the dense reference of the same function,
which the CPU tests hold against tpudl and ``chip_smoke.py`` holds the
kernel against on the card); a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.

The TPU version's ``block_q``/``block_k`` (Mosaic tiling), ``interpret``
(the CPU emulation of Pallas) and ``precision`` (the MXU's bf16 passes)
are TPU artefacts and have no counterpart here: the kernel fixes its own
64-row tiles, handles any length, and accumulates in f32. The backward
kernels (dq, dk/dv) are not ported yet, so the wrapper refuses inputs that
require grad.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["flash_attention", "flash_attention_plain", "launches",
           "HEAD_DIMS"]

NEG_INF = -1e30  # finite -inf stand-in, as in the TPU kernel
HEAD_DIMS = (16, 32, 64, 128)  # template instances in flash_attn_fwd.cu
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the caller last set it to 0


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B, Sq, H, D] and k/v "
                         f"[B, Sk, H, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q/k/v devices differ: {q.device}, {k.device}, "
                         f"{v.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "flash_attention has no backward yet (the dq and dk/dv kernels "
            "are ROADMAP Queue 2 items 2-3); call it under torch.no_grad() "
            "or torch.inference_mode()")


def flash_attention(q, k, v, *, causal: bool = False, q_offset=0,
                    k_offset=0, return_lse: bool = False):
    """Attention ``softmax(QKᵀ/√d)·V``: q ``[B, Sq, H, D]``, k/v
    ``[B, Sk, H, D]`` → out ``[B, Sq, H, D]`` in q's dtype (and, with
    ``return_lse``, lse ``[B, Sq, H]`` f32 — ``logsumexp`` of each query
    row's visible scores, −1e30 for a row that sees no key).

    ``q_offset``/``k_offset`` (ints or 0-d integer tensors) are the
    blocks' global sequence positions for the causal mask. CPU tensors
    run :func:`flash_attention_plain`; CUDA tensors (f32 or bf16, head_dim
    in :data:`HEAD_DIMS`, last dim contiguous) run the kernel."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, k_offset=k_offset,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, "
                         f"got {q.device}")
    out, lse = _launch(q, k, v, causal=causal, q_offset=int(q_offset),
                       k_offset=int(k_offset))
    return (out, lse) if return_lse else out


def flash_attention_plain(q, k, v, *, causal: bool = False, q_offset=0,
                          k_offset=0, return_lse: bool = False):
    """The same function as :func:`flash_attention`, dense, in plain
    torch: f32 scores with the global-position causal mask, softmax with
    the fully-masked-row rule (output 0, lse −1e30), output cast back to
    q's dtype. It materialises the ``[B, H, Sq, Sk]`` scores."""
    _check(q, k, v)
    d = q.shape[-1]
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (1.0 / d ** 0.5)
    if causal:
        q_pos = int(q_offset) + torch.arange(q.shape[1], device=q.device)
        k_pos = int(k_offset) + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(m <= NEG_INF * 0.5, 0.0)
    l = p.sum(dim=-1)                                    # [B, H, Sq]
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / safe_l.transpose(1, 2)[..., None]
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0.0, torch.full_like(l, NEG_INF),
                      m[..., 0] + torch.log(safe_l))
    return out, lse.transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    from tpudl_torch._build import library

    lib = library("flash_attn_fwd")
    fn = lib.tpudl_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.tpudl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpudl_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.tpudl_cuda_error_string


def _launch(q, k, v, *, causal, q_offset, k_offset):
    global launches
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel has head_dim instances {HEAD_DIMS}, "
                         f"got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel needs the head_dim axis contiguous "
                         "(stride 1)")
    for name, off in (("q_offset", q_offset), ("k_offset", k_offset)):
        if not -2**31 <= off < 2**31:
            raise ValueError(f"{name} {off} does not fit int32")
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s_q, h), dtype=torch.float32, device=q.device)
    if b * h == 0 or s_q == 0:
        return out, lse
    fn, err_str = _fwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), _KERNEL_DTYPES[q.dtype], b, h, s_q, s_k, d,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                int(causal), q_offset, k_offset, 1.0 / d ** 0.5, stream)
    if rc:
        what = (err_str(rc).decode() if rc > 0
                else "no kernel instance for this dtype/head_dim")
        raise RuntimeError(f"flash_attn_fwd launch failed ({rc}): {what}")
    launches += 1
    return out, lse
