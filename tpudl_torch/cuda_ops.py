"""Hand-written CUDA kernels for the hot attention op — the counterpart of
``tpudl/pallas_ops.py``.

:func:`flash_attention` is tiled flash attention with its gradient: the
forward kernel (``csrc/flash_attn_fwd.cu``) never materialises the
``[Sq, Sk]`` score matrix, returns the per-row log-sum-exp for exact
partial-softmax merges, and masks causally on global positions
``q_offset``/``k_offset`` so a caller holding a shard of the sequence stays
correct. Under autograd it is one ``torch.autograd.Function`` (the
counterpart of tpudl's ``jax.custom_vjp`` ``_flash_fn``) whose backward
runs the dq and dk/dv kernels (``csrc/flash_attn_bwd.cu``) on both
cotangents, dO and dlse — the lse output is differentiable, as the ring
merge needs. All three kernels take their products on the tensor cores
at f32 accuracy (three TF32 passes, ``csrc/flash_attn_mma.cuh``) and
repeat bit for bit. The kernels are built by :mod:`tpudl_torch._build`.

Routing is by the tensors' device, with no fallback: CPU tensors run the
plain versions (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`: dense torch of the same functions,
which the CPU tests hold against tpudl and ``chip_smoke.py`` holds the
kernels against on the card); CUDA tensors launch the kernels or raise.
``launch_counts`` counts each kernel's launches, so a run can show that
its main path went through the kernels.

The TPU version's ``block_q``/``block_k`` (Mosaic tiling), ``interpret``
(the CPU emulation of Pallas) and ``precision`` (the MXU's bf16 passes)
are TPU artefacts and have no counterpart here: the kernels fix their own
64-row tiles, handle any length, and accumulate in f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "launch_counts", "HEAD_DIMS"]

NEG_INF = -1e30  # finite -inf stand-in, as in the TPU kernel
HEAD_DIMS = (16, 32, 64, 128)  # template instances in csrc/flash_attn_*.cu
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the caller last set them to 0
launch_counts = {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
                 "flash_attn_bwd_dkv": 0}


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


def flash_attention(q, k, v, *, causal: bool = False, q_offset=0,
                    k_offset=0, return_lse: bool = False):
    """Attention ``softmax(QKᵀ/√d)·V``: q ``[B, Sq, H, D]``, k/v
    ``[B, Sk, H, D]`` → out ``[B, Sq, H, D]`` in q's dtype (and, with
    ``return_lse``, lse ``[B, Sq, H]`` f32 — ``logsumexp`` of each query
    row's visible scores, −1e30 for a row that sees no key).

    ``q_offset``/``k_offset`` (ints or 0-d integer tensors) are the
    blocks' global sequence positions for the causal mask. CPU tensors
    run the plain versions; CUDA tensors (f32 or bf16, head_dim in
    :data:`HEAD_DIMS`, last dim contiguous) run the kernels. Gradients
    flow to q, k and v from out and lse alike; a row that sees no key
    gets exactly zero gradient."""
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, "
                         f"got {q.device}")
    out, lse = _FlashAttention.apply(q, k, v, bool(causal), int(q_offset),
                                     int(k_offset))
    return (out, lse) if return_lse else out


class _FlashAttention(torch.autograd.Function):
    """Forward and backward of :func:`flash_attention`; saves (q, k, v,
    out, lse) and the offsets. A cotangent autograd does not supply
    (out or lse unused) arrives as zeros."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             q_offset=q_offset,
                                             k_offset=k_offset,
                                             return_lse=True)
        else:
            out, lse = _launch_fwd(q, k, v, causal=causal,
                                   q_offset=q_offset, k_offset=k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, dlse,
                                         **ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention_plain(q, k, v, *, causal: bool = False, q_offset=0,
                          k_offset=0, return_lse: bool = False):
    """The same function as :func:`flash_attention`'s forward, dense, in
    plain torch: f32 scores with the global-position causal mask, softmax
    with the fully-masked-row rule (output 0, lse −1e30), output cast back
    to q's dtype. It materialises the ``[B, H, Sq, Sk]`` scores."""
    _check(q, k, v)
    s = _scores(q, k, causal, q_offset, k_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(m <= NEG_INF * 0.5, 0.0)
    l = p.sum(dim=-1)                                    # [B, H, Sq]
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / safe_l.transpose(1, 2)[..., None]
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0.0, torch.full_like(l, NEG_INF),
                      m[..., 0] + torch.log(safe_l))
    return out, lse.transpose(1, 2).contiguous()


def flash_attention_bwd(q, k, v, o, lse, do, dlse, *, causal: bool = False,
                        q_offset=0, k_offset=0):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` at (q, k, v),
    given its outputs ``o`` ``[B, Sq, H, D]`` and ``lse`` ``[B, Sq, H]``
    and their cotangents ``do`` and ``dlse`` (same shapes); each gradient
    comes in its input's shape and dtype. CPU tensors run
    :func:`flash_attention_bwd_plain`; CUDA tensors run the dq kernel,
    then the dk/dv kernel."""
    _check(q, k, v)
    _check_bwd(q, o, lse, do, dlse)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, dlse,
                                         causal=causal, q_offset=q_offset,
                                         k_offset=k_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda tensors, "
                         f"got {q.device}")
    # tpudl's dlt: the per-row constant −δ + dlse (δ = rowsum(dO ⊙ O))
    # that both kernels subtract from dO·Vᵀ
    dlt = ((do.float() * o.float()).sum(dim=-1) - dlse.float()).contiguous()
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    q, k, v, do = _aligned_rows(q, k, v, do)
    mask = dict(causal=causal, q_offset=int(q_offset), k_offset=int(k_offset))
    lse = lse.contiguous()
    dq = _launch_bwd_dq(q, k, v, do, lse, dlt, **mask)
    dk, dv = _launch_bwd_dkv(q, k, v, do, lse, dlt, **mask)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, lse, do, dlse, *,
                              causal: bool = False, q_offset=0, k_offset=0):
    """The same function as :func:`flash_attention_bwd`, dense, in plain
    f32 torch: p rebuilt from the saved lse (0 on a row whose lse is
    −1e30: it saw no key), ds = p ⊙ (dO·Vᵀ − dlt)·scale with
    dlt = rowsum(dO ⊙ O) − dlse, then dq = ds·K, dk = dsᵀ·Q, dv = pᵀ·dO,
    each cast to its input's dtype. It materialises the ``[B, H, Sq, Sk]``
    scores."""
    _check(q, k, v)
    _check_bwd(q, o, lse, do, dlse)
    scale = 1.0 / q.shape[-1] ** 0.5
    s = _scores(q, k, causal, q_offset, k_offset)
    lse_t = lse.float().transpose(1, 2)[..., None]      # [B, H, Sq, 1]
    p = torch.exp(torch.where(lse_t > NEG_INF * 0.5, s - lse_t, NEG_INF))
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dlt = (dof * o.float()).sum(dim=-1) - dlse.float()  # [B, Sq, H]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - dlt.transpose(1, 2)[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _scores(q, k, causal, q_offset, k_offset):
    """f32 ``QKᵀ/√d`` ``[B, H, Sq, Sk]``, −1e30 where the causal mask on
    global positions hides a key."""
    s = (torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
         * (1.0 / q.shape[-1] ** 0.5))
    if causal:
        q_pos = int(q_offset) + torch.arange(q.shape[1], device=q.device)
        k_pos = int(k_offset) + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    return s


def _check_bwd(q, o, lse, do, dlse):
    b, s_q, h, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if lse.shape != (b, s_q, h) or dlse.shape != (b, s_q, h):
        raise ValueError(f"lse {tuple(lse.shape)} and dlse "
                         f"{tuple(dlse.shape)} must be {(b, s_q, h)}")
    if lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32, got {lse.dtype}")


# kernel name → (source in csrc/, C symbol, pointer arguments, strides)
_ENTRY = {"flash_attn_fwd": ("flash_attn_fwd", "tpudl_flash_attn_fwd", 5, 9),
          "flash_attn_bwd_dq": ("flash_attn_bwd", "tpudl_flash_attn_bwd_dq",
                                7, 12),
          "flash_attn_bwd_dkv": ("flash_attn_bwd",
                                 "tpudl_flash_attn_bwd_dkv", 8, 12)}


@functools.lru_cache(maxsize=None)
def _kernel(name):
    """(C entry point, ``cudaGetErrorString``) of kernel ``name``, its
    library built and loaded on first use. Every entry point takes its
    pointers, then dtype/B/H/Sq/Sk/D, the strides, causal/q_offset/
    k_offset, the scale and the stream."""
    from tpudl_torch._build import library

    source, symbol, n_ptr, n_strides = _ENTRY[name]
    lib = library(source)
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * n_strides + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err_str = lib.tpudl_cuda_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, err_str


def _check_kernel_inputs(q, tensors, q_offset, k_offset):
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernels have head_dim instances "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash kernels need the head_dim axis contiguous "
                         "(stride 1)")
    for name, off in (("q_offset", q_offset), ("k_offset", k_offset)):
        if not -2**31 <= off < 2**31:
            raise ValueError(f"{name} {off} does not fit int32")


def _run(name, q, k, pointers, strides, *, causal, q_offset, k_offset):
    """Launch kernel ``name`` on the current stream; count it."""
    b, s_q, h, d = q.shape
    fn, err_str = _kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*pointers, _KERNEL_DTYPES[q.dtype], b, h, s_q, k.shape[1], d,
                *strides, int(causal), q_offset, k_offset, 1.0 / d ** 0.5,
                stream)
    if rc:
        what = (err_str(rc).decode() if rc > 0
                else "no kernel instance for this dtype/head_dim")
        raise RuntimeError(f"{name} launch failed ({rc}): {what}")
    launch_counts[name] += 1


def _rows_aligned16(t):
    """Whether every ``[B, S, H]`` row of ``t`` starts on a 16-byte
    boundary."""
    item = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(st * item % 16 == 0 for st in t.stride()[:3]))


def _aligned_rows(*tensors):
    """The kernels copy rows into shared memory in 16-byte cp.async
    chunks, so every row must start on a 16-byte boundary: each tensor
    whose rows do not is copied."""
    return tuple(t if _rows_aligned16(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in tensors)


def _strides(*tensors):
    return [st for t in tensors for st in t.stride()[:3]]


def _launch_fwd(q, k, v, *, causal, q_offset, k_offset):
    _check_kernel_inputs(q, (q, k, v), q_offset, k_offset)
    q, k, v = _aligned_rows(q, k, v)
    b, s_q, h, d = q.shape
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s_q, h), dtype=torch.float32, device=q.device)
    if b * h == 0 or s_q == 0:
        return out, lse
    _run("flash_attn_fwd", q, k,
         [t.data_ptr() for t in (q, k, v, out, lse)], _strides(q, k, v),
         causal=causal, q_offset=q_offset, k_offset=k_offset)
    return out, lse


def _launch_bwd_dq(q, k, v, do, lse, dlt, *, causal, q_offset, k_offset):
    """dq kernel: lse and dlt f32 ``[B, Sq, H]`` contiguous."""
    _check_kernel_inputs(q, (q, k, v, do), q_offset, k_offset)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    _run("flash_attn_bwd_dq", q, k,
         [t.data_ptr() for t in (q, k, v, do, lse, dlt, dq)],
         _strides(q, k, v, do), causal=causal, q_offset=q_offset,
         k_offset=k_offset)
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, dlt, *, causal, q_offset, k_offset):
    """dk/dv kernel: lse and dlt f32 ``[B, Sq, H]`` contiguous."""
    _check_kernel_inputs(q, (q, k, v, do), q_offset, k_offset)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    _run("flash_attn_bwd_dkv", q, k,
         [t.data_ptr() for t in (q, k, v, do, lse, dlt, dk, dv)],
         _strides(q, k, v, do), causal=causal, q_offset=q_offset,
         k_offset=k_offset)
    return dk, dv
