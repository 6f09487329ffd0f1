"""Ring attention — sequence parallelism over a mesh.

Port of ``tpudl/attention.py``: ``attention_reference``, ``shard_sequence``
and ``ring_attention``. Each entry of the ring axis holds one contiguous
block of the sequence (its Q, K and V), and the K/V blocks rotate one hop
along the axis per step (``n - 1`` hops for ``n`` entries: tpudl's
``_rotate_unless_last``), so no card ever holds the whole K/V or a
``[S, S]`` score matrix. tpudl runs the ring as one ``shard_map`` program
with ``ppermute`` hops; here one host thread issues every entry's work
(the entries' indices are Python ints), and each hop is a
device-to-device copy that PyTorch orders after the source card's work
and before the destination's use. Where entries repeat a card the copy
moves nothing.

Two ways of computing a hop, as in tpudl:

- ``use_pallas=True``: one :func:`tpudl_torch.cuda_ops.flash_attention`
  call per hop with ``q_offset``/``k_offset`` the blocks' global
  positions and ``return_lse=True`` (the hand-written CUDA kernels on the
  card, under autograd their dq and dk/dv kernels too), the partial
  outputs merged by their log-sum-exps in f32 (tpudl's merge, the guard
  for a denominator of 0 included). Under ``causal`` a hop whose K block
  lies strictly in the Q block's future is not launched at all, so a
  causal ring over ``n`` entries makes ``n(n+1)/2`` forward launches, and
  as many of each backward kernel, a call.
- otherwise the online-softmax scan in f32 (running max, normaliser and
  accumulator per query row), plain torch, which materialises one hop's
  ``[B, H, S/n, S/n]`` scores at a time.

Everything is differentiable: the gradients of K and V come back along
the hops they took.

Over a process group's mesh (one card a rank) each rank runs only its own
entry (:func:`ring_group`): rank ``i`` of the axis holds block ``i``, and
its K/V blocks travel through
:func:`tpudl_torch.collectives.ring_hop`, one send/recv pair a step whose
backward sends the gradients back the other way. Under ``causal`` rank
``i`` runs ``i + 1`` hops and receives only the blocks it or a later rank
reads; a rank still passes on what later ranks read, so every send has
its receive.
"""

from __future__ import annotations

import math

import torch

from tpudl_torch import collectives as C
from tpudl_torch import cuda_ops
from tpudl_torch import mesh as M

__all__ = ["ring_attention", "attention_reference", "shard_sequence",
           "ring_group"]


def attention_reference(q, k, v, causal: bool = False):
    """Dense single-device softmax attention ``softmax(QKᵀ/√d)V``.
    q, k, v: ``[batch, seq, heads, head_dim]``; the causal mask is the
    lower triangle of ``[Sq, Sk]`` (positions start at 0 on both)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def shard_sequence(tree, mesh, axis: str = M.DATA_AXIS):
    """``[B, S, ...]`` tensors with the SEQUENCE dim split over ``axis``:
    each leaf becomes a :class:`~tpudl_torch.mesh.Sharded` of its ``n``
    contiguous sequence blocks, block ``i`` on the axis's entry ``i`` (the
    first card of the other axis). :func:`ring_attention` takes and
    returns that form. A tuple, list or dict of tensors maps leaf by
    leaf."""
    if isinstance(tree, dict):
        return {k: shard_sequence(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, M.Sharded):
        return type(tree)(shard_sequence(v, mesh, axis) for v in tree)
    n = mesh.shape[axis]
    if tree.shape[1] % n:
        raise ValueError(
            f"sequence length {tree.shape[1]} not divisible by ring size {n}")
    return M.Sharded(block.to(mesh.entry(axis, i))
                     for i, block in enumerate(tree.chunk(n, dim=1)))


def ring_attention(q, k, v, mesh, *, axis: str = M.DATA_AXIS,
                   head_axis: str | None = None, causal: bool = False,
                   use_pallas: bool = False):
    """Sequence-parallel attention over ``mesh[axis]``.

    q, k, v: ``[batch, seq, heads, head_dim]``, either whole tensors (on
    any device; split here, and the result comes back whole on q's
    device) or :func:`shard_sequence`'s blocks (the result is blocks the
    same way). ``seq`` must divide by the axis size.

    ``head_axis`` also splits the HEADS over that mesh axis (ring × tensor
    parallelism): heads are independent in attention, so each of its
    entries runs its own ring over its head group; ``heads`` must divide
    by the axis size. ``use_pallas`` picks the flash-kernel hop (see the
    module docstring).

    Over a process group's mesh, q, k, v are this rank's sequence block
    (block ``i`` for data-axis index ``i``) and so is the result; under
    ``head_axis`` the rank runs the ring of its own heads, and the heads
    come back together over that axis."""
    if not mesh.local:
        return _ring_attention_group(q, k, v, mesh, axis=axis,
                                     head_axis=head_axis, causal=causal,
                                     use_pallas=use_pallas)
    n = mesh.shape[axis]
    blocks = isinstance(q, M.Sharded)
    seq = sum(t.shape[1] for t in q) if blocks else q.shape[1]
    if seq % n:
        raise ValueError(
            f"sequence length {seq} not divisible by ring size {n}")
    m = 1 if head_axis is None else mesh.shape[head_axis]
    heads = q[0].shape[2] if blocks else q.shape[2]
    if heads % m:
        raise ValueError(
            f"heads {heads} not divisible by mesh axis {head_axis!r} size "
            f"{m}")
    if blocks:
        qb, kb, vb = list(q), list(k), list(v)
    else:
        qb, kb, vb = (t.chunk(n, dim=1) for t in (q, k, v))
    hl = heads // m
    outs = [[None] * m for _ in range(n)]
    for j in range(m):
        devs = [mesh.entry(axis, i, j) for i in range(n)]

        def part(blk, i):
            return blk[:, :, j * hl:(j + 1) * hl].to(devs[i])

        col = ring([part(t, i) for i, t in enumerate(qb)],
                   [part(t, i) for i, t in enumerate(kb)],
                   [part(t, i) for i, t in enumerate(vb)],
                   devs, causal=causal, use_pallas=use_pallas)
        for i, o in enumerate(col):
            outs[i][j] = o
    dev = [qb[i].device for i in range(n)]
    out = [torch.cat([o.to(dev[i]) for o in outs[i]], dim=2)
           for i in range(n)]
    if blocks:
        return M.Sharded(out)
    return torch.cat([o.to(q.device) for o in out], dim=1)


def ring(qs, ks, vs, devices, *, causal: bool, use_pallas: bool) -> list:
    """One ring over ``devices``: entry ``i`` holds ``qs[i]``, ``ks[i]``,
    ``vs[i]`` (``[B, S/n, H, D]`` on ``devices[i]``, block ``i`` of the
    sequence); returns each entry's attention output, in its place.

    Step ``s`` computes, on every entry ``i``, the hop against the K/V
    block that originated on entry ``(i - s) mod n``, then (but after the
    last step) rotates the blocks one entry on. Under ``causal`` hops and
    copies that only carry future blocks are left out."""
    n = len(devices)
    s_loc = qs[0].shape[1]
    hop, finish = (_flash_hop, _flash_finish) if use_pallas else \
        (_plain_hop, _plain_finish)
    state: list = [None] * n
    kc, vc = list(ks), list(vs)
    for s in range(n):
        for i in range(n):
            src = (i - s) % n
            if causal and src > i:
                continue        # strictly future: weight exp(-inf), no launch
            state[i] = hop(state[i], qs[i], kc[i], vc[i], causal=causal,
                           q_offset=i * s_loc, k_offset=src * s_loc)
        if s < n - 1:
            # _rotate_unless_last: entry i takes entry i-1's block; under
            # causal only blocks some later hop reads are copied
            kc = [kc[i - 1].to(devices[i])
                  if not causal or i - s - 1 >= 0 else None
                  for i in range(n)]
            vc = [vc[i - 1].to(devices[i])
                  if not causal or i - s - 1 >= 0 else None
                  for i in range(n)]
    return [finish(st, q) for st, q in zip(state, qs)]


def _ring_attention_group(q, k, v, mesh, *, axis, head_axis, causal,
                          use_pallas):
    """:func:`ring_attention` on this rank's blocks over a group mesh."""
    m = 1 if head_axis is None else mesh.shape[head_axis]
    heads = q.shape[2]
    if heads % m:
        raise ValueError(
            f"heads {heads} not divisible by mesh axis {head_axis!r} size "
            f"{m}")
    if m > 1:
        hl, j = heads // m, mesh.axis_index(head_axis)
        q, k, v = (t[:, :, j * hl:(j + 1) * hl] for t in (q, k, v))
    out = ring_group(q, k, v, mesh, axis=axis, causal=causal,
                     use_pallas=use_pallas)
    if m > 1:
        out = C.gather(out, mesh.axis_group(head_axis), dim=2)
    return out


def ring_group(q, k, v, mesh, *, axis: str = M.DATA_AXIS, causal: bool,
               use_pallas: bool):
    """This rank's entry of a ring over ``axis`` of a process group's
    ``mesh``: ``q``, ``k``, ``v`` are its block ``i`` (``[B, S/n, H, D]``,
    ``i`` its index on the axis); returns its attention output.

    Step ``s`` runs the hop against the K/V block that originated on
    entry ``(i - s) mod n`` at offsets ``i·S/n`` and ``src·S/n``, then
    (but after the last step) sends the block held to entry ``i + 1``
    and receives entry ``i - 1``'s. Under ``causal`` the hops of strictly
    future blocks are left out (``i + 1`` of them run), a block is sent
    only while it is not one of them for the receiver, and nothing wraps
    from the last entry to the first."""
    n, i = mesh.shape[axis], mesh.axis_index(axis)
    group = mesh.axis_group(axis)
    s_loc = q.shape[1]
    hop, finish = (_flash_hop, _flash_finish) if use_pallas else \
        (_plain_hop, _plain_finish)
    nxt, prv = (mesh.axis_rank(axis, (i + 1) % n),
                mesh.axis_rank(axis, (i - 1) % n))
    state, kv, tokens = None, (k, v), []
    for s in range(n):
        src = (i - s) % n
        if kv is not None and not (causal and src > i):
            state = hop(state, q, *kv, causal=causal, q_offset=i * s_loc,
                        k_offset=src * s_loc)
        if s == n - 1:
            break
        send = kv is not None and (not causal or i + 1 < n)
        recv = not causal or i - s - 1 >= 0
        if not (send or recv):
            continue
        kv, token = C.ring_hop(kv if send else None, (k, v), group,
                               to=nxt if send else None,
                               frm=prv if recv else None)
        tokens.append(token)
    out = finish(state, q)
    if out.requires_grad:
        for token in tokens:   # 0: ties every hop's backward to the output
            out = out + token
    return out


def _flash_hop(state, q, k, v, *, causal, q_offset, k_offset):
    """One flash-kernel hop merged into ``state`` = (o f32, lse) by the
    blocks' log-sum-exps, as tpudl's ``_ring_attention_pallas`` merges. A
    first hop is the merge into (0, −1e30), whose result is the hop's
    own output."""
    ob, lb = cuda_ops.flash_attention(q, k, v, causal=causal,
                                      q_offset=q_offset, k_offset=k_offset,
                                      return_lse=True)
    if state is None:
        return ob.float(), lb
    o, lse = state
    m = torch.maximum(lse, lb)
    w_prev, w_blk = torch.exp(lse - m), torch.exp(lb - m)
    denom = w_prev + w_blk
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = (o * w_prev[..., None]
         + ob.float() * w_blk[..., None]) / safe[..., None]
    return o, m + torch.log(safe)


def _flash_finish(state, q):
    return state[0].to(q.dtype)


def _plain_hop(state, q, k, v, *, causal, q_offset, k_offset):
    """One online-softmax step of tpudl's plain ring, in f32: ``state`` =
    (running max ``m``, normaliser ``l``, accumulator ``acc``), ``[B, H,
    Sq]``, ``[B, H, Sq]`` and ``[B, H, Sq, D]``."""
    b, s_q, h, d = q.shape
    if state is None:
        m = torch.full((b, h, s_q), float("-inf"), device=q.device)
        state = (m, torch.zeros_like(m),
                 torch.zeros((b, h, s_q, d), device=q.device))
    m, l, acc = state
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if causal:
        q_pos = q_offset + torch.arange(s_q, device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        scores = scores.masked_fill(q_pos[:, None] < k_pos[None, :],
                                    float("-inf"))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # rows with no visible key yet keep m_new == -inf: correction 0, not NaN
    corr = torch.where(torch.isinf(m), torch.zeros_like(m),
                       torch.exp(m - m_new))
    p = torch.exp(scores - m_new[..., None])
    p = torch.where(torch.isinf(m_new)[..., None], torch.zeros_like(p), p)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v.float())
    return m_new, l, acc


def _plain_finish(state, q):
    _m, l, acc = state
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return out.transpose(1, 2).to(q.dtype)
