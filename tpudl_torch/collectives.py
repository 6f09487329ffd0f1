"""Collectives over one axis of a process-group mesh, that autograd
understands.

tpudl's model axis is one SPMD program, and XLA puts the collectives in
where the shardings meet. The port runs one process a card (Megatron's
layout): each rank holds its own entry of the ``(data, model)`` grid, and
the collectives between entries are NCCL's (gloo's on the CPU) over the
axis's sub-group (:meth:`tpudl_torch.mesh.Mesh.axis_group`). Each is a
``torch.autograd.Function``, so a forward through them trains:

- :func:`reduce_sum`: the row-parallel sum. Forward all-reduce, backward
  the identity: what follows it is computed alike on every rank of the
  group, so each rank already holds the whole gradient of its output;
- :func:`copy_in`: its partner at the entry of a column-parallel region.
  Forward the identity, backward all-reduce: each rank's backward holds
  only its own columns' share of the input's gradient;
- :func:`psum`: JAX's ``psum``, an all-reduce both ways (it is its own
  transpose): the sum of parts that each rank computed from its own share
  of the work, where every rank goes on to seed the backward of the sum;
- :func:`gather`: the inputs of the group's ranks joined along a dim.
  Backward keeps this rank's slice of the gradient (what follows is
  computed alike on every rank);
- :func:`all_to_all`: ``all_to_all_single`` over equal blocks of dim 0,
  both ways (MoE's dispatch and combine: tpudl's capacity makes every
  rank's buffers one size);
- :func:`ring_hop`: one hop of a ring, a send and a receive in one
  ``batch_isend_irecv``; its backward sends the received blocks'
  gradients back the other way and receives those of the blocks sent.

A group of ``None`` (an axis of one rank) makes each of them the
identity. The ranks of a group must call them in the same order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["reduce_sum", "copy_in", "psum", "gather", "all_to_all", "ring_hop",
           "group_size", "all_gather"]


def group_size(group) -> int:
    """The ranks of ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ``group``'s tensors joined along ``dim`` in rank order (no
    autograd; every rank's ``t`` has one shape)."""
    if group_size(group) == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.rank = dim, dist.get_rank(group)
        ctx.width = x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width)
                .contiguous(), None, None)


def _all_to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, on every rank; the gradient passes
    through unchanged (Megatron's ``g``)."""
    return x if group_size(group) == 1 else _ReduceSum.apply(x, group)


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group`` (Megatron's
    ``f``)."""
    return x if group_size(group) == 1 else _CopyIn.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, on every rank; the gradients of the
    ranks' sums are summed back onto each ``x`` (JAX's ``psum``)."""
    return x if group_size(group) == 1 else _Psum.apply(x, group)


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ``group``'s ``x`` joined along ``dim`` in rank order; the
    gradient of this rank's slice comes back to it."""
    return x if group_size(group) == 1 else _Gather.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s dim 0 in ``n`` equal blocks, block ``k`` to rank ``k`` of
    ``group``; the result holds the block each rank sent here, in rank
    order. Differentiable (the backward is the same exchange)."""
    return x if group_size(group) == 1 else _AllToAll.apply(x, group)


def _exchange(sends, to, recvs, frm, group) -> None:
    ops = [dist.P2POp(dist.isend, t, to, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, frm, group) for t in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _empty(spec):
    shape, dtype, device = spec
    return torch.empty(shape, dtype=dtype, device=device)


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, anchor, *sends):
        group, to, frm, like = meta
        ctx.meta = meta
        ctx.sent = [(t.shape, t.dtype, t.device) for t in sends]
        recvs = [_empty(spec) for spec in like] if frm is not None else []
        _exchange([t.contiguous() for t in sends], to, recvs, frm, group)
        return (*recvs, anchor.new_zeros(()))

    @staticmethod
    def backward(ctx, *grads):
        group, to, frm, like = ctx.meta
        back = [_empty(spec).zero_() if g is None else g.contiguous()
                for g, spec in zip(grads[:-1], like)]
        got = [_empty(spec) for spec in ctx.sent]
        _exchange(back, frm, got, to, group)
        return (None, None, *got)


def ring_hop(sends, like, group, *, to: int | None, frm: int | None):
    """One hop of a ring over ``group``: send the tensors ``sends`` (None:
    nothing) to global rank ``to`` and receive as many tensors shaped like
    ``like`` from global rank ``frm`` (None: nothing), in one
    ``batch_isend_irecv``. Returns ``(received, token)``: ``received`` the
    list of tensors (None when nothing came), ``token`` a 0-d zero that
    the caller adds into its output, so that autograd runs this hop's
    backward (which receives the sent blocks' gradients) on every rank
    that took part, also one that received nothing."""
    sends = list(sends or ())
    specs = [(t.shape, t.dtype, t.device) for t in like]
    anchor = next((t for t in (*sends, *like) if t.requires_grad), like[0])
    out = _RingHop.apply((group, to, frm, specs if frm is not None else []),
                         anchor, *sends)
    return (list(out[:-1]) if frm is not None else None), out[-1]
