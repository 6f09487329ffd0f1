"""Pipeline parallelism — a GPipe microbatch schedule over a mesh axis.

Port of ``tpudl/pipeline.py`` (``pipeline_blocks``). With ``n`` stages
and ``m`` microbatches the schedule has ``m + n - 1`` ticks, and stage
``s`` works on microbatch ``t - s`` at tick ``t``: one host thread issues
every stage's work of a tick before the next tick's, so stages on
different cards run at once (the bubble is the usual ``(n-1)/(m+n-1)``
idle share). A stage's output reaches the next stage as a
device-to-device copy that PyTorch orders after the producing card's
work; autograd through the schedule is the reverse pipeline.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["pipeline_blocks"]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipeline_blocks(block_fn, stacked_params, x_micro, mesh, *,
                    axis: str, data_axis: str | None = None,
                    remat: bool = False):
    """Run ``block_fn`` sequentially over the stacked blocks, pipelined
    over ``mesh[axis]``.

    - ``block_fn(x, p) -> y``: one block, shape-preserving.
    - ``stacked_params``: a tensor or a (nested) dict of tensors whose
      leading dim is the BLOCK dim (``L`` blocks); stage ``s`` of the
      ``n`` on the axis runs blocks ``[s·L/n, (s+1)·L/n)`` on its card
      (each stage's slice is copied to its card once a call, inside the
      autograd graph, so the gradients reach ``stacked_params``).
      ``L % n == 0``.
    - ``x_micro``: ``[m, mb, ...]`` microbatched activations. With
      ``data_axis``, the ``mb`` dim is split over that axis too: each of
      its entries runs its own pipeline over its cards (DP×PP).

    ``remat=True`` checkpoints each stage application
    (``torch.utils.checkpoint``): backprop recomputes the stage's
    activations instead of holding them for every microbatch.

    Returns ``[m, mb, ...]`` outputs (the full sequential composition) on
    ``x_micro``'s device."""
    n = mesh.shape[axis]
    leaves = _leaves(stacked_params)
    if not leaves:
        raise ValueError("stacked_params has no leaves")
    n_blocks = leaves[0].shape[0]
    if any(leaf.shape[0] != n_blocks for leaf in leaves):
        raise ValueError("stacked_params leaves disagree on block count")
    if n_blocks % n:
        raise ValueError(
            f"{n_blocks} blocks not divisible by {n} pipeline stages")
    per = n_blocks // n
    m = x_micro.shape[0]
    n_rows = 1 if data_axis is None else mesh.shape[data_axis]
    if x_micro.shape[1] % n_rows:
        raise ValueError(f"microbatch of {x_micro.shape[1]} rows does not "
                         f"split over {n_rows} {data_axis!r} entries")

    def card(stage, row):
        return mesh.entry(axis, stage, row)

    # stage s's blocks, on each card that runs stage s
    stage_params = {}
    for row in range(n_rows):
        for s in range(n):
            dev = card(s, row)
            if (s, dev) not in stage_params:
                stage_params[(s, dev)] = _map(
                    lambda t: t[s * per:(s + 1) * per].to(dev),
                    stacked_params)

    def stage_apply(x, p_stage):
        for b in range(per):
            x = block_fn(x, _map(lambda t: t[b], p_stage))
        return x

    rows = x_micro.chunk(n_rows, dim=1)
    done = [[None] * m for _ in rows]
    buf = [[None] * n for _ in rows]  # buf[row][s]: stage s's next input
    for t in range(m + n - 1):
        for row, xs in enumerate(rows):
            # later stages first, so a tick reads the previous tick's
            # hand-offs before they are overwritten
            for s in reversed(range(n)):
                mb = t - s
                if not 0 <= mb < m:
                    continue
                dev = card(s, row)
                x_in = xs[mb].to(dev) if s == 0 else buf[row][s]
                p = stage_params[(s, dev)]
                y = (checkpoint(stage_apply, x_in, p, use_reentrant=False)
                     if remat else stage_apply(x_in, p))
                if s == n - 1:
                    done[row][mb] = y.to(x_micro.device)
                else:
                    buf[row][s + 1] = y.to(card(s + 1, row))
    return torch.cat([torch.stack(d) for d in done], dim=1)
