"""The data-parallel group — the port's counterpart of tpudl's mesh.

Port of ``tpudl/mesh.py`` for data parallelism over ``torch.distributed``
(one process per rank): tpudl lays a ``(data, model)`` grid of devices
under one SPMD program; here a :class:`Mesh` is this process's place in
the group — its size, rank, device and process group.

- :func:`build_mesh` spans the joined process group's ranks on the
  ``data`` axis. A ``model`` axis above 1 (``n_model`` or
  ``TPUDL_MESH_MODEL``) is refused (ROADMAP Queue 1, 'LM parallelism').
- :func:`replicate` broadcasts rank 0's tensors (a tree of tensors or a
  module's parameters and buffers) in place: tpudl's replicated
  placement.
- :func:`shard_batch` moves this rank's rows of a global batch to the
  rank's device (:func:`tpudl_torch.distributed.global_batch`).
- :func:`all_reduce_mean` averages tensors over the group in one
  flattened all-reduce per dtype (the gradient reduction of
  :func:`tpudl_torch.train.make_train_step`); it counts its calls and
  bytes in ``mesh.allreduce.calls`` and ``mesh.allreduce.bytes``.
- :func:`pad_batch` / :func:`unpad_batch` are tpudl's.
- :func:`use_mesh` makes the rank's card the current CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from tpudl_torch import distributed as D
from tpudl_torch.obs import metrics as _metrics

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "model_axis_size",
           "build_mesh", "replicate", "shard_batch", "all_reduce_mean",
           "barrier", "pad_batch", "unpad_batch", "use_mesh"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a data-parallel group of ``size`` ranks."""

    size: int
    rank: int
    device: torch.device
    group: object  # the torch.distributed ProcessGroup of the ranks

    @property
    def shape(self) -> dict:
        """tpudl's ``mesh.shape``: ``{"data": size, "model": 1}``."""
        return {DATA_AXIS: self.size, MODEL_AXIS: 1}


# copied from tpudl/mesh.py:model_axis_size
def model_axis_size() -> int:
    """The process-default tensor-parallel degree: ``TPUDL_MESH_MODEL``,
    floor 1."""
    try:
        return max(1, int(os.environ.get("TPUDL_MESH_MODEL", "1")))
    except ValueError:
        return 1


def build_mesh(n_data: int | None = None, n_model: int | None = None, *,
               device=None) -> Mesh:
    """The mesh of the joined process group (:func:`tpudl_torch.
    distributed.initialize`): ``n_data`` must be its world size (the
    default). ``device`` defaults to ``cuda:<rank>`` when the group runs
    NCCL, else the CPU."""
    if n_model is None:
        n_model = model_axis_size()
    if n_model > 1:
        raise NotImplementedError(
            f"a model axis of {n_model} (TPUDL_MESH_MODEL / n_model, tensor "
            "parallelism) is not ported to tpudl_torch yet (ROADMAP Queue 1, "
            "'LM parallelism')")
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs the process group: run under HorovodRunner "
            "or call tpudl_torch.distributed.initialize first")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_data is not None and n_data != size:
        raise ValueError(f"mesh of {n_data} ranks, but the process group "
                         f"has {size}")
    if device is None:
        device = (torch.device("cuda", rank)
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(size, rank, torch.device(device), dist.group.WORLD)


def _tensors(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _coalesced(tensors, collective, device) -> tuple[int, int]:
    """Run ``collective(flat)`` on one flat copy, on ``device``, of the
    tensors of each dtype and copy the results back; returns the number
    of collectives and the bytes they moved."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    nbytes = 0
    with torch.no_grad():
        for ts in groups.values():
            flat = torch.cat([t.reshape(-1).to(device) for t in ts])
            collective(flat)
            nbytes += flat.numel() * flat.element_size()
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view(t.shape))
    return len(groups), nbytes


def replicate(tree, mesh: Mesh):
    """Broadcast rank 0's tensors of ``tree`` (a module, a tensor, or
    dicts and sequences of tensors) to every rank, in place; returns
    ``tree``."""
    _coalesced(_tensors(tree),
               lambda flat: dist.broadcast(flat, src=0, group=mesh.group),
               mesh.device)
    return tree


def all_reduce_mean(tensors, mesh: Mesh) -> None:
    """Replace each tensor by its mean over the group: one all-reduce (a
    sum) per dtype of a flat copy, then a division by the group size."""
    def reduce(flat):
        dist.all_reduce(flat, group=mesh.group)
        if mesh.size > 1:
            flat.div_(mesh.size)

    # a named span, so that a profile can attribute the flatten, the
    # collective and the copy-back to the reduction
    with torch.profiler.record_function("mesh.all_reduce_mean"):
        calls, nbytes = _coalesced(list(tensors), reduce, mesh.device)
    _metrics.counter("mesh.allreduce.calls").inc(calls)
    _metrics.counter("mesh.allreduce.bytes").inc(nbytes)


def barrier(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def shard_batch(tree, mesh: Mesh):
    """This rank's rows of every leaf of a global batch (numpy arrays or
    tensors; a tuple, list or dict of them), as tensors on the rank's
    device."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh) for v in tree)
    rows = D.global_batch(tree, index=mesh.rank, count=mesh.size)
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    return rows.to(mesh.device)


# copied from tpudl/mesh.py:pad_batch
def pad_batch(arr: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the leading dim up to a multiple; returns (padded, n_pad).
    Padding repeats row 0 to keep dtype and scale realistic."""
    n = arr.shape[0]
    target = math.ceil(n / multiple) * multiple if n else multiple
    n_pad = target - n
    if n_pad == 0:
        return arr, 0
    pad = np.repeat(arr[:1] if n else np.zeros_like(arr, shape=(1, *arr.shape[1:])), n_pad, axis=0)
    return np.concatenate([arr, pad], axis=0), n_pad


# copied from tpudl/mesh.py:unpad_batch
def unpad_batch(arr, n_pad: int):
    return arr if n_pad == 0 else arr[: arr.shape[0] - n_pad]


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Run the block with the rank's card as the current CUDA device, so
    that ``device="cuda"`` inside it means this rank's card."""
    if mesh.device.type == "cuda":
        with torch.cuda.device(mesh.device):
            yield mesh
    else:
        yield mesh
