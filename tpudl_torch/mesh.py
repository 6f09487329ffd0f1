"""The device mesh — the port's counterpart of tpudl's mesh.

Port of ``tpudl/mesh.py``. tpudl lays a ``(data, model)`` grid of devices
under one SPMD program; the port has two forms of :class:`Mesh` with the
same ``shape``:

- a **local mesh**: a ``(data, model)`` grid of the cards this process
  drives (``grid``, row-major over ``devices=`` as tpudl lays out
  ``jax.devices()``), tpudl's ``build_mesh()``. One thread launches every
  card's work. On the data axis a batch is padded to a multiple of the
  axis and split into one contiguous shard a row (:func:`transfer_batch`;
  ``devices`` are the rows' first cards), each row runs its shard on its
  own replica of the model (:func:`replicate`, :class:`PerDevice`), and
  the outputs come back in row order. ``Frame.map_batches(mesh=)``, the
  stages, the UDFs, ``Dataset(mesh=)`` and the estimator's data-parallel
  fit take it. The model axis carries the LM's tensor and expert
  parallelism and its pipeline stages, and the data axis its ring
  attention (:mod:`tpudl_torch.attention`, :mod:`tpudl_torch.pipeline`,
  ``TinyCausalLM(mesh=, tp=True)``), through the differentiable
  :func:`sum_to` and :func:`all_sum`;
- a **process-group mesh**: one rank's place in a ``torch.distributed``
  group, one card a process — what ``HorovodRunner`` hands its
  ``train_fn``. The group's ranks lay out a ``(data, model)`` grid
  row-major (rank ``r * n_model + j`` is entry ``(r, j)``, as tpudl lays
  out ``jax.devices()``), with one sub-group a row (the model axis) and
  one a column (the data axis); :mod:`tpudl_torch.collectives` runs the
  LM's tensor and expert parallelism over the rows and its ring over the
  columns (``TinyCausalLM(mesh=, tp=True)``).

- :func:`build_mesh` builds a local mesh over ``devices=`` (a device may
  repeat: ``["cpu"] * 8`` on the host, ``["cuda:0"] * 4`` as a one-card
  rehearsal of a 2×2 grid), else this rank's place in the joined process
  group's ``(n_data, n_model)`` grid (``n_model`` or
  ``TPUDL_MESH_MODEL``), else every visible card.
- :func:`replicate` broadcasts rank 0's tensors in place over a group
  (or the first entry's over one axis of it), and over a local mesh
  returns one copy a distinct device, made once.
- :func:`transfer_batch` copies a padded host batch's shards to their
  cards, each on its card's copy stream; :func:`shard_batch` is this
  rank's rows of a global batch on a group, the same as
  :func:`transfer_batch` on a local mesh.
- :func:`all_reduce_mean` averages tensors over one axis of the group
  (the data axis by default) in one flattened all-reduce per dtype (the
  gradient reduction of :func:`tpudl_torch.train.make_train_step`), and
  counts its calls and bytes in ``mesh.allreduce.calls`` and
  ``mesh.allreduce.bytes``.
  :func:`reduce_add` and :func:`broadcast` are the local mesh's
  collectives (``torch.cuda.comm`` across distinct cards, plain sums and
  copies elsewhere).
- :func:`pad_batch` / :func:`unpad_batch` are tpudl's.
- :func:`use_mesh` makes the mesh's (first) card the current CUDA device.
- :func:`bytes_per_device` / :func:`require_hbm_fit` are tpudl's
  placement gate: under an explicit ``TPUDL_DATA_HBM_BUDGET_MB``, a
  placement whose bytes a card exceed the budget raises ``DeviceOOM``
  before any copy (:func:`replicate` on a local mesh,
  ``TinyCausalLM.shard_params``, the estimator's replicated trials).
  :func:`transfer_batch` carries the ``mesh.transfer`` fault point.
"""

from __future__ import annotations

import contextlib
import copy as _copy
import dataclasses
import math
import os
import weakref

import numpy as np
import torch
import torch.distributed as dist

from tpudl_torch import distributed as D
from tpudl_torch.obs import metrics as _metrics
from tpudl_torch.testing import faults as _faults
from tpudl_torch.testing import tsan as _tsan

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "NamedSharding",
           "model_axis_size", "build_mesh", "replicate", "PerDevice",
           "Sharded", "shard_rows", "transfer_batch", "shard_batch",
           "all_reduce_mean", "reduce_add", "broadcast", "sum_to", "all_sum",
           "barrier", "pad_batch", "unpad_batch", "use_mesh", "on_device",
           "bytes_per_device", "require_hbm_fit"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of ``size`` entries on the ``data`` axis.

    A process-group mesh is this rank's place in ``group`` (the world):
    ``device`` is the rank's card, ``devices`` is ``(device,)``, ``rank``
    the process rank, ``coords`` its ``(data, model)`` entry of the
    ``(size, n_model)`` grid and ``axis_groups`` the sub-groups of its
    column (the data axis) and its row (the model axis). A local mesh has
    no group (``group is None``, ``rank`` 0): ``grid`` holds its ``(data,
    model)`` rows of cards, ``devices`` are the rows' first cards, in
    shard order, and ``device`` is the first of them."""

    size: int
    rank: int
    device: torch.device
    group: object  # the torch.distributed ProcessGroup; None on a local mesh
    devices: tuple = ()
    grid: tuple = ()  # one tuple of cards a data row; () = one a device
    n_model: int = 1  # a group mesh's model axis
    coords: tuple = (0, 0)  # a group mesh: this rank's (data, model) entry
    axis_groups: tuple = (None, None)  # a group mesh: (column, row) groups

    def __post_init__(self):
        if not self.devices:
            object.__setattr__(self, "devices", (self.device,))
        if not self.grid:
            object.__setattr__(self, "grid",
                               tuple((d,) for d in self.devices))

    @property
    def shape(self) -> dict:
        """tpudl's ``mesh.shape``: ``{"data": rows, "model": columns}``."""
        cols = len(self.grid[0]) if self.local else self.n_model
        return {DATA_AXIS: self.size, MODEL_AXIS: cols}

    @property
    def local(self) -> bool:
        """True for a mesh of this process's own cards (no group)."""
        return self.group is None

    @property
    def world(self) -> int:
        """The processes of the mesh: every entry of a group's grid, 1 for
        a local mesh."""
        return 1 if self.local else self.size * self.n_model

    def _axis(self, axis: str) -> int:
        if axis not in (DATA_AXIS, MODEL_AXIS):
            raise ValueError(f"unknown mesh axis {axis!r}; the axes are "
                             f"{DATA_AXIS!r} and {MODEL_AXIS!r}")
        return 0 if axis == DATA_AXIS else 1

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on a local mesh)."""
        return self.coords[self._axis(axis)]

    def axis_group(self, axis: str):
        """The sub-group of the ranks that share this rank's place on the
        other axis: its column for ``data``, its row for ``model``."""
        return self.axis_groups[self._axis(axis)]

    def axis_rank(self, axis: str, index: int) -> int:
        """The process rank of entry ``index`` along ``axis`` in this
        rank's column (``data``) or row (``model``)."""
        r, j = self.coords
        return (index * self.n_model + j if self._axis(axis) == 0
                else r * self.n_model + index)

    def distinct_devices(self) -> list:
        """The mesh's devices once each, in order of first appearance."""
        return list(dict.fromkeys(self.devices))

    def entry(self, axis: str, index: int, other: int = 0) -> torch.device:
        """The card at ``index`` on ``axis`` and ``other`` on the other
        axis."""
        return (self.grid[index][other] if self._axis(axis) == 0
                else self.grid[other][index])

    def row(self, index: int) -> "Mesh":
        """Data row ``index`` as a local ``(1, model)`` mesh."""
        cards = self.grid[index]
        return Mesh(1, 0, cards[0], None, (cards[0],), (cards,))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """tpudl's ``NamedSharding(mesh, PartitionSpec(...))``: ``spec`` names
    the mesh axis each dim of a tensor is split over (None: whole).
    ``TinyCausalLM.param_shardings`` gives one a leaf."""

    mesh: Mesh
    spec: tuple = ()

    def dim(self, axis: str = MODEL_AXIS):
        """The dim split over ``axis``, or None when the leaf is whole on
        every card of it."""
        return self.spec.index(axis) if axis in self.spec else None


# copied from tpudl/mesh.py:model_axis_size
def model_axis_size() -> int:
    """The process-default tensor-parallel degree: ``TPUDL_MESH_MODEL``,
    floor 1."""
    try:
        return max(1, int(os.environ.get("TPUDL_MESH_MODEL", "1")))
    except ValueError:
        return 1


def _canonical(device) -> torch.device:
    """A mesh entry as a ``torch.device``: a card without an index is the
    current one, so that every shard names the card it runs on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh device {str(device)!r} but torch.cuda.is_available() "
                "is False; build the mesh over CPU devices "
                "(build_mesh(devices=['cpu'] * n)) to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_mesh(n_data: int | None = None, n_model: int | None = None, *,
               devices=None, device=None) -> Mesh:
    """A mesh of ``n_data`` entries on the ``data`` axis by ``n_model``
    on the ``model`` axis (``TPUDL_MESH_MODEL``, 1 by default).

    - ``devices=[...]``: a local ``(n_data, n_model)`` grid over that
      list, row-major (its first ``n_data * n_model`` entries; ``n_data``
      defaults to ``len(devices) // n_model``). A device may repeat:
      ``["cpu"] * 8`` runs eight shards on the host, and
      ``["cuda:0"] * 4`` with ``n_model=2`` runs a 2×2 grid on one card.
    - Otherwise, inside a joined process group
      (:func:`tpudl_torch.distributed.initialize`, ``HorovodRunner``):
      this rank's place in the group's ``(n_data, n_model)`` grid, whose
      entries must be the group's ranks (``n_data`` defaults to the world
      size over ``n_model``). Rank ``r * n_model + j`` is entry ``(r,
      j)``. Every rank must call it, with the same sizes: it creates one
      sub-group a row and one a column on every rank, in one order.
      ``device`` defaults to ``cuda:<rank>`` when the group runs NCCL,
      else the CPU.
    - Otherwise a local grid over the visible cards, tpudl's
      ``build_mesh()`` over ``jax.devices()``. Without a card this
      raises: the port never drops to the CPU unasked."""
    if n_model is None:
        n_model = model_axis_size()
    n_model = max(1, int(n_model))
    if devices is None and dist.is_initialized():
        return _group_mesh(n_data, n_model, device)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_mesh() found no CUDA card (torch.cuda.is_available() "
                "is False); name the devices to run on the host: "
                "build_mesh(devices=['cpu'] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_canonical(d) for d in devices]
    if n_data is None:
        n_data = len(devs) // n_model
    want = n_data * n_model
    if n_data < 1 or want > len(devs):
        raise ValueError(f"mesh {n_data}x{n_model} needs {want} devices, "
                         f"have {len(devs)}")
    grid = tuple(tuple(devs[r * n_model:(r + 1) * n_model])
                 for r in range(n_data))
    rows = tuple(row[0] for row in grid)
    return Mesh(n_data, 0, rows[0], None, rows, grid)


def _group_mesh(n_data, n_model: int, device) -> Mesh:
    """This rank's place in the joined group's ``(n_data, n_model)`` grid
    (see :func:`build_mesh`)."""
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = size // n_model
    want = n_data * n_model
    if n_data < 1 or want != size:
        raise ValueError(f"mesh {n_data}x{n_model} needs {want} devices, "
                         f"have {size} (the process group's ranks, one an "
                         "entry)")
    if device is None:
        device = (torch.device("cuda", rank) if dist.get_backend() == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    rows = _new_groups([range(r * n_model, (r + 1) * n_model)
                        for r in range(n_data)])
    cols = _new_groups([range(j, size, n_model) for j in range(n_model)])
    r, j = divmod(rank, n_model)
    groups = (cols[j], rows[r])
    for g in groups:   # each communicator made now, by all of its ranks
        if g is not None:
            dist.all_reduce(torch.zeros(1, device=device), group=g)
    return Mesh(n_data, rank, device, dist.group.WORLD, n_model=n_model,
                coords=(r, j), axis_groups=groups)


def _new_groups(rank_lists) -> list:
    """One process group a list of ranks, made on every rank in the same
    order, as ``new_group`` needs (None for one rank, the world group for
    all of them)."""
    world = dist.get_world_size()
    out = []
    for ranks in map(list, rank_lists):
        if len(ranks) == world:
            out.append(dist.group.WORLD)
        elif len(ranks) == 1:
            out.append(None)
        else:
            out.append(dist.new_group(ranks))
    return out


@contextlib.contextmanager
def on_device(device):
    """Make ``device`` the current CUDA device for the block (nothing for
    a CPU device): its kernels, events and default stream are then that
    card's."""
    dev = torch.device(device)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            yield
    else:
        yield


class PerDevice:
    """One callable per device, as one function: a call runs the callable
    of its first tensor argument's device. A stage builds one from its
    per-device replicas (:func:`replicate`), so that the executor can hand
    every card's shard to the same function."""

    def __init__(self, fns: dict):
        self._fns = {torch.device(d): f for d, f in fns.items()}

    def __call__(self, *args):
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        try:
            fn = self._fns[dev]
        except KeyError:
            raise ValueError(
                f"no replica on {dev}; this function has replicas on "
                f"{sorted(map(str, self._fns))}") from None
        return fn(*args)

    @property
    def devices(self) -> list:
        return list(self._fns)


class Sharded(tuple):
    """One column of a batch as its per-card shards, in mesh order (a
    batch resident on a local mesh: ``Dataset(mesh=)`` and the device
    cache hold it so)."""

    @property
    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self))

    @property
    def devices(self) -> list:
        return [t.device for t in self]


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


def _flat_leaves(tree, path=()):
    """``(path, leaf)`` of every leaf of a tree of dicts and sequences (a
    module's parameters and buffers under their names)."""
    if isinstance(tree, torch.nn.Module):
        named = {**dict(tree.named_parameters()), **dict(tree.named_buffers())}
        for name, t in named.items():
            yield path + (name,), t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_leaves(v, path + (i,))
    else:
        yield path, tree


def _sharding_at(shardings, path):
    node = shardings
    for k in path:
        try:
            node = node[k]
        except (KeyError, IndexError, TypeError):
            return None
    return node


def bytes_per_device(tree, shardings=None) -> int:
    """The bytes a card holds when ``tree`` is placed under ``shardings``
    (a tree of :class:`NamedSharding` shaped like ``tree``, as
    ``TinyCausalLM.param_shardings`` gives; ``None``: whole on every
    card). A dim split over an axis holds ``1/size`` of its length, as
    tpudl's ``shard_shape``."""
    total = 0
    for path, leaf in _flat_leaves(tree):
        if leaf is None:
            continue
        shape = list(getattr(leaf, "shape", np.shape(leaf)))
        itemsize = (leaf.element_size() if isinstance(leaf, torch.Tensor)
                    else np.dtype(getattr(leaf, "dtype",
                                          np.asarray(leaf).dtype)).itemsize)
        sh = _sharding_at(shardings, path) if shardings is not None else None
        if isinstance(sh, NamedSharding):
            for d, axis in enumerate(sh.spec[:len(shape)]):
                if axis is not None:
                    shape[d] //= sh.mesh.shape[axis]
        total += int(np.prod(shape, dtype=np.int64)) * int(itemsize)
    return total


def require_hbm_fit(tree, shardings=None, *, what: str = "params") -> None:
    """tpudl's placement gate: refuse a placement whose bytes a card
    (:func:`bytes_per_device`) exceed the declared
    ``TPUDL_DATA_HBM_BUDGET_MB``, typed
    (:class:`~tpudl_torch.frame.supervisor.DeviceOOM`), before any copy.
    Armed only by an explicit budget (the device cache's derived default
    is a cache policy, not a placement veto); an explicit 0 forbids
    cache residency and leaves placements ungated."""
    if not os.environ.get("TPUDL_DATA_HBM_BUDGET_MB"):
        return
    from tpudl_torch.data.device_cache import budget_bytes

    budget = budget_bytes(allow_device=False)
    if not budget:
        return
    need = bytes_per_device(tree, shardings)
    if need > budget:
        from tpudl_torch.frame.supervisor import DeviceOOM

        raise DeviceOOM(
            f"{what} need {need / 2**20:.1f} MB per device but "
            f"TPUDL_DATA_HBM_BUDGET_MB grants {budget / 2**20:.1f} MB — "
            f"shard over a wider 'model' axis (build_mesh(n_model=...), "
            f"param_shardings) or raise the budget")


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


# replicas of a module on a local mesh, made once a (module, device)
_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_REPLICAS_LOCK = _tsan.named_lock("mesh.replicas")


def _copy_to(tree, dev: torch.device):
    """``tree`` on ``dev``: a module deep-copied there (itself when all its
    tensors are there already), tensors moved, containers rebuilt."""
    if isinstance(tree, torch.nn.Module):
        if all(t.device == dev for t in _tensors(tree)):
            return tree
        with _REPLICAS_LOCK:
            cached = _REPLICAS.get(tree, {}).get(dev)
        if cached is not None:
            return cached
        with torch.no_grad():
            rep = _copy.deepcopy(tree).to(dev)
        with _REPLICAS_LOCK:
            return _REPLICAS.setdefault(tree, {}).setdefault(dev, rep)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev)
    if isinstance(tree, dict):
        return {k: _copy_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_to(v, dev) for v in tree)
    return tree


def replicate(tree, mesh: Mesh, axis: str | None = None):
    """tpudl's replicated placement of ``tree`` (a module, a tensor, or
    dicts and sequences of tensors) over ``mesh``.

    Over a process group, rank 0's tensors are broadcast to every rank in
    place and ``tree`` is returned; with ``axis``, the tensors of the
    entry at index 0 of this rank's column (``data``) or row (``model``)
    go to the other ranks of it (a leaf split over the model axis is
    replicated over the data axis only). Over a local mesh the result is
    ``{device: copy}`` with one copy a distinct device of the mesh: a
    module's copy is made once and cached by device (a snapshot of its
    weights then), the source itself serves its own device, and tensors
    are moved."""
    if mesh.local:
        require_hbm_fit(tree, None, what="replicated tree")
        return {dev: _copy_to(tree, dev) for dev in mesh.distinct_devices()}
    group, src = mesh.group, 0
    if axis is not None:
        group, src = mesh.axis_group(axis), mesh.axis_rank(axis, 0)
    if group is not None:
        _coalesced(_tensors(tree),
                   lambda flat: dist.broadcast(flat, src=src, group=group),
                   mesh.device)
    return tree


# one host→card copy stream a card, shared by every transfer to it
_COPY_STREAMS: dict = {}


def _copy_stream(dev: torch.device):
    with _REPLICAS_LOCK:
        stream = _COPY_STREAMS.get(dev)
        if stream is None:
            stream = _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
        return stream


def shard_rows(tensors, count: int) -> list:
    """The ``count`` contiguous row blocks of a batch (one list of views a
    block); the batch's rows must be a multiple of ``count``
    (:func:`pad_batch`)."""
    tensors = list(tensors)
    rows = int(tensors[0].shape[0]) if tensors else 0
    if rows % count:
        raise ValueError(
            f"a batch of {rows} rows does not split over {count} mesh "
            "entries; pad it to a multiple (tpudl_torch.mesh.pad_batch)")
    per = rows // count
    return [[t[i * per:(i + 1) * per] for t in tensors]
            for i in range(count)]


def transfer_batch(tensors, mesh: Mesh, *, block: bool = False) -> list:
    """The local mesh's infeed edge: a padded host batch (one tensor a
    column, rows a multiple of the data axis) split into one contiguous
    shard a mesh entry, each shard on its device. On a card each copy
    runs from pinned memory on that card's own copy stream, and the
    card's current stream waits for it, so the copies overlap the other
    cards' work; ``block=True`` waits for them (the conservative arm,
    ``TPUDL_MESH_FAST_PATH=0``). A shard already on its device is passed
    through. Returns one list of tensors a mesh entry."""
    # the transfer fault point: every mesh host→card copy crosses it
    _faults.fire("mesh.transfer")
    out = []
    for dev, part in zip(mesh.devices, shard_rows(tensors, mesh.size)):
        if dev.type != "cuda":
            out.append([t.to(dev) for t in part])
            continue
        with torch.cuda.device(dev):
            current = torch.cuda.current_stream()
            side = _copy_stream(dev)
            with torch.cuda.stream(side):
                moved = [t.to(dev, non_blocking=True) for t in part]
            current.wait_stream(side)
            for t in moved:
                # allocated on the copy stream, read on the current one
                t.record_stream(current)
            if block:
                side.synchronize()
        out.append(moved)
    return out


def reduce_add(parts, devices) -> list:
    """Sum tensors across mesh entries onto the first: ``parts[i]`` is
    entry ``i``'s list of tensors (``devices[i]``), and the result is the
    list of their sums on ``devices[0]``. Across distinct cards this is
    ``torch.cuda.comm.reduce_add_coalesced``; where a device repeats (or
    on the CPU) it is plain sums in entry order."""
    devs = [torch.device(d) for d in devices]
    if (len(devs) > 1 and len(set(devs)) == len(devs)
            and all(d.type == "cuda" for d in devs)):
        from torch.cuda import comm

        return list(comm.reduce_add_coalesced(
            [list(p) for p in parts], destination=devs[0].index))
    out = [t.clone() for t in parts[0]]
    for p in parts[1:]:
        for o, t in zip(out, p):
            o.add_(t.to(o.device))
    return out


def broadcast(tensors, replicas, devices) -> None:
    """Copy the first entry's ``tensors`` into every other entry's list
    ``replicas[i]`` (same order; ``replicas[0]`` is the first entry's own
    and is left alone), in place: one ``torch.cuda.comm.
    broadcast_coalesced`` to the other distinct cards, plain copies where
    a device repeats or on the CPU."""
    devs = [torch.device(d) for d in devices]
    src = devs[0]
    far = [i for i in range(1, len(devs))
           if src.type == "cuda" and devs[i].type == "cuda"
           and devs[i] != src]
    if len({devs[i] for i in far}) != len(far):
        far = []
    with torch.no_grad():
        if far:
            from torch.cuda import comm

            copies = comm.broadcast_coalesced(
                list(tensors), [src.index] + [devs[i].index for i in far])
            for i, got in zip(far, copies[1:]):
                for dst, t in zip(replicas[i], got):
                    dst.copy_(t)
        for i in range(1, len(devs)):
            if i not in far:
                for dst, t in zip(replicas[i], tensors):
                    dst.copy_(t)


def sum_to(parts, device) -> torch.Tensor:
    """The sum of ``parts`` (one tensor a mesh entry), on ``device``, in
    entry order: differentiable (autograd sends each part its share of
    the gradient back to its own card). A part already on ``device``
    moves nothing, so entries that repeat a card take plain sums."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def all_sum(parts, devices) -> list:
    """tpudl's ``psum`` over a local mesh axis, differentiable: the sum of
    ``parts[i]`` (on ``devices[i]``), one copy on each device. Each
    cross-card copy is a device-to-device copy that PyTorch orders after
    the source card's work and before the destination's use."""
    total = sum_to(parts, devices[0])
    return [total] + [total.to(d) for d in devices[1:]]


def all_reduce_mean(tensors, mesh: Mesh, axis: str = DATA_AXIS) -> None:
    """Replace each tensor by its mean over ``axis`` of the group (this
    rank's column for ``data``, its row for ``model``): one all-reduce (a
    sum) per dtype of a flat copy, then a division by the axis size."""
    group = mesh.axis_group(axis)
    if group is None:      # an axis of one rank: each tensor is its mean
        return
    n = mesh.shape[axis]

    def reduce(flat):
        dist.all_reduce(flat, group=group)
        if n > 1:
            flat.div_(n)

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
    """On a process-group mesh, this rank's rows of every leaf of a global
    batch (numpy arrays or tensors; a tuple, list or dict of them), as
    tensors on the rank's device: the block of its data-axis index, so
    every rank of one row gets the same rows. On a local mesh, one such tree a mesh
    entry, each holding that entry's contiguous block of rows on its
    device (:func:`transfer_batch`; the rows must split evenly)."""
    if mesh.local:
        leaves, rebuild = _flatten(tree)
        tensors = [x if isinstance(x, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(x))
                   for x in leaves]
        return [rebuild(part) for part in transfer_batch(tensors, mesh)]
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh) for v in tree)
    rows = D.global_batch(tree, index=mesh.axis_index(DATA_AXIS),
                          count=mesh.size)
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    return rows.to(mesh.device)


def _flatten(tree):
    """The leaves of a tuple, list or dict of arrays (or one array) and
    the function that rebuilds the tree from new leaves."""
    if isinstance(tree, dict):
        keys = list(tree)
        return ([tree[k] for k in keys],
                lambda leaves: dict(zip(keys, leaves)))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        return list(tree), lambda leaves: kind(leaves)
    return [tree], lambda leaves: leaves[0]


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
    """Run the block with the mesh's card (a rank's card; a local mesh's
    first) as the current CUDA device, so that ``device="cuda"`` inside
    it means that card."""
    with on_device(mesh.device):
        yield mesh
