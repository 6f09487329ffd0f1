"""The process group and per-rank input sharding.

Port of ``tpudl/distributed.py``. tpudl joins hosts with
``jax.distributed.initialize`` and runs one SPMD program over them; the
port runs one process per rank, joined by ``torch.distributed``:

- :func:`initialize` is ``torch.distributed.init_process_group`` with a
  bounded timeout (NCCL on the card, gloo on the CPU). With no arguments
  it is a no-op, as tpudl's. The rendezvous is a ``tcp://<host>:<port>``
  coordinator on any machine (tpudl's ``coordinator_address``), a
  ``file://`` path shared by the ranks, or ``env://``. Users who start
  their ranks themselves then call
  ``tpudl_torch.mesh.build_mesh(n_data, n_model)`` on every rank: it
  lays the group's ranks out as tpudl's ``(data, model)`` grid (rank
  ``r * n_model + j`` at entry ``(r, j)``, one card a rank) and makes the
  sub-groups of its rows and columns, over which ``TinyCausalLM(mesh=,
  tp=True)`` runs its tensor and expert parallelism and its ring.
- :func:`process_count`, :func:`process_index`, :func:`is_primary` read
  the default group (1, 0 and True before it is joined).
- :func:`host_shard` is tpudl's.
- :func:`global_batch` becomes this rank's rows of the global batch: in
  tpudl each host feeds its slice of one global array; here every rank
  sees the global batch and keeps its contiguous block of rows.
"""

from __future__ import annotations

import datetime
import urllib.parse
from collections.abc import Sequence

import torch
import torch.distributed as dist

__all__ = ["initialize", "process_count", "process_index", "is_primary",
           "host_shard", "global_batch", "COLLECTIVE_TIMEOUT_S"]

# how long a collective (or the rendezvous) waits for a missing rank
# before it fails: a dead rank must not leave its siblings blocked for
# torch's 30-minute default
COLLECTIVE_TIMEOUT_S = 60.0

def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None) -> None:
    """Join the process group: ``coordinator_address`` is the rendezvous
    (``tcp://<host>:<port>`` on this machine or another, as tpudl's
    ``host:port``; ``file:///path`` on a file system every rank sees; or
    ``env://``, which reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``), ``num_processes`` the world size and
    ``process_id`` this rank (under ``env://`` either may be left to the
    variables). A bare ``host:port`` is taken as ``tcp://host:port``.
    ``backend`` defaults to NCCL when the card is available and gloo
    otherwise. With no arguments this is a documented no-op.

    Then ``build_mesh(n_data, n_model)`` on every rank gives each its
    place in the ``(n_data, n_model)`` grid of the group (``n_data *
    n_model`` must be ``num_processes``); under NCCL set each rank's card
    first (``torch.cuda.set_device``), rank ``r`` on ``cuda:r`` of its
    machine by default."""
    if coordinator_address is None and num_processes is None:
        return
    address = str(coordinator_address)
    if "://" not in address:
        address = f"tcp://{address}"
    scheme = urllib.parse.urlparse(address).scheme
    if scheme not in ("tcp", "file", "env"):
        raise ValueError(
            f"initialize({coordinator_address!r}): the rendezvous is "
            "tcp://<host>:<port>, file:///<path> or env://")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    sizes = {}
    if num_processes is not None:
        sizes["world_size"] = int(num_processes)
    if process_id is not None:
        sizes["rank"] = int(process_id)
    dist.init_process_group(
        backend, init_method=address,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **sizes)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on rank 0 (checkpoint writes, logging — the reference's
    rank-0 convention)."""
    return process_index() == 0


# copied from tpudl/distributed.py:host_shard
def host_shard(items: Sequence, *, index: int | None = None,
               count: int | None = None) -> list:
    """This rank's contiguous slice of a global work list (files, URIs).
    Pads by wrapping so every rank gets the same count (the ranks' steps
    must agree on batch shape)."""
    items = list(items)
    count = count if count is not None else process_count()
    index = index if index is not None else process_index()
    if count <= 1:
        return items
    per = -(-len(items) // count)  # ceil
    start = index * per
    shard = items[start:start + per]
    while len(shard) < per and items:
        shard.append(items[(start + len(shard)) % len(items)])
    return shard


def global_batch(batch, *, index: int | None = None,
                 count: int | None = None):
    """Rows ``[index·B/count, (index+1)·B/count)`` of the global batch
    ``batch`` (a numpy array or tensor; defaults: this rank of the default
    group). ``B % count != 0`` raises: pad the batch first
    (:func:`tpudl_torch.mesh.pad_batch`), as tpudl's sharding requires."""
    count = count if count is not None else process_count()
    index = index if index is not None else process_index()
    n = batch.shape[0]
    if n % count:
        raise ValueError(
            f"global batch of {n} rows does not split over {count} ranks; "
            "pad it to a multiple (tpudl_torch.mesh.pad_batch)")
    per = n // count
    return batch[index * per:(index + 1) * per]
