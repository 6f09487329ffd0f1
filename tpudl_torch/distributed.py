"""The process group and per-rank input sharding.

Port of ``tpudl/distributed.py``. tpudl joins hosts with
``jax.distributed.initialize`` and runs one SPMD program over them; the
port runs one process per rank, joined by ``torch.distributed``:

- :func:`initialize` is ``torch.distributed.init_process_group`` with a
  bounded timeout (NCCL on the card, gloo on the CPU). With no arguments
  it is a no-op, as tpudl's. Ranks on one machine rendezvous through a
  ``file://`` path or a ``tcp://localhost`` address; a coordinator on
  another machine is refused (ROADMAP Queue 1, 'Training, rest').
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

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None) -> None:
    """Join the process group: ``coordinator_address`` is the rendezvous
    (``file:///path`` or ``tcp://localhost:<port>``), ``num_processes``
    the world size and ``process_id`` this rank. ``backend`` defaults to
    NCCL when the card is available and gloo otherwise. With no
    arguments this is a documented no-op."""
    if coordinator_address is None and num_processes is None:
        return
    url = urllib.parse.urlparse(str(coordinator_address))
    if url.scheme != "file" and url.hostname not in _LOCAL_HOSTS:
        raise NotImplementedError(
            f"initialize({coordinator_address!r}): a coordinator on another "
            "machine (multi-machine training) is not ported to tpudl_torch "
            "yet (ROADMAP Queue 1, 'Training, rest'); ranks of one machine "
            "rendezvous through file:// or tcp://localhost")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=coordinator_address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


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
