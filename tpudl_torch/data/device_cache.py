"""Device-memory batch cache: epoch ≥ 2 ships zero wire bytes.

Port of ``tpudl/data/device_cache.py``, the top of the cache hierarchy:
the shard cache kills the re-decode, this module kills the re-ship. A
:class:`DeviceBatchCache` keeps prepared, codec-ENCODED batches (u8 on
the wire stays u8 on the card) in device memory once and replays them
thereafter.

Contracts, as in tpudl:

- **identity** — entries are keyed by the shard cache's key material
  (fingerprint or cache_key + input columns + batch size + codec spec +
  pack token) plus the device the batches live on, via :func:`run_key`,
  so a run on another card (or on the host) misses instead of being
  handed tensors on the wrong device; under a mesh the key carries the
  topology and its devices, and a resident batch is held as its per-card
  shards (:func:`place_sharded`);
- **budget** — ``TPUDL_DATA_HBM_BUDGET_MB`` caps total resident bytes
  (``0`` means none), else :data:`DEFAULT_BUDGET_FRACTION` of the card's
  memory (``torch.cuda.get_device_properties(d).total_memory``), else
  :data:`DEFAULT_BUDGET_BYTES`. LRU entries of other runs evict to make
  room; an entry that cannot fit is simply not stored (the batch stays a
  plain wire transfer — never an error);
- **pinning** — a batch handed to an in-flight dispatch is pinned via
  its :class:`Pin` until the dispatch is done, so the byte accounting
  never drops an entry whose tensors a kernel still reads;
- **degrade, never error** — a placement that runs out of device memory
  (``torch.cuda.OutOfMemoryError``) leaves the cache cold and counts
  ``data.hbm.put_failed``; the batch still runs on the card.

Counters and gauges are tpudl's: ``data.hbm.bytes_resident`` /
``budget_bytes``, ``hits`` / ``misses`` / ``puts`` / ``evictions`` /
``bytes_served`` / ``put_failed`` (a torch function donates nothing, so
tpudl's ``donation_blocked`` has no counterpart). Each entry's bytes are
charged ``hbm_bytes`` to the attribution scope that put it, and credited
back to that scope when it leaves, so the ledger mirrors the resident
gauge. On a device OOM the executor's supervisor
(:mod:`tpudl_torch.frame.supervisor`, its ``evict_hbm`` rung) calls
:meth:`DeviceBatchCache.evict_unpinned` before it retries the run.
"""

from __future__ import annotations

import os
import zlib
from collections import OrderedDict

import numpy as np
import torch

from tpudl_torch.obs import attribution as _attr
from tpudl_torch.obs import metrics as _m
from tpudl_torch.testing import tsan as _tsan

__all__ = ["DeviceBatchCache", "Pin", "get_device_cache",
           "reset_device_cache", "run_key", "budget_bytes",
           "bulk_resident", "array_token", "count_put_failed",
           "device_token", "place", "place_sharded",
           "DEFAULT_BUDGET_BYTES", "DEFAULT_BUDGET_FRACTION"]

# when no card reports its memory (the CPU), stay conservative: enough
# for the test datasets, far below any real card
DEFAULT_BUDGET_BYTES = 256 << 20
# fraction of the card's memory the cache may own when no explicit
# TPUDL_DATA_HBM_BUDGET_MB is set — the model, activations and the
# executor's in-flight batches need the rest
DEFAULT_BUDGET_FRACTION = 0.25

_BUDGET_CACHE: dict = {}


def budget_bytes(allow_device: bool = True) -> int | None:
    """The resident-byte budget. ``TPUDL_DATA_HBM_BUDGET_MB`` wins (an
    explicit ``0`` means ZERO — residency forbidden); otherwise
    :data:`DEFAULT_BUDGET_FRACTION` of the current card's total memory
    (cached per process), or :data:`DEFAULT_BUDGET_BYTES` without a card.
    ``allow_device=False`` reads the env/cache without ever initializing
    CUDA (returns None when the budget was never derived)."""
    env = os.environ.get("TPUDL_DATA_HBM_BUDGET_MB")
    if env:
        try:
            return max(0, int(float(env) * (1 << 20)))
        except ValueError:
            pass
    if "bytes" in _BUDGET_CACHE:
        return _BUDGET_CACHE["bytes"]
    if not allow_device:
        return None
    derived = DEFAULT_BUDGET_BYTES
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        derived = int(props.total_memory * DEFAULT_BUDGET_FRACTION)
    _BUDGET_CACHE["bytes"] = derived
    return derived


def device_token(device) -> str:
    """``device`` as the device cache names it: a card without an index
    is the current one, so ``"cuda"`` and ``"cuda:0"`` share entries."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def run_key(material_key: str, mesh=None, device=None) -> str:
    """One run's device-cache namespace: the shard-cache key string
    extended with the topology and the devices the entries live on, so
    an entry made for one mesh (or card) is a miss on any other, never
    resharded in place. Without a mesh this is tpudl's ``|mesh=single``
    plus the port's ``|dev=cuda:0`` (the port's stages and trials take a
    device per call: without it a run on one card would replay the
    tensors another run left on a different card or on the host). With a
    mesh it is tpudl's ``|mesh=data=N,model=1|dev=...`` over the mesh's
    devices, in order."""
    if mesh is not None:
        topo = ",".join(f"{k}={v}" for k, v in sorted(mesh.shape.items()))
        return (f"{material_key}|mesh={topo}|dev="
                + ",".join(device_token(d) for d in mesh.devices))
    key = f"{material_key}|mesh=single"
    if device is not None:
        key += f"|dev={device_token(device)}"
    return key


_TOKEN_MEMO: dict = {}
_TOKEN_MEMO_CAP = 32
_TOKEN_MEMO_LOCK = _tsan.named_lock("data.device_cache.token_memo")
_PROBE_ELEMS = 16384


# copied from tpudl/data/device_cache.py:_probe_crc
def _probe_crc(carr: np.ndarray) -> int:
    """crc32 over the first+last ``_PROBE_ELEMS`` elements of a
    C-contiguous array — O(64KB) no matter the array size (reshape of
    a contiguous array is a view)."""
    flat = carr.reshape(-1)
    return zlib.crc32(flat[-_PROBE_ELEMS:].tobytes(),
                      zlib.crc32(flat[:_PROBE_ELEMS].tobytes()))


# copied from tpudl/data/device_cache.py:array_token
def array_token(arr) -> str:
    """Cheap content identity of one host array (the estimator's bulk
    residency key): crc32 over the raw bytes + shape/dtype, memoized
    per live array object. A changed dataset — a new object OR an
    in-place rewrite of the same one — re-keys instead of replaying
    stale device buffers (the memo hit re-probes a 64KB head+tail
    sample; a mutation the sample misses everywhere is the same
    residual risk class as any sampling fingerprint, documented
    here)."""
    import weakref

    contiguous = (getattr(arr, "flags", None) is not None
                  and arr.flags.c_contiguous)
    if contiguous:
        with _TOKEN_MEMO_LOCK:
            memo = _TOKEN_MEMO.get(id(arr))
        if memo is not None and memo[0]() is arr \
                and _probe_crc(arr) == memo[2]:
            return memo[1]
    carr = np.ascontiguousarray(arr)
    token = f"{carr.dtype}{carr.shape}:{zlib.crc32(carr) & 0xFFFFFFFF:08x}"
    if not contiguous:
        return token  # the probe view needs the original's layout
    try:
        ref = weakref.ref(arr)
    except TypeError:  # non-weakrefable input (rare): skip the memo
        return token
    probe = _probe_crc(arr)
    with _TOKEN_MEMO_LOCK:
        if len(_TOKEN_MEMO) >= _TOKEN_MEMO_CAP:
            _TOKEN_MEMO.pop(next(iter(_TOKEN_MEMO)), None)
        _TOKEN_MEMO[id(arr)] = (ref, token, probe)
    return token


class Pin:
    """One acquisition's pin on one entry. ``release()`` is idempotent
    per token (checked and flipped under the cache lock)."""

    __slots__ = ("_entry", "_cache", "_released")

    def __init__(self, cache: "DeviceBatchCache", entry: "_Entry"):
        self._cache = cache
        self._entry = entry
        self._released = False

    @property
    def arrays(self) -> tuple:
        return self._entry.arrays

    @property
    def n_pad(self) -> int:
        return self._entry.n_pad

    @property
    def nbytes(self) -> int:
        return self._entry.nbytes

    @property
    def codecs(self):
        return self._entry.codecs

    def release(self) -> None:
        self._cache._release(self)


class _Entry:
    __slots__ = ("key", "arrays", "n_pad", "codecs", "nbytes", "pins",
                 "resident", "owner")

    def __init__(self, key, arrays, n_pad, codecs):
        self.key = key
        self.arrays = tuple(arrays)
        self.n_pad = int(n_pad)
        self.codecs = codecs
        self.nbytes = int(sum(int(getattr(a, "nbytes", 0))
                              for a in self.arrays))
        self.pins = 0
        # False once evicted/cleared: an outstanding Pin's late release
        # must not adjust tallies for an entry no longer in the map
        self.resident = False
        # the attribution scope key charged for these bytes at put()
        self.owner = None

    @property
    def run(self):
        return self.key[0] if isinstance(self.key, tuple) else self.key


class DeviceBatchCache:
    """LRU cache of device-resident prepared batches under a byte budget.
    Keys are ``(run_key, batch_index)`` tuples; values hold the encoded
    device tensors, their pad count and the resolved codec keys (so an
    all-hits replay can still rebuild the prologue via
    ``CodecPlan.adopt``).

    The caller places tensors on the card (:func:`place`) BEFORE ``put``
    — this class owns only residency accounting, LRU order, pinning and
    eviction, and issues no device work itself."""

    def __init__(self, budget: int | None = None):
        if budget is None:
            budget = budget_bytes()  # an explicit env 0 stays 0
        self._budget = int(budget if budget is not None
                           else DEFAULT_BUDGET_BYTES)
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0
        # running tallies so would_fit()/put() admission is O(1) under
        # the lock: pinned bytes total + unpinned bytes per run
        self._pinned_bytes = 0
        self._unpinned_by_run: dict = {}
        self._lock = _tsan.named_lock("data.device_cache")
        _m.gauge("data.hbm.budget_bytes").set(self._budget)
        _m.gauge("data.hbm.bytes_resident").set(0)

    @property
    def budget(self) -> int:
        return self._budget

    @property
    def bytes_resident(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def bytes_pinned(self) -> int:
        """Resident bytes some caller still holds a pin on (0 once every
        dispatch and every fit has released)."""
        with self._lock:
            return self._pinned_bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _pin_locked(self, entry: _Entry) -> None:
        if entry.pins == 0 and entry.resident:
            self._pinned_bytes += entry.nbytes
            self._run_unpinned_locked(entry.run, -entry.nbytes)
        entry.pins += 1

    # copied from tpudl/data/device_cache.py:DeviceBatchCache._run_unpinned_locked
    def _run_unpinned_locked(self, run, delta: int) -> None:
        v = self._unpinned_by_run.get(run, 0) + delta
        if v <= 0:
            self._unpinned_by_run.pop(run, None)
        else:
            self._unpinned_by_run[run] = v

    # copied from tpudl/data/device_cache.py:DeviceBatchCache._admissible_locked
    def _admissible_locked(self, nbytes: int, run) -> bool:
        free = self._budget - self._bytes
        evictable = ((self._bytes - self._pinned_bytes)
                     - self._unpinned_by_run.get(run, 0))
        return nbytes <= free + max(0, evictable)

    def get(self, key) -> Pin | None:
        """The pinned entry for ``key`` (LRU-touched), or None. The
        caller MUST ``release()`` the returned :class:`Pin` once the
        batch's in-flight dispatch completes."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self._pin_locked(entry)
        if entry is None:
            _m.counter("data.hbm.misses").inc()
            return None
        _m.counter("data.hbm.hits").inc()
        _m.counter("data.hbm.bytes_served").inc(entry.nbytes)
        return Pin(self, entry)

    def would_fit(self, nbytes: int, run=None) -> bool:
        """Could an ``nbytes`` entry for ``run`` be admitted by
        :meth:`put` (free room, or room after evicting unpinned entries of
        OTHER runs)? The executor checks this before paying the copy, so
        a batch the cache would refuse never ships a doomed copy."""
        with self._lock:
            return self._admissible_locked(int(nbytes), run)

    def put(self, key, arrays, n_pad: int = 0, codecs=None) -> Pin | None:
        """Make one batch resident (tensors already on the card). Returns
        a pinned :class:`Pin` on success, None when the entry cannot fit.

        An entry ALREADY resident under ``key`` is returned pinned
        instead of being replaced (same key = same bytes); eviction to
        make room skips entries of the SAME run (``key[0]``), so a scan
        bigger than the budget keeps its prefix resident instead of
        thrashing itself."""
        entry = _Entry(key, arrays, n_pad, codecs)
        # the owner is resolved before the entry becomes visible, so a
        # concurrent eviction always credits the right scope
        sc = _attr.current_scope()
        entry.owner = sc.key if sc is not None else None
        run = entry.run
        evicted = 0
        victims: list = []
        stored = dedup = False
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._entries.move_to_end(key)
                self._pin_locked(old)
                entry = old
                stored = dedup = True
            elif self._admissible_locked(entry.nbytes, run):
                while (self._bytes + entry.nbytes > self._budget
                       and (victim := self._evictable_locked(run))
                       is not None):
                    del self._entries[victim.key]
                    victim.resident = False
                    self._bytes -= victim.nbytes
                    self._run_unpinned_locked(victim.run, -victim.nbytes)
                    victims.append(victim)
                    evicted += 1
                if self._bytes + entry.nbytes <= self._budget:
                    entry.resident = True
                    entry.pins = 1
                    self._entries[key] = entry
                    self._bytes += entry.nbytes
                    self._pinned_bytes += entry.nbytes
                    stored = True
            resident = self._bytes
        pin = Pin(self, entry) if stored else None
        if evicted:
            _m.counter("data.hbm.evictions").inc(evicted)
        _m.gauge("data.hbm.bytes_resident").set(resident)
        # the attribution pairing: the ledger mirrors the resident gauge
        # exactly — each victim's bytes credit its owner (create=False: a
        # folded scope's credit lands in unattributed, where its debits
        # went), the stored entry's bytes charge its owner
        for v in victims:
            _attr.charge("hbm_bytes", -v.nbytes, key=v.owner, create=False)
        if stored and not dedup:
            _m.counter("data.hbm.puts").inc()
            _attr.charge("hbm_bytes", entry.nbytes, key=entry.owner)
        return pin

    # copied from tpudl/data/device_cache.py:DeviceBatchCache._evictable_locked
    def _evictable_locked(self, incoming_run):
        """Oldest unpinned entry NOT belonging to ``incoming_run`` (see
        put: a scan never evicts its own entries). Only runs when an
        eviction actually happens — admission itself is O(1)."""
        for e in self._entries.values():
            if e.pins <= 0 and e.run != incoming_run:
                return e
        return None

    # copied from tpudl/data/device_cache.py:DeviceBatchCache._release
    def _release(self, pin: Pin) -> None:
        # token idempotence checked UNDER the lock: the dispatch-path
        # release and the unwind sweep may race on one token
        with self._lock:
            if pin._released:
                return
            pin._released = True
            e = pin._entry
            e.pins = max(0, e.pins - 1)
            if e.pins == 0 and e.resident:
                self._pinned_bytes -= e.nbytes
                self._run_unpinned_locked(e.run, e.nbytes)

    def evict_unpinned(self, run=None) -> tuple[int, int]:
        """Evict EVERY unpinned entry (all runs — or only ``run``'s when
        given), returning ``(entries, bytes_freed)``. Pinned entries stay,
        so the budget stays honest."""
        freed = count = 0
        with self._lock:
            victims = [e for e in self._entries.values()
                       if e.pins <= 0
                       and (run is None or e.run == run)]
            for e in victims:
                del self._entries[e.key]
                e.resident = False
                self._bytes -= e.nbytes
                self._run_unpinned_locked(e.run, -e.nbytes)
                freed += e.nbytes
                count += 1
            resident = self._bytes
        if count:
            _m.counter("data.hbm.evictions").inc(count)
        _m.gauge("data.hbm.bytes_resident").set(resident)
        for e in victims:
            _attr.charge("hbm_bytes", -e.nbytes, key=e.owner, create=False)
        return count, freed

    def clear(self) -> None:
        with self._lock:
            dropped = [(e.owner, e.nbytes) for e in self._entries.values()]
            for e in self._entries.values():
                e.resident = False
            self._entries.clear()
            self._bytes = 0
            self._pinned_bytes = 0
            self._unpinned_by_run.clear()
        _m.gauge("data.hbm.bytes_resident").set(0)
        for owner, nbytes in dropped:
            _attr.charge("hbm_bytes", -nbytes, key=owner, create=False)


_CACHE: DeviceBatchCache | None = None
_CACHE_LOCK = _tsan.named_lock("data.device_cache.singleton")


# copied from tpudl/data/device_cache.py:get_device_cache
def get_device_cache() -> DeviceBatchCache:
    """The process-wide cache (one budget, shared by every consumer —
    frame executor, Dataset, estimator bulk residency)."""
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is None:
            _CACHE = DeviceBatchCache()
        return _CACHE


# copied from tpudl/data/device_cache.py:reset_device_cache
def reset_device_cache() -> None:
    """Drop the process-wide cache (tests, and the restart-semantics
    simulation: a fresh process = a fresh, COLD cache)."""
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is not None:
            _CACHE.clear()
        _CACHE = None


def count_put_failed() -> None:
    """One batch failed to become resident because its placement ran out
    of device memory; the batch fell back to the plain wire path. This
    counter is the operator's evidence that residency is degrading."""
    _m.counter("data.hbm.put_failed").inc()


def place(tensors, device) -> tuple | None:
    """``tensors`` (CPU tensors) copied onto ``device``, or None when the
    card runs out of memory on the way (counted ``data.hbm.put_failed``;
    the caller keeps the host batch). The copies are asynchronous from
    pinned memory and ordered before later work on the current stream."""
    try:
        return tuple(t.to(device, non_blocking=True) for t in tensors)
    except torch.cuda.OutOfMemoryError:
        count_put_failed()
        return None


def place_sharded(tensors, mesh) -> tuple | None:
    """``tensors`` (CPU tensors, rows a multiple of the mesh's data axis)
    split over a local ``mesh``: one :class:`~tpudl_torch.mesh.Sharded`
    a column, each shard on its card (:func:`tpudl_torch.mesh.
    transfer_batch`), or None when a card runs out of memory on the way
    (counted ``data.hbm.put_failed``)."""
    from tpudl_torch import mesh as M

    try:
        shards = M.transfer_batch(tensors, mesh)
    except torch.cuda.OutOfMemoryError:
        count_put_failed()
        return None
    return tuple(M.Sharded(entry[j] for entry in shards)
                 for j in range(len(tensors)))


def bulk_resident(key, arrays, device=None) -> Pin | None:
    """Whole-dataset residency for the estimator's multi-epoch path:
    place ``arrays`` (host numpy, e.g. the full X, y) on ``device`` ONCE
    under the shared budget and index batches on the card thereafter —
    every epoch past the first ships no dataset bytes. Returns a pinned
    :class:`Pin` (``.arrays`` are the device tensors), or None when the
    bulk does not fit (the caller keeps the per-step host transfer).

    The CALLER must ``release()`` the pin when its fit/trial completes, so
    a finished dataset's bulk becomes ordinary LRU prey for the next.
    Put a content token (:func:`array_token`) in the RUN component
    (``key[0]``) so different datasets' bulks can evict each other."""
    from tpudl_torch.data.codec import host_tensor

    cache = get_device_cache()
    hit = cache.get(key)
    if hit is not None:
        return hit
    nbytes = sum(int(getattr(a, "nbytes", 0)) for a in arrays)
    if not cache.would_fit(nbytes,
                           run=key[0] if isinstance(key, tuple) else key):
        return None
    dev = torch.device(device) if device is not None else None
    pin = dev is not None and dev.type == "cuda"
    placed = place([host_tensor(a, pin=pin) for a in arrays],
                   dev if dev is not None else "cpu")
    if placed is None:
        return None
    return cache.put(key, placed, n_pad=0, codecs=None)
