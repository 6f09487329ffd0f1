"""Sharded prepared-batch cache: checksummed, memory-mapped, atomic.

Port of ``tpudl/data/shards.py``. Prepared (packed + wire-encoded)
batches persist as one ``.npy`` file per (batch, column) under a
key-named directory, indexed by a JSON manifest; epochs ≥ 2 and repeat
runs over the same inputs then skip the decode stage — a warm batch is an
``np.load(mmap_mode='r')`` away.

The on-disk format is tpudl's, byte for byte: the file names
(``shard-%06d-c%d.npy``), the ``.npy`` headers, ``manifest.json``'s
fields (``version``, ``key``, ``meta``, ``shards`` → ``files``
[``name``, ``crc32``, ``nbytes``, ``shape``, ``dtype``] and ``rows``) and
CRC-32 (zlib) over each whole file, so one directory serves both
packages. A bfloat16 shard is written as tpudl writes it (header
``'<V2'``, manifest dtype ``"bfloat16"``). Reading one back, numpy says
``'|V2'``; tpudl then fails its header check and drops the shard, the
port reads the bits as bfloat16.

Durability, as in tpudl: shard files and the manifest are written to a
temp name and ``os.replace``d into place; the manifest records crc32 +
byte size per file, and ``get`` checks the size always and the crc per
``TPUDL_DATA_VERIFY`` (``first`` — once per file per process, the
default; ``always``; ``never``); any mismatch (truncated file, bit flip,
bad header, missing file) makes ``get`` return None — a miss the caller
re-prepares — and counts ``data.cache.corrupt`` (or
``data.cache.evicted`` for a file that is simply gone). ``put`` retries a
failed write under the shared IO policy (``TPUDL_RETRY_IO_ATTEMPTS``,
``TPUDL_RETRY_IO_BACKOFF_S``) and otherwise leaves the entry cold. Past
``EAGER_FLUSH_MAX`` entries the manifest rewrite is throttled; the
executor and ``Dataset`` call ``flush()`` at the end of a run. Two
writers' disjoint entries merge (``put`` re-reads a manifest another
process rewrote). tpudl's fault points are here: ``shards.read`` fires
between a file's integrity check and its open (a file deleted in between
is a plain miss, ``ShardEvicted``, with no corrupt count) and
``shards.write`` before each file's write; each corrupt shard is sampled
into the flight recorder's error ring (kind ``data.cache.corrupt``).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zlib

import numpy as np

from tpudl_torch.data.codec import BF16_BITS
from tpudl_torch.obs import metrics as _m
from tpudl_torch.testing import faults as _faults
from tpudl_torch.testing import tsan as _tsan

__all__ = ["ShardCache", "ShardCorruption", "ShardEvicted", "cache_key",
           "MANIFEST_NAME", "MANIFEST_VERSION"]

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
# what tpudl's manifest and .npy header say of a bfloat16 shard
_BF16_NAME = "bfloat16"
_BF16_DESCR = "<V2"


class ShardCorruption(Exception):
    """A shard failed its integrity check (internal control flow: `get`
    converts it into a miss)."""


class ShardEvicted(ShardCorruption):
    """The shard FILE is gone — deleted by a concurrent eviction
    (another process's ``_drop``/``clear``) between our manifest read
    and the open. Counted as ``data.cache.evicted``, not as
    corruption."""


# copied from tpudl/data/shards.py:cache_key
def cache_key(material: str, **parts) -> str:
    """sha1 hex over the dataset fingerprint + every keyword part
    (input columns, batch size, codec spec, schema version) — the name
    of the cache's key directory. Any ingredient changing re-keys the
    cache instead of serving stale shards."""
    h = hashlib.sha1()
    h.update(str(material).encode())
    for k in sorted(parts):
        h.update(f"|{k}={parts[k]}".encode())
    return h.hexdigest()


# copied from tpudl/data/shards.py:_crc32_file
def _crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


# copied from tpudl/data/shards.py:_verify_policy
def _verify_policy() -> str:
    v = os.environ.get("TPUDL_DATA_VERIFY", "first").lower()
    return v if v in ("first", "always", "never") else "first"


def _dtype_name(arr: np.ndarray) -> str:
    """The manifest's dtype string: numpy's, or tpudl's ``"bfloat16"``
    for bfloat16 bits."""
    return _BF16_NAME if arr.dtype == BF16_BITS else str(arr.dtype)


def _save_npy(f, arr: np.ndarray) -> None:
    """``np.save``, except that bfloat16 bits get the header numpy writes
    for ``ml_dtypes``' bfloat16 (``'<V2'``), so the file is tpudl's."""
    if arr.dtype != BF16_BITS:
        np.save(f, arr, allow_pickle=False)
        return
    from numpy.lib import format as npf

    npf.write_array_header_1_0(f, {"descr": _BF16_DESCR,
                                   "fortran_order": False,
                                   "shape": arr.shape})
    f.write(np.ascontiguousarray(arr).tobytes())


class ShardCache:
    """Prepared-batch store under ``<cache_dir>/<key>/``.

    ``get(index)`` → list of memory-mapped arrays (one per input column)
    or None (miss/corrupt). ``put(index, arrays)`` persists one batch
    atomically. ``meta`` is a small JSON dict persisted in the manifest —
    the executor records the resolved wire-codec keys there so a warm
    replay rebuilds the exact device prologue
    (:meth:`tpudl_torch.data.codec.CodecPlan.adopt`)."""

    EAGER_FLUSH_MAX = 256
    DIRTY_FLUSH = 8
    FLUSH_S = 0.5

    def __init__(self, cache_dir: str, key: str):
        self.key = str(key)
        self.dir = os.path.join(str(cache_dir), self.key)
        os.makedirs(self.dir, exist_ok=True)
        self._lock = _tsan.named_lock("data.shards.manifest")
        self._verified: set[str] = set()
        self._shards: dict[str, dict] = {}
        self.meta: dict = {}
        self._disk_mtime_ns = -1  # manifest mtime at last load/write
        self._dirty = 0
        self._last_flush = time.monotonic()
        self._load_manifest()

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, MANIFEST_NAME)

    # copied from tpudl/data/shards.py:ShardCache._disk_changed
    def _disk_changed(self) -> bool:
        """Cheap stat: has another process rewritten the manifest since
        we last read/wrote it? Gates every reload/merge so steady-state
        single-writer runs never re-parse their own manifest."""
        try:
            mtime = os.stat(self._manifest_path()).st_mtime_ns
        except OSError:
            return False
        return mtime != self._disk_mtime_ns

    # copied from tpudl/data/shards.py:ShardCache._load_manifest
    def _load_manifest(self) -> None:
        try:
            try:
                self._disk_mtime_ns = os.stat(
                    self._manifest_path()).st_mtime_ns
            except OSError:
                self._disk_mtime_ns = -1
            with open(self._manifest_path()) as f:
                m = json.load(f)
            if (isinstance(m, dict) and m.get("version") == MANIFEST_VERSION
                    and m.get("key") == self.key
                    and isinstance(m.get("shards"), dict)):
                self._shards = m["shards"]
                self.meta = m.get("meta") or {}
            else:  # foreign/stale manifest: start empty, don't crash
                self._shards, self.meta = {}, {}
        except (OSError, json.JSONDecodeError):
            self._shards, self.meta = {}, {}

    def _write_manifest_locked(self) -> None:
        m = {"version": MANIFEST_VERSION, "key": self.key,
             "meta": self.meta, "shards": self._shards}
        tmp = self._manifest_path() + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(m, f)
            os.replace(tmp, self._manifest_path())
            self._disk_mtime_ns = os.stat(
                self._manifest_path()).st_mtime_ns
        except OSError:
            # a full disk must not take down the pipeline; the cache
            # just stays cold for the unwritten entries
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self._dirty = 0
        self._last_flush = time.monotonic()

    def flush(self) -> None:
        """Persist any throttled manifest entries; the executor and
        Dataset call this at the end of a run."""
        with self._lock:
            if self._dirty:
                self._write_manifest_locked()

    def set_meta(self, meta: dict) -> None:
        with self._lock:
            self.meta.update(meta)
            self._write_manifest_locked()

    # -- read --------------------------------------------------------------
    def indices(self) -> list[int]:
        with self._lock:
            return sorted(int(i) for i in self._shards)

    def __len__(self) -> int:
        with self._lock:
            return len(self._shards)

    def _check_file(self, fmeta: dict) -> str:
        """Path of a verified shard file, or raise ShardCorruption
        (ShardEvicted when the file is simply gone)."""
        path = os.path.join(self.dir, fmeta["name"])
        try:
            size = os.stat(path).st_size
        except FileNotFoundError as e:
            raise ShardEvicted(f"shard file {path} deleted (concurrent "
                               "eviction)") from e
        except OSError as e:
            raise ShardCorruption(f"unreadable shard file {path}") from e
        if size != fmeta["nbytes"]:
            raise ShardCorruption(
                f"{path}: size {size} != manifest {fmeta['nbytes']} "
                "(truncated or partial write)")
        policy = _verify_policy()
        if policy == "always" or (policy == "first"
                                  and fmeta["name"] not in self._verified):
            if _crc32_file(path) != fmeta["crc32"]:
                raise ShardCorruption(f"{path}: crc32 mismatch (bit rot "
                                      "or torn write)")
            with self._lock:
                self._verified.add(fmeta["name"])
        return path

    def get(self, index: int):
        """Memory-mapped arrays for one batch, or None (miss). Corrupt
        shards are dropped from the manifest and surface as misses — the
        caller re-prepares."""
        with self._lock:
            entry = self._shards.get(str(index))
        if entry is None:
            # another process may have written since we loaded; one
            # reload keeps a concurrent reader warm without polling
            self._reload_for(str(index))
            with self._lock:
                entry = self._shards.get(str(index))
        if entry is None:
            _m.counter("data.cache.misses").inc()
            return None
        try:
            arrays = []
            for fmeta in entry["files"]:
                path = self._check_file(fmeta)
                # the fault point between the integrity check and the
                # open: a test corrupts or deletes the file exactly here
                _faults.fire("shards.read", path=path, index=int(index))
                try:
                    arr = np.load(path, mmap_mode="r", allow_pickle=False)
                except FileNotFoundError as e:
                    raise ShardEvicted(
                        f"shard file {path} deleted between check and "
                        "read (concurrent eviction)") from e
                if (list(arr.shape) != list(fmeta["shape"])
                        or _dtype_name(arr) != fmeta["dtype"]):
                    raise ShardCorruption(
                        f"{path}: header {arr.dtype}{arr.shape} != manifest "
                        f"{fmeta['dtype']}{tuple(fmeta['shape'])}")
                arrays.append(arr)
        except ShardEvicted:
            _m.counter("data.cache.evicted").inc()
            _m.counter("data.cache.misses").inc()
            self._forget(index)
            return None
        except (ShardCorruption, OSError, ValueError) as e:
            _m.counter("data.cache.corrupt").inc()
            _m.counter("data.cache.misses").inc()
            # the black box keeps the corruption samples, not only the
            # count
            from tpudl_torch.obs import flight as _flight

            _flight.record_error("data.cache.corrupt", e,
                                 index=int(index), key=self.key)
            self._drop(index, reason=repr(e))
            return None
        _m.counter("data.cache.hits").inc()
        _m.counter("data.cache.bytes_read").inc(
            sum(f["nbytes"] for f in entry["files"]))
        return arrays

    # copied from tpudl/data/shards.py:ShardCache._reload_for
    def _reload_for(self, index_key: str) -> None:
        if not self._disk_changed():  # stat-gate: no re-parse unless a
            return                    # concurrent writer actually wrote
        try:
            mtime = os.stat(self._manifest_path()).st_mtime_ns
            with open(self._manifest_path()) as f:
                m = json.load(f)
            fresh = (m.get("shards") or {}) if isinstance(m, dict) else {}
        except (OSError, json.JSONDecodeError):
            return
        with self._lock:
            self._disk_mtime_ns = mtime
            for k, v in fresh.items():
                self._shards.setdefault(k, v)

    # copied from tpudl/data/shards.py:ShardCache._forget
    def _forget(self, index: int) -> None:
        """Drop one manifest entry WITHOUT unlinking its files — used
        on the eviction race, where another process already owns the
        deletion (unlinking here could race a concurrent re-``put``)."""
        with self._lock:
            if self._shards.pop(str(index), None) is not None:
                self._write_manifest_locked()

    # copied from tpudl/data/shards.py:ShardCache._drop
    def _drop(self, index: int, reason: str = "") -> None:
        with self._lock:
            entry = self._shards.pop(str(index), None)
            if entry is not None:
                self._write_manifest_locked()
        for fmeta in (entry or {}).get("files", []):
            try:
                os.unlink(os.path.join(self.dir, fmeta["name"]))
            except OSError:
                pass

    # -- write -------------------------------------------------------------
    def put(self, index: int, arrays) -> None:
        """Persist one prepared batch (one array per input column)
        atomically; overwrites any previous entry for ``index``. A write
        that still fails after the IO policy's retries leaves the entry
        cold and never fails the run."""
        from tpudl_torch.jobs.retry import io_policy

        files, total = [], 0
        for j, arr in enumerate(arrays):
            arr = np.ascontiguousarray(arr)
            name = f"shard-{int(index):06d}-c{j}.npy"
            path = os.path.join(self.dir, name)
            tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"

            def _write_one(tmp=tmp, path=path, arr=arr):
                _faults.fire("shards.write", path=path)
                with open(tmp, "wb") as f:
                    _save_npy(f, arr)
                crc = _crc32_file(tmp)
                nbytes = os.stat(tmp).st_size
                os.replace(tmp, path)
                return crc, nbytes

            try:
                crc, nbytes = io_policy().call(_write_one,
                                               kind="data.cache.write")
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return  # full disk etc: stay cold, never crash the run
            files.append({"name": name, "crc32": crc, "nbytes": nbytes,
                          "shape": list(arr.shape),
                          "dtype": _dtype_name(arr)})
            total += nbytes
        rows = int(np.asarray(arrays[0]).shape[0]) if len(files) else 0
        with self._lock:
            # merge a concurrent writer's entries before rewriting, so
            # disjoint batch sets from two processes interleave safely
            if self._disk_changed():
                self._merge_disk_entries_locked()
            self._shards[str(index)] = {"files": files, "rows": rows}
            self._dirty += 1
            if (len(self._shards) <= self.EAGER_FLUSH_MAX
                    or self._dirty >= self.DIRTY_FLUSH
                    or time.monotonic() - self._last_flush
                    > self.FLUSH_S):
                self._write_manifest_locked()
            self._verified.update(f["name"] for f in files)
        _m.counter("data.cache.bytes_written").inc(total)
        _m.counter("data.cache.puts").inc()

    # copied from tpudl/data/shards.py:ShardCache._merge_disk_entries_locked
    def _merge_disk_entries_locked(self) -> None:
        try:
            mtime = os.stat(self._manifest_path()).st_mtime_ns
            with open(self._manifest_path()) as f:
                m = json.load(f)
            disk = (m.get("shards") or {}) if isinstance(m, dict) else {}
        except (OSError, json.JSONDecodeError):
            return
        self._disk_mtime_ns = mtime
        for k, v in disk.items():
            self._shards.setdefault(k, v)

    # -- maintenance -------------------------------------------------------
    # copied from tpudl/data/shards.py:ShardCache.clear
    def clear(self) -> None:
        with self._lock:
            entries = list(self._shards.values())
            self._shards = {}
            self._write_manifest_locked()
        for entry in entries:
            for fmeta in entry.get("files", []):
                try:
                    os.unlink(os.path.join(self.dir, fmeta["name"]))
                except OSError:
                    pass

    # copied from tpudl/data/shards.py:ShardCache.validate
    def validate(self) -> list[str]:
        """Integrity errors for every manifest entry (empty = clean);
        full crc pass regardless of the runtime verify policy — this is
        the audit path ``tools/validate_shards.py`` drives."""
        errs = []
        with self._lock:
            shards = {k: dict(v) for k, v in self._shards.items()}
        for k in sorted(shards, key=lambda s: int(s)):
            for fmeta in shards[k].get("files", []):
                path = os.path.join(self.dir, fmeta["name"])
                try:
                    size = os.stat(path).st_size
                except OSError:
                    errs.append(f"shard {k}: missing file {fmeta['name']}")
                    continue
                if size != fmeta["nbytes"]:
                    errs.append(f"shard {k}: {fmeta['name']} size {size} "
                                f"!= manifest {fmeta['nbytes']}")
                elif _crc32_file(path) != fmeta["crc32"]:
                    errs.append(f"shard {k}: {fmeta['name']} crc mismatch")
        return errs
