"""Checkpoint / resume: atomic, checksummed snapshots of a training state.

Port of ``tpudl/train/checkpoint.py`` (``CheckpointManager``,
``CheckpointCorruption``, ``as_numpy_state``), with tpudl's on-disk
format, so one directory can be read by both packages:

- each step is ONE ``ckpt-%08d.npz`` written to a temp name, fsynced and
  ``os.replace``d into place, then indexed in ``ckpt-manifest.json``
  (schema ``tpudl-checkpoint-manifest``, version 1; itself tmp+rename);
- the manifest records crc32 + byte size per checkpoint; ``restore``
  verifies before trusting, and a truncated, bit-flipped or unparseable
  newest checkpoint is dropped (``train.checkpoint.corrupt``) so that
  ``restore()`` falls back to the newest VALID step;
- every leaf is stored as raw bytes (``leaf_%05d``) with its shape and
  dtype name in a ``__meta__`` JSON entry, keyed by jax's ``keystr`` of
  its path (``['params']['w']``, ``[0]``, ``.count``) in jax's flatten
  order (dict keys sorted, sequences in order, ``None`` holds no leaf).

A leaf may be a torch tensor (any device), a numpy array or a Python
number. A ``torch.bfloat16`` tensor is written under the dtype name
``"bfloat16"``, as tpudl writes its ml_dtypes leaves, and a
``"bfloat16"`` leaf reads back as a ``torch.bfloat16`` tensor: the port
needs neither ml_dtypes nor jax. Restored leaves are CPU tensors (numpy
has no bfloat16), or, with ``like=``, placed like the ``like`` leaf: on
its device for a tensor, as a numpy array for a numpy leaf.

A corrupt checkpoint that a restore drops is counted
(``train.checkpoint.corrupt``) and filed in the flight recorder's error
ring with its reason, as tpudl files it.
"""

from __future__ import annotations

import io
import json
import os
import threading
import zlib

import numpy as np
import torch

from tpudl_torch.obs import metrics as _metrics
from tpudl_torch.testing import tsan as _tsan

__all__ = ["CheckpointManager", "CheckpointCorruption", "as_numpy_state"]

MANIFEST_NAME = "ckpt-manifest.json"
MANIFEST_SCHEMA = "tpudl-checkpoint-manifest"
MANIFEST_VERSION = 1
PAYLOAD_VERSION = 1


class CheckpointCorruption(Exception):
    """A checkpoint failed its integrity check (restore() converts it
    into a fallback to the next-newest valid step)."""


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


def _flatten(tree, path=()):
    """``[(path, leaf)]`` in jax's flatten order; a path is a tuple of
    ``("key", k)``, ``("idx", i)`` or ``("attr", name)``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (("key", k),))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # namedtuple
        out = []
        for name in tree._fields:
            out += _flatten(getattr(tree, name), path + (("attr", name),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + (("idx", i),))
        return out
    return [(path, tree)]


def _keystr(path) -> str:
    """jax.tree_util.keystr of the same path."""
    return "".join(f".{k}" if t == "attr" else f"[{k!r}]"
                   for t, k in path)


def _path_components(path) -> list:
    """JSON-able path components, tpudl's ``_path_components``."""
    return [{"t": "idx", "i": int(k)} if t == "idx"
            else {"t": t, "k": str(k)} for t, k in path]


def _leaf_bytes(leaf) -> tuple[bytes, list, str]:
    """(C-order bytes, shape, dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), list(t.shape),
                    "bfloat16")
        arr = t.numpy()
    else:
        # NOT ascontiguousarray: it promotes 0-d scalars to shape (1,);
        # tobytes() already yields C-order bytes for any layout
        arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _from_bytes(buf: np.ndarray, shape, dtype: str) -> torch.Tensor:
    """One stored leaf → a CPU tensor that owns a copy of its bytes."""
    raw = bytearray(buf.tobytes())
    if dtype == "bfloat16":
        if not raw:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(raw, dtype=torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype))
                            .reshape(shape))


def _itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


class CheckpointManager:
    """Atomic checksummed store of the {params, opt_state, step, ...}
    training-state tree under one directory."""

    def __init__(self, directory: str, *, save_every: int = 100,
                 max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.save_every = int(save_every)
        self.max_to_keep = int(max_to_keep)
        self._lock = _tsan.named_lock("train.checkpoint.manifest")
        self._manifest: dict[str, dict] = {}
        self._load_manifest()

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self._dir, MANIFEST_NAME)

    def _file_for(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt-{int(step):08d}.npz")

    def _load_manifest(self) -> None:
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
            if (isinstance(m, dict) and m.get("schema") == MANIFEST_SCHEMA
                    and isinstance(m.get("checkpoints"), dict)):
                self._manifest = m["checkpoints"]
            else:
                self._manifest = {}
        except (OSError, json.JSONDecodeError):
            self._manifest = {}

    def _write_manifest_locked(self) -> None:
        """Raises OSError on failure: ``save()`` must not report a
        checkpoint indexed when the index write was lost."""
        m = {"schema": MANIFEST_SCHEMA, "version": MANIFEST_VERSION,
             "checkpoints": self._manifest}
        tmp = self._manifest_path() + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(m, f)
            os.replace(tmp, self._manifest_path())
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- write -------------------------------------------------------------
    def save(self, step: int, state, *, force: bool = False) -> bool:
        """Save if ``step`` hits the cadence (or ``force``). Blocking and
        durable before it returns, as tpudl's: resume-equivalence needs
        the write on disk before the step counter advances."""
        if not force and (self.save_every <= 0
                          or step % self.save_every != 0):
            return False
        leaves = _flatten(state)
        meta = {"version": PAYLOAD_VERSION, "step": int(step),
                "leaves": []}
        entries: dict[str, np.ndarray] = {}
        for i, (path, leaf) in enumerate(leaves):
            raw, shape, dtype = _leaf_bytes(leaf)
            entries[f"leaf_{i:05d}"] = np.frombuffer(raw, dtype=np.uint8)
            meta["leaves"].append({
                "key": _keystr(path), "path": _path_components(path),
                "shape": shape, "dtype": dtype})
        entries["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
        out = self._file_for(step)
        tmp = out + f".tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **entries)
                f.flush()
                os.fsync(f.fileno())
            crc = _crc32_file(tmp)
            nbytes = os.stat(tmp).st_size
            os.replace(tmp, out)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            self._manifest[str(int(step))] = {
                "file": os.path.basename(out), "crc32": crc,
                "nbytes": nbytes, "n_leaves": len(leaves)}
            self._write_manifest_locked()
            self._prune_locked()
        return True

    def maybe_save(self, step: int, state) -> bool:
        return self.save(step, state)

    def _prune_locked(self) -> None:
        steps = sorted(int(s) for s in self._manifest)
        for s in steps[: max(0, len(steps) - self.max_to_keep)]:
            entry = self._manifest.pop(str(s), None)
            if entry:
                try:
                    os.unlink(os.path.join(self._dir, entry["file"]))
                except OSError:
                    pass
        if len(steps) > self.max_to_keep:
            try:
                self._write_manifest_locked()
            except OSError:
                # stale entries point at unlinked files; restore treats
                # those as corrupt and drops them
                pass

    # -- read --------------------------------------------------------------
    def _candidate_steps(self) -> list[int]:
        """Known steps, newest first: manifest entries plus any orphan
        ``ckpt-*.npz`` a crash left un-indexed."""
        with self._lock:
            steps = {int(s) for s in self._manifest}
        try:
            for name in os.listdir(self._dir):
                if name.startswith("ckpt-") and name.endswith(".npz"):
                    try:
                        steps.add(int(name[5:-4]))
                    except ValueError:
                        pass
        except OSError:
            pass
        return sorted(steps, reverse=True)

    def latest_step(self) -> int | None:
        steps = self._candidate_steps()
        return steps[0] if steps else None

    def _load_verified(self, step: int) -> dict:
        """Parse + verify one checkpoint file → {meta, arrays} or raise
        CheckpointCorruption."""
        path = self._file_for(step)
        with self._lock:
            entry = self._manifest.get(str(int(step)))
        try:
            size = os.stat(path).st_size
        except OSError as e:
            raise CheckpointCorruption(f"missing {path}") from e
        if entry is not None:
            if size != entry["nbytes"]:
                raise CheckpointCorruption(
                    f"{path}: size {size} != manifest {entry['nbytes']} "
                    "(truncated or partial write)")
            if _crc32_file(path) != entry["crc32"]:
                raise CheckpointCorruption(
                    f"{path}: crc32 mismatch (bit rot or torn write)")
        try:
            with open(path, "rb") as f:
                blob = f.read()
            z = np.load(io.BytesIO(blob), allow_pickle=False)
            meta = json.loads(bytes(z["__meta__"]).decode())
            arrays = []
            for i, lf in enumerate(meta["leaves"]):
                buf = z[f"leaf_{i:05d}"]
                want = (int(np.prod(lf["shape"], dtype=np.int64))
                        * _itemsize(lf["dtype"]))
                if buf.nbytes != want:
                    raise CheckpointCorruption(
                        f"{path}: leaf {i} has {buf.nbytes} bytes, "
                        f"expected {want}")
                arrays.append(_from_bytes(buf, lf["shape"], lf["dtype"]))
        except CheckpointCorruption:
            raise
        except Exception as e:  # zip/json/npy damage of any shape
            raise CheckpointCorruption(f"{path}: unreadable ({e!r})") from e
        return {"meta": meta, "arrays": arrays}

    def _drop(self, step: int, reason: str) -> None:
        from tpudl_torch.obs import flight as _flight

        _metrics.counter("train.checkpoint.corrupt").inc()
        _flight.record_error("train.checkpoint.corrupt", reason,
                             step=int(step), dir=self._dir)
        with self._lock:
            if self._manifest.pop(str(int(step)), None) is not None:
                try:
                    self._write_manifest_locked()
                except OSError:
                    pass  # the in-memory drop still prevents re-reads
        try:
            os.unlink(self._file_for(step))
        except OSError:
            pass

    def restore(self, step: int | None = None, *, like=None):
        """Restore the state tree at ``step`` (default: the newest VALID
        step — a corrupt newest checkpoint falls back to its
        predecessor). ``like`` gives the target structure: each leaf
        comes back placed like the ``like`` leaf (see the module
        docstring). Returns None when nothing restorable exists."""
        if step is not None:
            payload = self._load_verified(step)  # explicit step: raise
            return self._rebuild(payload, like)
        for cand in self._candidate_steps():
            try:
                payload = self._load_verified(cand)
            except CheckpointCorruption as e:
                self._drop(cand, str(e))
                continue
            return self._rebuild(payload, like)
        return None

    def _rebuild(self, payload: dict, like):
        meta, arrays = payload["meta"], payload["arrays"]
        if like is not None:
            flat = _flatten(like)
            keys = [_keystr(p) for p, _ in flat]
            saved = [lf["key"] for lf in meta["leaves"]]
            if keys != saved:
                raise ValueError(
                    f"checkpoint structure does not match `like`: saved "
                    f"leaves {saved[:4]}... vs target {keys[:4]}...")
            placed = iter([_place_like(ref, arr)
                           for (_, ref), arr in zip(flat, arrays)])
            return _unflatten_like(like, placed)
        # like-less restore: rebuild nested dict/list containers from the
        # recorded path components (attr paths degrade to dict keys)
        root = None

        def _place(container, comps, value):
            head, rest = comps[0], comps[1:]
            key = head["k"] if head["t"] in ("key", "attr") else head["i"]
            if isinstance(container, list):
                while len(container) <= key:
                    container.append(None)
            if not rest:
                container[key] = value
                return
            nxt = [] if rest[0]["t"] == "idx" else {}
            if isinstance(container, list):
                if container[key] is None:
                    container[key] = nxt
                child = container[key]
            else:
                child = container.setdefault(key, nxt)
            _place(child, rest, value)

        for lf, arr in zip(meta["leaves"], arrays):
            comps = lf["path"]
            if not comps:
                return arr  # bare-leaf state
            if root is None:
                root = [] if comps[0]["t"] == "idx" else {}
            _place(root, comps, arr)
        return root

    # -- maintenance -------------------------------------------------------
    def validate(self) -> list[str]:
        """Integrity errors across every known step; empty = clean."""
        errs = []
        for s in self._candidate_steps():
            try:
                self._load_verified(s)
            except CheckpointCorruption as e:
                errs.append(str(e))
        return errs

    def close(self):
        pass  # every save is already durable; kept for API compat

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _place_like(ref, t: torch.Tensor):
    if isinstance(ref, torch.Tensor):
        return t.to(ref.device)
    if t.dtype == torch.bfloat16:
        return t
    return t.numpy()


def _unflatten_like(like, leaves):
    """``like``'s containers with its leaves taken in order from the
    ``leaves`` iterator (``None`` stays ``None``)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten_like(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten_like(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves) for v in like)
    return next(leaves)


def as_numpy_state(state):
    """A state tree of tensors → host numpy arrays (for handing across
    process restarts). bfloat16 tensors stay CPU tensors: numpy has no
    bfloat16 without ml_dtypes."""
    def host(leaf):
        if not isinstance(leaf, torch.Tensor):
            return np.asarray(leaf)
        t = leaf.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()

    return _unflatten_like(state, iter([host(leaf)
                                        for _, leaf in _flatten(state)]))
