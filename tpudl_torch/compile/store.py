"""The program store: CUDA graphs keyed by program signature, and a
manifest of those signatures that a fresh process captures ahead of
traffic.

Port of ``tpudl/compile/store.py`` on torch's terms. tpudl's program is a
compiled XLA executable, which it serializes; the port's is a CUDA graph
captured through the port's one capture path
(:func:`tpudl_torch.cuda_ops.capture_graph`), and a CUDA graph cannot be
serialized: it holds the addresses of the live function's weights. So
the store has the two layers that carry over and none of tpudl's
executable files:

1. an **in-process program table** ``(signature key, live owner, device)
   → graph``, consulted at dispatch (``compile.hits`` /
   ``compile.misses``), bounded to :data:`PROGRAM_CACHE_SIZE` graphs, as
   the executor bounds the fused graphs of one function (least recently
   used out; an evicted graph's memory pool goes back only after its
   last replay). A **hit** copies the arguments into the graph's static
   inputs, replays it and clones its outputs (the executor's
   :class:`~tpudl_torch.compile.graphs.FusedGraph` with one microbatch);
   a **miss** runs the eager function, returns its result, records the
   signature and captures, so that the next dispatch of that key hits;
2. a checksummed **manifest** (:data:`MANIFEST_NAME`, atomic tmp +
   ``os.replace``): one entry per signature — the function's fingerprint,
   each argument's shape, dtype, device type and mesh token, the kernel
   flags a capture freezes (TF32 for matmul and cuDNN, cuDNN's
   determinism), the backend — each with tpudl's self-crc. Its schema
   and file name are the port's own, so tpudl and the port can share one
   ``TPUDL_COMPILE_AOT=<dir>`` and neither reads, rewrites or warms the
   other's entries.

"Restore" means capture from the manifest before traffic: a CUDA graph
needs its live function, so :meth:`ProgramStore.ensure_restored` captures
every entry (of this backend) whose fingerprint matches a live function —
the one it is given, those the store has seen, or one an owner rebuilds
from the entry (``TinyCausalLM``'s generate graphs) — on zero-filled
inputs of the entry's shapes. ``compile.programs_restored`` and
``compile.aot_s`` count it. A capture holds to the entry's kernel flags
without writing the process's: an entry with TF32 off captures inside
``device.full_f32()``; any other only while the process holds its flags
(else ``compile.restore_skipped``). Serve-loop programs run in place over
an engine's state (:class:`BoundGraph`); they are recorded, and captured
when their engine is built (``TinyCausalLM.precompile_serve``), not from
the manifest, and the engine, not the table, holds them.

Identity (``fn_fingerprint``): the function's code and closure contents,
memoised; numpy and CPU tensors by bounded-sample crc. A closure that
reaches tensors on a card or opaque objects (memory addresses) cannot be
content-hashed from the host, so such a fingerprint is **not portable**:
its signatures are recorded but never restored in another process. An
``aot_token`` attribute (a host-side identity: model name, weights file,
seed, dtype) wins over the walk.

On the CPU a program is the plain function: the table, the manifest and
the counters behave the same. Failures: a corrupt manifest is
quarantined (``.corrupt``, ``compile.store_corrupt``) and the store
starts empty; a corrupt entry is skipped and counted; entries of another
backend are skipped. A capture or replay that fails raises, as the
executor's fused graphs do; nothing falls back to the eager function.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import hashlib
import json
import math
import os
import re
import time
import weakref
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpudl_torch.compile.graphs import BoundGraph, FusedGraph, PlainProgram
from tpudl_torch.testing import faults as _faults
from tpudl_torch.testing import tsan as _tsan

__all__ = ["ProgramStore", "BoundGraph", "get_program_store",
           "reset_program_store", "aot_enabled", "store_dir", "warm_start",
           "fn_fingerprint", "content_token", "backend_token",
           "signature_of", "forget", "counting_misses",
           "MANIFEST_NAME", "MANIFEST_SCHEMA", "MANIFEST_VERSION",
           "PROGRAM_CACHE_SIZE"]

MANIFEST_NAME = "programs-manifest-torch.json"
MANIFEST_SCHEMA = "tpudl_torch-programs"
MANIFEST_VERSION = 1
PROGRAM_CACHE_SIZE = 8   # graphs kept in the table, least recently used out

_TRUTHY = ("1", "on", "true", "yes")


# copied from tpudl/compile/store.py:aot_enabled
def aot_enabled(value=None) -> bool:
    """Is the program store armed? An explicit kwarg wins; else
    ``TPUDL_COMPILE_AOT`` — unset/``0``/``off`` = off, ``1`` (or a
    store-directory path) = on."""
    if value is not None:
        return bool(value)
    env = os.environ.get("TPUDL_COMPILE_AOT", "").strip()
    return env != "" and env.lower() not in ("0", "off", "false", "none")


# copied from tpudl/compile/store.py:store_dir
def store_dir() -> str:
    """The program store directory: a path-valued ``TPUDL_COMPILE_AOT``
    names it directly; otherwise ``<cache dir>/programs`` (the kernel-build
    cache's base: one knob relocates both)."""
    env = os.environ.get("TPUDL_COMPILE_AOT", "").strip()
    if env and env.lower() not in _TRUTHY \
            and env.lower() not in ("0", "off", "false", "none"):
        return os.path.expanduser(env)
    from tpudl_torch.compile.cache import DEFAULT_CACHE_DIR

    base = os.environ.get("TPUDL_COMPILE_CACHE_DIR")
    if not base or base == "0":
        base = DEFAULT_CACHE_DIR
    return os.path.join(os.path.expanduser(base), "programs")


@functools.lru_cache(maxsize=None)
def _backend(dev: str) -> dict:
    """:func:`backend_token` of one device, read once (do not mutate)."""
    return backend_token(dev)


def backend_token(device=None) -> dict:
    """The backend a captured program is valid for: platform, the card's
    name, count, torch and CUDA versions and compute capability (a graph
    freezes kernels built for all of them). ``device`` picks the platform
    (default: the card when there is one)."""
    dev = (torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return {"platform": "cuda",
                "device_kind": torch.cuda.get_device_name(idx),
                "n_devices": torch.cuda.device_count(),
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "capability": list(torch.cuda.get_device_capability(idx))}
    return {"platform": "cpu", "device_kind": "cpu", "n_devices": 1,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "capability": None}


# -- fn fingerprinting -------------------------------------------------------

_FP_LOCK = _tsan.named_lock("compile.fingerprint_memo")
_FP_MEMO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

_SAMPLE = 1 << 16  # closure-array crc sample bytes (head + tail)


# copied from tpudl/compile/store.py:_hash_array
def _hash_array(h, arr: np.ndarray) -> None:
    h.update(f"&nd{arr.dtype}{arr.shape}".encode())
    flat = arr.reshape(-1) if arr.flags["C_CONTIGUOUS"] \
        else np.ascontiguousarray(arr).reshape(-1)
    head = flat[: _SAMPLE // max(1, arr.itemsize)]
    tail = flat[-(_SAMPLE // max(1, arr.itemsize)):]
    h.update(zlib.crc32(head.tobytes()).to_bytes(4, "little"))
    h.update(zlib.crc32(tail.tobytes()).to_bytes(4, "little"))


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bits as numpy (bfloat16 as its int16 bits)."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _hash_obj(h, obj, depth: int, seen: set, state: dict) -> None:
    """One closure/const value into the running fingerprint (tpudl's walk,
    over torch's types). Bounded depth + identity-set so cyclic graphs
    terminate. A tensor on a card or an object known only by its address
    marks the fingerprint NOT portable."""
    if depth > 5 or id(obj) in seen:
        h.update(b"&deep")
        return
    seen.add(id(obj))
    tok = getattr(obj, "aot_token", None)
    if tok is not None and not callable(tok):
        h.update(f"&tok{tok}".encode())
        return
    if obj is None or isinstance(obj, (bool, int, float, complex, str,
                                       bytes)):
        h.update(f"&c{obj!r}".encode())
        return
    import types

    if isinstance(obj, types.ModuleType):
        h.update(f"&mod{obj.__name__}".encode())
        return
    if isinstance(obj, type):
        h.update(f"&cls{obj.__module__}.{obj.__qualname__}".encode())
        return
    if isinstance(obj, (torch.dtype, torch.device)):
        # a device is its type: the ordinal is where, not what
        h.update(f"&t{getattr(obj, 'type', obj)}".encode())
        return
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cpu" and obj.layout == torch.strided:
            _hash_array(h, _host_array(obj))
        else:
            # content-blind: hashing it would read the card back
            h.update(f"&tensor{obj.dtype}{tuple(obj.shape)}".encode())
            state["portable"] = False
        return
    if isinstance(obj, np.ndarray):
        _hash_array(h, obj)
        return
    if type(obj).__name__ == "Mesh" and hasattr(obj, "grid"):
        # topology, never device ordinals or object ids
        h.update(f"&mesh{sorted(obj.shape.items())!r}".encode())
        return
    code = getattr(obj, "__code__", None)
    if code is not None:
        h.update(f"&fn{getattr(obj, '__qualname__', '?')}".encode())
        h.update(hashlib.sha1(code.co_code).digest())
        for const in code.co_consts:
            if hasattr(const, "co_code"):
                h.update(hashlib.sha1(const.co_code).digest())
            else:
                h.update(f"&k{const!r}".encode())
        for cell in (obj.__closure__ or ()):
            try:
                contents = cell.cell_contents
            except ValueError:   # an empty cell (a name not yet bound)
                h.update(b"&empty")
                continue
            _hash_obj(h, contents, depth + 1, seen, state)
        for d in (obj.__defaults__ or ()):
            _hash_obj(h, d, depth + 1, seen, state)
        owner = getattr(obj, "__self__", None)
        if owner is not None:
            _hash_obj(h, owner, depth + 1, seen, state)
        return
    if isinstance(obj, (tuple, list)):
        h.update(f"&seq{len(obj)}".encode())
        for v in obj[:32]:
            _hash_obj(h, v, depth + 1, seen, state)
        return
    if isinstance(obj, dict):
        h.update(f"&map{len(obj)}".encode())
        for k in sorted(obj, key=repr)[:32]:
            h.update(f"&k{k!r}".encode())
            _hash_obj(h, obj[k], depth + 1, seen, state)
        return
    inner = getattr(obj, "__wrapped__", None) or getattr(obj, "func",
                                                         None)
    if inner is not None and inner is not obj:
        _hash_obj(h, inner, depth + 1, seen, state)
        args = getattr(obj, "args", None)
        if isinstance(args, (tuple, list)):
            for a in args:
                _hash_obj(h, a, depth + 1, seen, state)
        kw = getattr(obj, "keywords", None)
        if isinstance(kw, dict):
            for k, v in sorted(kw.items()):
                h.update(f"&k{k}".encode())
                _hash_obj(h, v, depth + 1, seen, state)
        return
    t = type(obj)
    h.update(f"&o{t.__module__}.{t.__qualname__}".encode())
    attrs = getattr(obj, "__dict__", None)
    if isinstance(attrs, dict) and attrs:
        for k in sorted(attrs)[:32]:
            h.update(f"&k{k}".encode())
            _hash_obj(h, attrs[k], depth + 1, seen, state)
    else:
        text = repr(obj)[:256]
        if re.search(r"0x[0-9a-fA-F]+", text):
            state["portable"] = False   # known only by its address
        h.update(re.sub(r"0x[0-9a-fA-F]+", "0x", text).encode())


def content_token(obj) -> str | None:
    """A host-side content identity of ``obj`` (weights pytrees, model
    files' configs): the sha1 of the fingerprint walk, or None when the walk
    reaches a tensor on a card or an object known only by its address.
    Stages build their functions' ``aot_token`` from it."""
    h = hashlib.sha1()
    state = {"portable": True}
    _hash_obj(h, obj, 0, set(), state)
    return h.hexdigest() if state["portable"] else None


def fn_fingerprint(fn) -> tuple[str | None, bool]:
    """``(sha1-hex, portable)`` identity of a program's function, stable
    across processes for the same source and closure contents; ``None``
    when no code is reachable (the store then stands aside). ``aot_token``
    wins. Memoised per live function."""
    try:
        with _FP_LOCK:
            cached = _FP_MEMO.get(fn)
    except TypeError:
        cached = None
    if cached is not None:
        return cached
    tok = getattr(fn, "aot_token", None)
    if tok is not None and not callable(tok):
        out: tuple[str | None, bool] = (
            hashlib.sha1(f"token:{tok}".encode()).hexdigest(), True)
    else:
        h = hashlib.sha1()
        state = {"portable": True}
        _hash_obj(h, fn, 0, set(), state)
        found_code = hasattr(fn, "__code__") or \
            getattr(fn, "__wrapped__", None) is not None or \
            getattr(fn, "func", None) is not None or \
            hasattr(type(fn), "__call__") and hasattr(fn, "__dict__")
        out = (h.hexdigest() if found_code else None, state["portable"])
    try:
        with _FP_LOCK:
            _FP_MEMO[fn] = out
    except TypeError:
        pass
    return out


# -- program signatures ------------------------------------------------------

def _kernel_flags() -> dict:
    """The settings a capture freezes into its kernels (as the executor's
    fused-graph key holds them)."""
    return {"matmul_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn_tf32": bool(torch.backends.cudnn.allow_tf32),
            "cudnn_deterministic": bool(torch.backends.cudnn.deterministic)}


@contextlib.contextmanager
def _entry_flags(flags: dict):
    """Hold a restore's capture to an entry's kernel flags without writing
    the process's behind :func:`tpudl_torch.device.full_f32`'s back. An
    entry with both TF32 flags off captures inside ``full_f32()``, which
    counts its block as any f32 stage does; any other entry captures only
    while the process already holds its flags (never while a thread is
    inside a ``full_f32`` block, which holds both flags off). Yields
    whether the capture may run; the caller skips and counts a False."""
    if not flags["matmul_tf32"] and not flags["cudnn_tf32"]:
        from tpudl_torch.device import full_f32

        with full_f32():
            yield _kernel_flags() == flags
    else:
        yield _kernel_flags() == flags


def _mesh_token(mesh) -> str | None:
    """A mesh's topology: axis names and sizes (never device ordinals)."""
    if mesh is None:
        return None
    return f"mesh{sorted((str(k), int(v)) for k, v in mesh.shape.items())}"


def _flatten(obj, leaves: list) -> str:
    if isinstance(obj, tuple):
        return "(" + ",".join(_flatten(v, leaves) for v in obj) + ")"
    if isinstance(obj, list):
        return "[" + ",".join(_flatten(v, leaves) for v in obj) + "]"
    if isinstance(obj, dict):
        return "{" + ",".join(f"{k!r}:" + _flatten(obj[k], leaves)
                              for k in sorted(obj, key=repr)) + "}"
    leaves.append(obj)
    return "*"


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def signature_of(args, mesh=None) -> dict:
    """JSON-shippable signature of one positional-argument tuple: its
    structure, per leaf ``[shape, dtype, device type, mesh token]``
    (``["value", repr]`` for a Python constant), and the kernel flags."""
    leaves: list = []
    tree = _flatten(tuple(args), leaves)
    mtok = _mesh_token(mesh)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return [list(x.shape), _dtype_name(x.dtype), x.device.type, mtok]
        if isinstance(x, np.ndarray):
            return [list(x.shape), str(x.dtype), "host", mtok]
        return ["value", repr(x)]

    return {"tree": tree, "leaves": [leaf(x) for x in leaves],
            "flags": _kernel_flags()}


def _program_device(args):
    """The device of a graph program over ``args``, a flat sequence of
    tensors on one device; None when the store cannot capture them (a
    nested or non-tensor argument, or two devices)."""
    devs = set()
    for a in args:
        if not isinstance(a, torch.Tensor):
            return None
        devs.add(a.device)
    if len(devs) != 1:
        return None
    return devs.pop()


def _zeros_of(leaves, device) -> list:
    """Zero-filled arguments of an entry's shapes, on ``device`` — or on
    the host where the entry's leaf was (a fused group's microbatches are
    host tensors the graph copies in), so that their signature is the
    entry's (zeroed as bytes: the unsigned wire dtypes have no fill kernel
    everywhere)."""
    out = []
    for shape, dtype, where, *_ in leaves:
        dt = getattr(torch, dtype)
        n = math.prod(shape)
        raw = torch.zeros(max(n, 1) * dt.itemsize, dtype=torch.uint8,
                          device="cpu" if where == "cpu" else device)
        out.append(raw.view(dt)[:n].reshape(shape))
    return out


# copied from tpudl/compile/store.py:_entry_crc
def _entry_crc(entry: dict) -> int:
    """Self-checksum over the entry's canonical JSON (sans the crc
    field itself) — the validator's torn-manifest tripwire."""
    body = {k: v for k, v in entry.items() if k != "crc"}
    return zlib.crc32(json.dumps(body, sort_keys=True,
                                 default=str).encode()) & 0xFFFFFFFF


def _metrics():
    from tpudl_torch.obs import metrics as _m

    return _m


def _charge_compile_s(seconds: float) -> None:
    """The attribution pairing of ``compile.aot_s``: the same seconds to
    the calling scope (a background restore runs scope-free and lands in
    ``unattributed``), so the ledger reconciles."""
    from tpudl_torch.obs import attribution as _attr

    _attr.charge("compile_s", seconds)


# the capture misses of the context that set it (a supervised attempt):
# a one-element list, or None where nobody counts
_CONTEXT_MISSES: contextvars.ContextVar = contextvars.ContextVar(
    "tpudl_torch_context_misses", default=None)


@contextlib.contextmanager
def counting_misses():
    """Count the store's misses made in this context (the calling thread
    and what it runs inline), not the process's: ``with counting_misses()
    as n:`` leaves the count in ``n[0]``. Another thread missing the store
    meanwhile does not move it."""
    box = [0]
    token = _CONTEXT_MISSES.set(box)
    try:
        yield box
    finally:
        _CONTEXT_MISSES.reset(token)


def _live_ref(owner):
    """``(id, weakref)`` of a program's live owner (a bound method stands
    for its object and function; a fresh one is made at every access)."""
    self_ = getattr(owner, "__self__", None)
    func = getattr(owner, "__func__", None)
    if self_ is not None and func is not None:
        target, ident = self_, ("m", id(self_), id(func))
    else:
        target, ident = owner, ("f", id(owner))
    try:
        return ident, weakref.ref(target), target
    except TypeError:
        return ident, (lambda t=target: t), target


class _NullReport:
    """A report that records nothing (dispatches outside the executor)."""

    @staticmethod
    def stage(name):
        return contextlib.nullcontext()


_NULL_REPORT = _NullReport()
_UNSEEN = object()   # a bound program the store has not readied

# where a program lives in the table, and what its manifest entry holds
_Site = collections.namedtuple(
    "_Site", "fp portable sig backend key tkey ref mesh device")


class ProgramStore:
    """One store directory: the manifest plus the live program table.
    Thread-safe (the executor's consumer, a stage's warm-up and a
    background restore may touch it at once)."""

    def __init__(self, root: str):
        self.root = str(root)
        self._lock = _tsan.named_lock("compile.program_store", kind="rlock")
        # (key, live owner id, device) → (ref, program)
        self._table: collections.OrderedDict = collections.OrderedDict()
        self._entries: dict = {}
        self._ladder_meta: dict | None = None
        self._live: dict = {}     # fingerprint → {id: () -> live fn}
        self._owners: dict = {}   # owner token → {id: ref}
        # bound programs readied here → their key (None: no identity)
        self._bound: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._pool: ThreadPoolExecutor | None = None
        self._futures: list = []
        os.makedirs(self.root, exist_ok=True)
        self._load_manifest()

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST_NAME)

    def _load_manifest(self) -> None:
        path = self._manifest_path()
        try:
            with open(path) as f:
                m = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            m = None
        if not isinstance(m, dict) or m.get("schema") != MANIFEST_SCHEMA:
            # corrupt or foreign: quarantine beside and start empty
            _metrics().counter("compile.store_corrupt").inc()
            try:
                os.replace(path, path + ".corrupt")
            except OSError:
                pass
            return
        entries = m.get("entries")
        if isinstance(entries, dict):
            self._entries = {k: v for k, v in entries.items()
                             if isinstance(v, dict)}
        lad = m.get("ladder")
        if isinstance(lad, dict):
            # tpudl: ignore[daemon-shared-write] — runs from __init__
            # only, before the instance is published to any thread;
            # later writes (note_ladder) hold the store's lock
            self._ladder_meta = lad

    def _write_manifest_locked(self) -> None:
        m = {"schema": MANIFEST_SCHEMA, "version": MANIFEST_VERSION,
             "ladder": self._ladder_meta, "updated_ts": time.time(),
             "entries": self._entries}
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

    def note_ladder(self, ladder) -> None:
        """Record the bucket ladder this store's signatures were observed
        under."""
        meta = ladder.to_meta() if ladder is not None else None
        with self._lock:
            if meta != self._ladder_meta:
                self._ladder_meta = meta
                self._write_manifest_locked()

    def entries(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def programs(self) -> int:
        """Programs in the in-process table."""
        with self._lock:
            return len(self._table)

    # -- keys and the table ------------------------------------------------
    @staticmethod
    def _key_for(fp: str, sig: dict, micro: int, bound: bool,
                 backend: dict) -> str:
        h = hashlib.sha1()
        h.update(fp.encode())
        h.update(json.dumps(sig, sort_keys=True).encode())
        h.update(f"m{int(micro)}".encode())
        h.update(b"bound" if bound else b"copy")
        h.update(json.dumps(backend, sort_keys=True).encode())
        return h.hexdigest()

    def _lookup(self, tkey, target):
        with self._lock:
            slot = self._table.get(tkey)
            if slot is None:
                return None
            if slot[0]() is not target:   # its owner died; the id moved on
                self._table.pop(tkey)
                evicted = slot[1]
            else:
                self._table.move_to_end(tkey)
                return slot[1]
        evicted.release()
        return None

    def _insert(self, tkey, ref, program) -> None:
        evicted = []
        with self._lock:
            self._table[tkey] = (ref, program)
            self._table.move_to_end(tkey)
            for k in [k for k, (r, _) in self._table.items() if r() is None]:
                evicted.append(self._table.pop(k)[1])
            while len(self._table) > PROGRAM_CACHE_SIZE:
                evicted.append(self._table.popitem(last=False)[1][1])
            n = len(self._table)
        _metrics().gauge("compile.programs").set(n)
        for program in evicted:
            program.release()   # after its last replay

    def forget(self, *owners) -> int:
        """Drop the programs of ``owners`` (functions or the objects whose
        bound methods they are) from the table: their graphs read memory
        the owner is about to replace. Returns how many went."""
        idents = {_live_ref(o)[0] for o in owners}
        ids = {i[1] for i in idents}
        gone = []
        with self._lock:
            for k in list(self._table):
                if k[1] in idents or k[1][1] in ids:
                    gone.append(self._table.pop(k)[1])
        for program in gone:
            program.release()
        return len(gone)

    def _remember(self, fp: str, fn) -> None:
        """Keep a weak handle on a live function of fingerprint ``fp``, so
        that a later :meth:`ensure_restored` can capture its entries."""
        ident, ref, _ = _live_ref(fn)
        func = getattr(fn, "__func__", None)
        if ident[0] == "m":
            def live():
                obj = ref()
                return None if obj is None else func.__get__(obj)
        else:
            live = ref
        with self._lock:
            self._live.setdefault(fp, {})[ident] = live

    def register_owner(self, owner) -> None:
        """Let ``owner`` (with an ``aot_token`` and ``_aot_rebuild(spec) ->
        (fn, args) | None``) rebuild its programs from the manifest in
        :meth:`ensure_restored`."""
        ident, ref, _ = _live_ref(owner)
        with self._lock:
            self._owners.setdefault(str(owner.aot_token), {})[ident] = ref

    # -- entries -----------------------------------------------------------
    def _record(self, key: str, sig: dict, *, fp: str, portable: bool,
                micro: int, bound: bool, backend: dict, mesh, bucketed: bool,
                outputs, program=None) -> None:
        """The manifest entry of ``key``, written once (``compile.observed``)."""
        with self._lock:
            if key in self._entries:
                return
            entry = {"fn": fp, "tree": sig["tree"], "leaves": sig["leaves"],
                     "flags": sig["flags"], "micro": int(micro),
                     "bound": bool(bound), "portable": bool(portable),
                     "bucketed": bool(bucketed), "mesh": _mesh_token(mesh),
                     "outputs": outputs, "program": program,
                     "backend": dict(backend), "created_ts": time.time(),
                     "capture_s": None}
            entry["crc"] = _entry_crc(entry)
            self._entries[key] = entry
            self._write_manifest_locked()
        _metrics().counter("compile.observed").inc()

    def _note_capture(self, key: str, seconds: float) -> None:
        m = _metrics()
        m.counter("compile.programs_compiled").inc()
        m.counter("compile.aot_s").inc(seconds)
        _charge_compile_s(seconds)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.get("capture_s") is None:
                entry["capture_s"] = round(seconds, 4)
                entry["crc"] = _entry_crc(entry)
                self._write_manifest_locked()

    @staticmethod
    def _hit(report) -> None:
        _metrics().counter("compile.hits").inc()
        if report is not None:
            report.count("aot_hits")

    @staticmethod
    def _miss(report) -> None:
        _metrics().counter("compile.misses").inc()
        box = _CONTEXT_MISSES.get()
        if box is not None:
            box[0] += 1
        if report is not None:
            report.count("aot_misses")

    # -- the one dispatch sequence -----------------------------------------
    def _find(self, fn, owner, like, micro: int, device, mesh):
        """``(site, program)``: the table's program of ``fn`` as
        ``owner``'s (default ``fn``) on ``device``, at the signature of
        ``like`` (one microbatch's arguments) with ``micro`` microbatches,
        or None; ``site`` is its key, which :meth:`_build` fills on a
        miss. A card's key names its index, as a tensor's device does
        (the executor's ``cuda`` and a restore's ``cuda:0`` are one
        card's one program)."""
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        fp, portable = fn_fingerprint(fn)
        ident, ref, target = _live_ref(fn if owner is None else owner)
        sig = signature_of(like, mesh)
        backend = _backend(str(device))
        key = self._key_for(fp or "", sig, micro, False, backend)
        site = _Site(fp, portable, sig, backend, key,
                     (key, ident, str(device)), ref, mesh, device)
        return site, self._lookup(site.tkey, target)

    def _build(self, site, fn, group, n_out: int, single: bool, *,
               warm: bool, bucketed: bool = False, spec=None):
        """A miss at ``site``: record its manifest entry (when ``fn`` has
        an identity), make the program of ``len(group)`` microbatches —
        the executor's fused graph on the card, the plain function on the
        CPU — capture it over ``group`` (``warm=False`` skips the warm-up
        run: the caller just ran ``fn`` eagerly on these shapes) and hold
        it in the table. ``spec`` is an owner's rebuild descriptor. The
        ``compile.precompile`` fault point fires a program (a kill here
        leaves a valid manifest: the entry is written before the
        capture)."""
        m = len(group)
        if site.fp is not None:
            self._remember(site.fp, fn)
            self._record(site.key, site.sig, fp=site.fp,
                         portable=site.portable, micro=m, bound=False,
                         backend=site.backend, mesh=site.mesh,
                         bucketed=bucketed, outputs=[int(n_out), bool(single)],
                         program=spec)
        _faults.fire("compile.precompile", key=site.key[:12])
        if site.device.type == "cuda":
            program = FusedGraph(fn, m, tuple(group[0][0]), int(n_out),
                                 site.device)
        else:
            program = PlainProgram(fn, m, int(n_out))
        program.single = bool(single) and m == 1
        t0 = time.perf_counter()
        program.ready(group, warm=warm)
        if program.graph is not None:
            self._note_capture(site.key, time.perf_counter() - t0)
        self._insert(site.tkey, site.ref, program)
        return program

    # -- the dispatch-path hook -------------------------------------------
    def count_miss(self, report=None) -> None:
        """Count a dispatch the store could not serve (a sampled generate,
        which stays eager)."""
        self._miss(report)

    def call(self, fn, args, *, owner=None, mesh=None, bucketed: bool = False,
             report=None, program=None):
        """Run ``fn(*args)`` THROUGH the store. ``args`` is a flat tuple of
        tensors on one device (anything else runs ``fn`` directly, unseen).
        A table hit replays the program; a miss runs ``fn`` eagerly,
        returns its result, records the signature and captures the program
        (on the card, with no warm-up: the eager run was one) so that the
        next dispatch hits. ``owner`` (default ``fn``) is what the program
        lives as long as, and is keyed by in the table: the executor
        passes the user's function while ``fn`` is its codec wrapper.
        ``program`` is an owner's rebuild descriptor for the entry (see
        :meth:`register_owner`)."""
        args = tuple(args)
        dev = _program_device(args)
        if dev is None or fn_fingerprint(fn)[0] is None:
            return fn(*args)
        site, prog = self._find(fn, owner, args, 1, dev, mesh)
        if prog is not None:
            out = prog.run([(args,)], _NULL_REPORT)
            self._hit(report)
            return out[0] if prog.single else out
        result = fn(*args)
        single = not isinstance(result, (tuple, list))
        outs = (result,) if single else tuple(result)
        if not all(isinstance(o, torch.Tensor) and o.device == dev
                   for o in outs):
            return result   # a host function: nothing the store can hold
        self._miss(report)
        self._build(site, fn, [(args,)], len(outs), single, warm=False,
                    bucketed=bucketed, spec=program)
        return result

    def fused(self, run_fn, owner, group, n_out: int, device, *, mesh=None,
              report=None):
        """The program of a fused group (``len(group)`` microbatches shaped
        like ``group[0]``): under ``fuse_steps`` the executor's fused CUDA
        graph stays the program, and the store keys, records and counts it
        (a hit: captured before; a miss: captured by this dispatch).
        Returns it; the caller runs it."""
        site, program = self._find(run_fn, owner, group[0][0], len(group),
                                   device, mesh)
        if program is not None:
            self._hit(report)
            return program
        self._miss(report)
        return self._build(site, run_fn, group, n_out, False, warm=True)

    # -- bound (serve-loop) programs ----------------------------------------
    def _ready_bound(self, program: BoundGraph):
        """Record a :class:`BoundGraph`'s signature once and, on the card,
        capture it; its manifest key, or None when its function has no
        identity."""
        fp, portable = fn_fingerprint(program.fn)
        key = None
        if fp is not None:
            sig = signature_of(program.state)
            backend = _backend(str(program.device))
            key = self._key_for(fp, sig, 1, True, backend)
            self._record(key, sig, fp=fp, portable=portable, micro=1,
                         bound=True, backend=backend, mesh=None,
                         bucketed=False, outputs=None)
        t0 = time.perf_counter()
        captured = program.graph is None and program.graphs
        program.ready()
        if captured and key is not None:
            self._note_capture(key, time.perf_counter() - t0)
        with self._lock:
            self._bound[program] = key
        return key

    def ready_bound(self, program: BoundGraph) -> bool:
        """Ready a :class:`BoundGraph` ahead of traffic: record its
        signature in the manifest and, on the card, capture it. Its engine
        holds it, so the table does not (evicting it would free nothing);
        its later runs count as hits. Returns True when the program has an
        identity the store can count."""
        with self._lock:
            key = self._bound.get(program, _UNSEEN)
        if key is _UNSEEN:
            key = self._ready_bound(program)
        return key is not None

    def run_bound(self, program: BoundGraph, report=None) -> None:
        """Run one :class:`BoundGraph` through the store: its first run is
        a miss that records and captures it (and then replays: its warm-up
        cannot follow an eager run that already moved the state); every
        later run, or every run after :meth:`ready_bound`, a hit."""
        with self._lock:
            key = self._bound.get(program, _UNSEEN)
        count = self._hit
        if key is _UNSEEN:
            key, count = self._ready_bound(program), self._miss
        if key is not None:
            count(report)
        program()

    # -- explicit (warm-up path) capture -----------------------------------
    def compile_signature(self, fn, args, *, owner=None, mesh=None,
                          micro: int = 1, bucketed: bool = False,
                          n_out: int = 1, single: bool = True,
                          program=None, block: bool = True) -> bool:
        """Capture ``fn`` at the signature of ``args`` (example tensors on
        the program's device, whose values the capture's warm-up runs on)
        before traffic — the warm-up entry point (``ImageBatchWarmup``,
        ``TinyCausalLM.precompile_generate``). With ``micro`` M > 1 the
        program is the executor's fused graph of M such microbatches.
        ``n_out``/``single`` describe ``fn``'s outputs (default: one
        tensor). ``program`` is an owner's rebuild descriptor, stored in
        the entry. Returns True when the program is (or already was) in
        the table."""
        if not block:
            self._submit(self.compile_signature, fn, args, owner=owner,
                         mesh=mesh, micro=micro, bucketed=bucketed,
                         n_out=n_out, single=single, program=program)
            return True
        args = tuple(args)
        dev = _program_device(args)
        if dev is None or fn_fingerprint(fn)[0] is None:
            return False
        site, prog = self._find(fn, owner, args, int(micro), dev, mesh)
        if prog is None:
            self._build(site, fn, [(args,)] * int(micro), n_out, single,
                        warm=True, bucketed=bucketed, spec=program)
        return True

    def _submit(self, task, *a, **kw) -> None:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="tpudl-aot")
            self._futures.append(self._pool.submit(task, *a, **kw))
            del self._futures[:-64]

    # -- restore -----------------------------------------------------------
    def ensure_restored(self, fn=None, block: bool = False, *, owner=None,
                        devices=None, mesh=None) -> int:
        """Capture, before traffic, every manifest entry of this backend
        whose fingerprint matches a live function: ``fn`` when given (as
        ``owner``'s program, on each of ``devices`` under ``mesh``), else
        every function this store has seen and every registered owner's
        rebuilds. A CUDA graph needs its live function, so this is what
        "restore" means here. Entries of another backend, bound (serve)
        entries, non-portable and corrupt ones are skipped (corrupt ones
        counted), and so is an entry whose kernel flags the process does
        not hold now (``compile.restore_skipped``, see
        :func:`_entry_flags`). ``block=False`` runs on a background thread. Returns the
        programs captured by this call."""
        if not block:
            self._submit(self.ensure_restored, fn, True, owner=owner,
                         devices=devices, mesh=mesh)
            return 0
        t0 = time.perf_counter()
        want = fn_fingerprint(fn)[0] if fn is not None else None
        mtok = _mesh_token(mesh)
        n = 0
        for entry in self.entries().values():
            if entry.get("crc") != _entry_crc(entry):
                _metrics().counter("compile.store_corrupt").inc()
                continue
            if not entry.get("portable") or entry.get("bound"):
                continue
            if fn is not None:
                if entry.get("fn") != want or entry.get("mesh") != mtok:
                    continue
                cands = [(fn, fn if owner is None else owner, None)]
            elif entry.get("mesh") is not None:
                continue   # a mesh entry needs the run's mesh
            else:
                cands = self._candidates(entry)
            for live_fn, live_owner, args in cands:
                n += self._restore_one(entry, live_fn, live_owner, args,
                                       devices, mesh)
        if n:
            m = _metrics()
            m.counter("compile.programs_restored").inc(n)
            dt = time.perf_counter() - t0
            m.counter("compile.aot_s").inc(dt)
            _charge_compile_s(dt)
        return n

    def _candidates(self, entry) -> list:
        """``(fn, owner, example args or None)`` of the live functions that
        an entry may be captured for."""
        out = []
        with self._lock:
            bucket = dict(self._live.get(entry["fn"], {}))
            spec = entry.get("program")
            owners = (dict(self._owners.get(str(spec.get("owner")), {}))
                      if isinstance(spec, dict) else {})
        for live in bucket.values():
            live_fn = live()
            if live_fn is not None:
                out.append((live_fn, live_fn, None))
        for ref in owners.values():
            obj = ref()
            if obj is None:
                continue
            built = obj._aot_rebuild(spec)
            if built is None:
                continue
            live, args = built
            if fn_fingerprint(live)[0] == entry["fn"]:
                out.append((live, live, args))
        return out

    def _restore_one(self, entry, fn, owner, args, devices, mesh) -> int:
        backend = entry.get("backend") or {}
        platform = backend.get("platform")
        if platform == "cuda" and not torch.cuda.is_available():
            return 0
        if args is not None:
            targets = [_program_device(args)]
        else:
            # a card's key names its index, as a tensor's device does
            targets = [torch.device(d) for d in (devices or [platform])]
            targets = [torch.device("cuda", torch.cuda.current_device())
                       if d.type == "cuda" and d.index is None else d
                       for d in targets]
        n_out, single = entry.get("outputs") or [1, True]
        micro = int(entry.get("micro") or 1)
        n = 0
        for dev in dict.fromkeys(targets):
            if dev is None or dev.type != platform \
                    or _backend(str(dev)) != backend:
                continue   # another backend's entry: not ours
            example = tuple(args) if args is not None else tuple(
                _zeros_of(entry["leaves"], dev))
            ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
            with ctx, _entry_flags(entry["flags"]) as held:
                if not held:
                    _metrics().counter("compile.restore_skipped").inc()
                    continue
                site, prog = self._find(fn, owner, example, micro, dev, mesh)
                if prog is None:
                    self._build(site, fn, [(example,)] * micro, n_out,
                                single, warm=True)
                    n += 1
        return n

    def drain(self, timeout: float | None = None) -> None:
        """Wait for every queued background capture or restore; re-raises
        the first failure."""
        with self._lock:
            futs = list(self._futures)
            self._futures.clear()
        for f in futs:
            f.result(timeout)


# -- the process-wide store --------------------------------------------------

_STORE: ProgramStore | None = None
_STORE_LOCK = _tsan.named_lock("compile.store.singleton")


# copied from tpudl/compile/store.py:get_program_store
def get_program_store() -> ProgramStore:
    """The process-wide store at the CURRENT ``store_dir()`` (a changed
    env re-roots it)."""
    global _STORE
    root = store_dir()
    with _STORE_LOCK:
        if _STORE is None or _STORE.root != root:
            _STORE = ProgramStore(root)
        return _STORE


# copied from tpudl/compile/store.py:reset_program_store
def reset_program_store() -> None:
    global _STORE
    with _STORE_LOCK:
        _STORE = None


# copied from tpudl/compile/store.py:warm_start
def warm_start(block: bool = True) -> int:
    """Capture the manifest's programs for this process's live functions
    and registered owners (no-op unarmed): call it once the models are
    built and before traffic, so that the first dispatch replays."""
    if not aot_enabled():
        return 0
    return get_program_store().ensure_restored(block=block)


def forget(*owners) -> int:
    """Drop ``owners``' programs from the process-wide store's table, if
    there is a store (see :meth:`ProgramStore.forget`)."""
    with _STORE_LOCK:
        store = _STORE
    return store.forget(*owners) if store is not None else 0
