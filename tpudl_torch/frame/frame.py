"""Frame: ordered named columns of equal length, and its batch executor.

Port of ``tpudl/frame/frame.py``: the ``Frame`` container (with its
``num_partitions`` hint, ``filter_rows``/``take``/``dropna``/``head``,
``fingerprint`` and ``concat``), ``LazyColumn`` with its subset view and
fingerprint, ``null_mask``, and ``map_batches``, the pipelined executor.
A :class:`LazyColumn` (such as ``readImages``'s image column) materializes
only the rows a batch asks for, so host RAM stays O(batch).

The executor runs tpudl's stages, rebuilt for CUDA:

1. a prepare pool of N threads packs, checks, wire-encodes, bucket-pads
   and pins each batch (:class:`_PipelineInfeed`, K batches deep), or
   takes it from the shard cache or the device cache instead
   (:mod:`tpudl_torch.data`);
2. the consumer thread copies a batch to the card, runs ``fn`` and starts
   the device→host copies of its outputs, all without waiting
   (:func:`_start_host_copies`);
3. a window of D such batches is in flight (:class:`_DispatchWindow`);
   the consumer waits only on the oldest batch's copies;
4. with ``fuse_steps`` M > 1, M full batches run as one replay of a CUDA
   graph (:class:`tpudl_torch.compile.graphs.FusedGraph`).

Rows come back in the same order and count as tpudl's. With the program
store armed (``aot=`` / ``TPUDL_COMPILE_AOT``) each per-batch dispatch
goes through :class:`tpudl_torch.compile.ProgramStore`: a hit replays a
CUDA graph captured for that signature (in this process, or at run setup
from the manifest another process left), a miss runs ``fn`` and captures.
Under ``supervise=`` (``TPUDL_FRAME_DEGRADE=1``) the run is a supervised
attempt (:mod:`tpudl_torch.frame.supervisor`), retried down tpudl's
degradation ladder; the stages carry tpudl's fault points
(``frame.prepare``, ``frame.h2d``, ``frame.dispatch``, ``frame.d2h``) and
file each prepared batch's descriptor in the flight recorder. Every
stage is a host span on the tracer and beats the run's watchdog heartbeat
(``frame.map_batches``), which also arms the live status writer; the
prepare pool carries the caller's attribution scope, which is charged the
run's rows in and out and its dispatch seconds. ``autotune`` (tpudl's
default, on unless ``TPUDL_FRAME_AUTOTUNE=0``) seeds the knobs a caller
left unset from the roofline advisor's reading of the previous run's
report (:func:`tpudl_torch.obs.roofline.autotune_seed`).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from collections.abc import Callable, Iterator, Mapping, Sequence
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpudl_torch.compile.graphs import FusedGraph as _FusedGraph
from tpudl_torch.compile.graphs import as_outputs as _as_outputs
from tpudl_torch.compile.graphs import fused_plain as _fused_plain
from tpudl_torch.device import resolve_device
from tpudl_torch.obs import attribution as _attr
from tpudl_torch.obs import flight as _flight
from tpudl_torch.obs import watchdog as _watchdog
from tpudl_torch.testing import faults as _faults
from tpudl_torch.testing import tsan as _tsan

__all__ = ["Frame", "LazyColumn", "null_mask", "concat"]


# copied from tpudl/frame/frame.py:LazyColumn
class LazyColumn:
    """A deferred column: elements materialize per access. Concrete
    sources implement ``__len__`` and ``_get(indices) -> object ndarray``
    (see :class:`tpudl_torch.image.imageIO.LazyFileColumn`)."""

    dtype = np.dtype(object)

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def _get(self, indices: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def __getitem__(self, idx):
        n = len(self)
        if isinstance(idx, slice):
            return self._get(np.arange(*idx.indices(n)))
        arr = np.asarray(idx)
        if arr.ndim == 0:
            return self._get(np.array([int(arr)]))[0]
        if arr.dtype == bool:
            arr = np.nonzero(arr)[0]
        return self._get(arr.astype(np.intp))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def subset(self, indices) -> "LazyColumn":
        """A lazy row-subset view (``filter_rows``, ``take``, ``dropna``,
        ``head``): only the index mapping is kept."""
        return _SubsetLazyColumn(self, np.asarray(indices, dtype=np.intp))

    def validity_mask(self):
        """Cheap per-row validity (True = not null) without materializing
        values, or None when unknown (``null_mask`` then scans)."""
        return None

    def fingerprint(self) -> str | None:
        """Cheap content identity without materializing values (sha1 hex),
        or None when unknown. File-backed sources override it."""
        return None


class _SubsetLazyColumn(LazyColumn):
    def __init__(self, base: LazyColumn, indices: np.ndarray):
        self._base = base
        self._indices = indices

    def __len__(self) -> int:
        return len(self._indices)

    def _get(self, indices: np.ndarray) -> np.ndarray:
        return self._base._get(self._indices[indices])

    def validity_mask(self):
        base = self._base.validity_mask()
        return None if base is None else base[self._indices]

    def fingerprint(self):
        base = self._base.fingerprint()
        if base is None:
            return None
        import hashlib

        return hashlib.sha1(
            base.encode() + self._indices.tobytes()).hexdigest()


# copied from tpudl/frame/frame.py:_env_int
def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# copied from tpudl/frame/frame.py:_PipelineInfeed
class _PipelineInfeed:
    """K-deep bounded infeed fed by an N-worker prepare pool: up to
    ``depth`` batches are prepared in flight, by up to ``workers``
    threads, while the consumer dispatches. Futures are consumed in
    submission order, so output rows keep their order whichever worker
    finishes first; at most ``depth`` prepared batches exist at once, so
    host RAM stays O(depth · batch)."""

    def __init__(self, prepare: Callable, spans: Sequence[tuple[int, int]],
                 depth: int = 2, workers: int = 2, report=None):
        self._prepare = prepare
        self._spans = spans
        self._depth = max(1, int(depth))
        self._ex = ThreadPoolExecutor(
            max_workers=max(1, min(int(workers), self._depth)),
            thread_name_prefix="tpudl-infeed")
        self._futs: deque = deque()
        self._next = 0
        self._report = report
        while self._next < min(self._depth, len(spans)):
            self._submit()

    def _submit(self):
        # the submitter's attribution scope rides onto the worker: a
        # contextvar does not cross a thread pool on its own
        self._futs.append(self._ex.submit(
            _attr.carry(self._prepare), *self._spans[self._next]))
        self._next += 1

    def get(self):
        fut = self._futs.popleft()
        if self._report is not None:
            # ready batches when the consumer takes one: pinned at 0 means
            # the pool cannot keep up, at K-1 the card is the gate
            self._report.gauge("queue_depth",
                               int(fut.done())
                               + sum(f.done() for f in self._futs))
        t0 = time.perf_counter()
        try:
            out = fut.result()
        except BaseException:
            self.close()
            raise  # the worker's own exception, not a pool wrapper
        if self._report is not None:
            self._report.add("infeed_wait", time.perf_counter() - t0)
        if self._next < len(self._spans):
            self._submit()
        elif not self._futs:
            self._ex.shutdown(wait=False)
        return out

    def close(self):
        """Release the pool on every exit path: queued prepares are
        cancelled, and the workers exit once any prepare in flight
        returns."""
        for f in self._futs:
            f.cancel()
        self._futs.clear()
        self._ex.shutdown(wait=False, cancel_futures=True)


class _Dispatched:
    """One dispatched batch or fused group: the host copies of its
    outputs (for each output, its parts in row order: one part a mesh
    entry, or one), the events recorded after them (none on the CPU,
    where the copies are the outputs themselves), its pad rows, and the
    pinned inputs, kept alive until the events have passed."""

    __slots__ = ("host", "events", "n_pad", "keep", "pin")

    def __init__(self, host, events, n_pad, keep, pin=None):
        self.host = host
        self.events = events
        self.n_pad = n_pad
        self.keep = keep
        self.pin = pin  # a device-cache pin, released once the batch is done

    def wait(self):
        for event in self.events:
            event.synchronize()
        self.keep = None
        if self.pin is not None:
            self.pin.release()
            self.pin = None


def _start_host_copies(results, n_pad: int, keep, pin=None,
                       interleave: int = 1) -> _Dispatched:
    """Start the device→host copy of every output of one dispatch, at
    dispatch, into pinned host memory, and record an event after them on
    the device's current stream: batch N's copies then overlap the
    dispatch of N+1..N+D. ``results`` holds one ``(device, outputs)``
    pair a mesh entry (one without a mesh), each copied under its own
    card. CPU outputs need no copy. A fused mesh group
    (``interleave`` M > 1) holds M microbatches in each entry's outputs:
    the parts come back microbatch by microbatch, entry by entry, which
    is row order."""
    from tpudl_torch.mesh import on_device

    per_entry, events = [], []
    for dev, outs in results:
        host, on_card = [], False
        with on_device(dev):
            for r in outs:
                r = r.detach()
                if r.device.type == "cuda":
                    h = torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                    h.copy_(r, non_blocking=True)
                    r, on_card = h, True
                host.append(r)
            if on_card:
                event = torch.cuda.Event()
                event.record()
                events.append(event)
        per_entry.append(host)
    n_out = len(per_entry[0])
    if interleave == 1:
        host = [[h[j] for h in per_entry] for j in range(n_out)]
    else:
        host = []
        for j in range(n_out):
            rows = int(per_entry[0][j].shape[0]) // interleave
            host.append([h[j][m * rows:(m + 1) * rows]
                         for m in range(interleave) for h in per_entry])
    return _Dispatched(host, events, n_pad, keep, pin)


class _DispatchWindow:
    """D-deep in-flight dispatch window, redesigned for CUDA. tpudl
    dispatches on a thread pool because a dispatch over its tunnel
    blocks; a torch enqueue does not, and what blocks is reading the
    outputs. So every call of ``fn`` stays on the consumer thread, and
    the window holds up to ``depth`` dispatched batches whose outputs are
    not yet read, each with the event after its device→host copies
    (:func:`_start_host_copies`). :meth:`pop` waits on the oldest event;
    that wait is the ``dispatch_wait`` stage, the card time the window
    did not hide. ``dispatch_inflight`` is gauged at every submit and
    never exceeds ``depth``. Unlike tpudl's, the window does not run its
    first dispatch alone: a capture already runs on the consumer before
    its replay is enqueued."""

    def __init__(self, depth: int, report):
        self._depth = max(1, int(depth))
        self._q: deque = deque()
        self._report = report

    def __len__(self) -> int:
        return len(self._q)

    def full(self) -> bool:
        return len(self._q) >= self._depth

    def submit(self, entry: _Dispatched):
        self._q.append(entry)
        self._report.gauge("dispatch_inflight", len(self._q))

    def pop(self) -> _Dispatched:
        entry = self._q.popleft()
        with self._report.stage("dispatch_wait"):
            entry.wait()
        return entry

    def close(self):
        for entry in self._q:   # an unwind: release device-cache pins
            if entry.pin is not None:
                entry.pin.release()
        self._q.clear()


def _host_outputs(result) -> bool:
    """Whether ``fn`` answered with numpy arrays: a host function, which
    the executor keeps serial and unfused under a mesh, as tpudl keeps a
    function it cannot jit."""
    if not isinstance(result, (tuple, list)):
        result = (result,)
    return any(isinstance(r, np.ndarray) for r in result)


# one lock over the graphs cached on every fn: two threads never build one
# key's graph twice (captures take ``cuda_ops.capture_graph``'s lock)
_FUSED_LOCK = _tsan.named_lock("frame.fused_cache")
_FUSED_CACHE_SIZE = 8  # graphs kept per fn, least recently used out


def _fused_graph(fn: Callable, run_fn: Callable, group, codecs, n_out: int,
                 device, local: dict) -> _FusedGraph:
    """The graph of ``len(group)`` microbatches shaped like ``group[0]``,
    cached ON ``fn`` (``fn._tpudl_fused``, as tpudl caches its fused
    program), so that it lives exactly as long as ``fn``, and at most
    ``_FUSED_CACHE_SIZE`` of them. The key covers M, every column's codec
    (``codecs``: their keys, or None), every input's shape and dtype, the
    device and the TF32 flags at capture
    (cuDNN fixes its algorithms then). A ``fn`` that takes no attributes
    keeps its graphs in ``local``, for one run."""
    like = group[0][0]
    key = (len(group), codecs,
           tuple((tuple(t.shape), t.dtype) for t in like), str(device),
           torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    evicted = None
    with _FUSED_LOCK:
        cache = getattr(fn, "_tpudl_fused", None)
        if cache is None:
            try:
                cache = fn._tpudl_fused = {}
            except (AttributeError, TypeError):
                cache = local
        graph = cache.pop(key, None)
        if graph is None:
            graph = _FusedGraph(run_fn, len(group), like, n_out, device)
            if len(cache) >= _FUSED_CACHE_SIZE:
                evicted = cache.pop(next(iter(cache)))
        cache[key] = graph  # most recently used last
    if evicted is not None:
        evicted.release()
    return graph


def _stackable(group) -> bool:
    """Whether the microbatches of ``group`` share every input's shape
    and dtype (tpudl's ``np.stack`` succeeding)."""
    first = group[0][0]
    return all(len(g[0]) == len(first)
               and all(t.shape == f.shape and t.dtype == f.dtype
                       for t, f in zip(g[0], first)) for g in group[1:])


# copied from tpudl/frame/frame.py:mesh_fuse_ok
def mesh_fuse_ok(batch_size: int, mesh) -> bool:
    """Can a fused group run under ``mesh`` at this batch geometry? The
    one rule, shared by the executor's fuse gate and the stages' warm-up:
    the mesh fast path must be armed (``TPUDL_MESH_FAST_PATH`` not
    ``0``) and full batches must shard evenly over the data axis, since
    per-microbatch padding would leave pad rows interleaved in a fused
    group's outputs. ``mesh=None`` imposes no constraint."""
    if mesh is None:
        return True
    if os.environ.get("TPUDL_MESH_FAST_PATH", "1") == "0":
        return False
    from tpudl_torch import mesh as M

    return int(batch_size) % mesh.shape[M.DATA_AXIS] == 0


def _as_column(values) -> np.ndarray:
    if isinstance(values, LazyColumn):
        return values  # deferred source; materializes per access
    if isinstance(values, np.ndarray):
        return values
    values = list(values)
    if values and isinstance(values[0], (dict, bytes, str, type(None))):
        col = np.empty(len(values), dtype=object)
        col[:] = values
        return col
    try:
        return np.asarray(values)
    except ValueError:
        col = np.empty(len(values), dtype=object)
        col[:] = values
        return col


def _fire_in(stage: str, point: str, **ctx):
    """Fire ``point`` as part of the executor's ``stage``: an injected
    fault carries the stage's tag, as one raised inside it would."""
    try:
        return _faults.fire(point, **ctx)
    except BaseException as e:
        if getattr(e, "tpudl_stage", None) is None:
            try:
                e.tpudl_stage = stage
            # tpudl: ignore[swallowed-except] — an exception with
            # immutable attributes stays untagged; the raise below
            # carries it either way
            except Exception:
                pass
        raise


class Frame:
    """Ordered named columns of equal length (numpy arrays; strings and
    other Python objects live in object columns). ``num_partitions`` is
    Spark's partition hint: ``map_batches`` then defaults to batches of
    ``ceil(rows / num_partitions)`` rows."""

    def __init__(self, columns: Mapping[str, object],
                 num_partitions: int | None = None):
        self._cols: dict[str, np.ndarray] = {}
        n = None
        for name, values in columns.items():
            col = _as_column(values)
            if n is None:
                n = len(col)
            elif len(col) != n:
                raise ValueError(
                    f"column {name!r} has length {len(col)}, expected {n}")
            self._cols[str(name)] = col
        self._n = n or 0
        self.num_partitions = num_partitions

    @classmethod
    def from_files(cls, path, num_partitions: int | None = None,
                   host_sharded: bool = False) -> "Frame":
        """Columns (filePath, fileData) with fileData lazy: paths in RAM,
        reads deferred to the accessed batch
        (:func:`tpudl_torch.image.imageIO.filesToFrame`)."""
        from tpudl_torch.image.imageIO import filesToFrame

        return filesToFrame(path, numPartitions=num_partitions,
                            host_sharded=host_sharded, lazy=True)

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __repr__(self) -> str:
        cols = ", ".join(f"{k}:{v.dtype}" for k, v in self._cols.items())
        return f"Frame[{self._n} rows]({cols})"

    def select(self, *names: str) -> "Frame":
        missing = [n for n in names if n not in self._cols]
        if missing:
            raise KeyError(f"unknown columns {missing}; have {self.columns}")
        return Frame({n: self._cols[n] for n in names}, self.num_partitions)

    def with_column(self, name: str, values) -> "Frame":
        col = _as_column(values)
        if len(col) != self._n:
            raise ValueError(
                f"column length {len(col)} != frame length {self._n}")
        out = dict(self._cols)
        out[name] = col
        return Frame(out, self.num_partitions)

    def with_column_renamed(self, old: str, new: str) -> "Frame":
        if new != old and new in self._cols:
            raise ValueError(
                f"cannot rename {old!r} to existing column {new!r}")
        return Frame({new if k == old else k: v
                      for k, v in self._cols.items()}, self.num_partitions)

    def drop(self, *names: str) -> "Frame":
        return Frame({k: v for k, v in self._cols.items() if k not in names},
                     self.num_partitions)

    def filter_rows(self, mask) -> "Frame":
        mask = np.asarray(mask, dtype=bool)
        idx = np.nonzero(mask)[0]
        return Frame({k: (v.subset(idx) if isinstance(v, LazyColumn)
                          else v[mask])
                      for k, v in self._cols.items()}, self.num_partitions)

    def take(self, indices) -> "Frame":
        """Rows by integer index, in the given order (duplicates
        allowed)."""
        idx = np.asarray(indices, dtype=int)
        return Frame({k: (v.subset(idx) if isinstance(v, LazyColumn)
                          else v[idx])
                      for k, v in self._cols.items()}, self.num_partitions)

    def dropna(self, subset: Sequence[str] | None = None) -> "Frame":
        """Drop rows with None/NaN in ``subset`` (default: all columns); a
        lazy column stays a lazy subset view."""
        names = list(subset) if subset else self.columns
        mask = np.ones(self._n, dtype=bool)
        for n in names:
            mask &= ~null_mask(self._cols[n])
        return self.filter_rows(mask)

    def head(self, n: int = 5) -> "Frame":
        # np.arange(len)[:n] keeps Python's slice semantics (negative n
        # included) for lazy and eager columns alike
        return Frame({k: (v.subset(np.arange(len(v))[:n])
                          if isinstance(v, LazyColumn) else v[:n])
                      for k, v in self._cols.items()}, self.num_partitions)

    def limit(self, n: int) -> "Frame":
        return self.head(n)

    def to_dict(self) -> dict[str, np.ndarray]:
        return dict(self._cols)

    def fingerprint(self, cols: Sequence[str] | None = None) -> str:
        """Content identity of the named columns (sha1 hex), equal to
        tpudl's ``Frame.fingerprint`` on the same columns, so that one
        prepared-batch cache can serve both packages. Lazy columns answer
        through their cheap ``fingerprint`` (a file column: paths, sizes,
        mtimes — no reads); eager columns hash their bytes. A lazy column
        without a fingerprint raises."""
        import hashlib

        h = hashlib.sha1()
        for name in (list(cols) if cols is not None else self.columns):
            col = self._cols[name]
            h.update(f"col:{name}\n".encode())
            if isinstance(col, LazyColumn):
                fp = col.fingerprint()
                if fp is None:
                    raise ValueError(
                        f"lazy column {name!r} has no content "
                        "fingerprint; pass an explicit cache_key= to "
                        "map_batches/Dataset to enable caching")
                h.update(str(fp).encode())
            elif col.dtype == object:
                for v in col:
                    _hash_value(h, v)
            else:
                h.update(f"{col.dtype}{col.shape}".encode())
                h.update(np.ascontiguousarray(col).tobytes())
        return h.hexdigest()

    def rows(self) -> Iterator[dict]:
        for i in range(self._n):
            yield {k: v[i] for k, v in self._cols.items()}

    def collect(self) -> list[dict]:
        return list(self.rows())

    def iter_batches(self, batch_size: int) -> Iterator[tuple[int, int]]:
        for start in range(0, self._n, batch_size):
            yield start, min(start + batch_size, self._n)

    def map_batches(self, fn: Callable, input_cols: Sequence[str],
                    output_cols: Sequence[str], *,
                    batch_size: int | None = None,
                    pack: Callable | None = None,
                    check_finite: bool = False,
                    prefetch: bool | None = None,
                    prefetch_depth: int | None = None,
                    prepare_workers: int | None = None,
                    fuse_steps: int | None = None,
                    dispatch_depth: int | None = None,
                    donate: bool | None = None,
                    wire_codec=None, buckets=None, device="cuda",
                    mesh=None, cache_dir=None, cache_key=None,
                    device_cache=None, aot=None, supervise=None,
                    autotune=None) -> "Frame":
        """Run ``fn`` over the frame in batches on ``device`` and append
        its outputs as ``output_cols``.

        ``fn`` takes one tensor per input column, on ``device``, and
        returns one tensor or a tuple matching ``output_cols``; an output
        with more than one dimension becomes an object column of per-row
        arrays, as in tpudl. ``pack`` turns a column slice into a numpy
        batch (default: stack the rows); ``check_finite`` rejects a batch
        with a non-finite float. ``batch_size`` defaults to ``ceil(rows /
        num_partitions)`` when the frame has the hint, else 256.

        The data layer (:mod:`tpudl_torch.data`), as tpudl takes it in:

        - ``wire_codec`` (``TPUDL_WIRE_CODEC``): a
          :class:`~tpudl_torch.data.codec.WireCodec` or a name (``"u8"``,
          ``"bf16"``, ``"identity"``, ``"tokens"``, ``"auto"``), one codec
          a column (:class:`~tpudl_torch.data.codec.CodecPlan`): each
          packed batch is encoded on the host and restored on the device
          in front of ``fn``;
        - ``cache_dir`` (``TPUDL_DATA_CACHE_DIR``): prepared batches
          persist as checksummed shards under a key of the input's
          content (``cache_key`` replaces the frame's fingerprint), the
          pack's ``cache_token``, the batch size and the codec; a warm run
          reads them instead of packing (no reads, no decodes) and adopts
          the codecs they were encoded with;
        - ``device_cache`` (``TPUDL_DATA_DEVICE_CACHE=1``): prepared
          batches stay resident on the device under the budget
          (``TPUDL_DATA_HBM_BUDGET_MB``), and a later run over the same
          input ships nothing. Residency forces ``fuse_steps`` to 1.

        The executor's knobs, with tpudl's variables and defaults:

        - ``prefetch`` (default on; ``TPUDL_FRAME_PREFETCH=0`` switches
          the whole pipelined executor off: no prefetch, D=1, M=1, no
          buckets — the serial arm): prepare batches on a pool;
        - ``prefetch_depth`` K (``TPUDL_FRAME_PREFETCH_DEPTH``, 2; raised
          to D·M when left unset, so that the window stays fed):
          batches prepared ahead;
        - ``prepare_workers`` N (``TPUDL_FRAME_PREPARE_WORKERS``, 2): the
          pool's threads. A ``pack`` not marked ``thread_safe = True``
          runs on one worker unless N is given;
        - ``dispatch_depth`` D (``TPUDL_FRAME_DISPATCH_DEPTH``, 2): batches
          dispatched whose outputs are not yet read. D=1 waits for each
          batch's outputs before the next is dispatched;
        - ``fuse_steps`` M (``TPUDL_FRAME_FUSE_STEPS``, 1): on the card,
          M full batches run as one CUDA-graph replay (on the CPU, M
          calls and a concatenation). Only full batches whose inputs
          stack fuse; the ragged tail, a group whose shapes differ and a
          primary ``batch_size`` that ``buckets`` would pad take
          per-batch dispatch, as in tpudl;
        - ``donate`` (``TPUDL_FRAME_DONATE``, on): accepted and reported.
          In torch it means only that a fused replay reuses its graph's
          static input buffers, which it always does;
        - ``buckets`` (a ladder spec or :class:`~tpudl_torch.compile.
          BucketLadder`; default ``TPUDL_COMPILE_BUCKETS``, unset = off):
          a ragged batch pads up to its rung by repeating row 0, and the
          pad rows are stripped from the outputs;
        - ``aot`` (``TPUDL_COMPILE_AOT``, default off): dispatch through
          the program store. Run setup captures the manifest's entries of
          ``fn`` (this backend, this mesh's topology) before the first
          batch; at dispatch a hit copies the batch into its graph's
          static input, replays and clones the outputs, and a miss runs
          ``fn``, records the signature and captures. Under ``fuse_steps``
          the fused graph stays the program and the store records and
          counts it; under a mesh each card has its graph. The report
          counts ``aot_hits`` and ``aot_misses``.

        Each batch's outputs are copied to pinned host memory at dispatch
        and joined once at the end. Each run files a
        :class:`~tpudl_torch.obs.PipelineReport`
        (``tpudl_torch.obs.last_pipeline_report()``); a batch resident on
        the device adds nothing to its ``bytes_prepared`` or ``h2d``.

        ``supervise`` (``TPUDL_FRAME_DEGRADE``, default off) arms the fault
        supervisor (:mod:`tpudl_torch.frame.supervisor`): a classified
        fault re-runs the whole run down tpudl's ladder — a device OOM
        evicts the device cache's unpinned entries, a transient transfer
        fault retries under the shared IO policy, repeated stage faults
        halve ``dispatch_depth``, then drop ``fuse_steps`` to 1, then turn
        donation off, then fall back to the serial arm. Every rung runs
        the same kernels and returns the healthy run's bytes; the report
        carries ``degraded_to`` and ``recovered_batches``. Exhaustion
        (``TPUDL_FRAME_DEGRADE_MAX_RUNGS``) writes a flight dump and raises
        the typed error (``DeviceOOM``, ``TransferError``,
        ``RecompileStorm``, ``StageFault``) chained to the original.

        ``autotune`` (``TPUDL_FRAME_AUTOTUNE``, default on): any of
        ``fuse_steps``/``dispatch_depth``/``prefetch_depth`` left unset
        (no kwarg, no env setting) is seeded from the roofline advisor's
        recommendations over the previous run's report, when that report
        ran at the same ``batch_size`` and mesh shape
        (:func:`tpudl_torch.obs.roofline.autotune_seed`, which never
        probes the card from here); the seeded knobs land in the report's
        ``autotuned``. The serial kill switch and the conservative mesh
        arm never autotune."""
        from tpudl_torch.frame import supervisor as _sup

        kwargs = dict(
            batch_size=batch_size, pack=pack, check_finite=check_finite,
            prefetch=prefetch, prefetch_depth=prefetch_depth,
            prepare_workers=prepare_workers, fuse_steps=fuse_steps,
            dispatch_depth=dispatch_depth, donate=donate,
            wire_codec=wire_codec, buckets=buckets, device=device,
            mesh=mesh, cache_dir=cache_dir, cache_key=cache_key,
            device_cache=device_cache, aot=aot, autotune=autotune)
        if not _sup.enabled(supervise):
            # unarmed: one env read, straight into the executor
            return self._map_batches_impl(fn, input_cols, output_cols,
                                          **kwargs)
        sup = _sup.Supervisor()

        def attempt(overrides):
            kw = dict(kwargs)
            kw.update(overrides)  # rung knobs beat the caller's
            return self._map_batches_impl(fn, input_cols, output_cols,
                                          _supervisor=sup, **kw)

        return sup.supervise(attempt)

    def _map_batches_impl(self, fn: Callable, input_cols: Sequence[str],
                          output_cols: Sequence[str], *,
                          batch_size: int | None = None,
                          pack: Callable | None = None,
                          check_finite: bool = False,
                          prefetch: bool | None = None,
                          prefetch_depth: int | None = None,
                          prepare_workers: int | None = None,
                          fuse_steps: int | None = None,
                          dispatch_depth: int | None = None,
                          donate: bool | None = None,
                          wire_codec=None, buckets=None, device="cuda",
                          mesh=None, cache_dir=None, cache_key=None,
                          device_cache=None, aot=None, autotune=None,
                          _supervisor=None) -> "Frame":
        """One run of :meth:`map_batches` (a supervised one's attempt,
        with the ladder's overrides and its ``_supervisor``)."""
        from tpudl_torch.compile import buckets as _bk
        from tpudl_torch.obs import pipeline as _pipeline

        missing = [c for c in input_cols if c not in self._cols]
        if missing:
            raise KeyError(f"unknown columns {missing}; have {self.columns}")
        if batch_size is None:
            batch_size = (max(1, -(-self._n // int(self.num_partitions)))
                          if self.num_partitions else 256)
        batch_size = int(batch_size)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        mesh_devs = None
        if mesh is not None:
            from tpudl_torch import mesh as M

            if not mesh.local:
                raise ValueError(
                    "map_batches(mesh=) runs over a mesh of this process's "
                    "cards (tpudl_torch.mesh.build_mesh() or "
                    "build_mesh(devices=[...])); a process group's mesh "
                    "holds one card a process")
            mesh_devs = [resolve_device(d) for d in mesh.devices]
            dev = mesh_devs[0]
        else:
            dev = resolve_device(device)
        multiple = mesh.size if mesh is not None else 1
        # the conservative mesh arm: serial, blocking transfers, no
        # fusion and no residency (tpudl's pre-fast-path mesh executor)
        mesh_slow = (mesh is not None and os.environ.get(
            "TPUDL_MESH_FAST_PATH", "1") == "0")

        # -- knobs, resolved as tpudl resolves them (every torch fn is a
        # device fn) --------------------------------------------------------
        killed = os.environ.get("TPUDL_FRAME_PREFETCH", "1") == "0"
        prefetch = (True if prefetch is None else bool(prefetch)) \
            and not killed
        # -- autotune: seed unset executor knobs from the advisor's reading
        # of the PREVIOUS run's report (explicit kwargs and env settings
        # always win; the kill switches never autotune)
        autotune_on = (
            (bool(autotune) if autotune is not None
             else os.environ.get("TPUDL_FRAME_AUTOTUNE", "1") != "0")
            and not killed and not mesh_slow)
        seeds: dict = {}
        seeded: list[str] = []

        def _resolve(kwarg, env_name, seed_key, default):
            if kwarg is not None:
                return int(kwarg)
            if os.environ.get(env_name, "") != "":
                return _env_int(env_name, default)
            if seed_key in seeds:
                seeded.append(seed_key)
                return int(seeds[seed_key])
            return default

        if autotune_on and any(
                k is None and os.environ.get(e, "") == ""
                for k, e in ((fuse_steps, "TPUDL_FRAME_FUSE_STEPS"),
                             (dispatch_depth, "TPUDL_FRAME_DISPATCH_DEPTH"),
                             (prefetch_depth, "TPUDL_FRAME_PREFETCH_DEPTH"))):
            # read the previous run's report before this run files its
            # own; batch size and mesh shape are the workload guard (the
            # advisor's numbers are per-dispatch quantities at that
            # geometry and topology); never probe the wire from here
            from tpudl_torch.obs import pipeline as _pipeline
            from tpudl_torch.obs import roofline as _roofline

            seeds = _roofline.autotune_seed(
                _roofline.model_report(_pipeline.last_pipeline_report()),
                allow_probe=False,
                match={"batch_size": batch_size,
                       "mesh": (dict(mesh.shape) if mesh is not None
                                else None)})
        depth = _resolve(prefetch_depth, "TPUDL_FRAME_PREFETCH_DEPTH",
                         "prefetch_depth", 2)
        workers = (int(prepare_workers) if prepare_workers is not None
                   else _env_int("TPUDL_FRAME_PREPARE_WORKERS", 2))
        d_depth = 1 if killed or mesh_slow else max(1, _resolve(
            dispatch_depth, "TPUDL_FRAME_DISPATCH_DEPTH", "dispatch_depth",
            2))
        donate_flag = (bool(donate) if donate is not None
                       else os.environ.get("TPUDL_FRAME_DONATE", "1") != "0")
        donate_flag = donate_flag and not killed and not mesh_slow
        fuse = 1 if killed or mesh_slow else max(1, _resolve(
            fuse_steps, "TPUDL_FRAME_FUSE_STEPS", "fuse_steps", 1))
        if fuse > 1 and not mesh_fuse_ok(batch_size, mesh):
            # a full batch that pads to the data axis would interleave its
            # pad rows in a fused group's outputs
            fuse = 1
        if (prepare_workers is None
                and "TPUDL_FRAME_PREPARE_WORKERS" not in os.environ
                and pack is not None
                and not getattr(pack, "thread_safe", False)):
            # a user pack never promised thread safety: one worker unless
            # the caller opted in (first-party packs are marked)
            workers = 1
        ladder = None if killed else _bk.resolve_ladder(buckets)
        store = None
        if not killed:
            from tpudl_torch.compile import store as _aot_store

            if _aot_store.aot_enabled(aot):
                store = _aot_store.get_program_store()
                store.note_ladder(ladder)

        def rung(rows: int) -> int:
            """The dispatch rows of a batch of ``rows``: its bucket, then
            (under a mesh) the data axis's multiple, so a mesh batch never
            pads twice."""
            target = ladder.pick(rows) if ladder is not None else rows
            return -(-target // multiple) * multiple

        if ladder is not None and rung(batch_size) != batch_size \
                and fuse > 1:
            # every full batch would carry pad rows, and a fused group
            # would interleave them in its outputs
            fuse = 1
        if prefetch and prefetch_depth is None and \
                os.environ.get("TPUDL_FRAME_PREFETCH_DEPTH", "") == "":
            # a D-deep window of M-batch dispatches drains prepared
            # batches D·M at a time: the default infeed must be able to
            # feed it (tpudl raises K to D only; at M=1 the two agree)
            depth = max(depth, d_depth * fuse)

        report = _pipeline.PipelineReport()

        # -- tpudl_torch.data: wire codec, shard cache, device cache -------
        if wire_codec is None:
            wire_codec = os.environ.get("TPUDL_WIRE_CODEC") or None
        if cache_dir is None:
            cache_dir = os.environ.get("TPUDL_DATA_CACHE_DIR") or None
        dc_flag = (bool(device_cache) if device_cache is not None
                   else os.environ.get("TPUDL_DATA_DEVICE_CACHE", "0")
                   == "1")
        # the serial kill switch and the conservative mesh arm stay
        # residency-free (their A/B role is the uncached wire)
        dc_flag = dc_flag and not killed and not mesh_slow
        plan = cache = dcache = dkey = None
        if wire_codec is not None or cache_dir is not None or dc_flag:
            from tpudl_torch.data import codec as _codec

            if wire_codec is not None:
                plan = _codec.CodecPlan(wire_codec, len(input_cols),
                                        report=report)
            if cache_dir is not None or dc_flag:
                from tpudl_torch.data import shards as _shards

                material = cache_key
                if material is None:
                    try:
                        material = self.fingerprint(input_cols)
                    except ValueError:
                        # a lazy column with no content fingerprint: an
                        # explicit request keeps the pass-cache_key
                        # error; the process-wide variable only disarms
                        if cache_dir is not None or device_cache:
                            raise
                        dc_flag = False
            if cache_dir is not None or dc_flag:
                # the pack is part of the prepared bytes' identity; one
                # without a cache_token keys by repr (this object only)
                pack_token = ("default" if pack is None else
                              getattr(pack, "cache_token", None)
                              or repr(pack))
                key_str = _shards.cache_key(
                    material,
                    cols=",".join(input_cols),
                    batch=int(batch_size),
                    codec=_codec.spec_token(wire_codec),
                    pack=pack_token,
                    finite=bool(check_finite),
                    layout="map_batches_v1")
            if cache_dir is not None:
                cache = _shards.ShardCache(cache_dir, key_str)
                if plan is not None and cache.meta.get("codecs"):
                    # a warm replay restores with the codecs the shards
                    # were encoded with, not a fresh auto pick
                    plan.adopt(cache.meta["codecs"])
            if dc_flag:
                from tpudl_torch.data import device_cache as _dc

                # the same key material as the shard cache plus the
                # topology: an entry made for one mesh (or device) is a
                # miss on any other, never resharded in place
                dkey = _dc.run_key(key_str, mesh, device=dev)
                dcache = _dc.get_device_cache()
                # residency replaces fusion: a fused replay copies host
                # microbatches into its graph's static input
                fuse = 1

        report.config = {
            "executor": ("pipelined" if (prefetch or fuse > 1
                                         or d_depth > 1) else "serial"),
            "prefetch": bool(prefetch),
            "prefetch_depth": int(depth) if prefetch else 0,
            "prepare_workers": (max(1, min(workers, depth))
                                if prefetch else 0),
            "fuse_steps": fuse,
            "dispatch_depth": int(d_depth),
            "donate": bool(donate_flag),
            "autotune": bool(autotune_on),
            "autotuned": sorted(seeded),
            "batch_size": batch_size,
            "rows": self._n,
            # the topology (None without a mesh): the gauges of finish()
            # and the report's readers key on it
            "mesh": dict(mesh.shape) if mesh is not None else None,
            "wire_codec": (plan.names()[0] if plan is not None
                           else "off"),
            "batch_cache": bool(cache is not None),
            "device_cache": bool(dcache is not None),
            "buckets": ladder.spec if ladder is not None else "off",
            "aot": store is not None,
            "device": (",".join(map(str, mesh_devs)) if mesh is not None
                       else str(dev)),
        }
        if _supervisor is not None:
            # the ladder reads the resolved knobs to know what to halve,
            # and recovery stamps its outcome onto this report
            _supervisor.note_report(report)
        _pipeline.set_last_pipeline(report)
        pin_host = dev.type == "cuda"

        def pack_encode(start, stop):
            """Pack, check and encode one batch's columns (host numpy)."""
            packed = []
            for ci, c in enumerate(input_cols):
                sl = self._cols[c][start:stop]
                arr = pack(sl) if pack is not None else _default_pack(sl)
                if check_finite and np.issubdtype(arr.dtype, np.floating):
                    bad = ~np.isfinite(arr).reshape(arr.shape[0], -1).all(1)
                    if bad.any():
                        rows = (np.nonzero(bad)[0][:8] + start).tolist()
                        raise ValueError(
                            f"non-finite values in column {c!r}, "
                            f"rows {rows} (batch {start}:{stop})")
                if plan is not None:
                    arr = plan.encode(ci, arr)
                packed.append(arr)
            return packed

        def pad(packed):
            """Pad one host batch up to its bucket and, under a mesh, to a
            multiple of the data axis: ``(arrays, n_pad)``. Pad rows
            repeat row 0 and are stripped from the outputs."""
            if not packed:
                return packed, 0
            rows_b = int(packed[0].shape[0])
            n_pad = 0
            if ladder is not None:
                target = rung(rows_b)
                if target > rows_b:
                    n_pad = target - rows_b
                    report.count("bucket_pad_rows", n_pad)
                    _bk.count_pad_rows(n_pad)
                    packed = [_bk.pad_to(a, target) for a in packed]
            if mesh is not None:
                # every column slices the same rows: one pad count serves
                padded = [M.pad_batch(a, multiple) for a in packed]
                mesh_pad = padded[0][1]
                packed = [a for a, _ in padded]
                if mesh_pad:
                    report.count("pad_rows", mesh_pad)
                report.gauge("mesh_pad_rows", mesh_pad)
                n_pad += mesh_pad
            return packed, n_pad

        def prepare(start, stop):
            """Bring one batch through the data layer's lookup chain
            (:func:`tpudl_torch.data.dataset.fetch_batch`) and pin its
            host tensors: on a prepare-pool thread when prefetching.
            Returns ``(tensors, n_pad, pin)``; ``pin`` marks a batch that
            is resident on the device (under a mesh, one ``Sharded`` a
            column), held until its dispatch is done."""
            from tpudl_torch.data.codec import host_tensor
            from tpudl_torch.data.dataset import fetch_batch

            with report.stage("prepare"):
                bidx = start // batch_size
                _faults.fire("frame.prepare", index=bidx)
                # rows entering the pipeline, charged in the submitting
                # run's scope (carried onto this pool thread)
                _attr.charge("rows_in", stop - start)
                arrays, n_pad, pin = fetch_batch(
                    bidx, lambda: pack_encode(start, stop),
                    plan=plan, shard_cache=cache, device_cache=dcache,
                    run=dkey, device=dev, mesh=mesh,
                    pad=pad if (ladder is not None or mesh is not None)
                    else None,
                    report=report)
                # the black box's descriptor: shapes, dtypes and a
                # fingerprint, never the data
                _flight.record_batch("prepare", bidx, arrays,
                                     rows=stop - start,
                                     hbm_hit=pin is not None,
                                     run=report.run_id)
                if pin is not None:
                    pins.add(pin)
                    return arrays, n_pad, pin
                return ([host_tensor(a, pin=pin_host) for a in arrays],
                        n_pad, None)

        # device-cache pins outstanding (hits and fresh entries awaiting
        # their dispatch): each is released when its batch is done, and
        # the sweep at the end releases any an unwind stranded
        pins: set = set()

        n_out = len(output_cols)
        run_fn = fn if plan is None else None

        def _run_fn():
            """``fn`` with the codec prologues in front; bound at the
            first dispatch, after at least one batch resolved the plan
            ('auto' picks from it)."""
            nonlocal run_fn
            if run_fn is None:
                run_fn = plan.wrap(fn)
            return run_fn

        acc: list[list] = [[] for _ in output_cols]  # host copies, joined at end
        segs: list[tuple[int, int]] = []  # (padded rows, n_pad) per dispatch
        graphs: dict = {}  # a fn that takes no attributes keeps them here
        host_fn = False   # set by the first mesh dispatch (a numpy fn)
        # a stage's per-device function is a torch function; any other
        # function's first mesh dispatch tells
        probe_first = mesh is not None and not isinstance(fn, M.PerDevice)

        def handle(entry: _Dispatched):
            """Keep one finished dispatch's host copies for the join."""
            done_rows = sum(int(h.shape[0]) if h.ndim else 1
                            for h in entry.host[0])
            report.progress(max(0, done_rows - entry.n_pad))
            _attr.charge("rows_out", max(0, done_rows - entry.n_pad))
            for i, parts in enumerate(entry.host):
                acc[i].extend(parts)
            segs.append((done_rows, entry.n_pad))

        def call(args):
            """``fn`` on one batch (or one mesh entry's shard), through the
            program store when it is armed."""
            nonlocal host_fn
            if store is not None:
                raw = store.call(_run_fn(), args, owner=fn, mesh=mesh,
                                 bucketed=ladder is not None and mesh is None,
                                 report=report)
            else:
                raw = _run_fn()(*args)
            if mesh is not None and _host_outputs(raw):
                host_fn = True
            return _as_outputs(raw, n_out)

        def run_batch(tensors, n_pad, pin):
            if mesh is None:
                if pin is None:
                    with report.stage("h2d"):
                        _faults.fire("frame.h2d", index=consumed - 1)
                        args = [t.to(dev, non_blocking=True)
                                for t in tensors]
                else:   # resident on the device: nothing to copy
                    args = tensors
                t0 = time.perf_counter()
                with report.stage("dispatch"):
                    result = [(dev, call(args))]
                return result, n_pad, tensors, t0, pin, 1
            if pin is None:
                with report.stage("h2d"):
                    _faults.fire("frame.h2d", index=consumed - 1)
                    shards = M.transfer_batch(tensors, mesh,
                                              block=mesh_slow)
            else:   # resident as per-card shards: nothing to copy
                shards = [[col[i] for col in tensors]
                          for i in range(multiple)]
            t0 = time.perf_counter()
            result = []
            with report.stage("dispatch"):
                for card, args in zip(mesh_devs, shards):
                    with M.on_device(card):
                        result.append((card, call(args)))
            return result, n_pad, (tensors, shards), t0, pin, 1

        def run_fused(group):
            from tpudl_torch.mesh import on_device

            codecs = None if plan is None else tuple(map(tuple, plan.keys()))
            if mesh is None:
                entries = [(dev, group)]
            else:
                # each card fuses its shards of the group's microbatches
                cut = [M.shard_rows(g[0], multiple) for g in group]
                entries = [(card, [(c[i],) for c in cut])
                           for i, card in enumerate(mesh_devs)]
            t0 = time.perf_counter()
            result = []
            for card, card_group in entries:
                with on_device(card):
                    if store is not None:
                        # the fused graph stays the program; the store
                        # keys, records and counts it
                        prog = store.fused(_run_fn(), fn, card_group, n_out,
                                           card, mesh=mesh, report=report)
                        with (report.stage("dispatch")
                              if card.type != "cuda"
                              else contextlib.nullcontext()):
                            out = prog.run(card_group, report)
                    elif card.type != "cuda":
                        with report.stage("dispatch"):
                            out = _fused_plain(_run_fn(), card_group, n_out)
                    else:
                        out = _fused_graph(
                            fn, _run_fn(), card_group, codecs, n_out, card,
                            graphs).run(card_group, report)
                result.append((card, out))
            keep = [g[0] for g in group]
            return result, 0, keep, t0, None, len(group)

        if store is not None and (plan is None or plan.resolved()):
            # a fresh process captures what the manifest holds for this
            # fn before its first batch, so that the first dispatch hits
            store.ensure_restored(_run_fn(), True, owner=fn,
                                  devices=mesh_devs or [dev], mesh=mesh)

        first_dispatch = True

        def dispatch(run, *args):
            """Issue one dispatch on the consumer thread, after the window
            has room; with D=1 wait for its outputs at once. Under a mesh
            the first dispatch of a function that is not a stage's
            (:class:`~tpudl_torch.mesh.PerDevice`) runs alone, and a host
            function (numpy outputs) turns the window and fusion off for
            the rest of the run, as tpudl keeps such a function serial."""
            nonlocal first_dispatch, window, fuse
            if window is not None:
                while window.full():
                    handle(window.pop())
            # tpudl's index: the batches consumed so far, this dispatch's
            # included
            _fire_in("dispatch", "frame.dispatch", index=consumed)
            result, n_pad, keep, t0, pin, interleave = run(*args)
            # the host seconds this scope spent issuing the dispatch
            _attr.charge("dispatch_s", time.perf_counter() - t0)
            pins.discard(pin)   # the entry releases it from here on
            entry = _start_host_copies(result, n_pad, keep, pin, interleave)
            if first_dispatch:
                first_dispatch = False
                report.count("first_dispatch_s", time.perf_counter() - t0)
                if host_fn:
                    fuse = 1
                    report.config.update(fuse_steps=1, dispatch_depth=1,
                                         donate=False)
                    if window is not None:
                        while len(window):
                            handle(window.pop())
                        window = None
            if window is None:
                with report.stage("d2h"):
                    _faults.fire("frame.d2h")
                    # tpudl: ignore[hot-sync] — this wait IS the d2h
                    # stage of a window of depth 1: the copy was started
                    # at dispatch, and the batch's rows are read next
                    entry.wait()
                handle(entry)
            else:
                window.submit(entry)

        spans = list(self.iter_batches(batch_size))
        # only the leading run of full-size batches can fuse
        n_full = sum(1 for s, e in spans if e - s == batch_size)
        # one watchdog heartbeat for the whole run, beaten at every stage
        # entry (PipelineReport.stage): a freeze inside prepare, h2d,
        # dispatch or d2h surfaces as a stall naming that stage.
        # Registered before the infeed, so the pool's first batches are
        # watched; it leaves the scan list on every exit path below.
        hb_run = _watchdog.heartbeat("frame.map_batches", run=report.run_id,
                                     rows=self._n)
        report.heartbeat = hb_run
        infeed = (_PipelineInfeed(prepare, spans, depth, workers, report)
                  if prefetch else None)
        window = (_DispatchWindow(d_depth, report) if d_depth > 1
                  else None)
        consumed = 0

        def next_prepared():
            nonlocal consumed
            out = infeed.get() if infeed else prepare(*spans[consumed])
            consumed += 1
            return out

        t_wall = time.perf_counter()
        try:
            while consumed < len(spans):
                # under a mesh the first dispatch of a function not known
                # to run on the device runs alone: it tells a host
                # function, which must not fuse, from a torch one
                if (fuse > 1 and consumed + fuse <= n_full
                        and not (probe_first and first_dispatch)):
                    group = [next_prepared() for _ in range(fuse)]
                    if not _stackable(group):
                        # shapes drifted between microbatches (a ragged
                        # pack): dispatch this group per batch
                        for prepared in group:
                            dispatch(run_batch, *prepared)
                        continue
                    report.count("fused_dispatches")
                    dispatch(run_fused, group)
                else:
                    dispatch(run_batch, *next_prepared())
            while window is not None and len(window):
                handle(window.pop())
        finally:
            if window is not None:
                window.close()
            if infeed is not None:
                infeed.close()
            if cache is not None:
                cache.flush()  # persist throttled manifest entries
            for p in list(pins):
                p.release()
            hb_run.__exit__(None, None, None)
            report.heartbeat = None
        outputs: list[list[np.ndarray]] = [[] for _ in output_cols]
        with report.stage("d2h"):
            _faults.fire("frame.d2h")
            _fetch_accumulated(acc, segs, outputs)
        report.finish(time.perf_counter() - t_wall)
        out = self
        for name, chunks in zip(output_cols, outputs):
            col = np.concatenate(chunks, axis=0) if chunks else np.empty((0,))
            if col.ndim > 1:
                obj = np.empty(len(col), dtype=object)
                obj[:] = list(col)
                col = obj
            out = out.with_column(name, col)
        return out


def _fetch_accumulated(acc, segs, outputs):
    """Join the held host copies per output, stripping each dispatch's
    pad rows. tpudl forks here: its "acc" keeps outputs on the device and
    fetches them once, and its "window" fetches each batch as it leaves,
    to bound device memory. The port copies every output to pinned host
    memory at dispatch (:func:`_start_host_copies`), so device memory is
    bounded by the window either way, and one outfeed serves."""
    for i, chunks in enumerate(acc):
        if not chunks:
            continue
        parts = [h.numpy() for h in chunks]
        host = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        if any(n_pad for _, n_pad in segs):
            out, pos = [], 0
            for padded_len, n_pad in segs:
                out.append(host[pos: pos + padded_len - n_pad])
                pos += padded_len
            outputs[i].extend(out)
        else:
            outputs[i].append(host)



# copied from tpudl/frame/frame.py:null_mask
def null_mask(col) -> np.ndarray:
    """Per-row null flags: object ``None`` and float ``NaN`` are null. A
    LazyColumn answers through its ``validity_mask`` when it has one (no
    decode); otherwise it is scanned in chunks of 256 rows."""
    if isinstance(col, LazyColumn):
        valid = col.validity_mask()
        if valid is not None:
            return ~np.asarray(valid, dtype=bool)
        flags = np.empty(len(col), dtype=bool)
        for start in range(0, len(col), 256):
            stop = min(start + 256, len(col))
            flags[start:stop] = [v is None for v in col[start:stop]]
        return flags
    if col.dtype == object:
        return np.array([v is None for v in col], dtype=bool)
    if np.issubdtype(col.dtype, np.floating):
        return np.isnan(col)
    return np.zeros(len(col), dtype=bool)


# copied from tpudl/frame/frame.py:_hash_value
def _hash_value(h, v) -> None:
    """One object-column row into a running hash: image structs, bytes,
    ndarrays, None, and the repr of anything else."""
    if v is None:
        h.update(b"\x00none")
    elif isinstance(v, bytes):
        h.update(b"\x00b")
        h.update(v)
    elif isinstance(v, dict):
        for k in sorted(v):
            h.update(f"\x00k{k}=".encode())
            _hash_value(h, v[k])
    elif isinstance(v, np.ndarray):
        h.update(f"\x00a{v.dtype}{v.shape}".encode())
        h.update(np.ascontiguousarray(v).tobytes())
    else:
        h.update(f"\x00r{v!r}".encode())


def _default_pack(sl: np.ndarray) -> np.ndarray:
    if sl.dtype == object:
        return np.stack([np.asarray(v) for v in sl])
    return np.asarray(sl)


# copied from tpudl/frame/frame.py:concat
def concat(frames: Sequence[Frame]) -> Frame:
    """Rows of ``frames`` in order (same column set); a lazy column
    materializes here."""
    if not frames:
        raise ValueError("concat of zero frames")
    names = frames[0].columns
    for i, f in enumerate(frames[1:], start=1):
        if set(f.columns) != set(names):
            raise ValueError(
                f"concat schema mismatch: frame 0 has {names}, "
                f"frame {i} has {f.columns}")
    out = {}
    for n in names:
        cols = [f[n] for f in frames]
        if any(c.dtype == object for c in cols):
            merged = np.empty(sum(len(c) for c in cols), dtype=object)
            i = 0
            for c in cols:
                merged[i: i + len(c)] = (c[:] if isinstance(c, LazyColumn)
                                         else c)
                i += len(c)
            out[n] = merged
        else:
            out[n] = np.concatenate(cols, axis=0)
    return Frame(out, frames[0].num_partitions)
