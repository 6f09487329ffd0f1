"""Frame: ordered named columns of equal length, and its batch executor.

Port of ``tpudl/frame/frame.py`` (``Frame`` container with
``filter_rows``/``dropna``/``head``, ``LazyColumn`` with its subset view,
``null_mask``, and ``map_batches``). A :class:`LazyColumn` (such as
``readImages``'s image column) materializes only the rows a batch asks
for, so host RAM stays O(batch). The executor here is SERIAL: for each
batch, pack on the host → wire-codec encode → pinned-memory host→device
copy → codec prologue → ``fn`` → device→host copy → rows. Rows come back
in the same order and count as tpudl's. The prefetch pool, dispatch window, fused
dispatch, mesh sharding, batch buckets and the shard/device caches are
later ROADMAP items (Queue 1, "Executor").
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence

import numpy as np
import torch

from tpudl_torch.device import resolve_device

__all__ = ["Frame", "LazyColumn", "null_mask"]


# copied from tpudl/frame/frame.py:LazyColumn (without the cache
# fingerprint, which belongs to the data layer: ROADMAP Queue 1, 'Data
# layer')
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
        """A lazy row-subset view (``filter_rows``, ``dropna``, ``head``):
        only the index mapping is kept."""
        return _SubsetLazyColumn(self, np.asarray(indices, dtype=np.intp))

    def validity_mask(self):
        """Cheap per-row validity (True = not null) without materializing
        values, or None when unknown (``null_mask`` then scans)."""
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


def _default_pack(sl: np.ndarray) -> np.ndarray:
    if sl.dtype == object:
        return np.stack([np.asarray(v) for v in sl])
    return np.asarray(sl)


class Frame:
    """Ordered named columns of equal length (numpy arrays; strings and
    other Python objects live in object columns)."""

    def __init__(self, columns: Mapping[str, object]):
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
        return Frame({n: self._cols[n] for n in names})

    def with_column(self, name: str, values) -> "Frame":
        col = _as_column(values)
        if len(col) != self._n:
            raise ValueError(
                f"column length {len(col)} != frame length {self._n}")
        out = dict(self._cols)
        out[name] = col
        return Frame(out)

    def drop(self, *names: str) -> "Frame":
        return Frame({k: v for k, v in self._cols.items() if k not in names})

    def filter_rows(self, mask) -> "Frame":
        mask = np.asarray(mask, dtype=bool)
        idx = np.nonzero(mask)[0]
        return Frame({k: (v.subset(idx) if isinstance(v, LazyColumn)
                          else v[mask])
                      for k, v in self._cols.items()})

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
                      for k, v in self._cols.items()})

    def map_batches(self, fn: Callable, input_cols: Sequence[str],
                    output_cols: Sequence[str], *, batch_size: int = 256,
                    pack: Callable | None = None, wire_codec=None,
                    device="cuda") -> "Frame":
        """Run ``fn`` over the frame in batches of ``batch_size`` rows on
        ``device`` and append its outputs as ``output_cols``.

        ``fn`` takes one tensor per input column and returns one tensor or
        a tuple matching ``output_cols``. ``pack`` turns a column slice
        into a numpy batch (default: stack the rows). ``wire_codec`` (a
        :class:`~tpudl_torch.data.codec.WireCodec`) encodes each packed
        batch on the host, and its ``prologue`` restores it on the device
        before ``fn``. An output with more than one dimension becomes an
        object column of per-row arrays, as in tpudl."""
        missing = [c for c in input_cols if c not in self._cols]
        if missing:
            raise KeyError(f"unknown columns {missing}; have {self.columns}")
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        dev = resolve_device(device)
        outputs: list[list[np.ndarray]] = [[] for _ in output_cols]
        for start in range(0, self._n, int(batch_size)):
            stop = min(start + int(batch_size), self._n)
            args = []
            for c in input_cols:
                sl = self._cols[c][start:stop]
                arr = pack(sl) if pack is not None else _default_pack(sl)
                if wire_codec is not None:
                    arr = wire_codec.encode(arr)
                t = torch.from_numpy(np.ascontiguousarray(arr))
                if dev.type == "cuda":
                    t = t.pin_memory().to(dev, non_blocking=True)
                if wire_codec is not None:
                    t = wire_codec.prologue(t)
                args.append(t)
            result = fn(*args)
            if not isinstance(result, (tuple, list)):
                result = (result,)
            if len(result) != len(output_cols):
                raise ValueError(f"fn returned {len(result)} outputs for "
                                 f"output_cols {list(output_cols)}")
            for i, r in enumerate(result):
                outputs[i].append(r.detach().cpu().numpy())
        out = self
        for name, chunks in zip(output_cols, outputs):
            col = np.concatenate(chunks, axis=0) if chunks else np.empty((0,))
            if col.ndim > 1:
                obj = np.empty(len(col), dtype=object)
                obj[:] = list(col)
                col = obj
            out = out.with_column(name, col)
        return out
