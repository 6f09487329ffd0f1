"""Frame: ordered named columns of equal length, and its batch executor.

Port of ``tpudl/frame/frame.py`` (``Frame`` container and
``map_batches``). The executor here is SERIAL: for each batch, pack on the
host → wire-codec encode → pinned-memory host→device copy → codec
prologue → ``fn`` → device→host copy → rows. Rows come back in the same
order and count as tpudl's. The prefetch pool, dispatch window, fused
dispatch, mesh sharding, batch buckets and the shard/device caches are
later ROADMAP items (Queue 1, "Executor").
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence

import numpy as np
import torch

from tpudl_torch.device import resolve_device

__all__ = ["Frame"]


def _as_column(values) -> np.ndarray:
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
