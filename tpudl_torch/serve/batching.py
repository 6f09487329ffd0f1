"""Rung-bucketed dynamic batching for ragged serve payloads.

Port of ``tpudl/serve/batching.py``: the featurize/UDF/embed half of the
serve plane (the LM half is :mod:`tpudl_torch.serve.slots`). In-flight
requests carry ragged row counts; :class:`RungBatcher` concatenates them,
pads the row count up to a bucket-ladder rung (``pad_to``: row 0
repeated, and the pad rows are stripped before results fan back out) and
dispatches ONE ``fn`` call, so a handful of rungs serves every mix.

``serve.batches`` counts dispatches; ``serve.batch_occupancy`` gauges
real rows over rung rows; padding lands on the shared
``compile.bucket_pad_rows`` counter. As tpudl routes a jittable ``fn``
through its program store when that is armed, the port routes a ``fn``
that declares its ``device``: with ``TPUDL_COMPILE_AOT`` set, the padded
batch goes onto that device as a tensor and dispatches through
:class:`~tpudl_torch.compile.ProgramStore` (one CUDA graph a rung on the
card). Otherwise ``fn`` is called directly on the host batch.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudl_torch.compile.buckets import count_pad_rows, pad_to, \
    resolve_ladder
from tpudl_torch.compile.store import aot_enabled, get_program_store
from tpudl_torch.device import resolve_device
from tpudl_torch.obs import metrics as _metrics

__all__ = ["RungBatcher"]


def _host(out) -> np.ndarray:
    """``fn``'s answer as a host array (a tensor on the card is copied)."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class RungBatcher:
    """Pack ragged per-request payloads onto bucket rungs and dispatch
    one ``fn`` call per batch.

    ``fn`` maps a host batch ``[N, ...]`` to ``[N, ...]`` (numpy or a
    tensor on any device; the leading dim is preserved — the
    UDF/featurize/embed contract). ``buckets`` resolves through
    :func:`tpudl_torch.compile.buckets.resolve_ladder` (``True``, the
    default, is the pow2ish ladder; ``None``/``False`` dispatch the exact
    row count). ``device`` (default None) is where ``fn`` computes: given,
    and with the program store armed, ``fn`` receives the padded batch as
    a tensor there, through the store; it must then take a tensor as well
    as a host array."""

    def __init__(self, fn, *, buckets=True, device=None):
        self._fn = fn
        self._ladder = resolve_ladder(buckets)
        self._device = device

    def rung_for(self, n: int) -> int:
        return self._ladder.pick(int(n)) if self._ladder else int(n)

    def run(self, payloads) -> list:
        """Dispatch one padded batch for ``payloads`` (a list of
        ``[rows_i, ...]`` arrays, ragged in ``rows_i``) and split the
        result back per request, pad rows stripped."""
        payloads = [_host(p) for p in payloads]
        if not payloads:
            return []
        sizes = [int(p.shape[0]) for p in payloads]
        batch = (np.concatenate(payloads, axis=0) if len(payloads) > 1
                 else payloads[0])
        n = int(batch.shape[0])
        rung = self.rung_for(n)
        padded = pad_to(batch, rung)
        count_pad_rows(rung - n)
        if self._device is not None and aot_enabled():
            x = torch.from_numpy(np.ascontiguousarray(padded)).to(
                resolve_device(self._device))
            out = _host(get_program_store().call(self._fn, (x,)))[:n]
        else:
            out = _host(self._fn(padded))[:n]
        _metrics.counter("serve.batches").inc()
        _metrics.gauge("serve.batch_occupancy").set(n / max(rung, 1))
        cuts = np.cumsum(sizes)[:-1]
        return [np.asarray(a) for a in np.split(out, cuts)] \
            if len(sizes) > 1 else [out]
