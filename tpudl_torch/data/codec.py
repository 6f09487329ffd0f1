"""Wire codecs: shrink the host→device representation of prepared batches.

Port of ``tpudl/data/codec.py``. A :class:`WireCodec` is the two-sided
contract that makes shipping fewer bytes safe:

- ``encode(arr)`` runs on the host, in the executor's prepare stage, and
  returns the smaller wire representation (uint8 pixels, bfloat16 bits,
  ...);
- ``prologue(x)`` restores it on the batch's device as torch ops in front
  of the user's function (tpudl fuses the same restore into its jitted
  program; here it runs as separate kernels, and inside a fused CUDA
  graph as captured ones).

Codecs are bit-controlled: ``u8`` restores as ``f32(u8) * scale`` (then
``+ offset`` when set), each a separate IEEE f32 operation on either side
of the wire, so the restored pixels equal the float32 path's, and
``decode_array`` (numpy) equals ``prologue`` (torch) bit for bit with a
nonzero offset too: torch runs the multiply and the add as two kernels,
so no FMA forms. ``bf16`` is lossy by declaration (relative error ≤ 2⁻⁸
an element). The port keeps bfloat16 on the host without ``ml_dtypes``:
:class:`BF16Codec` rounds float32 to nearest-even on the bits and ships
them as a numpy ``V2`` array (the dtype an ``.npy`` of ``ml_dtypes``'
bfloat16 reads back as); :func:`host_tensor` turns one into a
``torch.bfloat16`` tensor.

Selection: a :class:`WireCodec`, a name (``"u8"``, ``"bf16"``,
``"identity"``, ``"tokens"``), or ``"auto"`` — picked per column from the
first packed batch's dtype, never its values: uint8 → ``u8``; float32 →
``bf16`` on a wire measured slower than ``TPUDL_DATA_BF16_WIRE_MBPS``
(:func:`probe_wire_mbps` times the executor's own pinned host→card copy),
identity otherwise or when no card is there to measure.
``TPUDL_WIRE_CODEC`` is the default ``Frame.map_batches`` falls back to.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tpudl_torch.obs import attribution as _attr
from tpudl_torch.obs import metrics as _m
from tpudl_torch.testing import tsan as _tsan

__all__ = [
    "CodecError",
    "WireCodec",
    "IdentityCodec",
    "U8Codec",
    "BF16Codec",
    "BF16_BITS",
    "host_tensor",
    "resolve_codec",
    "codec_from_key",
    "spec_token",
    "probe_wire_mbps",
    "CodecPlan",
]

# the host form of a bfloat16 array: two opaque bytes an element, as
# numpy reads an .npy of ml_dtypes' bfloat16 back
BF16_BITS = np.dtype("V2")


class CodecError(ValueError):
    """A codec cannot represent this batch losslessly (caller falls back
    or surfaces the misconfiguration — never silent value drift)."""


class WireCodec:
    """One host→device wire representation. Subclasses implement
    ``encode`` (host, numpy → numpy), ``decode_array`` (its host inverse,
    the same op sequence as the prologue), ``prologue`` (device, torch
    tensor → the tensor the model consumes) and ``key`` (a
    JSON-serialisable identity tuple — shard manifests persist it so a
    warm replay rebuilds the exact prologue)."""

    name = "abstract"

    def encode(self, arr: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def decode_array(self, arr: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def prologue(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def key(self) -> tuple:
        return (self.name,)

    def dense_nbytes(self, encoded: np.ndarray) -> int:
        """Bytes of the float32 tensor ``prologue`` reconstitutes — the
        counterfactual the wire would carry without this codec (the
        ``data.wire.bytes_dense`` counter's contribution)."""
        return int(encoded.size) * 4

    def __repr__(self):
        return f"{type(self).__name__}({self.key()!r})"


class IdentityCodec(WireCodec):
    """Ship the packed batch as it is."""

    name = "identity"

    def encode(self, arr: np.ndarray) -> np.ndarray:
        return np.asarray(arr)

    def decode_array(self, arr: np.ndarray) -> np.ndarray:
        return np.asarray(arr)

    def prologue(self, x):
        return x

    def dense_nbytes(self, encoded: np.ndarray) -> int:
        return int(encoded.nbytes)  # no shrink claimed


class U8Codec(WireCodec):
    """uint8 pixels + (scale, offset) — 4× fewer wire bytes than float32,
    restored on the device as ``f32(u8) * scale + offset``.

    ``encode`` of a float32 batch inverts the loader's normalize and
    checks losslessness by re-applying the restore on the host and
    comparing bitwise; a mismatch raises :class:`CodecError` rather than
    shipping drifted values. uint8 batches pass straight through."""

    name = "u8"

    def __init__(self, scale: float = 1.0, offset: float = 0.0):
        # pinned to f32 so host verify and device prologue use the SAME
        # constant (a float64 scale would round differently on device)
        self.scale = float(np.float32(scale))
        self.offset = float(np.float32(offset))
        if self.scale == 0.0:
            raise CodecError("u8 codec scale must be nonzero")

    def key(self) -> tuple:
        return (self.name, self.scale, self.offset)

    def _restore_np(self, q8: np.ndarray) -> np.ndarray:
        # mirror prologue op-for-op (skip no-op affine terms so the
        # exactness claim covers the same instruction sequence)
        y = q8.astype(np.float32)
        if self.scale != 1.0:
            y = y * np.float32(self.scale)
        if self.offset != 0.0:
            y = y + np.float32(self.offset)
        return y

    def encode(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        if arr.dtype == np.uint8:
            return arr
        if arr.dtype != np.float32:
            raise CodecError(
                f"u8 codec encodes uint8/float32 batches, got {arr.dtype}")
        q = np.rint((arr.astype(np.float64) - self.offset) / self.scale)
        if q.size and (q.min() < 0 or q.max() > 255):
            raise CodecError(
                f"u8 codec: values outside u8×{self.scale}+{self.offset} "
                f"range (min {q.min()}, max {q.max()})")
        q8 = q.astype(np.uint8)
        if not np.array_equal(self._restore_np(q8), arr):
            raise CodecError(
                "u8 codec cannot losslessly encode this batch (values are "
                f"not exactly uint8 × {self.scale} + {self.offset}); use "
                "'bf16' or 'identity', or fix the loader to emit raw uint8 "
                "(imageIO.createNativeImageLoader(output_dtype='uint8'))")
        return q8

    def decode_array(self, arr: np.ndarray) -> np.ndarray:
        return self._restore_np(np.asarray(arr))

    def prologue(self, x: torch.Tensor) -> torch.Tensor:
        # two separate kernels: the multiply rounds before the add, as
        # _restore_np's numpy operations do
        y = x.to(torch.float32)
        if self.scale != 1.0:
            y = y * self.scale
        if self.offset != 0.0:
            y = y + self.offset
        return y

    # copied from tpudl/data/codec.py:U8Codec.infer
    @classmethod
    def infer(cls, arr: np.ndarray) -> "U8Codec | None":
        """The codec that losslessly encodes ``arr``: raw uint8 → scale
        1; float32 tries the loader conventions — ``scale=1/255``
        FIRST when the batch's range says 'normalized' (max ≤ 1: a
        degenerate integral batch, e.g. all-black images, encodes
        under BOTH scales, and pinning scale=1 there would make every
        later generic /255 batch raise mid-run), ``scale=1`` first
        otherwise."""
        arr = np.asarray(arr)
        if arr.dtype == np.uint8:
            return cls(1.0)
        if arr.dtype != np.float32:
            return None
        normalized = arr.size == 0 or float(np.max(np.abs(arr))) <= 1.0
        scales = ((1.0 / 255.0, 1.0) if normalized
                  else (1.0, 1.0 / 255.0))
        for scale in scales:
            codec = cls(scale)
            try:
                codec.encode(arr)
                return codec
            except CodecError:
                continue
        return None


def f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 → the uint16 bit patterns of bfloat16, rounded to nearest
    even on the f32 bits; a NaN becomes the quiet NaN of its sign (0x7FC0
    or 0xFFC0), so a NaN payload can never round into an infinity."""
    u = np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)
    lsb = (u >> 16) & 1
    bits = ((u + np.uint32(0x7FFF) + lsb) >> 16).astype(np.uint16)
    nan = np.isnan(arr)
    if nan.any():
        bits[nan] = np.where(u[nan] >> 31, 0xFFC0, 0x7FC0).astype(np.uint16)
    return bits


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """The inverse cast: each bfloat16 (uint16 bits, or a ``V2`` array)
    as the float32 it is exactly."""
    b = np.ascontiguousarray(bits)
    if b.dtype == BF16_BITS:
        b = b.view(np.uint16)
    return (b.astype(np.uint32) << 16).view(np.float32)


class BF16Codec(WireCodec):
    """bfloat16 on the wire — 2× fewer bytes for float32 batches that are
    NOT exact uint8 multiples. Lossy by declaration: bfloat16 keeps 8
    significand bits, so each element's relative error is ≤ 2⁻⁸ (and
    integers up to 256 are exact); the documented round-trip tolerance
    is rtol=2⁻⁷. uint8 batches pass through. The encoded batch is a
    :data:`BF16_BITS` array (``ml_dtypes``' bfloat16 bits, without
    ``ml_dtypes``)."""

    name = "bf16"
    RTOL = 2.0 ** -7  # documented round-trip tolerance

    def encode(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        if arr.dtype == np.uint8:
            return arr
        if arr.dtype != np.float32:
            raise CodecError(
                f"bf16 codec encodes uint8/float32 batches, got {arr.dtype}")
        return f32_to_bf16_bits(arr).view(BF16_BITS)

    def decode_array(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        if arr.dtype == BF16_BITS:
            return bf16_bits_to_f32(arr)
        return arr.astype(np.float32)

    def prologue(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint16:   # bits that reached torch unviewed
            x = x.view(torch.bfloat16)
        return x.to(torch.float32)

    def dense_nbytes(self, encoded: np.ndarray) -> int:
        return int(encoded.size) * 4


def host_tensor(arr: np.ndarray, pin: bool = False) -> torch.Tensor:
    """One host batch as a CPU tensor that owns or shares its memory: a
    :data:`BF16_BITS` array becomes ``torch.bfloat16``, a read-only array
    (a memory-mapped shard) is copied, and ``pin=True`` lands the bytes
    in page-locked memory with one copy."""
    a = np.asarray(arr)
    bf16 = a.dtype == BF16_BITS
    if bf16:
        a = a.view(np.uint16)
    if pin:
        t = torch.empty(a.shape, dtype=torch.from_numpy(
            np.zeros(0, a.dtype)).dtype, pin_memory=True)
        np.copyto(t.numpy(), a, casting="no")
    elif not a.flags.writeable or not a.flags.c_contiguous:
        t = torch.from_numpy(np.array(a, order="C"))
    else:
        t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


_WIRE_MBPS_CACHE: dict = {}
_WIRE_MBPS_LOCK = _tsan.named_lock("data.codec.wire_probe")


def probe_wire_mbps(mb: int = 4) -> float | None:
    """Host→card bandwidth in MB/s: a pinned ``mb``-MB copy, as the
    executor ships its batches, timed once per process (tpudl times a
    ``jax.device_put`` of the same size). ``TPUDL_WIRE_MBPS`` overrides.
    None without a card — callers treat that as 'unknown', not
    'fast'."""
    env = os.environ.get("TPUDL_WIRE_MBPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    with _WIRE_MBPS_LOCK:
        if "mbps" in _WIRE_MBPS_CACHE:
            return _WIRE_MBPS_CACHE["mbps"]
        mbps = None
        if torch.cuda.is_available():
            host = torch.zeros(mb << 20, dtype=torch.uint8, pin_memory=True)
            dev = torch.empty_like(host, device="cuda")
            dev[: 1 << 20].copy_(host[: 1 << 20], non_blocking=True)  # warm
            # tpudl: ignore[lock-held-blocking] — the probe IS the
            # blocking op: the lock serializes "one probe, ever", and
            # concurrent probes would skew each other's timing (waiters
            # get the cached result the moment it exists)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev.copy_(host, non_blocking=True)
            # tpudl: ignore[lock-held-blocking] — see above: the timed
            # transfer must run under the probe lock
            torch.cuda.synchronize()
            mbps = mb / (time.perf_counter() - t0)
        _WIRE_MBPS_CACHE["mbps"] = mbps
        return mbps


# copied from tpudl/data/codec.py:_bf16_wire_threshold
def _bf16_wire_threshold() -> float:
    try:
        return float(os.environ.get("TPUDL_DATA_BF16_WIRE_MBPS", "")
                     or 1000.0)
    except ValueError:
        return 1000.0


# copied from tpudl/data/codec.py:_auto_pick
def _auto_pick(arr: np.ndarray) -> WireCodec:
    """Auto selection for one packed column — STRUCTURAL only (dtype,
    never sample values): uint8 columns ship as u8; float32 columns ship
    bf16 when the measured wire is slower than
    ``TPUDL_DATA_BF16_WIRE_MBPS``, identity when the wire is fast or
    unknown."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint8:
        return U8Codec(1.0)
    if arr.dtype == np.float32:
        mbps = probe_wire_mbps()
        if mbps is not None and mbps < _bf16_wire_threshold():
            return BF16Codec()
    return IdentityCodec()


def resolve_codec(spec) -> "WireCodec | str | None":
    """Codec spec → instance, or a deferred sentinel string resolved per
    column from the first packed batch by :class:`CodecPlan`: ``"auto"``
    (pick freely) and ``"u8"`` (infer the scale — raw uint8, exact
    ``u8×1`` or exact ``u8/255`` floats — and REFUSE anything else)."""
    if spec is None:
        return None
    if isinstance(spec, WireCodec):
        return spec
    if spec in ("auto", "u8"):
        return spec
    if spec == "identity":
        return IdentityCodec()
    if spec == "bf16":
        return BF16Codec()
    if spec == "tokens":
        # lazy: tpudl_torch.text.codec imports this module
        from tpudl_torch.text.codec import TokenCodec

        return TokenCodec()
    if isinstance(spec, str):
        raise CodecError(
            f"unknown wire codec {spec!r}; known: "
            "['auto', 'bf16', 'identity', 'tokens', 'u8']")
    raise CodecError(f"wire codec must be a name or WireCodec, got "
                     f"{type(spec).__name__}")


def codec_from_key(key) -> WireCodec:
    """Inverse of ``WireCodec.key()`` — how a shard manifest's persisted
    codec identity becomes the prologue for a warm replay."""
    key = tuple(key)
    name = key[0]
    if name == "identity":
        return IdentityCodec()
    if name == "u8":
        return U8Codec(*key[1:])
    if name == "bf16":
        return BF16Codec()
    if name == "tokens":
        from tpudl_torch.text.codec import TokenCodec

        pad_id, vocab_size, wire = key[1:]
        return TokenCodec(pad_id=pad_id, vocab_size=vocab_size,
                          wire_dtype=wire)
    raise CodecError(f"unknown codec key {key!r}")


# copied from tpudl/data/codec.py:spec_token
def spec_token(spec) -> str:
    """Stable string identity of a codec spec, for cache keys."""
    if spec is None:
        return "none"
    if isinstance(spec, WireCodec):
        return repr(spec.key())
    return str(spec)


class CodecPlan:
    """One ``map_batches`` run's (or one ``Dataset``'s) codec state: one
    resolved codec per input column, the restoring wrapper of the user's
    function, and the wire-byte accounting.

    ``encode`` runs on the prepare pool's threads for different batches
    at once; a deferred column (``"auto"``, ``"u8"``) resolves once, under
    a lock, on whichever batch arrives first (every batch of a column
    packs to the same dtype, so the choice does not depend on the order).

    Counters (:mod:`tpudl_torch.obs.metrics`): ``data.wire.bytes_shipped``
    (encoded bytes that cross), ``data.wire.bytes_dense`` (the float32
    the prologue reconstitutes), ``data.wire.bytes_saved`` (their
    difference), the ``data.codec.encode_seconds`` histogram and
    ``data.codec.<name>.batches``."""

    def __init__(self, spec, n_cols: int, report=None):
        base = resolve_codec(spec)
        self._deferred = base if isinstance(base, str) else None
        self._codecs: list[WireCodec | None] = [
            None if self._deferred else base for _ in range(n_cols)]
        self._lock = _tsan.named_lock("data.codec.plan")
        self._report = report

    # -- resolution --------------------------------------------------------
    def _resolve_one(self, arr: np.ndarray) -> WireCodec:
        if self._deferred == "auto":
            return _auto_pick(arr)
        # "u8": infer the scale but NEVER fall back silently — the user
        # asked for the 4× wire shrink, a quiet identity would fake it
        codec = U8Codec.infer(arr)
        if codec is None:
            raise CodecError(
                "wire_codec='u8': batch is not losslessly uint8-encodable "
                f"(dtype {np.asarray(arr).dtype}); pass U8Codec(scale=...) "
                "for a custom normalize, or 'bf16'/'auto'")
        return codec

    def _codec_for(self, col: int, arr: np.ndarray) -> WireCodec:
        c = self._codecs[col]
        if c is not None:
            return c
        with self._lock:
            if self._codecs[col] is None:
                # tpudl: ignore[lock-held-blocking] — resolution may run
                # the one-time wire probe (probe_wire_mbps); one thread
                # resolves a column while the others wait for its codec
                self._codecs[col] = self._resolve_one(arr)
            return self._codecs[col]

    def resolved(self) -> bool:
        return all(c is not None for c in self._codecs)

    @property
    def codecs(self) -> list:
        return list(self._codecs)

    def keys(self) -> list:
        """JSON-serialisable per-column codec keys (shard-manifest form);
        requires resolution."""
        return [list(c.key()) for c in self._codecs]

    def adopt(self, keys) -> None:
        """Pin the plan to a persisted resolution (a warm shard cache's
        manifest meta): the replay restores with the codecs the shards
        were encoded with, not a fresh auto pick."""
        codecs = [codec_from_key(k) for k in keys]
        if len(codecs) != len(self._codecs):
            raise CodecError(
                f"cached codec count {len(codecs)} != input columns "
                f"{len(self._codecs)}")
        with self._lock:
            self._codecs = codecs

    # -- host side ---------------------------------------------------------
    def encode(self, col: int, arr: np.ndarray) -> np.ndarray:
        codec = self._codec_for(col, arr)
        t0 = time.perf_counter()
        enc = codec.encode(arr)
        _m.histogram("data.codec.encode_seconds").observe(
            time.perf_counter() - t0)
        _m.counter(f"data.codec.{codec.name}.batches").inc()
        return enc

    def record_shipped(self, arrays) -> None:
        """Wire-byte accounting for one prepared batch — called for
        encoded AND shard-cache-hit batches (a replayed shard still
        crosses the wire); never for a batch resident on the card."""
        shipped = dense = 0
        for col, arr in enumerate(arrays):
            codec = self._codecs[col] or IdentityCodec()
            shipped += int(np.asarray(arr).nbytes)
            dense += codec.dense_nbytes(np.asarray(arr))
        _m.counter("data.wire.bytes_shipped").inc(shipped)
        # the attribution pairing: the same amount as the global counter,
        # so per-scope sums + unattributed reconcile exactly
        _attr.charge("wire_bytes", shipped)
        _m.counter("data.wire.bytes_dense").inc(dense)
        if dense > shipped:
            _m.counter("data.wire.bytes_saved").inc(dense - shipped)
        if self._report is not None:
            self._report.gauge("wire_batch_bytes", shipped)

    # -- device side -------------------------------------------------------
    def wrap(self, fn):
        """``fn`` with the per-column prologues in front: the returned
        function restores its LAST ``n_cols`` positional arguments (the
        columns) and passes any leading ones through, so a loss
        ``loss_fn(model, tokens)`` wraps as well as a batch function.
        Identity-only plans return ``fn`` itself. tpudl's ``donate`` is
        not taken: a torch function holds no buffers to donate."""
        codecs = list(self._codecs)
        if any(c is None for c in codecs):
            raise CodecError("codec plan not resolved (no batch encoded "
                             "and no cache meta adopted)")
        if all(c.name == "identity" for c in codecs):
            return fn
        n = len(codecs)

        def wrapped(*args):
            lead, cols = args[: len(args) - n], args[len(args) - n:]
            return fn(*lead, *(c.prologue(x) for c, x in zip(codecs, cols)))

        return wrapped

    def names(self) -> list[str]:
        return [c.name if c is not None else "auto" for c in self._codecs]
