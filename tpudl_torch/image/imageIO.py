"""Image struct ⇄ ndarray codec, decode, resize and lazy file reads.

Port of ``tpudl/image/imageIO.py``, host-only code copied: the Spark
image struct (``origin, height, width, nChannels, mode, data`` with
OpenCV mode ordinals and **BGR** storage order), PIL and libjpeg
(:mod:`tpudl_torch.native`) decoding, host resize, and the lazy file
column behind ``readImages``. The device half (cast, flip, resize to the
model) lives in :mod:`tpudl_torch.image.ops`.

``LazyFileColumn`` reads the files of a batch on ``io_workers`` threads
and decodes on ``decode_workers``, and the executor's prepare pool may
read several batches at once; a decoder not marked ``thread_safe`` runs
under a column-wide lock. ``host_sharded=True`` keeps this process's
share of the file list (:func:`tpudl_torch.distributed.host_shard`, the
multi-machine input plane that replaces Spark's partition assignment).
Every file read fires tpudl's ``io.read`` fault point and retries a
transient failure under the shared IO policy
(:func:`tpudl_torch.jobs.retry.io_policy`, counted as
``retry.imageio.read``). Every decode error is counted
(``imageio.decode_errors``) and sampled into the flight recorder's error
ring (kind ``imageio.decode_error``, with the file's origin), which
``obs doctor``'s decode-error-storm rule reads.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from io import BytesIO
from typing import Callable, Iterable

import numpy as np

from tpudl_torch.frame.frame import Frame, LazyColumn, _env_int
from tpudl_torch.obs import flight as _flight
from tpudl_torch.obs import metrics as _obs_metrics
from tpudl_torch.testing import tsan as _tsan

try:  # PIL is the decode substrate, as in tpudl
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

__all__ = [
    "ImageType",
    "supportedImageTypes",
    "imageTypeByOrdinal",
    "imageTypeByName",
    "imageArrayToStruct",
    "imageStructToArray",
    "imageStructToPIL",
    "PIL_decode",
    "PIL_decode_and_resize",
    "default_decode",
    "default_probe",
    "resizeImage",
    "createResizeImageUDF",
    "filesToFrame",
    "readImagesWithCustomFn",
    "readImages",
    "LazyFileColumn",
    "createNativeImageLoader",
    "SPARK_MODE",
]


@dataclasses.dataclass(frozen=True)
class ImageType:
    """One OpenCV storage mode of the Spark image schema."""

    name: str
    ord: int
    nChannels: int
    dtype: str


_SUPPORTED = [
    ImageType("CV_8UC1", 0, 1, "uint8"),
    ImageType("CV_32FC1", 5, 1, "float32"),
    ImageType("CV_8UC3", 16, 3, "uint8"),
    ImageType("CV_32FC3", 21, 3, "float32"),
    ImageType("CV_8UC4", 24, 4, "uint8"),
    ImageType("CV_32FC4", 29, 4, "float32"),
]
_BY_ORD = {t.ord: t for t in _SUPPORTED}
_BY_NAME = {t.name: t for t in _SUPPORTED}


class SPARK_MODE:
    """Symbolic channel orders."""

    BGR = "BGR"
    RGB = "RGB"
    GRAY = "L"


def supportedImageTypes() -> list[ImageType]:
    return list(_SUPPORTED)


def imageTypeByOrdinal(ord: int) -> ImageType:
    if ord not in _BY_ORD:
        raise KeyError(
            f"unsupported image mode ordinal {ord}; supported: {sorted(_BY_ORD)}"
        )
    return _BY_ORD[ord]


def imageTypeByName(name: str) -> ImageType:
    if name not in _BY_NAME:
        raise KeyError(
            f"unsupported image mode {name!r}; supported: {sorted(_BY_NAME)}"
        )
    return _BY_NAME[name]


def imageArrayToStruct(imgArray: np.ndarray, origin: str = "") -> dict:
    """ndarray (H, W, C) or (H, W), already in storage channel order (BGR
    for color) → Spark image struct dict. No flip happens here."""
    arr = np.asarray(imgArray)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"image array must be 2-D or 3-D, got shape {arr.shape}")
    h, w, c = arr.shape
    if arr.dtype == np.uint8:
        dtype = "uint8"
    elif arr.dtype in (np.float32, np.float64):
        dtype = "float32"
        arr = arr.astype(np.float32)
    else:
        raise ValueError(f"unsupported image array dtype {arr.dtype}")
    matches = [t for t in _SUPPORTED if t.nChannels == c and t.dtype == dtype]
    if not matches:
        raise ValueError(f"no OpenCV mode for nChannels={c} dtype={dtype}")
    t = matches[0]
    return {
        "origin": origin,
        "height": int(h),
        "width": int(w),
        "nChannels": int(c),
        "mode": t.ord,
        "data": np.ascontiguousarray(arr).tobytes(),
    }


def imageStructToArray(imageRow: dict, copy: bool = True) -> np.ndarray:
    """Spark image struct dict → ndarray (H, W, C) in storage order;
    ``copy=False`` returns a read-only view over the struct's bytes."""
    t = imageTypeByOrdinal(imageRow["mode"])
    shape = (imageRow["height"], imageRow["width"], imageRow["nChannels"])
    arr = np.frombuffer(imageRow["data"], dtype=t.dtype).reshape(shape)
    return arr.copy() if copy else arr


def imageStructToPIL(imageRow: dict):
    """struct → PIL image (RGB/RGBA/L)."""
    arr = imageStructToArray(imageRow)
    t = imageTypeByOrdinal(imageRow["mode"])
    if t.dtype == "float32":
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    c = arr.shape[2]
    if c == 1:
        return Image.fromarray(arr[:, :, 0], mode="L")
    if c == 3:
        return Image.fromarray(arr[:, :, ::-1], mode="RGB")  # BGR → RGB
    if c == 4:
        rgba = arr[:, :, [2, 1, 0, 3]]  # BGRA → RGBA
        return Image.fromarray(rgba, mode="RGBA")
    raise ValueError(f"unsupported channel count {c}")


def PIL_decode(raw_bytes: bytes, origin: str = "") -> dict | None:
    """Encoded image bytes → image struct (BGR, grayscale widened to 3
    channels), or None when undecodable."""
    if Image is None:  # pragma: no cover
        raise ImportError("PIL is required for image decoding")
    try:
        img = Image.open(BytesIO(raw_bytes))
        img = img.convert("RGB")
    except Exception:
        return None
    rgb = np.asarray(img, dtype=np.uint8)
    return imageArrayToStruct(rgb[:, :, ::-1], origin=origin)  # store BGR


def PIL_decode_and_resize(
    raw_bytes: bytes, size: tuple[int, int], origin: str = ""
) -> dict | None:
    """Decode + bilinear resize to ``size`` (h, w) in one host step."""
    if Image is None:  # pragma: no cover
        raise ImportError("PIL is required for image decoding")
    try:
        img = Image.open(BytesIO(raw_bytes)).convert("RGB")
        img = img.resize((size[1], size[0]), Image.BILINEAR)  # PIL takes (W, H)
    except Exception:
        return None
    rgb = np.asarray(img, dtype=np.uint8)
    return imageArrayToStruct(rgb[:, :, ::-1], origin=origin)


# copied from tpudl/image/imageIO.py:_jpeg_dims
def _jpeg_dims(raw: bytes) -> tuple[int, int] | None:
    """(height, width) from a JPEG header's SOF marker (no decode), or None
    when the bytes aren't a JPEG."""
    if len(raw) < 4 or raw[0:2] != b"\xff\xd8":
        return None
    i, n = 2, len(raw)
    while i + 9 < n:
        if raw[i] != 0xFF:
            i += 1
            continue
        marker = raw[i + 1]
        if marker == 0xFF:  # 0xFF fill/padding byte before a marker
            i += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2  # parameterless markers
            continue
        if marker == 0xDA:  # start-of-scan reached without a SOF
            return None
        seg_len = int.from_bytes(raw[i + 2:i + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h = int.from_bytes(raw[i + 5:i + 7], "big")
            w = int.from_bytes(raw[i + 7:i + 9], "big")
            return (h, w) if h > 0 and w > 0 else None
        i += 2 + seg_len
    return None


def default_decode(raw_bytes: bytes, origin: str = "") -> dict | None:
    """Decode bytes → image struct: libjpeg (:mod:`tpudl_torch.native`) for
    JPEGs when it is available, PIL for every other format or as the
    fallback."""
    from tpudl_torch import native

    if native.available():
        dims = _jpeg_dims(raw_bytes)
        # decompression-bomb guard: huge claimed geometry goes to PIL,
        # whose own check yields the null row
        if dims is not None and dims[0] * dims[1] <= 64_000_000:
            batch, ok = native.decode_resize_batch(
                [raw_bytes], dims[0], dims[1], n_threads=1)
            if ok[0]:  # already BGR storage order
                return imageArrayToStruct(batch[0], origin=origin)
    return PIL_decode(raw_bytes, origin=origin)


# stateless over thread-safe substrates (PIL and the native decoder both
# release the GIL): a LazyFileColumn may run it for several batches at once
default_decode.thread_safe = True
# tpudl's identity for the same decoder (the native decoder is a copy of
# tpudl's, with the same PIL fallback), so that a frame's fingerprint, and
# a prepared-batch cache keyed on it, is the same in both packages
default_decode.cache_token = "tpudl.image.imageIO|default_decode"


def default_probe(raw_bytes: bytes) -> bool:
    """Cheap validity twin of :func:`default_decode`: a header parse and
    stream verify (PIL ``Image.verify``), no pixel decode."""
    if Image is None:  # pragma: no cover
        raise ImportError("PIL is required for image probing")
    try:
        img = Image.open(BytesIO(raw_bytes))
        img.verify()
        return True
    except Exception:
        return False


# copied from tpudl/image/imageIO.py:createNativeImageLoader (reads
# without tpudl's retry policy and fault points)
def createNativeImageLoader(height: int, width: int, scale: float = 1.0,
                            n_threads: int | None = None,
                            output_dtype: str = "float32"):
    """A URI → ndarray ``imageLoader`` whose ``batch_decode`` attribute
    decodes a whole URI batch in one threaded native decode + resize call
    (libjpeg, :mod:`tpudl_torch.native`), the path ``load_uri_batch``
    takes for ``KerasImageFileTransformer``/``KerasImageFileEstimator``.
    Where the native decoder is not built (no libjpeg headers), and for
    a file it cannot decode, PIL decodes and resizes (bilinear).

    ``output_dtype`` picks the wire representation, as in tpudl:

    - ``"float32"`` (default): RGB ``(H, W, 3)`` in [0, 255]·``scale``;
    - ``"uint8"``: the raw uint8 RGB pixels, with the ``* scale``
      normalize deferred to the card — the loader declares
      ``wire_scale``/``wire_offset``, and the u8 wire codec's prologue
      applies them (``f32(u8) * f32(scale)``: bit for bit the float32
      output, at 4× fewer host→card bytes). ``KerasImageFileTransformer``
      and ``KerasImageFileEstimator`` install that codec themselves.

    ``n_threads`` (``TPUDL_DECODE_THREADS``; default: the native layer's
    choice) caps the decoder's threads per batch. Every path reads the
    files through one counted read (``imageio.files_read``,
    ``imageio.bytes_read``)."""
    if output_dtype not in ("float32", "uint8"):
        raise ValueError(
            f"output_dtype must be 'float32' or 'uint8', got "
            f"{output_dtype!r}")
    raw_u8 = output_dtype == "uint8"
    if n_threads is None:
        env = os.environ.get("TPUDL_DECODE_THREADS")
        try:
            n_threads = max(1, int(env)) if env else None
        except ValueError:
            n_threads = None  # malformed env: let the native layer pick

    def _pil_one(uri: str, raw: bytes | None = None) -> np.ndarray:
        src = BytesIO(raw) if raw is not None else uri
        img = Image.open(src).convert("RGB").resize(
            (width, height), Image.BILINEAR)
        if raw_u8:
            return np.asarray(img, np.uint8)
        return np.asarray(img, np.float32) * scale

    def _read(uri):
        from tpudl_torch.jobs.retry import io_policy
        from tpudl_torch.testing import faults as _faults

        def _once():
            _faults.fire("io.read", path=str(uri))
            with open(uri, "rb") as f:
                return f.read()

        # the same transient-IO retry as LazyFileColumn._read_raw
        return io_policy().call(_once, kind="imageio.read")

    def _read_all(uris: list) -> list:
        raws = _parallel_map(
            _read, uris,
            _env_workers("TPUDL_FRAME_IO_WORKERS",
                         LazyFileColumn._IO_WORKERS))
        if raws:  # same per-batch accounting as LazyFileColumn reads
            _obs_metrics.counter("imageio.files_read").inc(len(raws))
            _obs_metrics.counter("imageio.bytes_read").inc(
                sum(len(r) for r in raws))
        return raws

    def loader(uri: str) -> np.ndarray:
        from tpudl_torch import native

        if native.available():
            batch, ok = native.decode_resize_batch(
                [_read(uri)], height, width, n_threads=1)
            if ok[0]:
                rgb = batch[0][:, :, ::-1]
                if raw_u8:
                    return np.ascontiguousarray(rgb)
                return rgb.astype(np.float32) * scale
        return _pil_one(uri)

    def batch_decode(uris) -> np.ndarray:
        from tpudl_torch import native

        uris = list(uris)
        if not uris:
            return np.zeros((0, height, width, 3),
                            np.uint8 if raw_u8 else np.float32)
        raws = _read_all(uris)
        if not native.available():
            return np.stack([_pil_one(u, r) for u, r in zip(uris, raws)])
        batch, ok = native.decode_resize_batch(raws, height, width,
                                               n_threads=n_threads)
        rgb = batch[:, :, :, ::-1]
        out = (np.ascontiguousarray(rgb) if raw_u8
               else rgb.astype(np.float32) * scale)
        for i, good in enumerate(ok):
            if not good:
                out[i] = _pil_one(uris[i], raws[i])
        return out

    loader.batch_decode = batch_decode
    # wire declaration the data layer reads: with raw uint8 output the
    # deferred normalize (scale, offset) becomes the u8 codec's prologue
    loader.output_dtype = output_dtype
    loader.wire_scale = float(scale)
    loader.wire_offset = 0.0
    loader.cache_token = (f"native:{height}x{width}:s{scale!r}"
                          f":{output_dtype}")
    # stateless over thread-safe substrates: the executor's prepare pool
    # may run batch_decode for several batches at once
    loader.thread_safe = True
    return loader


def resizeImage(imageRow: dict, height: int, width: int) -> dict:
    """Bilinear host resize of an image struct (PIL)."""
    if (imageRow["height"], imageRow["width"]) == (height, width):
        return imageRow
    t = imageTypeByOrdinal(imageRow["mode"])
    if t.dtype == "float32":
        # PIL has no multi-channel float mode: resize each channel as 'F'
        src = imageStructToArray(imageRow, copy=False)
        chans = [
            np.asarray(
                Image.fromarray(src[:, :, c], mode="F").resize(
                    (width, height), Image.BILINEAR
                ),
                dtype=np.float32,
            )
            for c in range(src.shape[2])
        ]
        arr = np.stack(chans, axis=-1)
        return imageArrayToStruct(arr, origin=imageRow.get("origin", ""))
    pil = imageStructToPIL(imageRow)
    resized = pil.resize((width, height), Image.BILINEAR)
    arr = np.asarray(resized, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    elif arr.shape[2] == 3:
        arr = arr[:, :, ::-1]  # back to BGR storage
    elif arr.shape[2] == 4:
        arr = arr[:, :, [2, 1, 0, 3]]
    return imageArrayToStruct(arr, origin=imageRow.get("origin", ""))


def createResizeImageUDF(size: tuple[int, int]) -> Callable[[dict], dict]:
    """Row-function form of :func:`resizeImage`."""
    height, width = int(size[0]), int(size[1])

    def _resize(row: dict) -> dict:
        return resizeImage(row, height, width)

    return _resize


class LazyFileColumn(LazyColumn):
    """File-backed lazy column: stores only the paths; the bytes of an
    accessed batch are read (and passed through ``transform(path, raw)``
    when given) on access, so host RAM is O(batch). ``reads`` counts file
    reads. Accesses of up to 32 rows are memoized (the same index set
    twice reads once), as in tpudl.

    Worker knobs (the executor's prepare pool calls ``_get`` for different
    batches at once, so everything here is thread-safe):

    - ``io_workers`` (``TPUDL_FRAME_IO_WORKERS``, default 8): parallel
      file reads per batch;
    - ``decode_workers`` (``TPUDL_FRAME_DECODE_WORKERS``, default 1):
      parallel ``transform`` calls within one batch. A transform marked
      ``thread_safe = True`` (``default_decode`` is) or an explicit
      ``decode_workers > 1`` opts into concurrency; any other transform
      runs under a column-wide lock, serial even across batches."""

    _MEMO_MAX_ROWS = 32
    _IO_WORKERS = 8

    def __init__(self, paths, transform: Callable | None = None,
                 probe: Callable | None = None,
                 io_workers: int | None = None,
                 decode_workers: int | None = None):
        self._paths = np.asarray(list(paths), dtype=object)
        self._transform = transform
        self._probe = probe  # (path, raw) -> bool; see validity_mask
        self._validity: np.ndarray | None = None
        self._memo: tuple[bytes, np.ndarray] | None = None
        self.reads = 0
        self._reads_lock = _tsan.named_lock("image.lazyfile.reads")
        self._memo_lock = _tsan.named_lock("image.lazyfile.memo")
        self._transform_lock = _tsan.named_lock("image.lazyfile.transform")
        self.io_workers = int(io_workers if io_workers is not None
                              else _env_workers("TPUDL_FRAME_IO_WORKERS",
                                                self._IO_WORKERS))
        self.decode_workers = int(
            decode_workers if decode_workers is not None
            else _env_workers("TPUDL_FRAME_DECODE_WORKERS", 1))

    def __len__(self) -> int:
        return len(self._paths)

    def _read_raw(self, i) -> bytes:
        from tpudl_torch.jobs.retry import io_policy
        from tpudl_torch.testing import faults as _faults

        def _read():
            # the fault point: a test injects transient IO errors
            # (recovery after K) exactly here
            _faults.fire("io.read", path=str(self._paths[i]))
            with open(self._paths[i], "rb") as f:
                return f.read()

        # a flaky-storage read retries under the shared IO policy
        # (bounded backoff, each attempt in the retry.* counters and the
        # flight recorder) instead of poisoning the row at the first EIO
        raw = io_policy().call(_read, kind="imageio.read")
        with self._reads_lock:
            self.reads += 1
        return raw

    def _read_batch(self, indices: np.ndarray) -> list[bytes]:
        raws = _parallel_map(self._read_raw, indices, self.io_workers)
        if raws:
            _obs_metrics.counter("imageio.files_read").inc(len(raws))
            _obs_metrics.counter("imageio.bytes_read").inc(
                sum(len(r) for r in raws))
        return raws

    def _decode_batch(self, indices: np.ndarray, raws: list) -> np.ndarray:
        """Per-row ``transform`` over the read bytes, in row order: fanned
        over ``decode_workers`` threads for a transform that opted into
        concurrency, else serial under the column-wide lock."""
        out = np.empty(len(indices), dtype=object)
        if self._transform is None:
            out[:] = raws
            return out

        def row(ir):
            return self._transform(self._paths[ir[0]], ir[1])

        if (getattr(self._transform, "thread_safe", False)
                or self.decode_workers > 1):
            out[:] = _parallel_map(row, zip(indices, raws),
                                   self.decode_workers)
            return out
        with self._transform_lock:
            out[:] = [row(ir) for ir in zip(indices, raws)]
        return out

    def _get(self, indices: np.ndarray) -> np.ndarray:
        key = indices.tobytes()
        with self._memo_lock:
            memo = self._memo
        if memo is not None and memo[0] == key:
            _obs_metrics.counter("imageio.memo_hits").inc()
            return _copy_rows(memo[1])
        out = self._decode_batch(indices, self._read_batch(indices))
        if len(indices) <= self._MEMO_MAX_ROWS:
            with self._memo_lock:
                self._memo = (key, out)
            return _copy_rows(out)
        return out

    def validity_mask(self) -> np.ndarray | None:
        """Per-row validity without running the transform: a raw-bytes
        column is never null; a transform column answers through its
        ``probe`` (each file read once, no decode), else None."""
        if self._transform is None:
            return np.ones(len(self), dtype=bool)
        if self._probe is None:
            return None
        if self._validity is None:
            flags = np.empty(len(self), dtype=bool)
            for start in range(0, len(self), 256):
                idx = np.arange(start, min(start + 256, len(self)))
                raws = self._read_batch(idx)
                flags[idx] = [bool(self._probe(self._paths[i], raw))
                              for i, raw in zip(idx, raws)]
            self._validity = flags
        return self._validity

    # copied from tpudl/image/imageIO.py:LazyFileColumn.fingerprint
    def fingerprint(self) -> str:
        """Content identity without reads or decodes, equal to tpudl's:
        sha1 over each path, its size and mtime, and the transform's
        cache token."""
        h = hashlib.sha1()
        if self._transform is not None:
            h.update(
                f"transform:{_callable_token(self._transform)}\n".encode())
        h.update(_uri_fingerprint(self._paths).encode())
        return h.hexdigest()

    def with_transform(self, transform: Callable,
                       probe: Callable | None = None) -> "LazyFileColumn":
        """Same paths and workers, another per-file transform (and its
        cheap validity ``probe``)."""
        return LazyFileColumn(self._paths, transform, probe=probe,
                              io_workers=self.io_workers,
                              decode_workers=self.decode_workers)


def _env_workers(name: str, default: int) -> int:
    return max(1, _env_int(name, default))


# copied from tpudl/image/imageIO.py:_parallel_map
def _parallel_map(fn, items, workers: int) -> list:
    """Order-preserving map, fanned over a thread pool when both the item
    count (>= 4) and ``workers`` (> 1) justify one."""
    items = list(items)
    if len(items) >= 4 and workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(workers, len(items))) as ex:
            return list(ex.map(fn, items))
    return [fn(i) for i in items]


# copied from tpudl/data/dataset.py:_callable_token
def _callable_token(fn) -> str:
    """Cache identity of a callable: its ``cache_token``, else
    module|qualname."""
    tok = getattr(fn, "cache_token", None)
    if tok:
        return str(tok)
    return "|".join((getattr(fn, "__module__", "?"),
                     getattr(fn, "__qualname__", repr(fn))))


# copied from tpudl/data/dataset.py:_uri_fingerprint
def _uri_fingerprint(uris) -> str:
    """sha1 over (path, size, mtime) per file."""
    h = hashlib.sha1()
    for u in uris:
        h.update(str(u).encode())
        try:
            st = os.stat(u)
            h.update(f"|{st.st_size}|{st.st_mtime_ns}".encode())
        except OSError:
            h.update(b"|?")
        h.update(b"\n")
    return h.hexdigest()


def _copy_rows(arr: np.ndarray) -> np.ndarray:
    """Fresh object array with dict rows shallow-copied, so a caller that
    mutates a returned struct cannot change the memo."""
    out = np.empty(len(arr), dtype=object)
    for j, v in enumerate(arr):
        out[j] = dict(v) if isinstance(v, dict) else v
    return out


def _listFiles(path: str | Iterable[str]) -> list[str]:
    if isinstance(path, (list, tuple)):
        return [str(p) for p in path]
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            out.extend(os.path.join(root, f) for f in sorted(files))
        return sorted(out)
    return [path]


def filesToFrame(path, numPartitions: int | None = None,
                 host_sharded: bool = False, lazy: bool = True) -> Frame:
    """A Frame with columns (filePath, fileData) over raw file bytes;
    ``fileData`` is a :class:`LazyFileColumn` unless ``lazy=False``.
    ``numPartitions`` is the frame's partition hint (``map_batches``'s
    default batch is ``ceil(rows / numPartitions)``). ``host_sharded=True``
    keeps only this process's contiguous share of the sorted file list
    (:func:`tpudl_torch.distributed.host_shard` over the joined process
    group; the whole list outside one)."""
    paths = _listFiles(path)
    if host_sharded:
        from tpudl_torch import distributed as D

        paths = D.host_shard(paths)
    if lazy:
        data = LazyFileColumn(paths)
    else:
        datas = []
        for p in paths:
            with open(p, "rb") as f:
                datas.append(f.read())
        data = np.empty(len(datas), dtype=object)
        data[:] = datas
    return Frame({"filePath": np.array(paths, dtype=object), "fileData": data},
                 num_partitions=numPartitions)


def _decode_row(decode_f, origin, raw):
    """``decode_f`` semantics shared by the eager and lazy read paths: an
    exception or None gives a None row (counted in
    ``imageio.decode_errors``, never retried); an ndarray becomes a
    struct with the file's origin."""
    try:
        out = decode_f(raw)
    except Exception as e:
        _obs_metrics.counter("imageio.decode_errors").inc()
        # a sample lands in the flight recorder's bounded error ring, so a
        # post-mortem shows which files went bad, not just how many
        _flight.record_error("imageio.decode_error", e, origin=origin)
        return None
    if out is None:
        _obs_metrics.counter("imageio.decode_errors").inc()
        _flight.record_error("imageio.decode_error",
                             "decode_f returned None", origin=origin)
        return None
    if isinstance(out, dict):
        out = dict(out)
        if not out.get("origin"):
            out["origin"] = origin
        return out
    return imageArrayToStruct(np.asarray(out), origin=origin)


def readImagesWithCustomFn(path, decode_f, numPartition: int | None = None,
                           host_sharded: bool = False, lazy: bool = True,
                           probe_f: Callable | None = None) -> Frame:
    """A directory of images → Frame["image"], decoded by ``decode_f``
    (raw bytes → ndarray (H, W, C) in BGR storage order, a struct, or
    None); undecodable files become None rows. Lazy by default: each
    accessed batch is read and decoded on access, in the executor's
    prepare pool. ``decode_f`` runs concurrently only when it is marked
    ``thread_safe = True``. ``probe_f`` (raw → bool, True iff the decode
    would succeed) lets ``dropna`` classify rows without decoding them.
    ``numPartition`` is the frame's partition hint; ``host_sharded`` is
    :func:`filesToFrame`'s."""
    files = filesToFrame(path, host_sharded=host_sharded, lazy=lazy)
    if lazy:
        def tr(p, raw):
            return _decode_row(decode_f, p, raw)

        # the serial-decode contract follows decode_f's own declaration,
        # and its cache identity keys the column's fingerprint
        tr.thread_safe = bool(getattr(decode_f, "thread_safe", False))
        tr.cache_token = "decode:" + _callable_token(decode_f)
        col = files["fileData"].with_transform(
            tr, probe=(lambda p, raw: probe_f(raw)) if probe_f else None)
        return Frame({"image": col}, num_partitions=numPartition)
    structs = np.empty(len(files), dtype=object)
    structs[:] = [_decode_row(decode_f, origin, raw) for origin, raw
                  in zip(files["filePath"], files["fileData"])]
    return Frame({"image": structs}, num_partitions=numPartition)


def readImages(path, numPartition: int | None = None) -> Frame:
    """:func:`readImagesWithCustomFn` with :func:`default_decode` (libjpeg
    for JPEGs, PIL otherwise) and :func:`default_probe`, so
    ``readImages(...).dropna()`` decodes no dropped row."""
    return readImagesWithCustomFn(path, default_decode,
                                  numPartition=numPartition,
                                  probe_f=default_probe)
