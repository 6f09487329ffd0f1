"""Host JPEG decoder bindings (ctypes over ``decode.cpp``).

Port of ``tpudl/native/__init__.py``: ``decode.cpp`` (copied from tpudl)
is a threaded libjpeg decode + bilinear resize into packed uint8 BGR. It
is host code, not a GPU kernel. The first call builds it with ``g++``
into ``tpudl_torch/_build/libtpudl_decode-<digest>.so`` (the digest
covers the source and the flags, so an edited source rebuilds); when no
compiler or libjpeg is there, :func:`available` is False and callers
decode with PIL, as tpudl's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

from tpudl_torch.testing import tsan as _tsan

__all__ = ["available", "decode_resize_batch", "build", "lib_path"]

log = logging.getLogger("tpudl_torch.native")

_SRC = Path(__file__).resolve().parent / "decode.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-ljpeg", "-lpthread")
_ABI_VERSION = 1
_lock = _tsan.named_lock("native.build")
_lib = None
_build_failed = False


def lib_path() -> Path:
    h = hashlib.sha1(" ".join(_FLAGS + _LIBS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libtpudl_decode-{h.hexdigest()[:16]}.so"


# tpudl: ignore[lock-held-blocking] — the one-shot native build: the
# lock EXISTS to hold everyone while one g++ subprocess (timeout=120)
# compiles; a second concurrent build would race the .so write
def build() -> bool:
    """Compile ``decode.cpp`` unless its library exists. Returns success.
    The library is written under a temporary name and renamed, so a
    concurrent reader never loads half a file."""
    lib = lib_path()
    if lib.exists():
        return True
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *_FLAGS, str(_SRC), *_LIBS, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native build unavailable: %r", e)
        return False
    if proc.returncode != 0:
        log.warning("native build failed:\n%s", proc.stderr[-2000:])
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib)
    return True


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(lib_path()))
        except OSError as e:
            log.warning("native lib load failed: %r", e)
            _build_failed = True
            return None
        lib.tpudl_native_abi_version.restype = ctypes.c_int
        lib.tpudl_native_abi_version.argtypes = []
        if lib.tpudl_native_abi_version() != _ABI_VERSION:
            log.warning("native library has another ABI version")
            _build_failed = True
            return None
        lib.tpudl_decode_resize_batch.restype = ctypes.c_int
        lib.tpudl_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
        ]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


# copied from tpudl/native/__init__.py:decode_resize_batch
def decode_resize_batch(blobs: list[bytes], height: int, width: int,
                        n_threads: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Decode a list of encoded JPEGs → ((N, H, W, 3) uint8 BGR batch, ok
    mask). Failed rows are zeroed with ok=False."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native decoder unavailable (no compiler or libjpeg); use the "
            "PIL path (tpudl_torch.image.imageIO)")
    n = len(blobs)
    out = np.zeros((n, height, width, 3), dtype=np.uint8)
    status = np.zeros((n,), dtype=np.uint8)
    if n == 0:
        return out, status.astype(bool)
    keepalive = [ctypes.create_string_buffer(b, len(b)) for b in blobs]
    datas = (ctypes.c_char_p * n)(
        *[ctypes.cast(buf, ctypes.c_char_p) for buf in keepalive])
    sizes = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    lib.tpudl_decode_resize_batch(
        datas, sizes, n, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(n_threads))
    return out, status.astype(bool)
