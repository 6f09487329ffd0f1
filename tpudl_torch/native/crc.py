"""CRC-32C, the checksum of TF's tensor bundles.

``crc32c.cpp`` (slicing by 8) is built with ``g++`` at first use into
``tpudl_torch/_build/libtpudl_crc32c-<digest>.so`` and bound with ctypes,
as ``decode.cpp`` is. Plain Python runs about 10 MB/s, and a full-width
InceptionV3 bundle holds 174.5 MB, so a failed build raises rather than
falling back: the check is never skipped. :func:`crc32c_plain` is the
table version in Python that the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["crc32c", "crc32c_plain", "masked", "build", "lib_path"]

_SRC = Path(__file__).resolve().parent / "crc32c.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_ABI_VERSION = 1
_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libtpudl_crc32c-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``crc32c.cpp`` unless its library exists; raise on failure.
    The library is written under a temporary name and renamed, so a
    concurrent reader never loads half a file."""
    lib = lib_path()
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build the CRC-32C library: {e!r}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("cannot build the CRC-32C library:\n"
                           + proc.stderr[-2000:])
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tpudl_crc_abi_version.restype = ctypes.c_int
            if lib.tpudl_crc_abi_version() != _ABI_VERSION:
                raise RuntimeError("CRC-32C library has another ABI version")
            lib.tpudl_crc32c_extend.restype = ctypes.c_uint32
            lib.tpudl_crc32c_extend.argtypes = [
                ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
            _lib = lib
    return _lib


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of ``data`` (bytes-like), extending ``crc``."""
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(_load().tpudl_crc32c_extend(
        crc, buf.ctypes.data if buf.size else None, buf.size))


_TABLE = []
for _i in range(256):
    _c = _i
    for _k in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _TABLE.append(_c)


def crc32c_plain(data, crc: int = 0) -> int:
    """The same checksum, a byte at a time in Python."""
    c = crc ^ 0xFFFFFFFF
    for b in bytes(data):
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked(crc: int) -> int:
    """LevelDB's masked form of a CRC, as bundles store it."""
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
