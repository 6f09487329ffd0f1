"""TF's tensor bundles (checkpoints and SavedModel ``variables/``), read
without TensorFlow.

A bundle is ``<prefix>.index`` plus ``<prefix>.data-NNNNN-of-NNNNN``. The
index is a LevelDB-format table: a 48-byte footer (metaindex and index
block handles, then the magic ``0xdb4775248b80fb57``), an index block
whose values are handles of data blocks, and data blocks of
prefix-compressed keys with a restart array; each block carries a 5-byte
trailer (compression type, checksum). Key ``""`` holds the
``BundleHeaderProto``; every other key a ``BundleEntryProto`` (dtype,
shape, shard, offset, size, masked CRC-32C). :meth:`BundleReader.read`
checks each tensor's bytes against that checksum
(:mod:`tpudl_torch.native.crc`) and raises on a mismatch, as TF's restore
does. :func:`latest_checkpoint` reads a ``checkpoint`` state file.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

from tpudl_torch.ingest import protowire as pw
from tpudl_torch.native import crc as _crc

__all__ = ["BundleReader", "BundleError", "latest_checkpoint"]

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_SIZE = 48
BLOCK_TRAILER = 5


class BundleError(ValueError):
    """The bundle is malformed, corrupt, or of a kind not read here."""


def _varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _block(data: bytes, offset: int, size: int) -> bytes:
    if offset + size + BLOCK_TRAILER > len(data):
        raise BundleError("block handle runs past the end of the index")
    kind = data[offset + size]
    if kind != 0:
        raise BundleError(
            f"index block compressed with type {kind} (snappy or zlib); "
            "only uncompressed bundle indexes are read")
    return data[offset:offset + size]


def _entries(block: bytes):
    """(key, value) pairs of one table block, keys unshared."""
    if len(block) < 4:
        raise BundleError("table block shorter than its restart count")
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 - 4 * n_restarts
    if end < 0:
        raise BundleError("table block restart array runs past its start")
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        if shared > len(key) or pos + non_shared + vlen > end:
            raise BundleError("table block entry is malformed")
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + vlen]
        pos += vlen


def read_table(data: bytes) -> dict[bytes, bytes]:
    """Every key and value of a LevelDB-format table file, in key order."""
    if len(data) < FOOTER_SIZE:
        raise BundleError("index file shorter than its footer")
    footer = data[-FOOTER_SIZE:]
    (magic,) = struct.unpack_from("<Q", footer, FOOTER_SIZE - 8)
    if magic != TABLE_MAGIC:
        raise BundleError(f"bad table magic {magic:#x}")
    _meta_off, pos = _varint(footer, 0)
    _meta_size, pos = _varint(footer, pos)
    idx_off, pos = _varint(footer, pos)
    idx_size, pos = _varint(footer, pos)
    out = {}
    for _last, handle in _entries(_block(data, idx_off, idx_size)):
        off, p = _varint(handle, 0)
        size, _p = _varint(handle, p)
        for k, v in _entries(_block(data, off, size)):
            out[bytes(k)] = bytes(v)
    return out


class BundleReader:
    """One tensor bundle, opened by its prefix (``.../variables/variables``
    or ``.../model.ckpt-1000``)."""

    def __init__(self, prefix: str):
        self.prefix = os.fspath(prefix)
        try:
            with open(self.prefix + ".index", "rb") as f:
                table = read_table(f.read())
        except FileNotFoundError:
            raise BundleError(
                f"no tensor bundle at {self.prefix!r} (no .index)") from None
        if b"" not in table:
            raise BundleError("bundle index has no header entry")
        self.header = pw.parse("BundleHeaderProto", table.pop(b""))
        if self.header.endianness != 0:
            raise BundleError("big-endian bundles are not read")
        self.entries = {k.decode("utf-8"): pw.parse("BundleEntryProto", v)
                        for k, v in table.items()}

    def keys(self) -> list[str]:
        return sorted(self.entries)

    def __contains__(self, key) -> bool:
        return key in self.entries

    def _data_file(self, shard: int) -> str:
        n = max(1, self.header.num_shards)
        return f"{self.prefix}.data-{shard:05d}-of-{n:05d}"

    def raw(self, key: str) -> bytes:
        """The tensor's bytes, checked against the entry's CRC-32C."""
        e = self.entries.get(key)
        if e is None:
            raise KeyError(f"bundle {self.prefix!r} has no key {key!r}")
        if e.slices:
            raise BundleError(f"{key!r} is a partitioned (sliced) variable; "
                              "slices are not read")
        with open(self._data_file(e.shard_id), "rb") as f:
            f.seek(e.offset)
            data = f.read(e.size)
        if len(data) != e.size:
            raise BundleError(f"{key!r}: data file ends inside the tensor")
        got = _crc.masked(_crc.crc32c(data))
        if got != e.crc32c:
            raise BundleError(
                f"{key!r}: checksum mismatch (stored {e.crc32c:#010x}, "
                f"read {got:#010x}); the bundle's data file is corrupt")
        return data

    def read(self, key: str):
        """The tensor as a numpy array (bfloat16 as a torch tensor), after
        its checksum."""
        e = self.entries.get(key)
        if e is None:
            raise KeyError(f"bundle {self.prefix!r} has no key {key!r}")
        if e.dtype in (7, 20, 21):
            raise NotImplementedError(
                f"{key!r}: string, resource and variant bundle tensors are "
                "not read")
        t = pw.new("TensorProto", dtype=e.dtype, tensor_shape=e.shape,
                   tensor_content=self.raw(key))
        if not t.tensor_content:      # an empty tensor
            shape = pw.shape_of(e.shape)
            return np.zeros(shape, pw.np_dtype(e.dtype))
        return pw.make_ndarray(t)


_STATE_RE = re.compile(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"\s*$',
                       re.MULTILINE)


def latest_checkpoint(checkpoint_dir: str) -> str | None:
    """``tf.train.latest_checkpoint``: the prefix named by the text-format
    ``checkpoint`` state file in ``checkpoint_dir`` (relative paths are
    under that directory), or None."""
    state = os.path.join(checkpoint_dir, "checkpoint")
    try:
        with open(state, encoding="utf-8") as f:
            text = f.read()
    except FileNotFoundError:
        return None
    m = _STATE_RE.search(text)
    if m is None:
        return None
    path = m.group(1).encode("utf-8").decode("unicode_escape")
    if not os.path.isabs(path):
        path = os.path.join(checkpoint_dir, path)
    return path if os.path.exists(path + ".index") else None
