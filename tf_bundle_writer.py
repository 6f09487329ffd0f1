"""Writes TF tensor bundles (``<prefix>.index`` + ``<prefix>.data-00000-of-00001``)
and a SavedModel's ``variables/`` without TensorFlow, in numpy.

``tpudl_torch`` reads bundles and writes none (neither does tpudl), so
this writer lives beside ``chip_smoke.py``, which uses it to give a
committed ``saved_model.pb`` seeded weights on a machine that has no
TensorFlow. The index is a LevelDB-format table: one uncompressed data
block (every entry a restart point), an empty metaindex block, an index
block with that data block's handle, and the 48-byte footer with the
table magic. Each entry is a ``BundleEntryProto`` whose ``crc32c`` is the
masked CRC-32C of the tensor's bytes (``tpudl_torch.native.crc``); a
string tensor is stored as TF stores one (varint lengths, their masked
checksum, then the bytes). ``tests/test_torch_tf_bundle.py`` holds the
output against ``tf.train.load_checkpoint`` and ``tf.saved_model.load``.

    write_saved_model_variables(saved_model_dir, keys, weights, object_graph)
"""

from __future__ import annotations

import os
import struct

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
_DTYPES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2,
           np.dtype(np.int32): 3, np.dtype(np.uint8): 4,
           np.dtype(np.int16): 5, np.dtype(np.int8): 6,
           np.dtype(np.int64): 9, np.dtype(np.bool_): 10,
           np.dtype(np.uint16): 17, np.dtype(np.float16): 19}
DT_STRING = 7


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    key = _varint((num << 3) | wire)
    if wire == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


def _shape_proto(shape) -> bytes:
    return b"".join(_field(2, 2, _field(1, 0, _varint(int(d))))
                    for d in shape)


def _crc(data: bytes, crc: int = 0) -> int:
    from tpudl_torch.native import crc as _c

    return _c.crc32c(data, crc)


def _masked(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _entry(dtype: int, shape, offset: int, size: int, crc: int) -> bytes:
    return (_field(1, 0, _varint(dtype)) + _field(2, 2, _shape_proto(shape))
            + _field(4, 0, _varint(offset)) + _field(5, 0, _varint(size))
            + _field(6, 5, struct.pack("<I", crc)))


def _block(entries) -> bytes:
    body, restarts = bytearray(), []
    for key, value in entries:
        restarts.append(len(body))
        body += _varint(0) + _varint(len(key)) + _varint(len(value))
        body += key + value
    if not restarts:
        restarts = [0]
    body += b"".join(struct.pack("<I", r) for r in restarts)
    body += struct.pack("<I", len(restarts))
    return bytes(body)


def _with_trailer(block: bytes) -> bytes:
    return block + b"\x00" + struct.pack("<I", _masked(_crc(block + b"\x00")))


def _string_tensor(values) -> tuple[bytes, int]:
    """TF's on-disk string tensor: lengths, their checksum, the bytes."""
    lengths = b"".join(_varint(len(v)) for v in values)
    # the checksum covers each length as a little-endian uint32
    crc = _crc(b"".join(struct.pack("<I", len(v)) for v in values))
    check = struct.pack("<I", _masked(crc))
    crc = _crc(check, crc)
    data = b"".join(values)
    return lengths + check + data, _crc(data, crc)


def write_bundle(prefix: str, tensors: dict) -> None:
    """``tensors``: {key: numpy array, or bytes for a scalar string}."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    entries = []
    offset = 0
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        for key in sorted(tensors, key=lambda k: k.encode("utf-8")):
            v = tensors[key]
            if isinstance(v, bytes):
                data, crc = _string_tensor([v])
                dtype, shape = DT_STRING, ()
            else:
                a = np.asarray(v, order="C")
                data = a.astype(a.dtype.newbyteorder("<")).tobytes()
                dtype, shape, crc = _DTYPES[a.dtype], a.shape, _crc(data)
            f.write(data)
            entries.append((key.encode("utf-8"), _entry(
                dtype, shape, offset, len(data), _masked(crc))))
            offset += len(data)
    header = _field(1, 0, _varint(1)) + _field(3, 2, _field(1, 0, _varint(1)))
    entries.insert(0, (b"", header))
    data_block = _block(entries)
    meta_block = _block([])
    out = bytearray(_with_trailer(data_block))
    meta_off = len(out)
    out += _with_trailer(meta_block)
    index_off = len(out)
    handle = _varint(0) + _varint(len(data_block))
    index_block = _block([(entries[-1][0], handle)])
    out += _with_trailer(index_block)
    footer = (_varint(meta_off) + _varint(len(meta_block))
              + _varint(index_off) + _varint(len(index_block)))
    footer += b"\x00" * (40 - len(footer)) + struct.pack("<Q", TABLE_MAGIC)
    out += footer
    with open(f"{prefix}.index", "wb") as f:
        f.write(bytes(out))


def write_saved_model_variables(saved_model_dir: str, keys: dict,
                                weights: dict, object_graph: bytes | None
                                ) -> str:
    """A SavedModel's ``variables/variables`` bundle: ``keys`` maps each
    bundle key to a Keras variable path of ``weights``; ``object_graph``
    is the export's ``_CHECKPOINTABLE_OBJECT_GRAPH`` (which TF's loader
    reads; the port does not). Returns the prefix."""
    tensors = {k: np.asarray(weights[path], np.float32)
               if np.asarray(weights[path]).dtype.kind == "f"
               else np.asarray(weights[path]) for k, path in keys.items()}
    if object_graph is not None:
        tensors["_CHECKPOINTABLE_OBJECT_GRAPH"] = object_graph
    prefix = os.path.join(saved_model_dir, "variables", "variables")
    write_bundle(prefix, tensors)
    return prefix
