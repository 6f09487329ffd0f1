"""A reader and writer for the subset of HDF5 that Keras 3 writes.

A ``.keras`` file holds its weights in ``model.weights.h5``, written by
h5py with the library's earliest format: superblock version 0, version 1
object headers, groups as symbol tables (a version 1 B-tree of symbol
table nodes over a local heap), datasets stored contiguous and
uncompressed in little-endian IEEE floats or integers, and variable-length
UTF-8 string attributes in a global heap (the ``name`` of each ``vars``
group). This module reads and writes exactly that, with numpy and the
standard library only, so the port reads Keras files on a machine that
has neither h5py nor keras.

The tree is plain: a :class:`Group` has ``attrs`` and ``members`` (name →
:class:`Group` or :class:`Dataset`, in name order); a :class:`Dataset`
has ``value`` (a numpy array) and ``attrs``. :func:`read` parses bytes,
:func:`write` returns bytes.

Anything outside the subset raises :class:`UnsupportedHDF5Feature`
naming it (chunked, compact or filtered layouts, superblock version 2 or
later, version 2 object headers, link-message groups, shared messages,
variable-length datasets, big-endian or non-IEEE types, ...); a file that
breaks the format raises :class:`HDF5FormatError`. Nothing is guessed.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["Group", "Dataset", "read", "write", "HDF5FormatError",
           "UnsupportedHDF5Feature"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_HEAP_FREE_NULL = 1        # a local heap's "no free block" (libhdf5)
_LEAF_K = 4                # symbol table node: up to 2K entries
_INTERNAL_K = 16           # group B-tree node: up to 2K children
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_TREE_SIZE = 24 + 2 * _INTERNAL_K * 8 + (2 * _INTERNAL_K + 1) * 8
_GCOL_MIN = 4096

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0, 1, 2, 3, 4, 5
_LINK, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 6, 8, 10, 11, 12
_MTIME_OLD, _CONTINUATION, _SYMTAB, _MTIME = 14, 16, 17, 18
_ATTR_INFO, _REFCOUNT = 21, 22
_IGNORED = {_NIL, _FILL_OLD, _FILL, _MTIME_OLD, _MTIME}


class HDF5FormatError(ValueError):
    """The bytes are not a well-formed HDF5 file."""


class UnsupportedHDF5Feature(NotImplementedError):
    """The file uses an HDF5 feature outside the subset Keras writes."""

    def __init__(self, feature: str):
        super().__init__(
            f"HDF5 feature not supported by tpudl_torch.ingest.hdf5: "
            f"{feature}")
        self.feature = feature


class Group:
    def __init__(self, members=None, attrs=None):
        self.members = dict(members or {})
        self.attrs = dict(attrs or {})

    def __getitem__(self, path: str):
        node = self
        for part in path.strip("/").split("/"):
            if not isinstance(node, Group) or part not in node.members:
                raise KeyError(path)
            node = node.members[part]
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __repr__(self):
        return f"Group({sorted(self.members)}, attrs={self.attrs})"


class Dataset:
    def __init__(self, value, attrs=None):
        self.value = np.asarray(value)
        self.attrs = dict(attrs or {})

    def __repr__(self):
        return (f"Dataset(shape={self.value.shape}, "
                f"dtype={self.value.dtype}, attrs={self.attrs})")


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# -- reading ---------------------------------------------------------------
class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self._gcol: dict[int, dict[int, bytes]] = {}

    def unpack(self, fmt, off):
        try:
            return struct.unpack_from("<" + fmt, self.buf, off)
        except struct.error as e:
            raise HDF5FormatError(f"truncated file at offset {off}") from e

    def sig(self, off, want: bytes, what: str):
        if bytes(self.buf[off:off + 4]) != want:
            raise HDF5FormatError(f"no {what} signature at offset {off}")

    def superblock(self) -> int:
        if bytes(self.buf[:8]) != _SIGNATURE:
            raise HDF5FormatError(
                "no HDF5 signature at offset 0 (a user block is not "
                "supported either)")
        version, = self.unpack("B", 8)
        if version >= 2:
            raise UnsupportedHDF5Feature(f"superblock version {version}")
        osize, lsize = self.unpack("BB", 13)
        if (osize, lsize) != (8, 8):
            raise UnsupportedHDF5Feature(
                f"{osize}-byte offsets and {lsize}-byte lengths")
        off = 24 + (4 if version == 1 else 0)
        base, = self.unpack("Q", off)
        if base != 0:
            raise UnsupportedHDF5Feature(f"base address {base}")
        _name, header, _cache, _r = self.unpack("QQII", off + 32)
        return header

    def messages(self, addr):
        """``[(type, flags, data view)]`` of the object header at ``addr``,
        continuation blocks followed."""
        if bytes(self.buf[addr:addr + 4]) == b"OHDR":
            raise UnsupportedHDF5Feature("version 2 object headers")
        version, _r, count, _refs, size = self.unpack("BBHII", addr)
        if version != 1:
            raise HDF5FormatError(
                f"object header version {version} at offset {addr}")
        out = []
        blocks = [(addr + 16, size)]
        while blocks:
            pos, length = blocks.pop(0)
            end = pos + length
            while pos + 8 <= end:
                mtype, msize, flags = self.unpack("HHB", pos)
                data = self.buf[pos + 8:pos + 8 + msize]
                if mtype == _CONTINUATION:
                    blocks.append(self.unpack("QQ", pos + 8))
                elif mtype != _NIL:
                    if flags & 0x02:
                        raise UnsupportedHDF5Feature(
                            f"shared object header message (type {mtype})")
                    out.append((mtype, flags, data))
                pos += 8 + msize
        if len(out) > count:
            raise HDF5FormatError(f"object header at {addr}: more messages "
                                  f"than its count {count}")
        return out

    def node(self, addr):
        msgs = self.messages(addr)
        types = {t for t, _f, _d in msgs}
        for t in types:
            if t in (_LINK_INFO, _LINK, _GROUP_INFO):
                raise UnsupportedHDF5Feature(
                    "link-message groups (compact or dense new-style groups)")
            if t == _FILTERS:
                raise UnsupportedHDF5Feature(
                    "filter pipeline (compressed or filtered data)")
            if t == _ATTR_INFO:
                raise UnsupportedHDF5Feature("dense attribute storage")
            if t not in _IGNORED | {_DATASPACE, _DATATYPE, _LAYOUT,
                                    _ATTRIBUTE, _SYMTAB, _REFCOUNT}:
                raise UnsupportedHDF5Feature(
                    f"object header message type {t:#x}")
        attrs = {}
        for t, _f, d in msgs:
            if t == _ATTRIBUTE:
                name, value = self.attribute(d)
                attrs[name] = value
        if _SYMTAB in types:
            data = next(d for t, _f, d in msgs if t == _SYMTAB)
            btree, heap = struct.unpack_from("<QQ", data)
            return Group(self.group_members(btree, heap), attrs)
        if _LAYOUT not in types:
            raise UnsupportedHDF5Feature(
                f"object at offset {addr} is neither a group nor a dataset "
                "(committed datatype?)")
        get = {t: d for t, _f, d in msgs}
        dtype = self.datatype(get[_DATATYPE], what="dataset")
        shape = self.dataspace(get[_DATASPACE])
        return Dataset(self.layout(get[_LAYOUT], dtype, shape), attrs)

    # groups
    def local_heap(self, addr) -> bytes:
        self.sig(addr, b"HEAP", "local heap")
        version, = self.unpack("B", addr + 4)
        if version != 0:
            raise HDF5FormatError(f"local heap version {version}")
        size, _free, data = self.unpack("QQQ", addr + 8)
        return bytes(self.buf[data:data + size])

    @staticmethod
    def heap_name(heap: bytes, off: int) -> str:
        end = heap.find(b"\0", off)
        if end < 0:
            raise HDF5FormatError("unterminated name in a local heap")
        return heap[off:end].decode("utf-8")

    def group_members(self, btree, heap_addr):
        heap = self.local_heap(heap_addr)
        members = {}
        for snod in self.btree_leaves(btree):
            self.sig(snod, b"SNOD", "symbol table node")
            version, _r, n = self.unpack("BBH", snod + 4)
            if version != 1:
                raise HDF5FormatError(f"symbol table node version {version}")
            for i in range(n):
                name_off, header = self.unpack("QQ", snod + 8 + 40 * i)
                members[self.heap_name(heap, name_off)] = self.node(header)
        return dict(sorted(members.items()))

    def btree_leaves(self, addr):
        """The symbol table node addresses under a group B-tree."""
        self.sig(addr, b"TREE", "B-tree node")
        ntype, level, used = self.unpack("BBH", addr + 4)
        if ntype != 0:
            raise HDF5FormatError(f"B-tree node type {ntype} in a group")
        children = [self.unpack("Q", addr + 24 + 8 + 16 * i)[0]
                    for i in range(used)]
        if level == 0:
            return children
        return [leaf for c in children for leaf in self.btree_leaves(c)]

    # datasets and attributes
    def dataspace(self, d):
        version, rank, flags = struct.unpack_from("<BBB", d)
        if version == 1:
            off = 8
        elif version == 2:
            if d[3] == 2:
                raise UnsupportedHDF5Feature("null dataspace")
            off = 4
        else:
            raise HDF5FormatError(f"dataspace message version {version}")
        if flags & 0x02:
            raise UnsupportedHDF5Feature("dataspace permutation indices")
        return tuple(struct.unpack_from(f"<{rank}Q", d, off))

    def datatype(self, d, *, what):
        """A numpy dtype, or the marker ``"vlen-str"`` for an attribute's
        variable-length string."""
        cv, b0, b1, _b2, size = struct.unpack_from("<BBBBI", d)
        cls, version = cv & 0x0F, cv >> 4
        if version not in (1, 2, 3):
            raise HDF5FormatError(f"datatype message version {version}")
        if cls == 0:                                    # fixed-point
            if b0 & 0x01:
                raise UnsupportedHDF5Feature("big-endian integers")
            if size not in (1, 2, 4, 8):
                raise UnsupportedHDF5Feature(f"{size}-byte integers")
            return np.dtype(f"<{'i' if b0 & 0x08 else 'u'}{size}")
        if cls == 1:                                    # floating-point
            if b0 & 0x41:
                raise UnsupportedHDF5Feature("big-endian or VAX floats")
            ieee = {4: (31, 32, 23, 8, 0, 23, 127),
                    8: (63, 64, 52, 11, 0, 52, 1023)}
            props = struct.unpack_from("<HHBBBBI", d, 8)
            if size not in ieee or (b1, *props[1:]) != ieee[size] or \
                    props[0] != 0:
                raise UnsupportedHDF5Feature(
                    f"{size}-byte float that is not IEEE binary32/64")
            return np.dtype(f"<f{size}")
        if cls == 3:                                    # fixed string
            if what != "attribute":
                raise UnsupportedHDF5Feature("string datasets")
            return np.dtype(f"S{size}")
        if cls == 9:                                    # variable-length
            if what != "attribute":
                raise UnsupportedHDF5Feature("variable-length data")
            if b0 & 0x0F != 1:
                raise UnsupportedHDF5Feature(
                    "variable-length sequences other than strings")
            return "vlen-str"
        names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enumerated", 10: "array"}
        raise UnsupportedHDF5Feature(
            f"{names.get(cls, f'class {cls}')} datatype")

    def layout(self, d, dtype, shape):
        version, cls = struct.unpack_from("<BB", d)
        if version != 3:
            raise UnsupportedHDF5Feature(
                f"data layout message version {version}")
        if cls != 1:
            raise UnsupportedHDF5Feature(
                {0: "compact layout", 2: "chunked layout"}.get(
                    cls, f"layout class {cls}"))
        addr, size = struct.unpack_from("<QQ", d, 2)
        n = int(np.prod(shape, dtype=np.int64))
        if addr == _UNDEF:           # never written: the fill value, 0
            return np.zeros(shape, dtype)
        if size != n * dtype.itemsize:
            raise HDF5FormatError(
                f"contiguous storage of {size} bytes for {shape} {dtype}")
        if addr + size > len(self.buf):
            raise HDF5FormatError("dataset storage past the end of file")
        return np.frombuffer(self.buf, dtype, n, addr).reshape(shape).copy()

    def attribute(self, d):
        version, = struct.unpack_from("<B", d)
        if version == 1:
            _r, nsize, tsize, ssize = struct.unpack_from("<BHHH", d, 1)
            off, pad = 8, _pad8
        elif version in (2, 3):
            flags, nsize, tsize, ssize = struct.unpack_from("<BHHH", d, 1)
            if flags:
                raise UnsupportedHDF5Feature("shared attribute datatype")
            off, pad = (8 if version == 2 else 9), (lambda n: n)
        else:
            raise HDF5FormatError(f"attribute message version {version}")
        name = bytes(d[off:off + nsize]).rstrip(b"\0").decode("utf-8")
        off += pad(nsize)
        dtype = self.datatype(d[off:off + tsize], what="attribute")
        off += pad(tsize)
        shape = self.dataspace(d[off:off + ssize])
        off += pad(ssize)
        n = int(np.prod(shape, dtype=np.int64))
        if dtype == "vlen-str":
            vals = []
            for i in range(n):
                length, coll, idx = struct.unpack_from("<IQI", d,
                                                       off + 16 * i)
                vals.append(self.global_object(coll, idx)[:length]
                            .decode("utf-8"))
            value = vals[0] if shape == () else np.array(
                vals, dtype=object).reshape(shape)
        else:
            arr = np.frombuffer(d, dtype, n, off).reshape(shape).copy()
            if dtype.kind == "S":
                arr = np.char.decode(np.char.rstrip(arr, b"\0"), "utf-8")
            value = arr[()] if shape == () else arr
        return name, value

    def global_object(self, addr, index) -> bytes:
        if addr not in self._gcol:
            self.sig(addr, b"GCOL", "global heap")
            size, = self.unpack("Q", addr + 8)
            objs, pos, end = {}, addr + 16, addr + size
            while pos + 16 <= end:
                idx, _refs, _r, osize = self.unpack("HHIQ", pos)
                if idx == 0:
                    break
                objs[idx] = bytes(self.buf[pos + 16:pos + 16 + osize])
                pos += 16 + _pad8(osize)
            self._gcol[addr] = objs
        try:
            return self._gcol[addr][index]
        except KeyError:
            raise HDF5FormatError(
                f"no object {index} in the global heap at {addr}") from None


def read(buf) -> Group:
    """Parse an HDF5 file's bytes into its root :class:`Group`."""
    r = _Reader(buf)
    return r.node(r.superblock())


# -- writing ---------------------------------------------------------------
_F32_TYPE = struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 31, 0, 4,
                        0, 32, 23, 8, 0, 23, 127)
_F64_TYPE = struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 63, 0, 8,
                        0, 64, 52, 11, 0, 52, 1023)
# variable-length UTF-8 string over 1-byte unsigned integers, as h5py
_VLEN_STR_TYPE = (struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16)
                  + struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8))
_FILL_MSG = bytes([2, 2, 2, 1, 0, 0, 0, 0])     # h5py's fill value message


def _type_message(dtype: np.dtype) -> bytes:
    if dtype == np.float32:
        return _F32_TYPE
    if dtype == np.float64:
        return _F64_TYPE
    if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8):
        bits = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, dtype.itemsize,
                           0, 8 * dtype.itemsize)
    raise UnsupportedHDF5Feature(f"writing {dtype} data")


def _space_message(shape) -> bytes:
    rank = len(shape)
    flags = 1 if rank else 0             # max dims = dims, as h5py
    dims = struct.pack(f"<{rank}Q", *shape)
    return struct.pack("<BBBB4x", 1, rank, flags, 0) + dims + (
        dims if rank else b"")


class _Writer:
    def __init__(self):
        self.out = bytearray(96)             # the superblock, filled last
        self.strings: list[bytes] = []       # global heap objects, 1-based
        self.gcol_fixups: list[int] = []     # where to put its address

    def alloc(self, data: bytes) -> int:
        addr = len(self.out)
        self.out += data
        self.out += b"\0" * (_pad8(len(data)) - len(data))
        return addr

    def header(self, messages) -> int:
        body = bytearray()
        fixups = []
        for mtype, flags, data in messages:
            if isinstance(data, tuple):      # an attribute's vlen string
                data, at = data
                fixups.append(len(body) + 8 + at)
            size = _pad8(len(data))
            body += struct.pack("<HHB3x", mtype, size, flags)
            body += data + b"\0" * (size - len(data))
        head = struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body))
        addr = self.alloc(head + bytes(body))
        self.gcol_fixups += [addr + 16 + f for f in fixups]
        return addr

    def attribute(self, name: str, value) -> tuple:
        nbytes = name.encode("utf-8") + b"\0"
        if isinstance(value, str):
            tmsg, smsg = _VLEN_STR_TYPE, _space_message(())
            s = value.encode("utf-8")
            self.strings.append(s)
            data = struct.pack("<IQI", len(s), 0, len(self.strings))
            at = None
        else:
            arr = np.asarray(value)
            if arr.dtype.kind == "U":
                raise UnsupportedHDF5Feature(
                    "writing non-scalar string attributes")
            arr = arr.astype(arr.dtype.newbyteorder("<"))
            tmsg, smsg = _type_message(arr.dtype), _space_message(arr.shape)
            data = arr.tobytes()
        msg = (struct.pack("<BBHHH", 1, 0, len(nbytes), len(tmsg), len(smsg))
               + nbytes.ljust(_pad8(len(nbytes)), b"\0")
               + tmsg.ljust(_pad8(len(tmsg)), b"\0")
               + smsg.ljust(_pad8(len(smsg)), b"\0"))
        if isinstance(value, str):
            at = len(msg) + 4                # the heap ID's address field
            return _ATTRIBUTE, 0, (msg + data, at)
        return _ATTRIBUTE, 0, msg + data

    def attr_messages(self, attrs):
        return [self.attribute(k, v) for k, v in attrs.items()]

    def dataset(self, ds: Dataset) -> int:
        arr = np.ascontiguousarray(ds.value)
        arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        tmsg = _type_message(arr.dtype)
        if arr.nbytes:
            addr = self.alloc(arr.tobytes())
        else:
            addr = _UNDEF
        layout = struct.pack("<BBQQ", 3, 1, addr, arr.nbytes)
        return self.header([(_DATASPACE, 0, _space_message(arr.shape)),
                            (_DATATYPE, 1, tmsg),
                            (_FILL, 1, _FILL_MSG),
                            (_LAYOUT, 0, layout)]
                           + self.attr_messages(ds.attrs))

    def group(self, g: Group) -> tuple[int, int, int]:
        """``(header, btree, heap)`` addresses of a written group."""
        entries = []
        for name in sorted(g.members, key=lambda n: n.encode("utf-8")):
            child = g.members[name]
            if isinstance(child, Group):
                addr = self.group(child)[0]
            elif isinstance(child, Dataset):
                addr = self.dataset(child)
            else:
                raise TypeError(f"{name!r}: not a Group or Dataset")
            entries.append((name.encode("utf-8"), addr))
        # local heap: "" at offset 0, then each name
        heap = bytearray(8)
        offsets = []
        for name, _a in entries:
            offsets.append(len(heap))
            heap += name + b"\0"
            heap += b"\0" * (_pad8(len(heap)) - len(heap))
        heap_data = self.alloc(bytes(heap))
        heap_addr = self.alloc(struct.pack("<4sB3xQQQ", b"HEAP", 0,
                                           len(heap), _HEAP_FREE_NULL,
                                           heap_data))
        # symbol table nodes of up to 2K entries, then the B-tree levels
        per = 2 * _LEAF_K
        nodes = []          # (address, heap offset of its last name)
        for i in range(0, len(entries), per):
            chunk = list(zip(offsets[i:i + per], entries[i:i + per]))
            body = bytearray(struct.pack("<4sBBH", b"SNOD", 1, 0,
                                         len(chunk)))
            for off, (_n, addr) in chunk:
                body += struct.pack("<QQII16x", off, addr, 0, 0)
            body += b"\0" * (_SNOD_SIZE - len(body))
            nodes.append((self.alloc(bytes(body)), chunk[-1][0]))
        level = 0
        while True:     # an empty group gets one B-tree node, no children
            parents = []
            fan = 2 * _INTERNAL_K
            for i in range(0, max(len(nodes), 1), fan):
                kids = nodes[i:i + fan]
                body = bytearray(struct.pack("<4sBBHQQ", b"TREE", 0, level,
                                             len(kids), _UNDEF, _UNDEF))
                body += struct.pack("<Q", 0)
                for addr, last in kids:
                    body += struct.pack("<QQ", addr, last)
                body += b"\0" * (_TREE_SIZE - len(body))
                parents.append((self.alloc(bytes(body)),
                                kids[-1][1] if kids else 0))
            nodes, level = parents, level + 1
            if len(nodes) == 1:
                break
        btree = nodes[0][0]
        header = self.header(
            [(_SYMTAB, 0, struct.pack("<QQ", btree, heap_addr))]
            + self.attr_messages(g.attrs))
        return header, btree, heap_addr

    def global_heap(self):
        if not self.strings:
            return
        body = bytearray()
        for i, s in enumerate(self.strings, 1):
            body += struct.pack("<HHIQ", i, 0, 0, len(s))
            body += s + b"\0" * (_pad8(len(s)) - len(s))
        size = max(_GCOL_MIN, 16 + len(body))
        free = size - 16 - len(body)
        if free >= 16:
            body += struct.pack("<HHIQ", 0, 0, 0, free) + b"\0" * (free - 16)
        else:
            body += b"\0" * free
        addr = self.alloc(struct.pack("<4sB3xQ", b"GCOL", 1, size)
                          + bytes(body))
        for at in self.gcol_fixups:
            struct.pack_into("<Q", self.out, at, addr)


def write(root: Group) -> bytes:
    """Serialize a :class:`Group` tree as an HDF5 file in the format Keras
    (through h5py) writes: superblock 0, version 1 object headers,
    symbol-table groups, contiguous datasets."""
    w = _Writer()
    header, btree, heap = w.group(root)
    w.global_heap()
    sb = (_SIGNATURE
          + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                        _LEAF_K, _INTERNAL_K, 0)
          + struct.pack("<QQQQ", 0, _UNDEF, len(w.out), _UNDEF)
          + struct.pack("<QQII", 0, header, 1, 0)
          + struct.pack("<QQ", btree, heap))
    w.out[:96] = sb
    return bytes(w.out)
