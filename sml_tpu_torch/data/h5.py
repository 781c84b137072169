"""A reader of one dataset from an HDF5 file, on numpy and the standard library.

The cohort readers take each slide's features from ``{id}.h5`` (dataset
``Res_feature``).  This module reads the file format that h5py writes with
its default ``libver`` ("earliest"), and nothing else:

- superblock version 0 or 1, at offset 0 (no user block);
- groups with a symbol table: v1 B-tree group nodes of any depth, ``SNOD``
  nodes and a local heap;
- version-1 object headers, with continuation messages;
- the dataspace message, versions 1 and 2;
- the datatype message: IEEE float of 2, 4 or 8 bytes in either byte order;
- the layout message, version 3: contiguous (one ``np.fromfile`` at its
  offset) or chunked (a v1 B-tree of chunks, edge chunks clipped; unwritten
  chunks take the value of the version-2 fill value message);
- the filter pipeline: deflate (``zlib``), shuffle and fletcher32 (the
  checksum is checked, then stripped).

Anything else (the version-2/3 superblocks and object headers of
``libver="latest"``, compact layouts, other datatypes or filters) raises
``NotImplementedError`` or ``ValueError`` naming what it met.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Dict, List, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types read here
MSG_DATASPACE, MSG_DATATYPE = 0x1, 0x3
MSG_FILL, MSG_LAYOUT = 0x5, 0x8
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xB, 0x10, 0x11
MSG_LINK, MSG_LINK_INFO = 0x6, 0x2

FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf",
                 32001: "blosc", 32004: "lz4", 32015: "zstd"}
# IEEE (exponent bits, mantissa bits) by byte size
_IEEE = {2: (5, 10), 4: (8, 23), 8: (11, 52)}


def read(path: str, name: str) -> np.ndarray:
    """The whole dataset ``name`` ('/'-separated from the root group) of the
    HDF5 file ``path``, in its stored dtype (as h5py's ``f[name][:]``)."""
    with open(path, "rb") as f:
        return _File(f, path).read(name)


class _File:
    def __init__(self, f: BinaryIO, path: str):
        self.f, self.path = f, path
        if f.read(8) != SIGNATURE:
            raise ValueError(f"{path}: no HDF5 signature at offset 0 (a file with a "
                             "user block is not read)")
        self.base = 0
        self._superblock()

    # --- raw access -------------------------------------------------------

    def _at(self, addr: int, n: int) -> bytes:
        self.f.seek(self.base + addr)
        data = self.f.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated file (wanted {n} bytes at "
                             f"{self.base + addr})")
        return data

    def _superblock(self) -> None:
        head = self._at(8, 16)
        version = head[0]
        if version not in (0, 1):
            raise NotImplementedError(
                f"{self.path}: HDF5 superblock version {version} (written with "
                "libver='latest' or 'v108'+); only versions 0 and 1 are read")
        if head[5] != 8 or head[6] != 8:
            raise NotImplementedError(f"{self.path}: offsets of {head[5]} / lengths of "
                                      f"{head[6]} bytes (only 8 / 8 are read)")
        pos = 24 + (4 if version == 1 else 0)
        base = struct.unpack("<Q", self._at(pos, 8))[0]
        root = struct.unpack_from("<Q", self._at(pos + 32, 16), 8)[0]
        # every other address is relative to the base address
        self.base, self.root = base, root

    def _symbol_entry(self, addr: int) -> Tuple[int, int]:
        """(link name offset, object header address) of a symbol table entry."""
        return struct.unpack("<QQ", self._at(addr, 16))

    # --- object headers ---------------------------------------------------

    def _messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """[(type, flags, body)] of the version-1 object header at ``addr``."""
        prefix = self._at(addr, 16)
        if prefix[:4] == b"OHDR":
            raise NotImplementedError(f"{self.path}: version-2 object header (libver "
                                      "'latest'); only version 1 is read")
        if prefix[0] != 1:
            raise NotImplementedError(f"{self.path}: object header version {prefix[0]}")
        n_msgs, _refs, size = struct.unpack_from("<HII", prefix, 2)
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < n_msgs:
            start, length = blocks.pop(0)
            raw, pos = self._at(start, length), 0
            while pos + 8 <= length and len(out) < n_msgs:
                mtype, msize, mflags = struct.unpack_from("<HHB", raw, pos)
                body = raw[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == MSG_CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body))
                out.append((mtype, mflags, body))
        return out

    # --- groups -----------------------------------------------------------

    def _lookup(self, group_addr: int, name: str) -> int:
        for mtype, _, body in self._messages(group_addr):
            if mtype == MSG_SYMBOL_TABLE:
                btree, heap = struct.unpack_from("<QQ", body)
                names = self._heap(heap)
                for name_off, obj in self._group_entries(btree):
                    if _cstr(names, name_off) == name:
                        return obj
                raise KeyError(f"{self.path}: no object {name!r}")
            if mtype in (MSG_LINK, MSG_LINK_INFO):
                raise NotImplementedError(f"{self.path}: group with link messages "
                                          "(new-style group); only symbol tables are read")
        raise ValueError(f"{self.path}: object at {group_addr} is not a group")

    def _heap(self, addr: int) -> bytes:
        head = self._at(addr, 32)
        if head[:4] != b"HEAP":
            raise ValueError(f"{self.path}: bad local heap signature at {addr}")
        size, _free, data = struct.unpack_from("<QQQ", head, 8)
        return self._at(data, size)

    def _btree_node(self, addr: int, node_type: int):
        head = self._at(addr, 24)
        if head[:4] != b"TREE":
            raise ValueError(f"{self.path}: bad B-tree signature at {addr}")
        if head[4] != node_type:
            raise ValueError(f"{self.path}: B-tree node type {head[4]} at {addr}, "
                             f"expected {node_type}")
        return head[5], struct.unpack_from("<H", head, 6)[0]

    def _group_entries(self, addr: int) -> List[Tuple[int, int]]:
        level, n = self._btree_node(addr, 0)
        raw = self._at(addr + 24, n * 16 + 8)
        children = [struct.unpack_from("<Q", raw, 8 + 16 * i)[0] for i in range(n)]
        if level > 0:
            return [e for c in children for e in self._group_entries(c)]
        entries = []
        for snod in children:
            head = self._at(snod, 8)
            if head[:4] != b"SNOD":
                raise ValueError(f"{self.path}: bad symbol node signature at {snod}")
            count = struct.unpack_from("<H", head, 6)[0]
            entries += [self._symbol_entry(snod + 8 + 40 * i) for i in range(count)]
        return entries

    # --- datasets ---------------------------------------------------------

    def read(self, name: str) -> np.ndarray:
        addr = self.root
        for part in [p for p in name.split("/") if p]:
            addr = self._lookup(addr, part)
        msgs = {}
        for mtype, mflags, body in self._messages(addr):
            if mflags & 0x2 and mtype in (MSG_DATASPACE, MSG_DATATYPE, MSG_LAYOUT,
                                          MSG_FILTERS):
                raise NotImplementedError(f"{self.path}: shared message of type {mtype}")
            msgs.setdefault(mtype, body)
        if MSG_LAYOUT not in msgs or MSG_DATATYPE not in msgs:
            raise ValueError(f"{self.path}: {name!r} is not a dataset")
        shape = _dataspace(msgs[MSG_DATASPACE])
        dtype = _datatype(msgs[MSG_DATATYPE])
        filters = _filters(msgs[MSG_FILTERS]) if MSG_FILTERS in msgs else []
        layout = msgs[MSG_LAYOUT]
        if layout[0] != 3:
            raise NotImplementedError(f"{self.path}: layout message version {layout[0]}")
        if layout[1] == 1:
            return self._contiguous(name, layout, shape, dtype)
        if layout[1] == 2:
            fill = _fill_value(msgs, dtype)
            return self._chunked(layout, shape, dtype, filters, fill)
        kind = {0: "compact"}.get(layout[1], f"class {layout[1]}")
        raise NotImplementedError(f"{self.path}: {kind} layout (only contiguous and "
                                  "chunked are read)")

    def _contiguous(self, name, layout, shape, dtype) -> np.ndarray:
        addr, size = struct.unpack_from("<QQ", layout, 2)
        count = int(np.prod(shape, dtype=np.int64))
        if addr == UNDEF:
            raise ValueError(f"{self.path}: dataset {name!r} was never written")
        if size != count * dtype.itemsize:
            raise ValueError(f"{self.path}: contiguous size {size} != {count} x "
                             f"{dtype.itemsize}")
        data = np.fromfile(self.path, dtype=dtype, count=count, offset=self.base + addr)
        if data.size != count:
            raise ValueError(f"{self.path}: truncated dataset {name!r}")
        return data.reshape(shape)

    def _chunked(self, layout, shape, dtype, filters, fill) -> np.ndarray:
        ndims = layout[2]
        btree = struct.unpack_from("<Q", layout, 3)[0]
        cdims = struct.unpack_from(f"<{ndims}I", layout, 11)
        chunk = tuple(cdims[:-1])
        if len(chunk) != len(shape) or cdims[-1] != dtype.itemsize:
            raise ValueError(f"{self.path}: chunk dims {cdims} for shape {shape}")
        out = np.full(shape, fill, dtype=dtype)
        if btree == UNDEF:
            return out
        nbytes = int(np.prod(chunk, dtype=np.int64)) * dtype.itemsize
        for offsets, size, mask, addr in self._chunk_entries(btree, ndims):
            raw = _unfilter(self._at(addr, size), filters, mask, self.path)
            if len(raw) != nbytes:
                raise ValueError(f"{self.path}: chunk at {addr} holds {len(raw)} bytes, "
                                 f"expected {nbytes}")
            block = np.frombuffer(raw, dtype=dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _chunk_entries(self, addr: int, ndims: int):
        """[(element offsets, stored size, filter mask, address)] of every chunk
        under the type-1 B-tree node at ``addr``."""
        level, n = self._btree_node(addr, 1)
        key = 8 + 8 * ndims
        raw = self._at(addr + 24, n * (key + 8) + key)
        entries = []
        for i in range(n):
            k = i * (key + 8)
            size, mask = struct.unpack_from("<II", raw, k)
            offsets = struct.unpack_from(f"<{ndims}Q", raw, k + 8)[:-1]
            child = struct.unpack_from("<Q", raw, k + key)[0]
            if level > 0:
                entries += self._chunk_entries(child, ndims)
            else:
                entries.append((offsets, size, mask, child))
        return entries


def _cstr(heap: bytes, off: int) -> str:
    return heap[off:heap.index(b"\0", off)].decode()


def _dataspace(body: bytes) -> Tuple[int, ...]:
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        dims_at = 8
    elif version == 2:
        if body[3] == 2:
            raise NotImplementedError("null dataspace")
        dims_at = 4
    else:
        raise NotImplementedError(f"dataspace message version {version}")
    if version == 1 and flags & 0x2:
        raise NotImplementedError("dataspace with a permutation index")
    return struct.unpack_from(f"<{rank}Q", body, dims_at)


def _datatype(body: bytes) -> np.dtype:
    cls, version = body[0] & 0x0F, body[0] >> 4
    names = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string",
             4: "bitfield", 5: "opaque", 6: "compound", 7: "reference", 8: "enum",
             9: "variable-length", 10: "array"}
    if cls != 1:
        raise NotImplementedError(f"datatype class {cls} ({names.get(cls, '?')}); "
                                  "only IEEE floats are read")
    bits0, _bits1, _bits2 = body[1], body[2], body[3]
    size = struct.unpack_from("<I", body, 4)[0]
    if bits0 & 0x40:
        raise NotImplementedError("VAX-order float")
    offset, precision, _eloc, esize, _mloc, msize = struct.unpack_from("<HHBBBB", body, 8)
    if size not in _IEEE or offset != 0 or precision != 8 * size or \
            (esize, msize) != _IEEE[size]:
        raise NotImplementedError(f"float of {size} bytes, precision {precision}, "
                                  f"exponent {esize} / mantissa {msize} bits (not IEEE "
                                  f"half / single / double; datatype version {version})")
    return np.dtype(f"{'>' if bits0 & 0x1 else '<'}f{size}")


def _filters(body: bytes) -> List[Tuple[int, str, Tuple[int, ...]]]:
    """[(filter id, name, client data)] of a filter pipeline message."""
    version, count = body[0], body[1]
    if version not in (1, 2):
        raise NotImplementedError(f"filter pipeline message version {version}")
    pos, out = (8 if version == 1 else 2), []
    for _ in range(count):
        fid, = struct.unpack_from("<H", body, pos)
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len, = struct.unpack_from("<H", body, pos)
            pos += 2
        _flags, n_values = struct.unpack_from("<HH", body, pos)
        pos += 4
        name = body[pos:pos + name_len].split(b"\0")[0].decode(errors="replace")
        pos += (-(-name_len // 8) * 8) if version == 1 else name_len
        values = struct.unpack_from(f"<{n_values}I", body, pos)
        pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32):
            label = name or _FILTER_NAMES.get(fid, "unknown")
            raise NotImplementedError(f"HDF5 filter {fid} ({label}); only deflate, "
                                      "shuffle and fletcher32 are read")
        out.append((fid, name, values))
    return out


def _fill_value(msgs: Dict[int, bytes], dtype: np.dtype):
    """The fill value of unwritten chunks, from the version-2 fill value
    message that h5py writes for every dataset (0 where it stores none)."""
    body = msgs.get(MSG_FILL)
    if body is None or body[0] != 2:
        found = "no fill value message" if body is None else \
            f"fill value message version {body[0]}"
        raise NotImplementedError(f"{found} (only version 2 is read)")
    size = struct.unpack_from("<I", body, 4)[0] if body[3] else 0
    if size == 0:
        return 0
    if size != dtype.itemsize:
        raise ValueError(f"fill value of {size} bytes for a {dtype} dataset")
    return np.frombuffer(body[8:8 + size], dtype=dtype)[0]


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (``H5_checksum_fletcher32``): big-endian 16-bit
    words summed in blocks of 360, each block's 32-bit sums folded by an
    end-around carry, then an odd last byte as the high byte of a word."""
    m32 = 0xFFFFFFFF
    fold = lambda s: (s & 0xFFFF) + (s >> 16)
    words = np.frombuffer(data[:len(data) // 2 * 2], dtype=">u2").astype(np.int64)
    sum1 = sum2 = 0
    for start in range(0, len(words), 360):
        w = words[start:start + 360]
        sum2 = (sum2 + len(w) * sum1 + int((w * np.arange(len(w), 0, -1)).sum())) & m32
        sum1 = (sum1 + int(w.sum())) & m32
        sum1, sum2 = fold(sum1), fold(sum2)
    if len(data) % 2:
        sum1 = (sum1 + (data[-1] << 8)) & m32
        sum2 = (sum2 + sum1) & m32
        sum1, sum2 = fold(sum1), fold(sum2)
    sum1, sum2 = fold(sum1), fold(sum2)
    return ((sum2 << 16) | sum1) & m32


def _unfilter(raw: bytes, filters, mask: int, path: str) -> bytes:
    """Undo the pipeline, last filter first; a set bit i of ``mask`` means
    filter i was skipped for this chunk."""
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, _, values = filters[i]
        if fid == FILTER_DEFLATE:
            raw = zlib.decompress(raw)
        elif fid == FILTER_SHUFFLE:
            size = values[0] if values else 1
            n = len(raw) // size
            if size > 1 and n > 0:
                body = np.frombuffer(raw[:n * size], np.uint8).reshape(size, n)
                raw = body.T.tobytes() + raw[n * size:]
        else:
            stored = struct.unpack("<I", raw[-4:])[0]
            raw = raw[:-4]
            if stored != fletcher32(raw):
                raise ValueError(f"{path}: fletcher32 checksum mismatch in a chunk")
    return raw
