"""The HDF5 file format, read and written in numpy and zlib, without libhdf5.

Written from the HDF5 File Format Specification for what libhdf5 writes at
its default (earliest) format, which is what h5py, MATLAB and Caffe's
``H5LT`` calls write:

* a superblock of version 0 or 1, at byte 0 or after a user block (512,
  1024, 2048, ... bytes), with 8-byte addresses and lengths;
* version 1 object headers: messages, continuation blocks;
* groups: a symbol-table message naming a version 1 B-tree (node type 0)
  whose children at level 0 are symbol-table nodes (``SNOD``), and a local
  heap (``HEAP``) of the members' names;
* datasets: a dataspace (scalar, simple, zero-sized), a datatype
  (fixed-point, IEEE float, fixed- and variable-length strings, h5py's
  boolean enum), a fill value (old or new message), a layout (compact,
  contiguous, or chunked with a version 1 B-tree of node type 1) and a filter
  pipeline of deflate, shuffle and fletcher32;
* variable-length strings in global heap collections (``GCOL``).

Anything else raises ``ValueError`` naming the feature and the file.
Attributes, comments and modification times are skipped.

The writer writes the same format: superblock version 0, version 1 object
headers, symbol-table groups, contiguous datasets, chunked datasets indexed
by a version 1 B-tree (deflate at ``DEFLATE_LEVEL``), strings in a global
heap.  Space is allocated at the end of the file; nothing frees it.  An
existing file opened for writing is changed in place: new objects, chunks
and B-tree nodes go past the old end of the file, and what changed in a
fixed-size structure (a dataspace's dimensions, a layout's address, a B-tree
node, a symbol-table node, a local heap's header) is rewritten where it
stands.  A B-tree root that splits keeps its address (its old content moves),
so the addresses a group's symbol-table message and the symbol-table entries
cache stay true.

Every address in the file is relative to the superblock's base address.
Metadata that changed is written back at ``H5File.flush``/``close``; raw data
is written at once.
"""

from __future__ import annotations

import bisect
import itertools
import os
import struct
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = (1 << 64) - 1  # the undefined address
FREE_NULL = 1  # a local heap's end of free list
GHEAP_MIN = 4096  # the least size of a global heap collection
LEAF_K, NODE_K, CHUNK_K = 4, 16, 32  # libhdf5's default B-tree K values
DEFLATE_LEVEL = 4  # h5py's default gzip level
SUPERBLOCK_V0 = 96

# object header message types the reader uses
SPACE, DTYPE, FILL_OLD, FILL, LAYOUT, PLINE, CONT, STAB = 1, 3, 4, 5, 8, 11, 16, 17
SKIPPED = {0, 9, 12, 13, 14, 15, 18, 19, 20, 21, 22}  # nil, bogus, attributes, comment, times ...
REFUSED = {2: "a link info message (a new-style group, or dense link storage in a fractal heap)",
           6: "a link message (a new-style group)",
           7: "external data storage (an external file list message)",
           10: "a group info message (a new-style group)"}
# the filters read are 1 (deflate), 2 (shuffle) and 3 (fletcher32); others
# are refused by name
FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf", 32001: "blosc",
                32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}
TYPE_CLASSES = {2: "a time", 4: "a bitfield", 5: "an opaque", 6: "a compound",
                7: "a reference", 10: "an array"}
# IEEE floats: bit offset, precision, exponent location and size, mantissa
# location and size, exponent bias
IEEE = {2: (0, 16, 10, 5, 0, 10, 15), 4: (0, 32, 23, 8, 0, 23, 127),
        8: (0, 64, 52, 11, 0, 52, 1023)}


def align8(n: int) -> int:
    return (n + 7) & ~7


def pad8(data: bytes) -> bytes:
    return data + bytes(align8(len(data)) - len(data))


# ------------------------------------------------------------------ file


class H5File:
    """One open file: its superblock, the objects read from it (one instance
    an object header address) and the metadata waiting to be written."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode {mode!r}: one of 'r', 'w', 'a'")
        self.path = os.fspath(path)
        self.writable = mode != "r"
        new = mode == "w" or (mode == "a" and not os.path.exists(self.path))
        self.fh = open(self.path, "w+b" if new else ("r+b" if self.writable else "rb"))
        self.objects: Dict[int, object] = {}
        self.gheaps: Dict[int, Dict[int, bytes]] = {}
        self.dirty: Dict[int, Tuple[Callable, object]] = {}
        try:
            self._create() if new else self._open()
        except BaseException:
            self.fh.close()
            raise

    def refuse(self, feature: str):
        raise ValueError(f"{self.path}: {feature} is not supported")

    def _open(self) -> None:
        size = os.fstat(self.fh.fileno()).st_size
        pos = 0
        while True:
            if pos + 8 > size:
                raise ValueError(f"{self.path}: not an HDF5 file (no superblock signature)")
            self.fh.seek(pos)
            if self.fh.read(8) == SIGNATURE:
                break
            pos = 512 if pos == 0 else 2 * pos
        self.fh.seek(pos)
        sb = self.fh.read(100)
        version = sb[8]
        if version > 1:
            self.refuse(f"superblock version {version} (a file written with libver='latest' "
                        "or for SWMR)")
        if sb[13] != 8 or sb[14] != 8:
            self.refuse(f"{sb[13]}-byte addresses and {sb[14]}-byte lengths")
        self.leaf_k, self.node_k = struct.unpack_from("<HH", sb, 16)
        p = 24
        self.chunk_k = CHUNK_K
        if version == 1:
            self.chunk_k = struct.unpack_from("<H", sb, 24)[0]
            p = 28
        self.base, _, eof, drvinfo = struct.unpack_from("<4Q", sb, p)
        if drvinfo != UNDEF:
            self.refuse("a family or multi-file layout (a DRVINFO block)")
        self.eof = eof - self.base
        self.eof_pos = pos + p + 16 - self.base  # relative, as write() takes it
        self.root_addr = struct.unpack_from("<Q", sb, p + 40)[0]

    def _create(self) -> None:
        self.base, self.eof, self.eof_pos = 0, SUPERBLOCK_V0, 40
        self.leaf_k, self.node_k, self.chunk_k = LEAF_K, NODE_K, CHUNK_K
        self.write(0, bytes(SUPERBLOCK_V0))
        self.root_addr, btree, heap = GroupObj.new(self)
        sb = (SIGNATURE + bytes(5) + b"\x08\x08\x00"
              + struct.pack("<HHI4Q", LEAF_K, NODE_K, 0, 0, UNDEF, UNDEF, UNDEF)
              + symbol_entry(0, self.root_addr, 1, struct.pack("<QQ", btree, heap)))
        self.write(0, sb)

    # bytes at addresses relative to the base address

    def read(self, addr: int, n: int) -> bytes:
        self.fh.seek(self.base + addr)
        data = self.fh.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated ({n} bytes at address {addr} run past "
                             "the end of the file)")
        return data

    def readinto(self, addr: int, out: np.ndarray) -> None:
        """Fill the C-contiguous array ``out`` from ``addr``."""
        self.fh.seek(self.base + addr)
        view = out.reshape(-1).view(np.uint8)
        if self.fh.readinto(view) != len(view):
            raise ValueError(f"{self.path}: truncated ({len(view)} bytes at address {addr} "
                             "run past the end of the file)")

    def write(self, addr: int, data) -> None:
        """Write bytes, or an array's bytes, at ``addr``."""
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        self.fh.seek(self.base + addr)
        self.fh.write(data)

    def alloc(self, n: int) -> int:
        addr = self.eof
        self.eof += n
        return addr

    def append(self, data) -> int:
        addr = self.alloc(data.nbytes if isinstance(data, np.ndarray) else len(data))
        self.write(addr, data)
        return addr

    def mark(self, write: Callable, obj) -> None:
        """``obj`` changed: ``write(obj)`` at the next flush."""
        self.dirty[id(obj)] = (write, obj)

    def flush(self) -> None:
        if not self.writable:
            return
        while self.dirty:
            _, (write, obj) = self.dirty.popitem()
            write(obj)
        self.write(self.eof_pos, struct.pack("<Q", self.eof + self.base))
        self.fh.flush()

    def close(self) -> None:
        if self.fh.closed:
            return
        try:
            self.flush()
        finally:
            self.fh.close()

    # objects

    def object(self, addr: int):
        """The group or dataset whose object header is at ``addr``."""
        obj = self.objects.get(addr)
        if obj is None:
            msgs = read_header(self, addr)
            kinds = {m.type for m in msgs}
            if STAB in kinds:
                obj = GroupObj(self, addr, msgs)
            elif LAYOUT in kinds:
                obj = DataObj(self, addr, msgs)
            elif DTYPE in kinds:
                self.refuse(f"a committed datatype (the named datatype at address {addr})")
            else:
                self.refuse(f"the object at address {addr}, neither a group nor a dataset")
            self.objects[addr] = obj
        return obj

    # global heap collections: variable-length strings

    def gheap_object(self, addr: int, index: int) -> bytes:
        coll = self.gheaps.get(addr)
        if coll is None:
            head = self.read(addr, 16)
            if head[:4] != b"GCOL" or head[4] != 1:
                raise ValueError(f"{self.path}: no global heap collection at {addr}")
            size = struct.unpack_from("<Q", head, 8)[0]
            buf = self.read(addr, size)
            coll, p = {}, 16
            while p + 16 <= size:
                i, _, n = struct.unpack_from("<HH4xQ", buf, p)
                if i == 0:
                    break
                coll[i] = buf[p + 16 : p + 16 + n]
                p += 16 + align8(n)
            self.gheaps[addr] = coll
        try:
            return coll[index]
        except KeyError:
            raise ValueError(f"{self.path}: no object {index} in the global heap "
                             f"collection at {addr}") from None

    def gheap_put(self, objs: Sequence[bytes]) -> List[Tuple[int, int]]:
        """Store ``objs`` in new collections: (collection address, index) each."""
        refs: List[Tuple[int, int]] = []
        for start in range(0, len(objs), 0xFFFF):
            part = objs[start : start + 0xFFFF]
            body = b"".join(struct.pack("<HH4xQ", i + 1, 0, len(o)) + pad8(o)
                            for i, o in enumerate(part))
            used = 16 + len(body)
            size = max(GHEAP_MIN, used)
            free = size - used
            tail = (struct.pack("<HH4xQ", 0, 0, free) + bytes(free - 16) if free >= 16
                    else bytes(free))
            addr = self.append(b"GCOL\x01\x00\x00\x00" + struct.pack("<Q", size) + body + tail)
            self.gheaps[addr] = {i + 1: bytes(o) for i, o in enumerate(part)}
            refs += [(addr, i + 1) for i in range(len(part))]
        return refs


# --------------------------------------------------------- object headers


class Message:
    __slots__ = ("type", "flags", "addr", "data")

    def __init__(self, mtype: int, flags: int, addr: int, data: bytes):
        self.type, self.flags, self.addr, self.data = mtype, flags, addr, data


def read_header(h5: H5File, addr: int) -> List[Message]:
    """The messages of the version 1 object header at ``addr`` (continuation
    blocks followed; nil, attribute, comment and time messages dropped)."""
    pre = h5.read(addr, 16)
    if pre[:4] == b"OHDR":
        h5.refuse("a version 2 object header")
    if pre[0] != 1:
        h5.refuse(f"object header version {pre[0]}")
    size = struct.unpack_from("<I", pre, 8)[0]
    blocks, out = [(addr + 16, size)], []
    while blocks:
        start, length = blocks.pop(0)
        buf = h5.read(start, length)
        p = 0
        while p + 8 <= length:
            mtype, msize, flags = struct.unpack_from("<HHB", buf, p)
            data = buf[p + 8 : p + 8 + msize]
            if mtype == CONT:
                blocks.append(struct.unpack_from("<QQ", data))
            elif mtype in REFUSED:
                h5.refuse(REFUSED[mtype])
            elif mtype not in SKIPPED:
                if mtype not in (SPACE, DTYPE, FILL_OLD, FILL, LAYOUT, PLINE, STAB):
                    h5.refuse(f"object header message type {mtype}")
                if flags & 2:
                    h5.refuse("a shared object header message (a committed datatype or a "
                              "shared message table)")
                out.append(Message(mtype, flags, start + p + 8, data))
            p += 8 + msize
    return out


def write_header(h5: H5File, msgs: Sequence[Tuple[int, int, bytes]]) -> int:
    """A version 1 object header holding ``msgs`` ((type, flags, data) each)."""
    body = b"".join(struct.pack("<HHB3x", t, align8(len(d)), f) + pad8(d) for t, f, d in msgs)
    return h5.append(struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body)


def symbol_entry(name_off: int, addr: int, cache: int = 0, scratch: bytes = bytes(16)) -> bytes:
    return struct.pack("<QQI4x", name_off, addr, cache) + scratch


# ------------------------------------------------------------ datatypes


class Type:
    """A dataset's element type: ``raw``, the numpy dtype of its stored
    bytes, and ``kind``: 'num', 'bool' (h5py's enum), 'str' (fixed length,
    ``pad`` 0 null-terminated, 1 null-padded, 2 space-padded) or 'vstr'
    (variable length, ``cset`` 0 ASCII or 1 UTF-8)."""

    __slots__ = ("raw", "kind", "cset", "pad")

    def __init__(self, raw, kind: str, cset: int = 0, pad: int = 1):
        self.raw, self.kind, self.cset, self.pad = np.dtype(raw), kind, cset, pad

    @property
    def dtype(self) -> np.dtype:
        """What a read gives, as h5py gives it."""
        return {"bool": np.dtype(bool), "vstr": np.dtype(object)}.get(self.kind, self.raw)

    @classmethod
    def of(cls, dtype, cset: int = 1) -> "Type":
        """The type the writer stores a numpy dtype as (object: strings)."""
        dt = np.dtype(dtype)
        if dt == bool:
            return cls("i1", "bool")
        if dt.kind in "iu" or (dt.kind == "f" and dt.itemsize in IEEE):
            return cls(dt.newbyteorder(">" if dt.byteorder == ">" else "<"), "num")
        if dt.kind == "S":
            return cls(dt, "str")
        if dt.kind == "O":
            return cls("V16", "vstr", cset)
        raise TypeError(f"no HDF5 type for numpy dtype {dt}")

    def encode(self) -> bytes:
        raw = self.raw
        if self.kind == "vstr":
            return (struct.pack("<BBBBI", 0x19, 1, self.cset, 0, 16)
                    + struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8))
        if self.kind == "str":
            return struct.pack("<BBBBI", 0x13, 1, 0, 0, raw.itemsize)  # null-padded ASCII
        if self.kind == "bool":
            return (struct.pack("<BBBBI", 0x18, 2, 0, 0, 1)
                    + struct.pack("<BBBBIHH", 0x10, 8, 0, 0, 1, 0, 8)
                    + b"FALSE\x00\x00\x00TRUE\x00\x00\x00\x00" + bytes([0, 1]))
        big = int(raw.byteorder == ">")
        if raw.kind == "f":
            return (struct.pack("<BBBBI", 0x11, 0x20 | big, 8 * raw.itemsize - 1, 0, raw.itemsize)
                    + struct.pack("<HHBBBBI", *IEEE[raw.itemsize]))
        return (struct.pack("<BBBBI", 0x10, big | (8 if raw.kind == "i" else 0), 0, 0,
                            raw.itemsize) + struct.pack("<HH", 0, 8 * raw.itemsize))


def decode_type(h5: H5File, d: bytes) -> Tuple[Type, int]:
    """The datatype message ``d``: the type and the bytes it took."""
    cls, version, b0, b1 = d[0] & 15, d[0] >> 4, d[1], d[2]
    size = struct.unpack_from("<I", d, 4)[0]
    order = ">" if b0 & 1 else "<"
    if cls == 0:
        off, prec = struct.unpack_from("<HH", d, 8)
        if size not in (1, 2, 4, 8) or off or prec != 8 * size:
            h5.refuse(f"a {prec}-bit fixed-point type at bit offset {off} in {size} bytes")
        return Type(f"{order}{'i' if b0 & 8 else 'u'}{size}", "num"), 12
    if cls == 1:
        if (b0 & 0x4E) or (b0 & 0x30) != 0x20 or size not in IEEE or b1 != 8 * size - 1 \
                or struct.unpack_from("<HHBBBBI", d, 8) != IEEE[size]:
            h5.refuse(f"a {8 * size}-bit floating-point type other than IEEE's")
        return Type(f"{order}f{size}", "num"), 20
    if cls == 3:
        return Type(f"S{size}", "str", pad=b0 & 15), 8
    if cls == 9:
        if b0 & 15 != 1:
            h5.refuse("a variable-length sequence type")
        base, n = decode_type(h5, d[8:])
        return Type("V16", "vstr", b1 & 15), 8 + n
    if cls == 8:
        base, n = decode_type(h5, d[8:])
        p, names = 8 + n, []
        for _ in range(b0 | (b1 << 8)):
            end = d.index(b"\x00", p)
            names.append(d[p:end])
            p = end + 1 if version >= 3 else p + align8(end - p + 1)
        values = np.frombuffer(d, base.raw, len(names), p).tolist()
        if base.raw.itemsize == 1 and dict(zip(names, values)) == {b"FALSE": 0, b"TRUE": 1}:
            return Type(base.raw, "bool"), p + len(names)
        h5.refuse("an enum type other than h5py's boolean")
    h5.refuse(f"{TYPE_CLASSES.get(cls, f'a class {cls}')} datatype")


# ----------------------------------------------------------- local heap


class LocalHeap:
    """A group's names: a header at ``addr`` and a data segment holding
    null-terminated names at 8-byte-aligned offsets and a free list."""

    def __init__(self, h5: H5File, addr: int):
        head = h5.read(addr, 32)
        if head[:4] != b"HEAP":
            raise ValueError(f"{h5.path}: no local heap at {addr}")
        size, free, self.seg = struct.unpack_from("<QQQ", head, 8)
        self.h5, self.addr, self.moved = h5, addr, False
        self.data = bytearray(h5.read(self.seg, size))
        self.free: List[List[int]] = []
        while free not in (FREE_NULL, UNDEF) and free + 16 <= size:
            nxt, n = struct.unpack_from("<QQ", self.data, free)
            self.free.append([free, n])
            free = nxt

    @staticmethod
    def create(h5: H5File, size: int = 88) -> int:
        data = bytearray(size)
        struct.pack_into("<QQ", data, 8, FREE_NULL, size - 8)
        addr = h5.alloc(32)
        h5.write(addr, b"HEAP" + bytes(4) + struct.pack("<QQQ", size, 8, addr + 32))
        h5.append(data)
        return addr

    def name(self, off: int) -> bytes:
        return bytes(self.data[off : self.data.index(0, off)])

    def add(self, name: bytes) -> int:
        need = align8(len(name) + 1)
        while True:
            for k, (off, n) in enumerate(self.free):
                if n >= need:
                    if n - need >= 16:
                        self.free[k] = [off + need, n - need]
                    else:
                        del self.free[k]
                    self.data[off : off + need] = name + bytes(need - len(name))
                    self.h5.mark(LocalHeap.flush, self)
                    return off
            old = len(self.data)
            self.data += bytes(max(old, need))
            if self.free and sum(self.free[-1]) == old:
                self.free[-1][1] += len(self.data) - old
            else:
                self.free.append([old, len(self.data) - old])
            self.moved = True

    def flush(self) -> None:
        for k, (off, n) in enumerate(self.free):
            nxt = self.free[k + 1][0] if k + 1 < len(self.free) else FREE_NULL
            struct.pack_into("<QQ", self.data, off, nxt, n)
        if self.moved:
            self.seg, self.moved = self.h5.alloc(len(self.data)), False
        self.h5.write(self.seg, bytes(self.data))
        head = self.free[0][0] if self.free else FREE_NULL
        self.h5.write(self.addr + 8, struct.pack("<QQQ", len(self.data), head, self.seg))


# --------------------------------------------------------- version 1 B-trees


class Node:
    """A B-tree node in memory: ``kids[i]`` lies between ``keys[i]`` and
    ``keys[i + 1]``; a kid is a node (level > 0, loaded on demand: an address
    until then) or, at level 0, the address of a symbol-table node or chunk."""

    __slots__ = ("addr", "level", "keys", "kids", "left", "right")

    def __init__(self, addr, level, keys, kids, left=UNDEF, right=UNDEF):
        self.addr, self.level, self.keys, self.kids = addr, level, keys, kids
        self.left, self.right = left, right


class BTree:
    """A version 1 B-tree of one node type (0: group, 1: chunks), loaded a
    node at a time.  A node holds at most 2K children; one that overflows
    splits and its parent takes the new half; a root that splits keeps its
    address."""

    ntype = -1

    def __init__(self, h5: H5File, root: int, k: int, key_size: int):
        self.h5, self.k, self.key_size = h5, k, key_size
        self.node_size = 24 + (2 * k + 1) * key_size + 2 * k * 8
        self.nodes: Dict[int, Node] = {}
        self.root = None if root == UNDEF else self.node(root)

    def decode_key(self, buf: bytes, p: int):
        raise NotImplementedError

    def encode_key(self, key) -> bytes:
        raise NotImplementedError

    def node(self, addr: int) -> Node:
        node = self.nodes.get(addr)
        if node is None:
            head = self.h5.read(addr, 24)
            if head[:4] != b"TREE" or head[4] != self.ntype:
                raise ValueError(f"{self.h5.path}: no B-tree node of type {self.ntype} at {addr}")
            level, n, left, right = struct.unpack_from("<BHQQ", head, 5)
            step = self.key_size + 8
            body = self.h5.read(addr + 24, n * step + self.key_size)
            keys = [self.decode_key(body, i * step) for i in range(n + 1)]
            kids = [struct.unpack_from("<Q", body, i * step + self.key_size)[0] for i in range(n)]
            node = self.nodes[addr] = Node(addr, level, keys, kids, left, right)
        return node

    def kid(self, node: Node, i: int):
        kid = node.kids[i]
        if node.level > 0 and not isinstance(kid, Node):
            kid = node.kids[i] = self.node(kid)
        return kid

    def write_node(self, node: Node) -> None:
        out = bytearray(self.node_size)
        struct.pack_into("<4sBBHQQ", out, 0, b"TREE", self.ntype, node.level, len(node.kids),
                         node.left, node.right)
        p = 24
        for i, key in enumerate(node.keys):
            out[p : p + self.key_size] = self.encode_key(key)
            p += self.key_size
            if i < len(node.kids):
                kid = node.kids[i]
                struct.pack_into("<Q", out, p, kid.addr if isinstance(kid, Node) else kid)
                p += 8
        self.h5.write(node.addr, out)

    def new_node(self, level: int, keys, kids) -> Node:
        node = Node(self.h5.alloc(self.node_size), level, keys, kids)
        self.nodes[node.addr] = node
        self.dirty(node)
        return node

    def dirty(self, node: Node) -> None:
        self.h5.mark(self.write_node, node)

    def leaves(self):
        """Level-0 nodes, left to right."""
        def walk(node):
            if node.level == 0:
                yield node
            else:
                for i in range(len(node.kids)):
                    yield from walk(self.kid(node, i))
        if self.root is not None:
            yield from walk(self.root)

    def split_up(self, path: List[Tuple[Node, int]], node: Node, at_end: bool = False) -> None:
        """Split ``node`` (reached through ``path``) and its ancestors while
        they hold more than 2K children.  ``at_end``: an append past the last
        key, so the full node stays whole and the new one takes the rest."""
        while len(node.kids) > 2 * self.k:
            m = 2 * self.k if at_end else len(node.kids) // 2
            new = self.new_node(node.level, node.keys[m:], node.kids[m:])
            node.keys, node.kids = node.keys[: m + 1], node.kids[:m]
            new.left, new.right, node.right = node.addr, node.right, new.addr
            if new.right != UNDEF:
                after = self.node(new.right)
                after.left = new.addr
                self.dirty(after)
            self.dirty(node)
            if path:
                parent, i = path.pop()
                parent.kids.insert(i + 1, new)
                parent.keys.insert(i + 1, node.keys[-1])
                self.dirty(parent)
                node = parent
                continue
            # the root: its content moves to a new node, the root stays put
            moved = self.new_node(node.level, node.keys, node.kids)
            moved.right, new.left = new.addr, moved.addr
            node.left = node.right = UNDEF
            node.level += 1
            node.keys = [moved.keys[0], moved.keys[-1], new.keys[-1]]
            node.kids = [moved, new]


class GroupTree(BTree):
    """A group's B-tree (node type 0, keys: local heap offsets of names) and
    its symbol-table nodes."""

    ntype = 0

    def __init__(self, h5: H5File, root: int, heap: LocalHeap):
        self.heap = heap
        self.snods: Dict[int, List[list]] = {}
        super().__init__(h5, root, h5.node_k, 8)

    def decode_key(self, buf, p):
        return struct.unpack_from("<Q", buf, p)[0]

    def encode_key(self, key):
        return struct.pack("<Q", key)

    @staticmethod
    def create(h5: H5File) -> int:
        """An empty root node (no children, key 0: the empty name)."""
        size = 24 + (2 * h5.node_k + 1) * 8 + 2 * h5.node_k * 8
        head = struct.pack("<4sBBHQQ", b"TREE", 0, 0, 0, UNDEF, UNDEF)
        return h5.append(head + bytes(size - len(head)))

    # symbol-table nodes: [name, heap offset, header address, cache type, scratch]

    def snod_size(self) -> int:
        return 8 + 2 * self.h5.leaf_k * 40

    def snod(self, addr: int) -> List[list]:
        entries = self.snods.get(addr)
        if entries is None:
            buf = self.h5.read(addr, self.snod_size())
            if buf[:4] != b"SNOD":
                raise ValueError(f"{self.h5.path}: no symbol-table node at {addr}")
            entries = []
            for i in range(struct.unpack_from("<H", buf, 6)[0]):
                off, obj, cache = struct.unpack_from("<QQI", buf, 8 + 40 * i)
                scratch = buf[8 + 40 * i + 24 : 8 + 40 * i + 40]
                entries.append([self.heap.name(off), off, obj, cache, scratch])
            self.snods[addr] = entries
        return entries

    def write_snod(self, addr: int) -> None:
        entries = self.snods[addr]
        out = bytearray(self.snod_size())
        out[:8] = b"SNOD\x01\x00" + struct.pack("<H", len(entries))
        for i, (_, off, obj, cache, scratch) in enumerate(entries):
            out[8 + 40 * i : 48 + 40 * i] = symbol_entry(off, obj, cache, scratch)
        self.h5.write(addr, out)

    def entries(self):
        for leaf in self.leaves():
            for addr in leaf.kids:
                yield from self.snod(addr)

    def find(self, name: bytes) -> Tuple[Optional[Node], int, List[Tuple[Node, int]]]:
        """The level-0 node and the kid index where ``name`` is or belongs,
        and the path to it."""
        node, path = self.root, []
        while node.kids:
            i = next((i for i in range(len(node.kids))
                      if name <= self.heap.name(node.keys[i + 1])), len(node.kids) - 1)
            if node.level == 0:
                return node, i, path
            path.append((node, i))
            node = self.kid(node, i)
        return node, -1, path

    def lookup(self, name: bytes) -> Optional[list]:
        node, i, _ = self.find(name)
        if i < 0:
            return None
        return next((e for e in self.snod(node.kids[i]) if e[0] == name), None)

    def insert(self, name: bytes, obj: int, cache: int = 0, scratch: bytes = bytes(16)) -> None:
        off = self.heap.add(name)
        entry = [name, off, obj, cache, scratch]
        leaf, i, path = self.find(name)
        if i < 0:  # an empty group
            addr = self.h5.alloc(self.snod_size())
            self.snods[addr] = [entry]
            self.h5.mark(self.write_snod, addr)
            leaf.kids, leaf.keys = [addr], [leaf.keys[0], off]
            self.dirty(leaf)
            return
        entries = self.snod(leaf.kids[i])
        names = [e[0] for e in entries]
        j = bisect.bisect_left(names, name)
        if j < len(names) and names[j] == name:
            raise ValueError(f"{self.h5.path}: the name {name.decode()!r} exists")
        entries.insert(j, entry)
        self.h5.mark(self.write_snod, leaf.kids[i])
        if j == len(names):  # the largest name in this symbol-table node
            leaf.keys[i + 1] = off
            self.dirty(leaf)
            child = leaf
            for parent, pi in reversed(path):
                parent.keys[pi + 1] = child.keys[-1]
                self.dirty(parent)
                child = parent
        if len(entries) > 2 * self.h5.leaf_k:
            m = len(entries) // 2
            addr = self.h5.alloc(self.snod_size())
            self.snods[addr] = entries[m:]
            del entries[m:]
            self.h5.mark(self.write_snod, addr)
            leaf.kids.insert(i + 1, addr)
            leaf.keys.insert(i + 1, entries[-1][1])
            self.dirty(leaf)
            self.split_up(path, leaf)


class ChunkTree(BTree):
    """A chunked dataset's index (node type 1).  A key: (element offsets,
    rank + 1 of them, the last 0 but in a right bound where it is the element
    size; stored bytes; filter mask); ``keys[i]`` is chunk ``i``'s and the
    last key bounds the node on the right."""

    ntype = 1

    def __init__(self, h5: H5File, root: int, dims: Tuple[int, ...]):
        self.dims = dims  # the chunk's dimensions and the element size
        super().__init__(h5, root, h5.chunk_k, 8 + 8 * len(dims))

    def decode_key(self, buf, p):
        size, mask = struct.unpack_from("<II", buf, p)
        return struct.unpack_from(f"<{len(self.dims)}Q", buf, p + 8), size, mask

    def encode_key(self, key):
        offs, size, mask = key
        return struct.pack(f"<II{len(self.dims)}Q", size, mask, *offs)

    def path_to(self, offs: Tuple[int, ...]) -> Tuple[Node, List[Tuple[Node, int]]]:
        node, path = self.root, []
        while node.level > 0:
            i = max(bisect.bisect_right([k[0][:-1] for k in node.keys[:-1]], offs) - 1, 0)
            path.append((node, i))
            node = self.kid(node, i)
        return node, path

    def lookup(self, offs: Tuple[int, ...]) -> Optional[Tuple[int, int, int]]:
        """(address, stored bytes, filter mask) of the chunk at element
        offsets ``offs``, or None when it was never written."""
        if self.root is None:
            return None
        leaf, _ = self.path_to(offs)
        lefts = [k[0][:-1] for k in leaf.keys[:-1]]
        j = bisect.bisect_left(lefts, offs)
        if j < len(lefts) and lefts[j] == offs:
            return leaf.kids[j], leaf.keys[j][1], leaf.keys[j][2]
        return None

    def put(self, offs: Tuple[int, ...], addr: int, size: int) -> bool:
        """Record the chunk at ``offs`` (filter mask 0).  True when the tree
        got its first node (the layout's address changes)."""
        key = (offs + (0,), size, 0)
        right = tuple(o + d for o, d in zip(offs, self.dims[:-1])) + (self.dims[-1],)
        if self.root is None:
            self.root = self.new_node(0, [key, (right, 0, 0)], [addr])
            return True
        leaf, path = self.path_to(offs)
        lefts = [k[0][:-1] for k in leaf.keys[:-1]]
        j = bisect.bisect_left(lefts, offs)
        self.dirty(leaf)
        if j < len(lefts) and lefts[j] == offs:
            leaf.keys[j], leaf.kids[j] = key, addr
            return False
        leaf.keys.insert(j, key)
        leaf.kids.insert(j, addr)
        last = all(i == len(p.kids) - 1 for p, i in path) and j == len(lefts)
        if last and right > leaf.keys[-1][0]:
            leaf.keys[-1] = (right, 0, 0)
        child = leaf
        for parent, i in reversed(path):  # the bounds the ancestors copy
            parent.keys[i] = child.keys[0]
            if i == len(parent.kids) - 1:
                parent.keys[-1] = child.keys[-1]
            self.dirty(parent)
            child = parent
        self.split_up(path, leaf, at_end=last)
        return False


# ---------------------------------------------------------------- groups


class GroupObj:
    """A symbol-table group."""

    def __init__(self, h5: H5File, addr: int, msgs: List[Message]):
        btree, heap = struct.unpack_from("<QQ", next(m for m in msgs if m.type == STAB).data)
        self.h5, self.addr = h5, addr
        self.tree = GroupTree(h5, btree, LocalHeap(h5, heap))

    @staticmethod
    def new(h5: H5File) -> Tuple[int, int, int]:
        """A new empty group: (header, B-tree, heap) addresses."""
        heap = LocalHeap.create(h5)
        btree = GroupTree.create(h5)
        return write_header(h5, [(STAB, 0, struct.pack("<QQ", btree, heap))]), btree, heap

    def names(self) -> List[str]:
        return [e[0].decode("utf-8", "surrogateescape") for e in self.tree.entries()]

    def get(self, name: str) -> Optional[int]:
        entry = self.tree.lookup(name.encode("utf-8", "surrogateescape"))
        return None if entry is None else entry[2]

    def link(self, name: str, addr: int, scratch: Optional[bytes] = None) -> None:
        if not name or "/" in name or name == ".":
            raise ValueError(f"{self.h5.path}: {name!r} is not a member name")
        self.tree.insert(name.encode("utf-8", "surrogateescape"), addr,
                         0 if scratch is None else 1, scratch or bytes(16))

    def create_group(self, name: str) -> "GroupObj":
        addr, btree, heap = GroupObj.new(self.h5)
        self.link(name, addr, struct.pack("<QQ", btree, heap))
        return self.h5.object(addr)

    def create_dataset(self, name: str, shape: Tuple[int, ...], type_: Type,
                       maxshape: Optional[Tuple[Optional[int], ...]] = None,
                       chunks: Optional[Tuple[int, ...]] = None,
                       deflate: Optional[int] = None) -> "DataObj":
        """A new dataset, its storage not yet allocated (contiguous unless
        ``chunks``; ``deflate``: the gzip level of a chunked one)."""
        shape = tuple(int(n) for n in shape)
        maxshape = shape if maxshape is None else tuple(maxshape)
        if len(maxshape) != len(shape) or any(m is not None and m < n
                                              for n, m in zip(shape, maxshape)):
            raise ValueError(f"maxshape {maxshape} does not hold shape {shape}")
        if chunks is None and (maxshape != shape or deflate is not None):
            raise ValueError("a resizable or compressed dataset needs chunks")
        rank, size = len(shape), type_.raw.itemsize
        space = struct.pack("<BBB5x", 1, rank, 1 if rank else 0) + struct.pack(
            f"<{2 * rank}Q", *shape, *(UNDEF if m is None else m for m in maxshape))
        msgs = [(SPACE, 0, space), (DTYPE, 1, type_.encode())]
        if chunks is None:
            msgs.append((FILL, 1, struct.pack("<BBBBI", 2, 2, 2, 1, 0)))
            layout = struct.pack("<BBQQ", 3, 1, UNDEF, int(np.prod(shape, dtype=np.int64)) * size)
        else:
            chunks = tuple(int(c) for c in chunks)
            if len(chunks) != rank or rank == 0 or min(chunks) < 1 or any(
                    m is not None and c > m for c, m in zip(chunks, maxshape)):
                raise ValueError(f"chunks {chunks} for shape {shape} and maxshape {maxshape}")
            msgs.append((FILL, 1, struct.pack("<BBBBI", 2, 3, 2, 1, 0)))
            if deflate is not None:
                msgs.append((PLINE, 1, struct.pack("<BB6xHHHH", 1, 1, 1, 8, 1, 1)
                             + b"deflate\x00" + struct.pack("<I4x", deflate)))
            layout = struct.pack(f"<BBBQ{rank + 1}I", 3, 2, rank + 1, UNDEF, *chunks, size)
        msgs.append((LAYOUT, 0, layout))
        addr = write_header(self.h5, msgs)
        self.link(name, addr)
        return self.h5.object(addr)


# -------------------------------------------------------------- datasets


def as_slice(idx: np.ndarray) -> Optional[slice]:
    """The slice that selects the sorted indices ``idx``, if one does."""
    if len(idx) == 1:
        return slice(int(idx[0]), int(idx[0]) + 1)
    step = int(idx[1] - idx[0])
    if step > 0 and bool(np.all(np.diff(idx) == step)):
        return slice(int(idx[0]), int(idx[-1]) + 1, step)
    return None


def outer(sel: Sequence[np.ndarray]):
    """An indexing key for the outer product of ``sel`` (one sorted index
    array an axis): slices where they do (a view), else ``np.ix_``."""
    slices = [as_slice(i) for i in sel]
    return tuple(slices) if all(s is not None for s in slices) else np.ix_(*sel)


def runs(idx: np.ndarray):
    """(start position, first value, length) of each run of consecutive values."""
    cut = np.flatnonzero(np.diff(idx) != 1) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [len(idx)]])
    return [(int(a), int(idx[a]), int(b - a)) for a, b in zip(starts, ends)]


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32: big-endian 16-bit words, folded every 360 words."""
    n = len(data)
    words = np.frombuffer(data, ">u2", n // 2).astype(np.int64)
    s1 = s2 = 0
    for start in range(0, len(words), 360):
        block = words[start : start + 360]
        t = len(block)
        s2 += t * s1 + int(np.dot(np.arange(t, 0, -1, dtype=np.int64), block))
        s1 += int(block.sum())
        s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    if n & 1:
        s1 += data[-1] << 8
        s2 += s1
        s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


def shuffle(data: bytes, size: int, inverse: bool) -> bytes:
    n = len(data) // size
    if size < 2 or n < 2:
        return data
    body = np.frombuffer(data, np.uint8, n * size)
    body = body.reshape(size, n).T if inverse else body.reshape(n, size).T
    return body.tobytes() + data[n * size :]


class DataObj:
    """A dataset: its shape, type, fill value, layout and filters, read and
    written by selections (one sorted index array an axis)."""

    def __init__(self, h5: H5File, addr: int, msgs: List[Message]):
        by = {m.type: m for m in msgs}
        self.h5, self.addr = h5, addr
        if SPACE not in by or DTYPE not in by:
            raise ValueError(f"{h5.path}: the dataset at {addr} lacks a dataspace or datatype")
        self._space(by[SPACE])
        self.type = decode_type(h5, by[DTYPE].data)[0]
        raw = self.type.raw
        fill = self._fill(by)
        self.fill = np.frombuffer(fill if fill and len(fill) == raw.itemsize
                                  else bytes(raw.itemsize), raw)[0]
        self._layout(by[LAYOUT])
        self.filters: List[Tuple[int, int, Tuple[int, ...]]] = []
        if PLINE in by:
            self._pipeline(by[PLINE].data)
        self.tree: Optional[ChunkTree] = None

    # -- messages

    def _space(self, msg: Message) -> None:
        d = msg.data
        version, rank, flags = d[0], d[1], d[2]
        if version == 2 and d[3] == 2:
            self.h5.refuse("a null dataspace")
        if version not in (1, 2) or flags & 2:
            self.h5.refuse(f"dataspace version {version} with flags {flags}")
        p = 8 if version == 1 else 4
        self.shape = struct.unpack_from(f"<{rank}Q", d, p)
        maxdims = struct.unpack_from(f"<{rank}Q", d, p + 8 * rank) if flags & 1 else self.shape
        self.maxshape = tuple(None if m == UNDEF else m for m in maxdims)
        self.dims_addr = msg.addr + p

    @staticmethod
    def _fill(by: Dict[int, Message]) -> Optional[bytes]:
        if FILL in by:
            d = by[FILL].data
            if d[0] in (1, 2):
                if d[0] == 2 and not d[3]:
                    return None
                n = struct.unpack_from("<I", d, 4)[0]
                return d[8 : 8 + n]
            if d[0] == 3 and d[1] & 0x20:
                n = struct.unpack_from("<I", d, 2)[0]
                return d[6 : 6 + n]
            return None
        if FILL_OLD in by:
            d = by[FILL_OLD].data
            return d[4 : 4 + struct.unpack_from("<I", d, 0)[0]]
        return None

    def _layout(self, msg: Message) -> None:
        d, h5 = msg.data, self.h5
        version = d[0]
        self.addr_pos = None
        self.data_addr, self.compact, self.chunks = UNDEF, None, None
        if version in (1, 2):
            ndims, cls, p = d[1], d[2], 8
            if cls in (1, 2):
                self.data_addr, self.addr_pos = struct.unpack_from("<Q", d, p)[0], msg.addr + p
                p += 8
            dims = struct.unpack_from(f"<{ndims}I", d, p)
            p += 4 * ndims
            if cls == 0:
                n = struct.unpack_from("<I", d, p)[0]
                self.compact, self.compact_addr = bytearray(d[p + 4 : p + 4 + n]), msg.addr + p + 4
            elif cls == 2:
                self.chunks = dims
        elif version == 3:
            cls = d[1]
            if cls == 0:
                n = struct.unpack_from("<H", d, 2)[0]
                self.compact, self.compact_addr = bytearray(d[4 : 4 + n]), msg.addr + 4
            elif cls == 1:
                self.data_addr, self.addr_pos = struct.unpack_from("<Q", d, 2)[0], msg.addr + 2
            elif cls == 2:
                self.data_addr, self.addr_pos = struct.unpack_from("<Q", d, 3)[0], msg.addr + 3
                self.chunks = struct.unpack_from(f"<{d[2]}I", d, 11)
            elif cls == 3:
                h5.refuse("virtual dataset storage")
            else:
                h5.refuse(f"layout class {cls}")
        elif version == 4:
            h5.refuse("layout message version 4 (a chunk index other than a version 1 "
                      "B-tree, as libver='latest' writes)")
        else:
            h5.refuse(f"layout message version {version}")
        if cls not in (0, 1, 2):
            h5.refuse(f"layout class {cls}")
        if self.chunks is not None:
            if len(self.chunks) != len(self.shape) + 1 \
                    or self.chunks[-1] != self.type.raw.itemsize:
                raise ValueError(f"{h5.path}: chunk dimensions {self.chunks} for shape "
                                 f"{self.shape} and {self.type.raw.itemsize}-byte elements")
        self.contiguous = cls == 1

    def _pipeline(self, d: bytes) -> None:
        version, n = d[0], d[1]
        if version not in (1, 2):
            self.h5.refuse(f"filter pipeline version {version}")
        p = 8 if version == 1 else 2
        for _ in range(n):
            fid = struct.unpack_from("<H", d, p)[0]
            named = version == 1 or fid >= 256
            namelen = struct.unpack_from("<H", d, p + 2)[0] if named else 0
            p += 4 if named else 2
            flags, nvals = struct.unpack_from("<HH", d, p)
            p += 4 + (align8(namelen) if version == 1 else namelen)
            vals = struct.unpack_from(f"<{nvals}I", d, p)
            p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2, 3):
                self.h5.refuse(f"the {FILTER_NAMES.get(fid, f'id {fid}')} filter")
            self.filters.append((fid, flags, vals))

    # -- chunks

    def chunk_tree(self) -> ChunkTree:
        if self.tree is None:
            self.tree = ChunkTree(self.h5, self.data_addr, tuple(self.chunks))
        return self.tree

    def decode(self, data: bytes, mask: int) -> bytes:
        for i in reversed(range(len(self.filters))):
            if mask >> i & 1:
                continue
            fid, _, vals = self.filters[i]
            if fid == 1:
                data = zlib.decompress(data)
            elif fid == 2:
                data = shuffle(data, vals[0] if vals else self.type.raw.itemsize, True)
            else:
                stored = struct.unpack_from("<I", data, len(data) - 4)[0]
                data = data[:-4]
                sum_ = fletcher32(data)
                swapped = ((sum_ & 0x00FF00FF) << 8) | ((sum_ >> 8) & 0x00FF00FF)
                if stored not in (sum_, swapped):
                    raise ValueError(f"{self.h5.path}: a chunk fails its fletcher32 checksum")
        return data

    def encode(self, data: bytes) -> bytes:
        for fid, _, vals in self.filters:
            if fid == 1:
                data = zlib.compress(data, vals[0] if vals else DEFLATE_LEVEL)
            elif fid == 2:
                data = shuffle(data, vals[0] if vals else self.type.raw.itemsize, False)
            else:
                data = data + struct.pack("<I", fletcher32(data))
        return data

    def chunk(self, offs: Tuple[int, ...]) -> Optional[np.ndarray]:
        found = self.chunk_tree().lookup(offs)
        if found is None:
            return None
        addr, size, mask = found
        data = self.decode(self.h5.read(addr, size), mask)
        dims = self.chunks[:-1]
        if len(data) != int(np.prod(dims)) * self.type.raw.itemsize:
            raise ValueError(f"{self.h5.path}: the chunk at {offs} holds {len(data)} bytes")
        return np.frombuffer(data, self.type.raw).reshape(dims)

    def store_chunk(self, offs: Tuple[int, ...], arr: np.ndarray) -> None:
        data = self.encode(np.ascontiguousarray(arr).tobytes())
        tree = self.chunk_tree()
        found = tree.lookup(offs)
        if found is not None and len(data) <= found[1]:
            addr = found[0]
            self.h5.write(addr, data)
        else:
            addr = self.h5.append(data)
        if found is None or found != (addr, len(data), 0):
            if tree.put(offs, addr, len(data)):
                self.data_addr = tree.root.addr
                self.h5.write(self.addr_pos, struct.pack("<Q", self.data_addr))

    def chunk_groups(self, sel: Sequence[np.ndarray]):
        """For each chunk a selection touches: its element offsets, the span
        of the selection it covers and the indices inside it."""
        axes = []
        for idx, c in zip(sel, self.chunks):
            cid = idx // c
            cut = np.flatnonzero(np.diff(cid)) + 1
            starts, ends = np.concatenate([[0], cut]), np.concatenate([cut, [len(idx)]])
            axes.append([(int(cid[a]) * c, slice(int(a), int(b)), idx[a:b] - int(cid[a]) * c)
                         for a, b in zip(starts, ends)])
        for combo in itertools.product(*axes):
            yield (tuple(o for o, _, _ in combo), tuple(s for _, s, _ in combo),
                   [i for _, _, i in combo])

    # -- values

    def to_raw(self, values: np.ndarray) -> np.ndarray:
        t = self.type
        if t.kind == "vstr":
            objs = [v.encode("utf-8") if isinstance(v, str) else bytes(v)
                    for v in values.ravel().tolist()]
            refs = self.h5.gheap_put([o for o in objs if o])
            it = iter(refs)
            recs = b"".join(struct.pack("<IQI", len(o), *next(it)) if o else bytes(16)
                            for o in objs)
            return np.frombuffer(recs, "V16").reshape(values.shape)
        if t.kind == "bool":
            return np.asarray(values, bool).astype(t.raw)
        return np.asarray(values).astype(t.raw)

    def from_raw(self, raw: np.ndarray) -> np.ndarray:
        t = self.type
        if t.kind == "bool":
            return raw != 0
        if t.kind == "str" and t.pad != 1:  # as libhdf5 converts to h5py's null padding
            cut = (lambda v: v.split(b"\x00", 1)[0]) if t.pad == 0 else \
                (lambda v: v.rstrip(b" "))
            return np.array([cut(v) for v in raw.ravel().tolist()], raw.dtype).reshape(raw.shape)
        if t.kind != "vstr":
            return raw
        recs = np.frombuffer(np.ascontiguousarray(raw).tobytes(),
                             [("n", "<u4"), ("addr", "<u8"), ("index", "<u4")])
        out = np.empty(len(recs), object)
        for k, (n, addr, index) in enumerate(recs.tolist()):
            out[k] = self.h5.gheap_object(addr, index)[:n] if n else b""
        return out.reshape(raw.shape)

    def filled(self, shape) -> np.ndarray:
        out = np.empty(shape, self.type.raw)
        out[...] = self.fill
        return out

    # -- read, write, resize

    def read(self, sel: Sequence[np.ndarray]) -> np.ndarray:
        """The elements at the outer product of ``sel`` (one sorted index
        array an axis), in the type h5py reads."""
        shape = tuple(len(s) for s in sel)
        if 0 in shape:
            return self.from_raw(np.empty(shape, self.type.raw))
        if self.compact is not None:
            full = np.frombuffer(bytes(self.compact), self.type.raw).reshape(self.shape)
            return self.from_raw(full[outer(sel)].copy() if sel else full.copy())
        if self.chunks is None and self.data_addr == UNDEF or \
                self.chunks is not None and self.chunk_tree().root is None:
            return self.from_raw(self.filled(shape))
        if self.chunks is None:
            return self.from_raw(self._read_contiguous(sel, shape))
        out = self.filled(shape)
        for offs, span, local in self.chunk_groups(sel):
            arr = self.chunk(offs)
            if arr is not None:
                out[span] = arr[outer(local)]
        return self.from_raw(out)

    def _read_contiguous(self, sel, shape) -> np.ndarray:
        raw = self.type.raw
        out = np.empty(shape, raw)
        if not sel:
            self.h5.readinto(self.data_addr, out)
            return out
        row = int(np.prod(self.shape[1:], dtype=np.int64)) * raw.itemsize
        whole = all(len(s) == n for s, n in zip(sel[1:], self.shape[1:]))
        rest = (slice(None),) + outer(sel[1:]) if len(sel) > 1 else ()
        for pos, first, n in runs(sel[0]):
            if whole:
                self.h5.readinto(self.data_addr + first * row, out[pos : pos + n])
            else:
                block = np.empty((n,) + tuple(self.shape[1:]), raw)
                self.h5.readinto(self.data_addr + first * row, block)
                out[pos : pos + n] = block[rest]
        return out

    def write(self, sel: Sequence[np.ndarray], values: np.ndarray) -> None:
        """Write ``values`` (shaped as the selection) at the outer product of
        ``sel``."""
        if not self.h5.writable:
            raise ValueError(f"{self.h5.path}: the file is open read-only")
        if 0 in [len(s) for s in sel]:
            return
        raw = self.to_raw(values)
        if self.compact is not None:
            full = np.frombuffer(bytes(self.compact), self.type.raw).reshape(self.shape).copy()
            full[outer(sel) if sel else ()] = raw
            self.compact[:] = full.tobytes()
            self.h5.write(self.compact_addr, bytes(self.compact))
        elif self.chunks is None:
            self._write_contiguous(sel, raw)
        else:
            whole_chunk = tuple(self.chunks[:-1])
            for offs, span, local in self.chunk_groups(sel):
                if all(len(i) == c for i, c in zip(local, whole_chunk)):
                    arr = raw[span]
                else:
                    arr = self.chunk(offs)
                    arr = self.filled(whole_chunk) if arr is None else arr.copy()
                    arr[outer(local)] = raw[span]
                self.store_chunk(offs, arr)

    def _write_contiguous(self, sel, raw: np.ndarray) -> None:
        size = int(np.prod(self.shape, dtype=np.int64)) * self.type.raw.itemsize
        whole = all(len(s) == n for s, n in zip(sel, self.shape))
        if self.data_addr == UNDEF:
            self.data_addr = self.h5.append(raw if whole else self.filled(self.shape))
            self.h5.write(self.addr_pos, struct.pack("<Q", self.data_addr))
            if whole:
                return
        if not sel:
            self.h5.write(self.data_addr, raw)
            return
        row = size // self.shape[0]
        whole_rows = all(len(s) == n for s, n in zip(sel[1:], self.shape[1:]))
        rest = (slice(None),) + outer(sel[1:]) if len(sel) > 1 else ()
        for pos, first, n in runs(sel[0]):
            if whole_rows:
                self.h5.write(self.data_addr + first * row, raw[pos : pos + n])
            else:
                block = np.empty((n,) + tuple(self.shape[1:]), self.type.raw)
                self.h5.readinto(self.data_addr + first * row, block)
                block[rest] = raw[pos : pos + n]
                self.h5.write(self.data_addr + first * row, block)

    def resize(self, shape: Tuple[int, ...]) -> None:
        """Grow the extent (a chunked dataset, within ``maxshape``)."""
        shape = tuple(int(n) for n in shape)
        if self.chunks is None:
            raise TypeError("only chunked datasets can be resized")
        if len(shape) != len(self.shape) or any(
                m is not None and n > m for n, m in zip(shape, self.maxshape)):
            raise ValueError(f"shape {shape} outside maxshape {self.maxshape}")
        if any(n < o for n, o in zip(shape, self.shape)):
            raise ValueError(f"shrinking {self.shape} to {shape} is not supported")
        if not self.h5.writable:
            raise ValueError(f"{self.h5.path}: the file is open read-only")
        self.shape = shape
        self.h5.write(self.dims_addr, struct.pack(f"<{len(shape)}Q", *shape))


# ------------------------------------------------------------- chunk shapes

CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024


def guess_chunk(shape: Sequence[int], itemsize: int) -> Tuple[int, ...]:
    """h5py's chunk rule: aim at a chunk of CHUNK_BASE * 2**log10(dataset
    MiB) bytes, clamped to [CHUNK_MIN, CHUNK_MAX]; halve the axes in turn
    (rounding up) until the chunk is below the target or within half of it,
    and below CHUNK_MAX.  An axis of 0 counts as 1024."""
    chunks = np.array([n if n else 1024 for n in shape], np.float64)
    if not len(chunks):
        raise ValueError("a scalar dataset cannot be chunked")
    target = CHUNK_BASE * 2 ** np.log10(np.prod(chunks) * itemsize / (1024.0 * 1024))
    target = min(max(target, CHUNK_MIN), CHUNK_MAX)
    axis = 0
    while True:
        nbytes = np.prod(chunks) * itemsize
        if (nbytes < target or abs(nbytes - target) / target < 0.5) and nbytes < CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[axis % len(chunks)] = np.ceil(chunks[axis % len(chunks)] / 2.0)
        axis += 1
    return tuple(int(c) for c in chunks)
