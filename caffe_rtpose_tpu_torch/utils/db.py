"""Key-value database abstraction for training data.

Equivalent of the reference's ``db::DB/Cursor/Transaction``
abstraction over LMDB/LevelDB (include/caffe/util/db.hpp,
src/caffe/util/db.cpp:GetDB, db_lmdb.cpp, db_leveldb.cpp).  The API shape
mirrors the reference so data tooling (convert_imageset, the Data layer's
sequential reader) translates one-to-one:

* :func:`open_db` — like ``db::GetDB(backend)`` + ``DB::Open``;
* :class:`DB` — ``new_cursor()`` / ``new_transaction()`` / ``close()``;
* :class:`Cursor` — ``seek_to_first()`` / ``next()`` / ``valid()`` /
  ``key()`` / ``value()`` (db.hpp:17-28);
* :class:`Transaction` — ``put(key, value)`` / ``commit()`` (db.hpp:30-39).

Backends:

* ``"kvdb"`` (default) — our own single-file sorted store (append-only
  record log + sorted offset index), read and written through
  ``native/kvdb.cpp`` (built by ``native.load_lib`` into the port's
  ``_build/``) or, without g++, in Python: byte for byte the same format.
* ``"lmdb"`` / ``"leveldb"`` — used when the corresponding Python binding is
  importable (it is not baked into this image); otherwise a clear error.

Like the reference, cursors iterate in sorted key order and wrap around via
``seek_to_first()`` when exhausted (data_reader.cpp:97-105 read loop).

The port of ``caffe_rtpose_tpu/utils/db.py``.
"""

from __future__ import annotations

import os
import struct
from bisect import bisect_left
from typing import List, Optional, Tuple

_MAGIC = b"CRTKVDB1"
_HEADER = struct.Struct("<8sQQ")
_RECHDR = struct.Struct("<II")


# --------------------------------------------------------------------- kvdb


class _PyKvdb:
    """Pure-Python reader/writer of the kvdb format (see native/kvdb.cpp)."""

    def __init__(self, path: str, writable: bool):
        self.path = path
        self.writable = writable
        self.pending: List[Tuple[bytes, bytes]] = []
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        if not exists:
            if not writable:
                raise IOError(f"kvdb {path!r} does not exist")
            with open(path, "wb") as f:
                f.write(_HEADER.pack(_MAGIC, _HEADER.size, 0))
        self.f = open(path, "r+b" if writable else "rb")
        self._load()

    def _load(self):
        self.f.seek(0)
        magic, self.data_end, count = _HEADER.unpack(self.f.read(_HEADER.size))
        if magic != _MAGIC:
            raise IOError(f"{self.path!r} is not a kvdb file")
        self.f.seek(self.data_end)
        raw = self.f.read(count * 8)
        self.index = list(struct.unpack(f"<{count}Q", raw)) if count else []
        self._keys: Optional[List[bytes]] = None

    def _read_at(self, off: int) -> Tuple[bytes, bytes]:
        self.f.seek(off)
        klen, vlen = _RECHDR.unpack(self.f.read(_RECHDR.size))
        buf = self.f.read(klen + vlen)
        return buf[:klen], buf[klen:]

    def _key_at(self, off: int) -> bytes:
        self.f.seek(off)
        klen, _ = _RECHDR.unpack(self.f.read(_RECHDR.size))
        return self.f.read(klen)

    def count(self) -> int:
        return len(self.index)

    def at(self, pos: int) -> Tuple[bytes, bytes]:
        return self._read_at(self.index[pos])

    def keys(self) -> List[bytes]:
        if self._keys is None:
            self._keys = [self._key_at(o) for o in self.index]
        return self._keys

    def find(self, key: bytes) -> int:
        ks = self.keys()
        i = bisect_left(ks, key)
        return i if i < len(ks) and ks[i] == key else -1 - i

    def put(self, key: bytes, value: bytes):
        if not self.writable:
            raise IOError("kvdb opened read-only")
        self.pending.append((key, value))

    def commit(self):
        if not self.pending:
            return
        # crash safety: append new records AFTER the live index so the old
        # header+index stay valid until the final (single-block) header
        # write; a crash mid-commit leaves the previous view intact
        self.f.seek(0, 2)
        off = max(self.f.tell(), self.data_end + 8 * len(self.index))
        fresh: List[Tuple[bytes, int]] = []
        buf = bytearray()
        for k, v in self.pending:
            fresh.append((k, off + len(buf)))
            buf += _RECHDR.pack(len(k), len(v)) + k + v
        self.f.seek(off)
        self.f.write(buf)
        new_end = off + len(buf)
        # merge with existing sorted index; last write wins
        merged = {k: o for k, o in zip(self.keys(), self.index)}
        for k, o in fresh:
            merged[k] = o
        items = sorted(merged.items())
        self.f.seek(new_end)
        self.f.write(struct.pack(f"<{len(items)}Q", *(o for _, o in items)))
        self.f.flush()
        os.fsync(self.f.fileno())  # records+index durable before the flip
        self.f.seek(0)
        self.f.write(_HEADER.pack(_MAGIC, new_end, len(items)))
        self.f.flush()
        os.fsync(self.f.fileno())
        self.pending.clear()
        self.data_end = new_end
        self.index = [o for _, o in items]
        self._keys = [k for k, _ in items]

    def close(self):
        self.f.close()


class _NativeKvdb:
    """ctypes wrapper over native/kvdb.cpp (the same on-disk format)."""

    def __init__(self, lib, path: str, writable: bool):
        import ctypes

        self._ct = ctypes
        self.lib = lib
        lib.kvdb_open.restype = ctypes.c_void_p
        lib.kvdb_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.kvdb_close.argtypes = [ctypes.c_void_p]
        lib.kvdb_count.restype = ctypes.c_int64
        lib.kvdb_count.argtypes = [ctypes.c_void_p]
        lib.kvdb_put.restype = ctypes.c_int
        lib.kvdb_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                                 ctypes.c_char_p, ctypes.c_int32]
        lib.kvdb_commit.restype = ctypes.c_int
        lib.kvdb_commit.argtypes = [ctypes.c_void_p]
        lib.kvdb_at.restype = ctypes.c_int
        lib.kvdb_at.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.kvdb_find.restype = ctypes.c_int64
        lib.kvdb_find.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
        self.h = lib.kvdb_open(path.encode(), 1 if writable else 0)
        if not self.h:
            raise IOError(f"kvdb_open failed for {path!r}")

    def count(self) -> int:
        return int(self.lib.kvdb_count(self.h))

    def at(self, pos: int) -> Tuple[bytes, bytes]:
        ct = self._ct
        kp, vp = ct.POINTER(ct.c_uint8)(), ct.POINTER(ct.c_uint8)()
        kl, vl = ct.c_int32(), ct.c_int32()
        if self.lib.kvdb_at(self.h, pos, ct.byref(kp), ct.byref(kl), ct.byref(vp),
                            ct.byref(vl)) != 0:
            raise IndexError(pos)
        return (ct.string_at(kp, kl.value), ct.string_at(vp, vl.value))

    def find(self, key: bytes) -> int:
        return int(self.lib.kvdb_find(self.h, key, len(key)))

    def put(self, key: bytes, value: bytes):
        if self.lib.kvdb_put(self.h, key, len(key), value, len(value)) != 0:
            raise IOError("kvdb opened read-only")

    def commit(self):
        if self.lib.kvdb_commit(self.h) != 0:
            raise IOError("kvdb commit failed")

    def close(self):
        if self.h:
            self.lib.kvdb_close(self.h)
            self.h = None


def _kvdb_impl(path: str, writable: bool):
    """The native store when ``native/kvdb.cpp`` builds, else Python."""
    from .. import native

    lib = native.load_lib("kvdb")
    if lib is not None and (writable or os.path.exists(path)):
        try:
            return _NativeKvdb(lib, path, writable)
        except IOError:
            pass  # the Python store reads the same format, and says why it cannot
    return _PyKvdb(path, writable)


# ------------------------------------------------------------ reference API


class Cursor:
    """Sorted-order cursor (db.hpp:17-28)."""

    def __init__(self, impl):
        self._impl = impl
        self._pos = 0

    def seek_to_first(self):
        self._pos = 0

    def next(self):
        self._pos += 1

    def valid(self) -> bool:
        return 0 <= self._pos < self._impl.count()

    def key(self) -> bytes:
        return self._impl.at(self._pos)[0]

    def value(self) -> bytes:
        return self._impl.at(self._pos)[1]

    # reference naming aliases
    SeekToFirst = seek_to_first
    Next = next


class Transaction:
    """Write batch (db.hpp:30-39)."""

    def __init__(self, impl):
        self._impl = impl

    def put(self, key, value):
        if isinstance(key, str):
            key = key.encode()
        if isinstance(value, str):
            value = value.encode()
        self._impl.put(key, value)

    def commit(self):
        self._impl.commit()

    Put = put
    Commit = commit


class DB:
    """A named key-value store (db.hpp:41-51)."""

    def __init__(self, impl, backend: str):
        self._impl = impl
        self.backend = backend

    def new_cursor(self) -> Cursor:
        return Cursor(self._impl)

    def new_transaction(self) -> Transaction:
        return Transaction(self._impl)

    def get(self, key) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode()
        pos = self._impl.find(key)
        return self._impl.at(pos)[1] if pos >= 0 else None

    def __len__(self) -> int:
        return self._impl.count()

    def close(self):
        self._impl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    NewCursor = new_cursor
    NewTransaction = new_transaction


class _LmdbImpl:
    """Adapter when the ``lmdb`` binding is importable (not in this image)."""

    def __init__(self, path: str, writable: bool):
        import lmdb  # gated import

        self.env = lmdb.open(path, readonly=not writable, map_size=1 << 40,
                             subdir=os.path.isdir(path) or writable, lock=writable)
        self.pending: List[Tuple[bytes, bytes]] = []
        self._refresh()

    def _refresh(self):
        with self.env.begin() as txn:
            self._items = [(k, bytes(v)) for k, v in txn.cursor()]
        self._keys = [k for k, _ in self._items]

    def count(self):
        return len(self._items)

    def at(self, pos):
        return self._items[pos]

    def find(self, key):
        ks = self._keys
        i = bisect_left(ks, key)
        return i if i < len(ks) and ks[i] == key else -1 - i

    def put(self, key, value):
        self.pending.append((key, value))

    def commit(self):
        with self.env.begin(write=True) as txn:
            for k, v in self.pending:
                txn.put(k, v)
        self.pending.clear()
        self._refresh()

    def close(self):
        self.env.close()


class _LevelDbImpl:
    """LevelDB directory backend over the clean-room format codec
    (utils/leveldb_fmt.py) — reads reference-generated datasets
    (util/db_leveldb.cpp output) without the leveldb library.

    Reads snapshot the merged live state at open through a LAZY index:
    keys stay in RAM, sstable values are fetched (and block-cached) on
    access, so a multi-GB Datum DB does not load into memory.  Commits
    APPEND the pending puts as a WriteBatch to the live .log — O(delta),
    like real pre-compaction leveldb writes — instead of rewriting the DB."""

    def __init__(self, path: str, writable: bool):
        from . import leveldb_fmt as ldb

        self._ldb = ldb
        self.path = path
        self.writable = writable
        self._overlay: dict = {}
        if os.path.exists(os.path.join(path, "CURRENT")):
            self._lazy = ldb.LazyDb(path)
            self._keys = self._lazy.keys()
            self._seq = ldb.next_seq(path) if writable else 0
        elif writable:
            self._lazy = None
            self._keys = []
            self._seq = 1
        else:
            raise FileNotFoundError(f"{path}: no LevelDB CURRENT file")
        self.pending: List[Tuple[bytes, bytes]] = []
        self._pos_map = None

    def count(self):
        return len(self._keys)

    def at(self, pos):
        k = self._keys[pos]
        if k in self._overlay:
            return k, self._overlay[k]
        return k, self._lazy.value(self._lazy_pos[pos])

    def find(self, key):
        i = bisect_left(self._keys, key)
        return i if i < len(self._keys) and self._keys[i] == key else -1 - i

    @property
    def _lazy_pos(self):
        # maps merged position -> LazyDb position; identity until writes
        # interleave new keys, then rebuilt by commit()
        if self._pos_map is None:
            lazy_keys = self._lazy.keys() if self._lazy else []
            lk = {k: i for i, k in enumerate(lazy_keys)}
            self._pos_map = [lk.get(k, -1) for k in self._keys]
        return self._pos_map

    def put(self, key, value):
        self.pending.append((key, value))

    def commit(self):
        if not self.writable:
            raise IOError("read-only LevelDB handle")
        if not self.pending:
            return
        if self._lazy is None and not os.path.exists(
                os.path.join(self.path, "CURRENT")):
            # first commit of a fresh DB: create it, then keep appending
            self._ldb.write_db(self.path, sorted(dict(self.pending).items()))
            self._lazy = self._ldb.LazyDb(self.path)
            self._seq = self._ldb.next_seq(self.path)
        else:
            # seq tracked locally: a commit costs one batch append, no
            # rescan of earlier logs
            self._ldb.append_db(
                self.path,
                [(self._ldb.TYPE_VALUE, k, v) for k, v in self.pending],
                seq=self._seq)
            self._seq += len(self.pending)
        # merge into the in-memory view without reloading values
        self._overlay.update(self.pending)
        merged = sorted(set(self._keys) | set(self._overlay))
        self._keys = merged
        self._pos_map = None
        self.pending.clear()

    def close(self):
        if self.pending:
            self.commit()


def open_db(source: str, mode: str = "r", backend: str = "auto") -> DB:
    """Open a database.  ``mode``: 'r' read, 'w' read-write (creates if
    absent).  ``backend``: 'kvdb' | 'lmdb' | 'leveldb' | 'auto' (sniff:
    a directory with a CURRENT file is LevelDB, other directories /
    .mdb/.lmdb paths are LMDB, else kvdb)."""
    writable = mode in ("w", "rw", "new")
    if backend == "auto":
        if os.path.exists(os.path.join(source, "CURRENT")):
            backend = "leveldb"
        elif source.endswith((".mdb", ".lmdb")) or os.path.isdir(source):
            backend = "lmdb"
        else:
            backend = "kvdb"
    if backend == "kvdb":
        return DB(_kvdb_impl(source, writable), "kvdb")
    if backend == "leveldb":
        return DB(_LevelDbImpl(source, writable), "leveldb")
    if backend == "lmdb":
        try:
            return DB(_LmdbImpl(source, writable), "lmdb")
        except ImportError as e:
            raise ImportError(
                "lmdb backend requested but the 'lmdb' Python binding is not "
                "installed; use the portable 'kvdb' backend instead"
            ) from e
    raise ValueError(f"unknown db backend {backend!r}")


def convert_db(src: str, dst: str, src_backend: str = "auto",
               dst_backend: str = "kvdb") -> int:
    """Copy every record from ``src`` to ``dst`` (the migration path for
    reference LevelDB/LMDB datasets).  Returns the record count."""
    sdb = open_db(src, "r", backend=src_backend)
    ddb = open_db(dst, "w", backend=dst_backend)
    txn = ddb.new_transaction()
    cur = sdb.new_cursor()
    cur.seek_to_first()
    n = 0
    while cur.valid():
        txn.put(cur.key(), cur.value())
        n += 1
        if n % 500 == 0:
            txn.commit()
        cur.next()
    txn.commit()
    ddb.close()
    sdb.close()
    return n
