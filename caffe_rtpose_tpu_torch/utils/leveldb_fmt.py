"""Clean-room LevelDB on-disk format codec (read + write, no leveldb lib).

The reference framework stores datasets in LevelDB (util/db_leveldb.cpp) or
LMDB; this image ships neither binding, so the format itself is implemented
here from the public spec (leveldb doc/log_format.md, doc/table_format.md,
doc/impl.md): 32KB-block record logs with masked crc32c, WriteBatch payloads,
MANIFEST VersionEdits, and SSTables (prefix-compressed blocks + restarts,
optional snappy, BlockHandle index, 48-byte footer with magic).

Scope: everything needed to *ingest a reference-generated dataset* (full
ordered scan with correct newest-sequence/deletion semantics across the log
and all live tables) and to *emit a valid DB* (log-only fresh DB, or
compacted single-table DB) that real leveldb can open.

Snappy blocks decompress through libsnappy via ctypes when present, else a
pure-Python decoder; we always write uncompressed blocks (type 0), which
every leveldb reader accepts.

A copy of ``caffe_rtpose_tpu/utils/leveldb_fmt.py``, which cannot be imported
without jax.
"""

from __future__ import annotations

import os
import struct
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

# ----------------------------------------------------------- crc32c + mask

_CRC_TABLE: List[int] = []


def _crc_init():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_crc_init()


def crc32c(data: bytes, crc: int = 0) -> int:
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc_mask(crc: int) -> int:
    # leveldb util/crc32c.h Mask()
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def crc_unmask(masked: int) -> int:
    rot = (masked - 0xA282EAD8) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# ----------------------------------------------------------------- varints


def put_varint(out: bytearray, v: int):
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def get_varint(buf: bytes, off: int) -> Tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, off
        shift += 7


def _put_len_prefixed(out: bytearray, s: bytes):
    put_varint(out, len(s))
    out += s


def _get_len_prefixed(buf: bytes, off: int) -> Tuple[bytes, int]:
    n, off = get_varint(buf, off)
    return buf[off : off + n], off + n


# ------------------------------------------------------------------ snappy


def _load_libsnappy():
    import ctypes.util

    for name in ("snappy", "snappy.1"):
        path = ctypes.util.find_library(name)
        if path:
            break
    else:
        path = "libsnappy.so.1"
    try:
        import ctypes

        lib = ctypes.CDLL(path)
        lib.snappy_uncompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.snappy_uncompressed_length.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
        return lib
    except OSError:
        return None


_SNAPPY = _load_libsnappy()


def snappy_decompress(data: bytes) -> bytes:
    if _SNAPPY is not None:
        import ctypes

        n = ctypes.c_size_t()
        if _SNAPPY.snappy_uncompressed_length(data, len(data),
                                              ctypes.byref(n)) != 0:
            raise ValueError("corrupt snappy preamble")
        out = ctypes.create_string_buffer(n.value)
        m = ctypes.c_size_t(n.value)
        if _SNAPPY.snappy_uncompress(data, len(data), out,
                                     ctypes.byref(m)) != 0:
            raise ValueError("snappy decompression failed")
        return out.raw[: m.value]
    # pure-Python decoder (format_description.txt tag stream)
    total, off = get_varint(data, 0)
    out = bytearray()
    while off < len(data):
        tag = data[off]
        off += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = (tag >> 2) + 1
            if ln > 60:
                nbytes = ln - 60
                ln = int.from_bytes(data[off : off + nbytes], "little") + 1
                off += nbytes
            out += data[off : off + ln]
            off += ln
        else:
            if kind == 1:
                ln = ((tag >> 2) & 7) + 4
                offset = ((tag >> 5) << 8) | data[off]
                off += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[off : off + 2], "little")
                off += 2
            else:
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[off : off + 4], "little")
                off += 4
            if offset == 0:
                raise ValueError("corrupt snappy copy offset")
            for _ in range(ln):  # may overlap: byte-at-a-time
                out.append(out[-offset])
    if len(out) != total:
        raise ValueError("snappy length mismatch")
    return bytes(out)


# ----------------------------------------------------- record log (.log)

LOG_BLOCK = 32768
_FULL, _FIRST, _MIDDLE, _LAST = 1, 2, 3, 4


def _write_framed(f, records: Iterable[bytes], block_off: int) -> int:
    """Shared log_writer framing: records fragmented across 32KB blocks,
    each fragment <masked crc32c(type+data)><len u16><type u8><data>.
    Returns the block offset after the last write."""
    for rec in records:
        pos, left = 0, len(rec)
        begin = True
        while True:
            avail = LOG_BLOCK - block_off
            if avail < 7:
                f.write(b"\x00" * avail)
                block_off = 0
                avail = LOG_BLOCK
            frag = min(left, avail - 7)
            end = frag == left
            t = (_FULL if begin and end else _FIRST if begin
                 else _LAST if end else _MIDDLE)
            payload = rec[pos : pos + frag]
            crc = crc_mask(crc32c(payload, crc32c(bytes([t]))))
            f.write(struct.pack("<IHB", crc, frag, t) + payload)
            block_off += 7 + frag
            pos += frag
            left -= frag
            begin = False
            if end:
                break
    return block_off


def write_log(path: str, records: Iterable[bytes]):
    with open(path, "wb") as f:
        _write_framed(f, records, 0)


def read_log(path: str) -> List[bytes]:
    """Reassemble records; stops at a zeroed/invalid trailer OR a bad-crc
    fragment, like leveldb's (non-paranoid) log recovery — a crash can
    tear the final record mid-write and the tail is dropped, not fatal.
    (Table blocks keep strict crc checking; a bad block there is real
    corruption, not an expected crash artifact.)"""
    out: List[bytes] = []
    with open(path, "rb") as f:
        data = f.read()
    n = len(data)
    off = 0
    partial = bytearray()
    while off + 7 <= n:
        if LOG_BLOCK - (off % LOG_BLOCK) < 7:
            off += LOG_BLOCK - (off % LOG_BLOCK)
            continue
        crc, ln, t = struct.unpack_from("<IHB", data, off)
        if t == 0 and ln == 0 and crc == 0:  # zero trailer
            off += 7
            continue
        payload = data[off + 7 : off + 7 + ln]
        if len(payload) < ln:
            break
        if crc_unmask(crc) != crc32c(payload, crc32c(bytes([t]))):
            break  # torn tail — drop like leveldb log recovery
        off += 7 + ln
        if t == _FULL:
            out.append(bytes(payload))
        elif t == _FIRST:
            partial = bytearray(payload)
        elif t == _MIDDLE:
            partial += payload
        elif t == _LAST:
            partial += payload
            out.append(bytes(partial))
            partial = bytearray()
        else:
            raise ValueError(f"bad log record type {t}")
    return out


# -------------------------------------------------------------- WriteBatch

TYPE_DELETION, TYPE_VALUE = 0, 1


def encode_write_batch(seq: int,
                       ops: List[Tuple[int, bytes, Optional[bytes]]]) -> bytes:
    """[seq u64][count u32] then per op: <tag u8><klen varint><key>
    (<vlen varint><value> for puts)."""
    out = bytearray(struct.pack("<QI", seq, len(ops)))
    for t, k, v in ops:
        out.append(t)
        _put_len_prefixed(out, k)
        if t == TYPE_VALUE:
            _put_len_prefixed(out, v or b"")
    return bytes(out)


def decode_write_batch(buf: bytes) -> Tuple[int, List[Tuple[int, bytes, Optional[bytes]]]]:
    seq, count = struct.unpack_from("<QI", buf, 0)
    off = 12
    ops: List[Tuple[int, bytes, Optional[bytes]]] = []
    for _ in range(count):
        t = buf[off]
        off += 1
        k, off = _get_len_prefixed(buf, off)
        v = None
        if t == TYPE_VALUE:
            v, off = _get_len_prefixed(buf, off)
        ops.append((t, k, v))
    return seq, ops


# ------------------------------------------------------------- VersionEdit

_TAG_COMPARATOR = 1
_TAG_LOG_NUMBER = 2
_TAG_NEXT_FILE = 3
_TAG_LAST_SEQ = 4
_TAG_COMPACT_POINTER = 5
_TAG_DELETED_FILE = 6
_TAG_NEW_FILE = 7
_TAG_PREV_LOG = 9


def encode_version_edit(comparator: Optional[str] = None,
                        log_number: Optional[int] = None,
                        next_file: Optional[int] = None,
                        last_seq: Optional[int] = None,
                        new_files: Iterable[Tuple[int, int, int, bytes, bytes]] = ()) -> bytes:
    out = bytearray()
    if comparator is not None:
        put_varint(out, _TAG_COMPARATOR)
        _put_len_prefixed(out, comparator.encode())
    if log_number is not None:
        put_varint(out, _TAG_LOG_NUMBER)
        put_varint(out, log_number)
    if next_file is not None:
        put_varint(out, _TAG_NEXT_FILE)
        put_varint(out, next_file)
    if last_seq is not None:
        put_varint(out, _TAG_LAST_SEQ)
        put_varint(out, last_seq)
    for level, num, size, smallest, largest in new_files:
        put_varint(out, _TAG_NEW_FILE)
        put_varint(out, level)
        put_varint(out, num)
        put_varint(out, size)
        _put_len_prefixed(out, smallest)
        _put_len_prefixed(out, largest)
    return bytes(out)


def decode_version_edit(buf: bytes) -> Dict:
    off = 0
    edit: Dict = {"new_files": [], "deleted_files": []}
    while off < len(buf):
        tag, off = get_varint(buf, off)
        if tag == _TAG_COMPARATOR:
            s, off = _get_len_prefixed(buf, off)
            edit["comparator"] = s.decode()
        elif tag in (_TAG_LOG_NUMBER, _TAG_NEXT_FILE, _TAG_LAST_SEQ,
                     _TAG_PREV_LOG):
            v, off = get_varint(buf, off)
            key = {_TAG_LOG_NUMBER: "log_number", _TAG_NEXT_FILE: "next_file",
                   _TAG_LAST_SEQ: "last_seq", _TAG_PREV_LOG: "prev_log"}[tag]
            edit[key] = v
        elif tag == _TAG_COMPACT_POINTER:
            _, off = get_varint(buf, off)
            _, off = _get_len_prefixed(buf, off)
        elif tag == _TAG_DELETED_FILE:
            lvl, off = get_varint(buf, off)
            num, off = get_varint(buf, off)
            edit["deleted_files"].append((lvl, num))
        elif tag == _TAG_NEW_FILE:
            lvl, off = get_varint(buf, off)
            num, off = get_varint(buf, off)
            size, off = get_varint(buf, off)
            smallest, off = _get_len_prefixed(buf, off)
            largest, off = _get_len_prefixed(buf, off)
            edit["new_files"].append((lvl, num, size, smallest, largest))
        else:
            raise ValueError(f"unknown VersionEdit tag {tag}")
    return edit


# ----------------------------------------------------------------- SSTable

TABLE_MAGIC = 0xDB4775248B80FB57
_BLOCK_SIZE = 4096
_RESTART_INTERVAL = 16


class _BlockBuilder:
    def __init__(self):
        self.buf = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.last_key = b""

    def add(self, key: bytes, value: bytes):
        shared = 0
        if self.counter < _RESTART_INTERVAL:
            m = min(len(key), len(self.last_key))
            while shared < m and key[shared] == self.last_key[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.counter = 0
        put_varint(self.buf, shared)
        put_varint(self.buf, len(key) - shared)
        put_varint(self.buf, len(value))
        self.buf += key[shared:]
        self.buf += value
        self.last_key = key
        self.counter += 1

    def finish(self) -> bytes:
        out = bytearray(self.buf)
        for r in self.restarts:
            out += struct.pack("<I", r)
        out += struct.pack("<I", len(self.restarts))
        return bytes(out)

    def __len__(self):
        return len(self.buf) + 4 * (len(self.restarts) + 1)


def _decode_block(block: bytes) -> List[Tuple[bytes, bytes]]:
    if len(block) < 4:
        return []
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * n_restarts
    out: List[Tuple[bytes, bytes]] = []
    off = 0
    key = b""
    while off < data_end:
        shared, off = get_varint(block, off)
        non_shared, off = get_varint(block, off)
        vlen, off = get_varint(block, off)
        key = key[:shared] + block[off : off + non_shared]
        off += non_shared
        out.append((key, block[off : off + vlen]))
        off += vlen
    return out


def _encode_handle(offset: int, size: int) -> bytes:
    out = bytearray()
    put_varint(out, offset)
    put_varint(out, size)
    return bytes(out)


def _decode_handle(buf: bytes, off: int) -> Tuple[int, int, int]:
    offset, off = get_varint(buf, off)
    size, off = get_varint(buf, off)
    return offset, size, off


def internal_key(user_key: bytes, seq: int, typ: int) -> bytes:
    return user_key + struct.pack("<Q", (seq << 8) | typ)


def parse_internal_key(ikey: bytes) -> Tuple[bytes, int, int]:
    tail = struct.unpack("<Q", ikey[-8:])[0]
    return ikey[:-8], tail >> 8, tail & 0xFF


def write_table(path: str,
                entries: List[Tuple[bytes, bytes]]) -> int:
    """Write an .ldb from sorted *internal-key* entries; returns file size.
    Blocks are stored uncompressed (type 0) — valid for any reader."""
    with open(path, "wb") as f:
        index: List[Tuple[bytes, bytes]] = []

        def emit_block(bb: _BlockBuilder) -> bytes:
            data = bb.finish()
            handle = _encode_handle(f.tell(), len(data))
            trailer = bytes([0])
            crc = crc_mask(crc32c(trailer, crc32c(data)))
            f.write(data + trailer + struct.pack("<I", crc))
            return handle

        bb = _BlockBuilder()
        for key, value in entries:
            bb.add(key, value)
            if len(bb) >= _BLOCK_SIZE:
                index.append((bb.last_key, emit_block(bb)))
                bb = _BlockBuilder()
        if bb.buf:
            index.append((bb.last_key, emit_block(bb)))

        meta_bb = _BlockBuilder()  # empty metaindex
        meta_handle = emit_block(meta_bb)
        idx_bb = _BlockBuilder()
        for last_key, handle in index:
            idx_bb.add(last_key, handle)
        idx_handle = emit_block(idx_bb)

        footer = bytearray(meta_handle + idx_handle)
        footer += b"\x00" * (40 - len(footer))
        footer += struct.pack("<Q", TABLE_MAGIC)
        f.write(footer)
        return f.tell()


def _check_block(path, raw: bytes, typ: int, crc: int) -> bytes:
    if crc_unmask(crc) != crc32c(bytes([typ]), crc32c(raw)):
        raise ValueError(f"{path}: block crc mismatch")
    if typ == 0:
        return raw
    if typ == 1:
        return snappy_decompress(raw)
    raise ValueError(f"{path}: unknown block compression {typ}")


def table_block_handles(path: str) -> List[Tuple[int, int]]:
    """Data-block (offset, size) handles from an sstable's index block,
    touching only the footer + index region on disk."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        f.seek(size - 48)
        footer = f.read(48)
        if struct.unpack("<Q", footer[-8:])[0] != TABLE_MAGIC:
            raise ValueError(f"{path}: not an sstable (bad footer magic)")
        _, _, off = _decode_handle(footer, 0)
        idx_off, idx_size, _ = _decode_handle(footer, off)
        f.seek(idx_off)
        raw = f.read(idx_size)
        typ = f.read(1)[0]
        crc = struct.unpack("<I", f.read(4))[0]
    handles = []
    for _, h in _decode_block(_check_block(path, raw, typ, crc)):
        b_off, b_size, _ = _decode_handle(h, 0)
        handles.append((b_off, b_size))
    return handles


def read_table_block(path: str, offset: int, size: int) -> List[Tuple[bytes, bytes]]:
    """Decode ONE data block (its (internal_key, value) entries), reading
    only that byte range — the unit the LazyDb value cache holds."""
    with open(path, "rb") as f:
        f.seek(offset)
        raw = f.read(size)
        typ = f.read(1)[0]
        crc = struct.unpack("<I", f.read(4))[0]
    return _decode_block(_check_block(path, raw, typ, crc))


def read_table(path: str) -> List[Tuple[bytes, bytes]]:
    """Full ordered scan of an .ldb/.sst: (internal_key, value) pairs."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 48 or struct.unpack("<Q", data[-8:])[0] != TABLE_MAGIC:
        raise ValueError(f"{path}: not an sstable (bad footer magic)")
    footer = data[-48:]
    _, _, off = _decode_handle(footer, 0)  # metaindex (unused)
    idx_off, idx_size, _ = _decode_handle(footer, off)

    def load_block(offset: int, size: int) -> bytes:
        raw = data[offset : offset + size]
        typ = data[offset + size]
        crc = struct.unpack_from("<I", data, offset + size + 1)[0]
        if crc_unmask(crc) != crc32c(bytes([typ]), crc32c(raw)):
            raise ValueError(f"{path}: block crc mismatch at {offset}")
        if typ == 0:
            return raw
        if typ == 1:
            return snappy_decompress(raw)
        raise ValueError(f"{path}: unknown block compression {typ}")

    out: List[Tuple[bytes, bytes]] = []
    for _, handle in _decode_block(load_block(idx_off, idx_size)):
        b_off, b_size, _ = _decode_handle(handle, 0)
        out.extend(_decode_block(load_block(b_off, b_size)))
    return out


# ----------------------------------------------------------- whole-DB API


def _read_manifest(path: str):
    """CURRENT -> merged MANIFEST state: (live_files {num: level},
    min replayable log number, last_seq)."""
    current = os.path.join(path, "CURRENT")
    with open(current) as f:
        manifest = f.read().strip()
    live_files: Dict[int, int] = {}
    log_number = 0
    prev_log = None
    last_seq = 0
    for rec in read_log(os.path.join(path, manifest)):
        edit = decode_version_edit(rec)
        log_number = edit.get("log_number", log_number)
        prev_log = edit.get("prev_log", prev_log)
        last_seq = edit.get("last_seq", last_seq)
        for lvl, num, _size, _s, _l in edit["new_files"]:
            live_files[num] = lvl
        for _lvl, num in edit["deleted_files"]:
            live_files.pop(num, None)
    min_log = min(log_number, prev_log) if prev_log else log_number
    return live_files, min_log, last_seq


def _replayable_logs(path: str, min_log: int) -> List[str]:
    """Every NNNNNN.log present with number >= min_log, ascending — real
    leveldb recovery replays prev_log and any logs newer than the
    manifest's log_number (a crash can leave both)."""
    logs = []
    for name in os.listdir(path):
        if name.endswith(".log") and name[:-4].isdigit() and \
                int(name[:-4]) >= min_log:
            logs.append(int(name[:-4]))
    return [os.path.join(path, f"{n:06d}.log") for n in sorted(logs)]


def _next_file_number(path: str) -> int:
    """A file number safe to allocate: max(MANIFEST next_file, every
    numbered file in the directory) + 1 — preserving the uniqueness
    invariant real leveldb's VersionSet::NewFileNumber maintains."""
    hi = 0
    current = os.path.join(path, "CURRENT")
    try:
        with open(current) as f:
            manifest = f.read().strip()
        for rec in read_log(os.path.join(path, manifest)):
            edit = decode_version_edit(rec)
            nf = edit.get("next_file")
            if nf:
                hi = max(hi, int(nf) - 1)
        m = manifest.rsplit("-", 1)
        if len(m) == 2 and m[1].isdigit():
            hi = max(hi, int(m[1]))
    except OSError:
        pass
    for name in os.listdir(path):
        stem = name.split(".")[0]
        if stem.isdigit():
            hi = max(hi, int(stem))
    return hi + 1


def _scan_entries(path: str, keep_values: bool):
    """Yield (user_key, seq, type, payload) from tables + replayable logs.
    ``payload`` is the value when keep_values, else a locator:
    ("t", table_path, block_off, block_size, entry_index) or ("m", value)
    for log entries."""
    live_files, min_log, _ = _read_manifest(path)
    entries = []
    for num in live_files:
        for name in (f"{num:06d}.ldb", f"{num:06d}.sst"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                for b_off, b_size in table_block_handles(p):
                    for i, (ikey, val) in enumerate(
                            read_table_block(p, b_off, b_size)):
                        uk, seq, typ = parse_internal_key(ikey)
                        entries.append((
                            uk, seq, typ,
                            val if keep_values
                            else ("t", p, b_off, b_size, i)))
                break
    for log_path in _replayable_logs(path, min_log):
        for rec in read_log(log_path):
            seq, ops = decode_write_batch(rec)
            for i, (typ, k, v) in enumerate(ops):
                v = v or b""
                entries.append((k, seq + i, typ,
                                v if keep_values else ("m", v)))
    return entries


def _merge_newest(entries):
    """Sort by (key, -seq), keep newest per key, drop deletions."""
    entries.sort(key=lambda e: (e[0], -e[1]))
    out = []
    prev: Optional[bytes] = None
    for uk, _seq, typ, payload in entries:
        if uk == prev:
            continue
        prev = uk
        if typ == TYPE_VALUE:
            out.append((uk, payload))
    return out


def read_db(path: str) -> List[Tuple[bytes, bytes]]:
    """Merged, sorted full scan of a LevelDB directory.

    Gathers every (user_key, seq, type, value) from the replayable logs
    and all live tables named by the MANIFEST, keeps the newest sequence
    per user key, and drops deletions — the semantics of a fresh iterator
    over the current version (doc/impl.md)."""
    return _merge_newest(_scan_entries(path, keep_values=True))


class LazyDb:
    """Index-only open: one streaming pass enumerates keys, but sstable
    VALUES are not retained — each access decodes only its ~4KB data block
    through a small LRU block cache, so resident memory is
    O(keys + delta log + cache), not O(dataset).  This is what lets
    multi-GB Datum DBs (including single-table ones) feed training without
    loading the whole dataset into RAM."""

    _BLOCK_CACHE = 64  # blocks (~4KB each uncompressed source data)

    def __init__(self, path: str):
        self._items = _merge_newest(_scan_entries(path, keep_values=False))
        self._cache: "OrderedDict[Tuple[str, int], List[Tuple[bytes, bytes]]]" = \
            OrderedDict()

    def __len__(self):
        return len(self._items)

    def key(self, pos: int) -> bytes:
        return self._items[pos][0]

    def keys(self) -> List[bytes]:
        return [k for k, _ in self._items]

    def value(self, pos: int) -> bytes:
        loc = self._items[pos][1]
        if loc[0] == "m":
            return loc[1]
        _, table_path, b_off, b_size, idx = loc
        ck = (table_path, b_off)
        block = self._cache.get(ck)
        if block is None:
            block = read_table_block(table_path, b_off, b_size)
            self._cache[ck] = block
            if len(self._cache) > self._BLOCK_CACHE:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(ck)
        return block[idx][1]


def _log_valid_end(path: str) -> Tuple[int, bool]:
    """(byte offset after the last VALID record fragment, tail_clean).
    A torn tail (crash mid-commit) leaves a partial/bad-crc fragment that
    must not be appended after — later records would be lost to (or
    corrupt) recovery."""
    if not os.path.exists(path):
        return 0, True
    with open(path, "rb") as f:
        data = f.read()
    n = len(data)
    off = 0
    good = 0
    while off + 7 <= n:
        if LOG_BLOCK - (off % LOG_BLOCK) < 7:
            off += LOG_BLOCK - (off % LOG_BLOCK)
            good = off
            continue
        crc, ln, t = struct.unpack_from("<IHB", data, off)
        if t == 0 and ln == 0 and crc == 0:
            off += 7
            good = off
            continue
        payload = data[off + 7 : off + 7 + ln]
        if len(payload) < ln or \
                crc_unmask(crc) != crc32c(payload, crc32c(bytes([t]))):
            return good, False
        off += 7 + ln
        good = off
    return good, off >= n  # trailing sub-header bytes are torn too


def next_seq(path: str) -> int:
    """1 + the newest sequence visible in the DB (manifest last_seq plus
    anything in the replayable logs)."""
    _, min_log, last_seq = _read_manifest(path)
    for log_path in _replayable_logs(path, min_log):
        for rec in read_log(log_path):
            seq, ops = decode_write_batch(rec)
            last_seq = max(last_seq, seq + len(ops) - 1)
    return last_seq + 1


def append_db(path: str, ops: List[Tuple[int, bytes, Optional[bytes]]],
              seq: Optional[int] = None):
    """Append one WriteBatch of (type, key, value) ops to the live log of
    an existing DB — O(delta), the write path real leveldb uses before
    compaction.  If the newest log has a torn tail (crash mid-commit), the
    batch starts a FRESH higher-numbered log like real recovery, instead
    of appending unreachable bytes after the tear.  ``seq`` lets a caller
    that tracks sequences (e.g. _LevelDbImpl) skip the log rescan."""
    live_files, min_log, _ = _read_manifest(path)
    logs = _replayable_logs(path, min_log)
    log_path = logs[-1] if logs else os.path.join(path,
                                                 f"{min_log:06d}.log")
    end, clean = _log_valid_end(log_path)
    if not clean:
        # fresh-log number must respect LevelDB's file-number-uniqueness
        # invariant: above the MANIFEST's next_file counter AND every
        # number already used by a table/log/manifest in the directory
        # (a bare last_log+1 could collide with an sstable and corrupt
        # the DB under a later real-leveldb compaction)
        num = _next_file_number(path)
        log_path = os.path.join(path, f"{num:06d}.log")
        end = 0
    if seq is None:
        seq = next_seq(path)
    with open(log_path, "ab") as f:
        _write_framed(f, [encode_write_batch(seq, ops)], end % LOG_BLOCK)


def write_db(path: str, items: Iterable[Tuple[bytes, bytes]],
             compact: bool = True):
    """Create a fresh LevelDB directory holding ``items``.

    ``compact=True`` writes one level-1 sstable (like a compacted DB);
    otherwise everything goes into the live .log (like an un-compacted
    fresh DB) — both forms exercise real readers' separate paths."""
    os.makedirs(path, exist_ok=True)
    items = sorted(items)
    seq = len(items)
    if compact:
        table_num, manifest_num = 5, 2
        entries = [(internal_key(k, i + 1, TYPE_VALUE), v)
                   for i, (k, v) in enumerate(items)]
        size = write_table(os.path.join(path, f"{table_num:06d}.ldb"),
                           entries)
        smallest = entries[0][0] if entries else b""
        largest = entries[-1][0] if entries else b""
        edit = encode_version_edit(
            comparator="leveldb.BytewiseComparator", log_number=6,
            next_file=7, last_seq=seq,
            new_files=[(1, table_num, size, smallest, largest)])
        write_log(os.path.join(path, f"{6:06d}.log"), [])
    else:
        batches = [encode_write_batch(
            i + 1, [(TYPE_VALUE, k, v)]) for i, (k, v) in enumerate(items)]
        write_log(os.path.join(path, f"{3:06d}.log"), batches)
        manifest_num = 2
        edit = encode_version_edit(comparator="leveldb.BytewiseComparator",
                                   log_number=3, next_file=4, last_seq=seq)
    write_log(os.path.join(path, f"MANIFEST-{manifest_num:06d}"), [edit])
    with open(os.path.join(path, "CURRENT"), "w") as f:
        f.write(f"MANIFEST-{manifest_num:06d}\n")
