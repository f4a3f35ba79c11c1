"""Matroska and WebM files (EBML) parsed with ``struct``: the first video
track's frames as libavformat's ``matroska`` demuxer hands them to OpenCV.

:func:`parse` reads the EBML header (DocType ``matroska`` or ``webm``, IDs
of at most 4 bytes, sizes of at most 8; anything else is refused), then the
Segment's level-1 elements in file order (a Segment or Cluster of unknown
size ends where an element that cannot be its child begins; ``EBMLVoid``
and ``CRC-32`` are skipped), and follows the ``SeekHead`` to ``Info``,
``Tracks`` and ``Cues`` that the walk did not reach.  ``Info`` gives
TimestampScale (default 1,000,000 ns) and Duration; ``Tracks`` the first
``TrackEntry`` of TrackType 1 (OpenCV takes the first video stream):
TrackNumber, CodecID, CodecPrivate, DefaultDuration and ContentEncodings
(the pictures' size is the codec's; ``PixelCrop*`` changes nothing in
cv2's frames): header stripping (ContentCompAlgo 3)
and zlib (0), on the frames and, where ContentEncodingScope says so, on
CodecPrivate.  bzlib, LZO, encryption, several encodings and a
TrackTimestampScale other than 1.0 raise :class:`MkvRefused` naming them.

Each Cluster's SimpleBlocks (key frame flag 0x80) and BlockGroups (a key
frame is a Block without ReferenceBlock; BlockDuration) of the track give
its frames, Xiph, fixed-size and EBML lacing included, as libavformat gives
them: a block's timestamp is the Cluster's Timestamp plus its signed 16-bit
offset; the laces after the first follow at the block's duration
(BlockDuration, else DefaultDuration x laces / TimestampScale, both in
whole ticks) split as libavformat splits it, and only the first lace is a
key frame.  The invisible flag changes nothing.  Blocks of other declared
tracks are passed; a block of a track that no TrackEntry declares is an
error to libavformat, which drops the rest of its Cluster and resyncs at
the next level-1 element; a block that the end of the file cuts, and what
follows it, are not read.  The seek index (:attr:`MkvTrack.seek_index`)
is what ``av_seek_frame`` searches: the Cues' CueTime and CueClusterPosition
of the track and each key frame's timestamp and Cluster, as the demuxer
indexes them while it reads.
"""

from __future__ import annotations

import bisect
import math
import struct
import zlib
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional, Tuple

from .bmff import Sample, Track

EBML, SEGMENT, VOID, CRC32 = 0x1A45DFA3, 0x18538067, 0xEC, 0xBF
SEEK_HEAD, INFO, TRACKS, CUES, CLUSTER = 0x114D9B74, 0x1549A966, 0x1654AE6B, 0x1C53BB6B, 0x1F43B675
TAGS, CHAPTERS, ATTACHMENTS = 0x1254C367, 0x1043A770, 0x1941A469
# the level-1 IDs libavformat's matroska_resync looks for
LEVEL1 = (INFO, TRACKS, CUES, TAGS, SEEK_HEAD, ATTACHMENTS, CLUSTER, CHAPTERS)
TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, BLOCK = 0xE7, 0xA3, 0xA0, 0xA1
BLOCK_DURATION, REFERENCE_BLOCK = 0x9B, 0xFB
# what a Cluster of unknown size holds (matroska_cluster_parsing)
_CLUSTER_CHILDREN = (TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, 0xA7, 0xAB, 0x5854, 0xAF, VOID, CRC32)
_UNKNOWN = -1
NOPTS = -(2**63)


class MkvRefused(ValueError):
    """A file layout or feature the reader does not take (the message names it)."""


class MkvError(ValueError):
    """Bytes that are not a well-formed Matroska file."""


@dataclass
class MkvTrack(Track):
    """The video track: :class:`bmff.Track` (``fourcc`` holds the CodecID,
    ``timescale`` TimestampScale in ns, ``extra`` the decoded CodecPrivate,
    ``fps`` and ``frame_count`` 0: they depend on the codec, see
    :func:`frame_rate`) and what Matroska adds."""

    doc_type: str = "matroska"
    default_duration: int = 0  # ns, 0 where absent
    duration: Optional[float] = None  # Info's Duration, in TimestampScale units
    strip: bytes = b""  # header stripping: prepended to each frame
    zlib: bool = False  # each frame deflated
    durations: List[int] = field(default_factory=list)  # each frame's packet duration, ticks
    seek_index: List[Tuple[int, int]] = field(default_factory=list)  # (timestamp, frame)


def _vint(b: bytes, at: int, what: str, max_len: int = 8) -> Tuple[int, int]:
    """(value, length) of the EBML variable-size integer at ``at``;
    the unknown size (all ones) is :data:`_UNKNOWN`."""
    if at >= len(b):
        raise MkvError(f"{what} past the end of the data")
    first = b[at]
    length = 9 - first.bit_length() if first else 9
    if length > max_len:
        raise MkvError(f"{what} of {length} bytes")
    if at + length > len(b):
        raise MkvError(f"{what} past the end of the data")
    v = int.from_bytes(b[at:at + length], "big") & ((1 << (7 * length)) - 1)
    return (_UNKNOWN if v == (1 << (7 * length)) - 1 else v), length


def _elements(b: bytes, start: int = 0, end: Optional[int] = None):
    """(id, body offset, body end) of each element of ``b`` from ``start``."""
    end = len(b) if end is None else end
    pos = start
    while pos < end:
        eid, n = _vint(b, pos, "element ID", 4)
        eid |= 1 << (7 * n)
        size, m = _vint(b, pos + n, "element size")
        body = pos + n + m
        if size == _UNKNOWN or body + size > end:
            raise MkvError(f"element {eid:#x} at {pos} runs past its parent")
        yield eid, body, body + size
        pos = body + size


def _uint(b: bytes) -> int:
    return int.from_bytes(b, "big")


def _float(b: bytes) -> float:
    if len(b) == 4:
        return struct.unpack(">f", b)[0]
    if len(b) == 8:
        return struct.unpack(">d", b)[0]
    return 0.0


def _children(b: bytes) -> Dict[int, List[bytes]]:
    out: Dict[int, List[bytes]] = {}
    for eid, x, y in _elements(b):
        out.setdefault(eid, []).append(b[x:y])
    return out


def _one(kids: Dict[int, List[bytes]], eid: int, conv=_uint, default=None):
    return conv(kids[eid][0]) if eid in kids else default


class _Reader:
    """Element headers and bodies of the file."""

    def __init__(self, f: BinaryIO, size: int):
        self.f, self.size = f, size

    def read(self, pos: int, n: int) -> bytes:
        self.f.seek(pos)
        return self.f.read(max(0, min(n, self.size - pos)))

    def head(self, pos: int) -> Optional[Tuple[int, int, int]]:
        """(id, body offset, size or _UNKNOWN) of the element at ``pos``,
        None where the end of the file cuts its header."""
        b = self.read(pos, 12)
        try:
            eid, n = _vint(b, 0, "element ID", 4)
            size, m = _vint(b, n, "element size")
        except MkvError:
            if len(b) < 12:
                return None
            raise
        return eid | 1 << (7 * n), pos + n + m, size

    def body(self, pos: int) -> Tuple[int, bytes]:
        eid, body, size = self.head(pos)
        if size == _UNKNOWN:
            raise MkvError(f"element {eid:#x} at {pos} of unknown size")
        return eid, self.read(body, size)


def video_codec(f: BinaryIO, size: int) -> Tuple[str, Optional[str]]:
    """(DocType, the first video track's CodecID), where the headers let
    them be found (for messages)."""
    try:
        r = _Reader(f, size)
        doc, seg, seg_end = _header(r, strict=False)
        tracks = _level1(r, seg, seg_end, headers_only=True)[1].get(TRACKS)
        entry = _video_entry(r, tracks) if tracks is not None else None
        return doc, _one(entry, 0x86, lambda b: b.decode("latin-1").rstrip("\0")) if entry else None
    except (MkvError, MkvRefused, struct.error, TypeError):
        return "matroska", None


def _header(r: _Reader, strict: bool = True) -> Tuple[str, int, int]:
    """(DocType, the Segment's body offset, its end) after the EBML header;
    ``strict``: a header the reader does not take raises."""
    eid, body = r.body(0)
    if eid != EBML:
        raise MkvError("no EBML header")
    kids = _children(body)
    version = _one(kids, 0x4286, default=1)
    id_length = _one(kids, 0x42F2, default=4)
    size_length = _one(kids, 0x42F3, default=8)
    doc = _one(kids, 0x4282, lambda b: b.decode("latin-1").rstrip("\0"), "matroska")
    if strict and doc not in ("matroska", "webm"):
        raise MkvRefused(f"EBML DocType {doc!r}")
    if strict and (version > 1 or id_length > 4 or size_length > 8):
        raise MkvRefused(f"EBMLVersion {version}, EBMLMaxIDLength {id_length}, "
                         f"EBMLMaxSizeLength {size_length}")
    _, _, size = r.head(0)
    pos = r.head(0)[1] + size
    while True:
        h = r.head(pos)
        if h is None:
            raise MkvError("no Segment")
        eid, body, size = h
        if eid == SEGMENT:
            return doc, body, r.size if size == _UNKNOWN else min(body + size, r.size)
        if eid != VOID or size == _UNKNOWN:
            raise MkvError(f"element {eid:#x} before the Segment")
        pos = body + size


def _cluster_end(r: _Reader, body: int, end: int) -> int:
    """Where a Cluster of unknown size ends: at the first element that
    cannot be its child, or at ``end``."""
    pos = body
    while pos < end:
        h = r.head(pos)
        if h is None or h[0] not in _CLUSTER_CHILDREN or h[2] == _UNKNOWN:
            return pos
        pos = h[1] + h[2]
    return end


def _level1(r: _Reader, seg: int, seg_end: int, headers_only: bool = False):
    """(clusters as (offset, body offset, end), {id: offset} of the first
    Info, Tracks, Cues and SeekHead) of the Segment's level-1 elements in
    file order; with ``headers_only``, up to the first Cluster."""
    clusters, first = [], {}
    pos = seg
    while pos < seg_end:
        h = r.head(pos)
        if h is None:
            break
        eid, body, size = h
        if eid == CLUSTER:
            if headers_only:
                break
            end = _cluster_end(r, body, seg_end) if size == _UNKNOWN else body + size
            clusters.append((pos, body, min(end, seg_end)))
            pos = end
            continue
        if size == _UNKNOWN:
            raise MkvRefused(f"a level-1 element {eid:#x} of unknown size")
        if eid in (INFO, TRACKS, CUES, SEEK_HEAD):
            first.setdefault(eid, pos)
        pos = body + size
    if SEEK_HEAD in first:  # Info, Tracks and Cues wherever the SeekHead puts them
        for seek in _children(r.body(first[SEEK_HEAD])[1]).get(0x4DBB, []):
            kids = _children(seek)
            target, at = _one(kids, 0x53AB), _one(kids, 0x53AC)
            if target in (INFO, TRACKS, CUES) and at is not None and target not in first:
                h = r.head(seg + at)
                if h is not None and h[0] == target:
                    first[target] = seg + at
    return clusters, first


def _video_entry(r: _Reader, tracks_at: int):
    for entry in _children(r.body(tracks_at)[1]).get(0xAE, []):
        kids = _children(entry)
        if _one(kids, 0x83) == 1:
            return kids
    return None


def _encodings(kids) -> Tuple[bytes, bool, int]:
    """(stripped header, zlib, scope) of a TrackEntry's ContentEncodings."""
    if 0x6D80 not in kids:
        return b"", False, 0
    encodings = _children(kids[0x6D80][0]).get(0x6240, [])
    if len(encodings) > 1:
        raise MkvRefused(f"{len(encodings)} combined ContentEncodings")
    if not encodings:
        return b"", False, 0
    enc = _children(encodings[0])
    scope = _one(enc, 0x5032, default=1)
    if _one(enc, 0x5033, default=0) != 0 or 0x5035 in enc:
        raise MkvRefused("encrypted frames (ContentEncryption)")
    comp = _children(enc[0x5034][0]) if 0x5034 in enc else {}
    algo = _one(comp, 0x4254, default=0)
    if algo == 3:
        return _one(comp, 0x4255, bytes, b""), False, scope
    if algo == 0:
        return b"", True, scope
    names = {1: "bzlib", 2: "LZO"}
    raise MkvRefused(f"{names.get(algo, 'unknown')} compression (ContentCompAlgo {algo})")


def decode_frame(data: bytes, strip: bytes, deflated: bool) -> bytes:
    """A frame's bytes after its ContentEncoding (matroska_decode_buffer)."""
    if deflated:
        try:
            data = zlib.decompress(data)
        except zlib.error as e:
            raise ValueError(f"a zlib frame does not inflate: {e}") from None
    return strip + data


def _laces(b: bytes, at: int, flags: int, what: str) -> List[Tuple[int, int]]:
    """(offset, size) in ``b`` of each frame of the laced block whose lace
    count is at ``at`` (after the track number, timestamp and flags)."""
    kind = (flags & 0x06) >> 1
    if at >= len(b):
        raise MkvError(f"{what}: a laced block without its lace count")
    n = b[at] + 1
    at += 1
    sizes: List[int] = []
    if kind == 1:  # Xiph
        for _ in range(n - 1):
            s = 0
            while True:
                if at >= len(b):
                    raise MkvError(f"{what}: Xiph lace sizes past the block")
                v = b[at]
                at += 1
                s += v
                if v != 255:
                    break
            sizes.append(s)
    elif kind == 3:  # EBML
        s, k = _vint(b, at, f"{what}: EBML lace size")
        at += k
        sizes.append(s)
        for _ in range(n - 2):
            d, k = _vint(b, at, f"{what}: EBML lace size")
            at += k
            s += d - ((1 << (7 * k - 1)) - 1)
            sizes.append(s)
    rest = len(b) - at - sum(sizes)
    if kind == 2:  # fixed
        if (len(b) - at) % n:
            raise MkvError(f"{what}: {len(b) - at} bytes do not split into {n} fixed-size laces")
        sizes = [(len(b) - at) // n] * n
    elif rest <= 0 or any(s <= 0 for s in sizes):
        raise MkvError(f"{what}: lace sizes past the block")
    else:
        sizes.append(rest)
    out = []
    for s in sizes:
        out.append((at, s))
        at += s
    return out


def parse(f: BinaryIO, size: int) -> MkvTrack:
    """The first video track of the Matroska or WebM file ``f`` of ``size`` bytes."""
    r = _Reader(f, size)
    doc, seg, seg_end = _header(r)
    clusters, first = _level1(r, seg, seg_end)
    if TRACKS not in first:
        raise MkvError("no Tracks")
    info = _children(r.body(first[INFO])[1]) if INFO in first else {}
    scale = _one(info, 0x2AD7B1, default=1_000_000) or 1_000_000
    duration = _one(info, 0x4489, _float)
    kids = _video_entry(r, first[TRACKS])
    if kids is None:
        raise MkvError("no video track (TrackType 1)")
    number = _one(kids, 0xD7, default=0)
    codec_id = _one(kids, 0x86, lambda b: b.decode("latin-1").rstrip("\0"), "")
    track_scale = _one(kids, 0x23314F, _float, 1.0)
    if track_scale != 1.0:
        raise MkvRefused(f"TrackTimestampScale {track_scale}")
    strip, deflated, scope = _encodings(kids)
    private = _one(kids, 0x63A2, bytes, b"")
    if scope & 2 and private:
        private = decode_frame(private, strip, deflated)
    if not scope & 1:
        strip, deflated = b"", False
    default_duration = _one(kids, 0x23E383, default=0)
    declared = set()
    for entry in _children(r.body(first[TRACKS])[1]).get(0xAE, []):
        declared.add(_one(_children(entry), 0xD7, default=0))

    frames: List[Sample] = []
    durations: List[int] = []
    index: Dict[int, int] = {}  # key frame timestamp -> the first frame of its Cluster
    cluster_pos: List[int] = []  # each Cluster's offset
    cluster_first: List[int] = []  # and its first frame
    at = 0
    while at < len(clusters):
        cpos, body, end = clusters[at]
        at += 1
        cluster_pos.append(cpos)
        cluster_first.append(len(frames))
        try:
            _cluster(r, body, end, number, declared, scale, default_duration, frames,
                     durations, index)
        except _Resync:
            # libavformat drops the rest of the Cluster and looks for the
            # next level-1 element from the Cluster's second byte
            nxt = _resync(r, cpos + 1)
            if nxt is None:
                break
            clusters[at:] = _level1(r, nxt, size)[0]
    # the Cues of the track: (CueTime, CueClusterPosition)
    if CUES in first:
        try:
            for point in _children(r.body(first[CUES])[1]).get(0xBB, []):
                kids_p = _children(point)
                t = _one(kids_p, 0xB3)
                for tp in kids_p.get(0xB7, []):
                    pk = _children(tp)
                    if _one(pk, 0xF7) == number and t is not None and 0xF1 in pk:
                        c = bisect.bisect_left(cluster_pos, seg + _one(pk, 0xF1))
                        index.setdefault(t, cluster_first[c] if c < len(cluster_first)
                                         else len(frames))
        except MkvError:
            pass  # a broken Cues element: the key frames read stay the index
    return MkvTrack(codec_id, scale, 0.0, 0, frames, private, None,
                    frames[0].pts if frames else 0, doc_type=doc,
                    default_duration=default_duration, duration=duration, strip=strip,
                    zlib=deflated, durations=durations, seek_index=sorted(index.items()))


class _Resync(Exception):
    """A block libavformat's parse_block fails on."""


def _resync(r: _Reader, pos: int) -> Optional[int]:
    """matroska_resync: the offset of the next level-1 ID from ``pos``."""
    ids = [i.to_bytes(4, "big") for i in LEVEL1]
    step = 1 << 20
    while pos < r.size:
        b = r.read(pos, step + 3)
        hits = [b.find(i) for i in ids]
        hits = [h for h in hits if h >= 0]
        if hits:
            return pos + min(hits)
        pos += step
    return None


def _cluster(r, body, end, number, declared, scale, default_duration, frames, durations,
             index) -> None:
    """Adds the track's frames of one Cluster (its body read at once), up
    to a block the end of the file cuts (the last Cluster's end is the
    file's)."""
    buf = r.read(body, end - body)
    cluster_ts = None
    first = len(frames)
    pos = 0
    while pos < end - body:
        try:
            eid, n = _vint(buf, pos, "element ID", 4)
            size, m = _vint(buf, pos + n, "element size")
        except MkvError:
            if body + pos + 12 > r.size:
                return  # the end of the file cuts its header
            raise
        eid |= 1 << (7 * n)
        data = pos + n + m
        if size == _UNKNOWN:
            raise MkvError(f"element {eid:#x} of unknown size in a Cluster")
        if data + size > len(buf):
            if body + data + size > r.size:
                return  # the end of the file cuts it
            raise MkvError(f"element {eid:#x} runs past its Cluster")
        pos = data + size
        if eid == TIMESTAMP:
            cluster_ts = _uint(buf[data:pos])
        elif eid in (SIMPLE_BLOCK, BLOCK_GROUP):
            key, block_duration = None, None
            if eid == BLOCK_GROUP:
                kids = {k: (data + x, data + y) for k, x, y in reversed(list(
                    _elements(buf[data:pos])))}
                if BLOCK not in kids:
                    continue
                data, pos_block = kids[BLOCK]
                key = REFERENCE_BLOCK not in kids
                if BLOCK_DURATION in kids:
                    block_duration = _uint(buf[slice(*kids[BLOCK_DURATION])])
            else:
                pos_block = pos
            block = buf[data:pos_block]
            track, n = _vint(block, 0, "a block's track number")
            if track not in declared or len(block) < n + 3:
                raise _Resync()
            if track != number:
                continue
            rel, flags = struct.unpack_from(">hB", block, n)
            if key is None:
                key = bool(flags & 0x80)
            if cluster_ts is None or (rel < 0 and cluster_ts < -rel):
                raise MkvRefused("a block without a timestamp (no Cluster Timestamp, or "
                                 "before the Cluster's time 0)")
            ts = cluster_ts + rel
            laces = (_laces(block, n + 3, flags, f"block at {body + data}") if flags & 0x06
                     else [(n + 3, len(block) - n - 3)])
            count = len(laces)
            if not block_duration and default_duration:
                block_duration = default_duration * count // scale
            block_duration = block_duration or 0
            if count > 1 and not block_duration:
                raise MkvRefused("laced frames without BlockDuration or DefaultDuration "
                                 "(libavformat gives them no timestamps)")
            if key:
                index[ts] = first  # av_add_index_entry at the Cluster's offset
            for k, (off, s) in enumerate(laces):
                lace_duration = block_duration * (k + 1) // count - block_duration * k // count
                frames.append(Sample(body + data + off, s, ts, key and k == 0))
                durations.append(lace_duration)
                ts += lace_duration


# ----------------------------------------------------------------- rates

def reduce(num: int, den: int, top: int) -> Tuple[int, int]:
    """libavutil's av_reduce: the nearest fraction with terms at most ``top``."""
    a0, a1 = (0, 1), (1, 0)
    sign = (num < 0) != (den < 0)
    num, den = abs(num), abs(den)
    g = _gcd(num, den)
    if g:
        num, den = num // g, den // g
    if num <= top and den <= top:
        a1, den = (num, den), 0
    while den:
        x = num // den
        next_den = num - den * x
        a2n, a2d = x * a1[0] + a0[0], x * a1[1] + a0[1]
        if a2n > top or a2d > top:
            if a1[0]:
                x = (top - a0[0]) // a1[0]
            if a1[1]:
                x = min(x, (top - a0[1]) // a1[1])
            if den * (2 * x * a1[1] + a0[1]) > num * a1[1]:
                a1 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
            break
        a0, a1 = a1, (a2n, a2d)
        num, den = den, next_den
    return (-a1[0] if sign else a1[0]), a1[1]


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def _std_rate(i: int) -> int:
    """libavformat's get_std_framerate: standard rates in 1/(12 x 1001) units."""
    if i < 30 * 12:
        return (i + 1) * 1001
    i -= 30 * 12
    if i < 30:
        return (i + 31) * 1001 * 12
    i -= 30
    if i < 3:
        return (80, 120, 240)[i] * 1001 * 12
    return (24, 30, 60, 12, 15, 48)[i - 3] * 1000 * 12


_STD = [_std_rate(i) for i in range(30 * 12 + 30 + 3 + 6)]
_INT_MAX = 2**31 - 1
_ANALYZE_US = 5_000_000  # max_analyze_duration's default


def _rfps(dts: List[int], tb: Tuple[int, int], unreliable: bool,
          info_duration: int) -> Optional[Tuple[int, int]]:
    """ff_rfps_add_frame over ``dts``, then ff_rfps_calculate's
    r_frame_rate (None where it sets none)."""
    err = [[[0.0] * len(_STD) for _ in range(2)] for _ in range(2)]
    count, total, g, last = 0, 0, 0, None
    q = tb[0] / tb[1]
    for ts in dts:
        if last is not None and ts > last:
            sec = ts * q
            for i, fr in enumerate(_STD):
                if err[0][1][i] < 1e10:
                    sdts = sec * fr / 12012
                    for j in range(2):
                        ticks = round(sdts + j * 0.5)
                        e = sdts - ticks + j * 0.5
                        err[j][0][i] += e
                        err[j][1][i] += e * e
            count += 1
            total += ts - last
            if count % 10 == 0:
                for i in range(len(_STD)):
                    if err[0][1][i] < 1e10:
                        a0 = err[0][0][i] / count
                        e0 = err[0][1][i] / count - a0 * a0
                        a1 = err[1][0][i] / count
                        e1 = err[1][1][i] / count - a1 * a1
                        if e0 > 0.04 and e1 > 0.04:
                            err[0][1][i] = err[1][1][i] = 2e10
            if count > 3:
                g = _gcd(g, ts - last)
        last = ts
    rate = None
    if unreliable and count > 15 and g > max(1, tb[1] // (500 * tb[0])):
        rate = reduce(tb[1], tb[0] * g, _INT_MAX)
    if count > 1 and rate is None and unreliable:
        num, best = 0, 0.01
        for j, fr in enumerate(_STD):
            if info_duration and info_duration * q < 1001 * 11.5 / fr:
                continue
            if not info_duration and fr < 1001 * 12:
                continue
            if q * total / count < 1001 * 12.0 * 0.8 / fr:
                continue
            for k in range(2):
                a = err[k][0][j] / count
                e = err[k][1][j] / count - a * a
                if e < best and best > 0.000000001:
                    best, num = e, fr
        if num and num / 12012 < 1.01 * tb[1] / tb[0]:
            rate = reduce(num, 12012, _INT_MAX)
    return rate


def frame_rate(track: MkvTrack, codec_rate: Optional[Tuple[int, int]], h264: bool) -> float:
    """``CAP_PROP_FPS``: the stream's avg_frame_rate, else its r_frame_rate.
    DefaultDuration gives avg_frame_rate (1e9 / DefaultDuration, reduced to
    terms of at most 30000).  Without it, avformat_find_stream_info reads
    packets until it has 40 timestamp steps (20 with a time base finer than
    0.5 ms) or 5 s of them, unless the codec's own rate ``codec_rate`` (a
    VOL's, an SPS's VUI timing) makes the time base reliable, and then it is
    the rate: their durations (BlockDuration, or one frame at the codec's
    rate) give avg_frame_rate, rounded to a standard rate within 1 %;
    without durations the timestamps give r_frame_rate (ff_rfps_calculate),
    which OpenCV takes where avg_frame_rate is unset."""
    g = _gcd(track.timescale, 10**9)
    tb = (track.timescale // g, 10**9 // g)
    if track.default_duration:
        n, d = reduce(10**9, track.default_duration, 30000)
        if n:
            return n / d
    mul = 2 if h264 else 1  # AV_CODEC_PROP_FIELDS
    ref = (codec_rate[1], codec_rate[0] * mul) if codec_rate else tb  # tb_unreliable's time base
    unreliable = h264 or ref[1] >= 101 * ref[0] or ref[1] < 5 * ref[0]
    needed = (40 if tb[0] / tb[1] > 0.0005 else 20) if unreliable else 0
    codec_duration = 0
    if tb[0] * 1000 > tb[1]:
        codec_duration = 1
    elif codec_rate and codec_rate[1] * 1000 > codec_rate[0]:
        num, den = reduce(codec_rate[1], codec_rate[0], _INT_MAX)
        codec_duration = (num * tb[1]) // (den * tb[0])
    dts, info_duration, fields, count, last = [], 0, 0, 0, None
    for i, f in enumerate(track.samples):
        if i and count >= needed:
            break
        duration = track.durations[i] or codec_duration
        if i > 1:
            span = info_duration if info_duration or i <= 30 else dts[-1] - dts[2]
            if (span * tb[0] * 1_000_000 + tb[1] // 2) // tb[1] >= _ANALYZE_US:
                break
            if duration > 0:
                info_duration += duration
                fields += 2
        ts = f.pts if f.dts is None else f.dts
        if last is not None and ts > last:
            count += 1
        last = ts
        dts.append(ts)
    rate = _rfps(dts, tb, unreliable, info_duration)
    if info_duration and fields:
        n, d = reduce(fields * tb[1], info_duration * 2 * tb[0], 60000)
        best, best_fps = 0.01, 0
        for fr in _STD:
            e = abs((n / d) / (fr / 12012) - 1)
            if e < best:
                best, best_fps = e, fr
        if best_fps:
            n, d = reduce(best_fps, 12012, _INT_MAX)
        return n / d
    if rate is not None:
        return rate[0] / rate[1]
    if codec_rate and tb[0] * codec_rate[0] * mul <= tb[1] * codec_rate[1]:
        return codec_rate[0] * mul / codec_rate[1]
    return tb[1] / tb[0]


def frame_count(track: MkvTrack, fps: float) -> int:
    """``CAP_PROP_FRAME_COUNT``: Matroska has no frame count, so OpenCV
    rounds the duration times ``fps``: Info's Duration (in microseconds,
    truncated, as libavformat keeps it), or without one the stream's
    unset duration (INT64_MIN ticks)."""
    if track.duration:
        sec = int(track.duration * track.timescale * 1000 / 1_000_000) / 1_000_000
    else:
        g = _gcd(track.timescale, 10**9)
        sec = float(NOPTS) * ((track.timescale // g) / (10**9 // g))
    return int(math.floor(sec * fps + 0.5))
