"""MP4 and QuickTime files (ISO BMFF) parsed with ``struct``: the first
video track's samples as libavformat's ``mov`` demuxer hands them to OpenCV.

:func:`parse` walks the boxes (32-bit, 64-bit (size 1) and to-the-end
(size 0) sizes; ``moov`` before or after ``mdat``), takes the first track
whose ``hdlr`` is ``vide`` and expands its sample table: ``stsd`` (the
sample entry; for ``mp4v`` the ``esds`` DecoderSpecificInfo, which holds
the VOL headers; for ``avc1`` and ``avc3`` the ``avcC`` record, which
holds H.264's SPS and PPS and its NAL length size), ``stts`` with
``mdhd``'s timescale, ``stsc`` (any number
of runs), ``stsz`` (uniform or a table), ``stco`` or ``co64``, ``stss``
(where absent every sample is a key frame), ``ctts`` and ``elst``:

* ``ctts`` (H.264 tracks: B pictures): each sample's pts is its dts plus
  its composition offset (read signed, versions 0 and 1); seeks then
  compare decode times, the stream starts at the first sample's pts, and
  the track's video delay is libavformat's estimate from the offsets;
* one edit from ``media_time`` M >= 0 lasting D: the samples before the
  key frame at or before M are dropped, those from it up to M and from
  M + D on are decoded but not shown (libavformat's discard flag), up to
  the first key frame whose end reaches M + D (the second with ``ctts``,
  as B pictures may follow it), and every timestamp is shifted by -M;
* empty edits first (``media_time`` -1) delay every timestamp by their
  duration.

``fps`` is the track's ``avg_frame_rate`` (timescale x samples / the
``stts`` duration, ``CAP_PROP_FPS``) and ``frame_count`` its sample count
(``CAP_PROP_FRAME_COUNT``).  Fragmented files (``moof``/``mvex``), non-zero
``ctts`` composition offsets on other tracks than H.264 (MPEG-4 B-VOPs),
other edit lists, ``stz2`` and several sample descriptions raise
:class:`BmffRefused` naming them.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, List, Optional, Tuple

MP4_VISUAL = 0x20  # esds objectTypeIndication of MPEG-4 Part 2 video
_VISUAL_ENTRY = 78  # bytes of a VisualSampleEntry before its child boxes


class BmffRefused(ValueError):
    """A file layout or feature the reader does not take."""


class BmffError(ValueError):
    """Bytes that are not a well-formed ISO BMFF file."""


@dataclass(frozen=True)
class Sample:
    """Where a frame's bytes lie and when it shows (also the AVI reader's)."""

    pos: int
    size: int
    pts: int  # in the stream's time base (MP4: after the edit list)
    key: bool
    discard: bool = False  # decoded but not shown (outside an MP4 edit)
    dts: Optional[int] = None  # what a seek compares, where it differs from pts (MP4 ctts)


@dataclass
class Track:
    fourcc: str  # the sample entry's type
    timescale: int
    fps: float
    frame_count: int
    samples: List[Sample]
    extra: bytes = b""  # the esds DecoderSpecificInfo, or the avcC record
    object_type: Optional[int] = None
    start_pts: int = 0  # the first shown sample's timestamp
    nal_length: int = 0  # H.264: bytes of each NAL unit's length prefix (avcC)
    video_delay: int = 0  # H.264 with composition offsets: the reordering they show


def _boxes(f: BinaryIO, start: int, end: int):
    """(type, body offset, end offset) of each box from ``start`` to ``end``."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(16)
        if len(head) < 8:
            return
        size, typ = struct.unpack_from(">I4s", head)
        hdr = 8
        if size == 1:
            if len(head) < 16:
                return
            size, hdr = struct.unpack_from(">Q", head, 8)[0], 16
        elif size == 0:
            size = end - pos
        if size < hdr:
            raise BmffError(f"box {typ!r} at {pos} has size {size}")
        yield typ.decode("latin-1"), pos + hdr, min(pos + size, end)
        pos += size


def _read(f: BinaryIO, a: int, b: int) -> bytes:
    f.seek(a)
    return f.read(b - a)


def _find(f, a, b, *path) -> Optional[Tuple[int, int]]:
    for typ, x, y in _boxes(f, a, b):
        if typ == path[0]:
            return (x, y) if len(path) == 1 else _find(f, x, y, *path[1:])
    return None


def _descriptor(data: bytes, pos: int) -> Tuple[int, int, int]:
    """(tag, body offset, body length) of the MPEG-4 descriptor at pos."""
    tag, pos, n = data[pos], pos + 1, 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        n = (n << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, n


def _esds(data: bytes) -> Tuple[Optional[int], bytes]:
    """(objectTypeIndication, DecoderSpecificInfo) of an esds box body."""
    tag, pos, _ = _descriptor(data, 4)
    if tag != 3:
        raise BmffError("esds without an ES_Descriptor")
    flags = data[pos + 2]
    pos += 3
    if flags & 0x80:
        pos += 2
    if flags & 0x40:
        pos += 1 + data[pos]
    if flags & 0x20:
        pos += 2
    tag, pos, n = _descriptor(data, pos)
    if tag != 4:
        raise BmffError("esds without a DecoderConfigDescriptor")
    oti, end = data[pos], pos + n
    pos += 13
    while pos < end:
        tag, body, n = _descriptor(data, pos)
        if tag == 5:
            return oti, data[body:body + n]
        pos = body + n
    return oti, b""


def _table(f, box, fmt: str, header: int = 4):
    """The entries of a full box's table (entry count, then ``fmt`` each)."""
    if box is None:
        return None
    data = _read(f, *box)
    (n,) = struct.unpack_from(">I", data, header)
    st = struct.Struct(">" + fmt)
    if header + 4 + n * st.size > len(data):
        raise BmffError(f"a sample table of {n} entries runs past its box")
    return [st.unpack_from(data, header + 4 + i * st.size) for i in range(n)]


def _rescale(a: int, b: int, c: int) -> int:
    """av_rescale: a * b / c rounded to nearest, halves away from zero."""
    r = c // 2
    return (a * b + r) // c if a >= 0 else -((-a * b + r) // c)


def _video_trak(f: BinaryIO, size: int):
    """(moov, trak, mdia) bounds of the first track whose handler is
    ``vide``; BmffError where there is none."""
    moov = next(((a, b) for t, a, b in _boxes(f, 0, size) if t == "moov"), None)
    if moov is None:
        raise BmffError("no moov box")
    for typ, a, b in _boxes(f, *moov):
        mdia = _find(f, a, b, "mdia") if typ == "trak" else None
        hdlr = _find(f, *mdia, "hdlr") if mdia else None
        if hdlr is not None and _read(f, hdlr[0] + 8, hdlr[0] + 12) == b"vide":
            return moov, (a, b), mdia
    raise BmffError("no video track")


def video_fourcc(f: BinaryIO, size: int) -> Optional[str]:
    """The sample entry type of the first video track, where the boxes let
    it be found (for messages)."""
    try:
        _, _, mdia = _video_trak(f, size)
        stsd = _find(f, *mdia, "minf", "stbl", "stsd")
    except (ValueError, struct.error):  # BmffError, or bytes past a box
        return None
    entry = _read(f, stsd[0] + 12, stsd[0] + 16) if stsd else b""
    return entry.decode("latin-1") if len(entry) == 4 else None


def parse(f: BinaryIO, size: int) -> Track:
    """The first video track of the ISO BMFF file ``f`` of ``size`` bytes."""
    if any(t == "moof" for t, _, _ in _boxes(f, 0, size)):
        raise BmffRefused("fragmented MP4 (moof boxes)")
    moov, (a, b), mdia = _video_trak(f, size)
    if _find(f, *moov, "mvex") is not None:
        raise BmffRefused("fragmented MP4 (mvex box)")
    mvhd = _find(f, *moov, "mvhd")
    movie_scale = 1000
    if mvhd is not None:
        head = _read(f, mvhd[0], mvhd[0] + 24)
        movie_scale = struct.unpack_from(">I", head, 20 if head[0] == 1 else 12)[0] or 1000
    return _track(f, a, b, mdia, movie_scale)


def _track(f, a, b, mdia, movie_scale) -> Track:
    mdhd = _find(f, *mdia, "mdhd")
    if mdhd is None:
        raise BmffError("no mdhd box")
    head = _read(f, mdhd[0], mdhd[0] + 24)
    scale = struct.unpack_from(">I", head, 20 if head[0] == 1 else 12)[0]
    if not scale:
        raise BmffError("mdhd timescale 0")
    stbl = _find(f, *mdia, "minf", "stbl")
    if stbl is None:
        raise BmffError("no stbl box")
    box = {t: (x, y) for t, x, y in _boxes(f, *stbl)}
    if "stz2" in box:
        raise BmffRefused("compact sample sizes (stz2)")
    for need in ("stsd", "stts", "stsc", "stsz"):
        if need not in box:
            raise BmffError(f"no {need} box")
    stsd = _read(f, *box["stsd"])
    (entries,) = struct.unpack_from(">I", stsd, 4)
    esize, fourcc = struct.unpack_from(">I4s", stsd, 8)
    fourcc = fourcc.decode("latin-1")
    entry = stsd[8:8 + esize]
    oti, extra, nal_length = None, b"", 0
    pos = _VISUAL_ENTRY + 8
    while pos + 8 <= len(entry):
        n, typ = struct.unpack_from(">I4s", entry, pos)
        if n < 8:
            break
        if typ == b"esds":
            oti, extra = _esds(entry[pos + 8:pos + n])
        elif typ == b"avcC" and fourcc in ("avc1", "avc3"):
            extra = entry[pos + 8:pos + n]
            nal_length = avcc_nal_length(extra)
        pos += n
    ctts = _table(f, box.get("ctts"), "Ii")  # signed, as libavformat reads both versions
    if ctts and any(off for _, off in ctts) and fourcc not in ("avc1", "avc3"):
        raise BmffRefused("composition offsets (ctts: B-frames or reordering) outside H.264")
    stts = _table(f, box["stts"], "II")
    stsc = _table(f, box["stsc"], "III")
    if entries > 1 and any(d != 1 for _, _, d in stsc):
        raise BmffRefused("several sample descriptions (stsd)")
    szhead = _read(f, box["stsz"][0], box["stsz"][0] + 12)
    uniform, count = struct.unpack_from(">II", szhead, 4)
    if uniform:
        sizes = [uniform] * count
    else:
        raw = _read(f, box["stsz"][0] + 12, box["stsz"][0] + 12 + 4 * count)
        if len(raw) < 4 * count:
            raise BmffError("stsz runs past its box")
        sizes = list(struct.unpack(f">{count}I", raw))
    if "co64" in box:
        offsets = [o for (o,) in _table(f, box["co64"], "Q")]
    elif "stco" in box:
        offsets = [o for (o,) in _table(f, box["stco"], "I")]
    else:
        raise BmffError("no stco or co64 box")
    stss = _table(f, box.get("stss"), "I")
    keys = None if stss is None else {s - 1 for (s,) in stss}

    positions: List[int] = []
    for i, (first, per, _) in enumerate(stsc):
        last = stsc[i + 1][0] - 1 if i + 1 < len(stsc) else len(offsets)
        for c in range(first - 1, min(last, len(offsets))):
            at = offsets[c]
            for _ in range(per):
                if len(positions) == count:
                    break
                positions.append(at)
                at += sizes[len(positions) - 1]
    if len(positions) < count:
        raise BmffError(f"stsc/stco give {len(positions)} of {count} samples")
    dts, durations, t = [], [], 0
    for n, d in stts:
        for _ in range(n):
            dts.append(t)
            durations.append(d)
            t += d
    if len(dts) < count:
        raise BmffError(f"stts times {len(dts)} of {count} samples")
    offsets = [off for n, off in ctts or () for _ in range(n)]
    if ctts and any(offsets):
        if len(offsets) < count:
            raise BmffError(f"ctts offsets {len(offsets)} of {count} samples")
        # each sample's pts its dts plus its offset
        samples = [Sample(p, s, dts[i] + offsets[i], keys is None or i in keys, dts=dts[i])
                   for i, (p, s) in enumerate(zip(positions, sizes))]
    else:
        samples = [Sample(p, s, dts[i], keys is None or i in keys)
                   for i, (p, s) in enumerate(zip(positions, sizes))]
    duration = sum(n * d for n, d in stts)
    nb = sum(n for n, _ in stts)
    fps = scale * nb / duration if duration > 0 and nb > 0 else 0.0

    edts = _find(f, a, b, "edts", "elst")
    start = 0
    if edts is not None:
        samples, start = _edit(_read(f, *edts), samples, durations, scale, movie_scale)
    delay = 0
    if samples and samples[0].dts is not None:
        start = samples[0].pts  # the stream's start_time: its first sample's pts
        delay = _video_delay([s.pts for s in samples])
    return Track(fourcc, scale, fps, count, samples, extra, oti, start, nal_length, delay)


def avcc_nal_length(record: bytes) -> int:
    """The NAL length size of an AVCDecoderConfigurationRecord (avcC)."""
    if len(record) < 7 or record[0] != 1:
        raise BmffError("an avcC record of another version")
    nal_length = (record[4] & 3) + 1
    if nal_length == 3:
        raise BmffError("avcC lengthSizeMinusOne 2")
    return nal_length


def _video_delay(pts: List[int]) -> int:
    """libavformat's mov_estimate_video_delay: the most samples decoded
    before one that show after it (within a window of 17)."""
    window: List[int] = []
    delay = 0
    for p in pts:
        window = window[-16:]
        delay = max(delay, sum(q > p for q in window))
        window.append(p)
    return delay


def _edit(elst: bytes, samples: List[Sample], durations: List[int], scale: int,
          movie_scale: int):
    """The samples after the edit list, and the first shown timestamp."""
    version = elst[0]
    (n,) = struct.unpack_from(">I", elst, 4)
    fmt = ">QqHH" if version == 1 else ">IiHH"
    step = struct.calcsize(fmt)
    edits = [struct.unpack_from(fmt, elst, 8 + i * step) for i in range(n)]
    delay = 0
    while edits and edits[0][1] == -1:  # empty edits: the track starts later
        delay += _rescale(edits[0][0], scale, movie_scale)
        edits = edits[1:]
    if len(edits) != 1 or edits[0][2:] != (1, 0):
        raise BmffRefused(f"an edit list of {n} entries other than one edit at rate 1")
    span, media_time = _rescale(edits[0][0], scale, movie_scale), edits[0][1]
    end = media_time + span if span else None
    first = 0
    for i, s in enumerate(samples):
        if s.pts <= media_time and s.key and (s.dts is None or s.dts <= media_time):
            first = i
    out, keys_after = [], 0
    for i in range(first, len(samples)):
        s = samples[i]
        shown = media_time <= s.pts and (end is None or s.pts < end)
        # with composition offsets a seek compares decode times, from the
        # first sample kept (libavformat's edit_list_dts_counter)
        dts = None if s.dts is None else s.dts - samples[first].dts
        out.append(Sample(s.pos, s.size, s.pts - media_time + delay, s.key, not shown, dts))
        # mov_fix_index stops after the first key frame reaching the edit's
        # end (with composition offsets, the second: B pictures may follow)
        if end is not None and s.key and s.pts + durations[i] >= end:
            keys_after += 1
            if s.dts is None or keys_after == 2:
                break
    return out, delay
