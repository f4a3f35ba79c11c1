"""Motion-JPEG AVI files read on the host without OpenCV: the RIFF container
walked with ``struct``, each frame's bytes decoded by the port's JPEG codec
(``jpeg.py``).

:class:`AviReader` has what ``runner.frame_source`` uses of
``cv2.VideoCapture`` and gives, for the same file, what the JAX package's
reader gives: ``cv2.VideoCapture(path)`` with no backend named, which opens
an AVI through FFMPEG (libavformat's AVI demuxer).

* **Frames**: the chunks of the first video stream (``NNdc``/``NNdb``) in
  file order, through every ``movi`` list, OpenDML's ``RIFF AVIX`` parts
  included.  A zero-length chunk (AVI's "repeat the last frame") yields no
  frame but takes one frame period of the timestamps, as in FFMPEG.  A
  chunk whose bytes are not a JPEG ends a sequential read, as FFMPEG's
  decode error ends ``cap.read()``; a seek can reach past it.  A chunk that
  the end of the file cuts inside its scan is a frame, as FFMPEG's decoder
  ends a scan without EOI; cut before its scan, it ends the read.
* **The index**: OpenDML's ``indx`` and its ``ix##`` chunks, else ``idx1``
  (offsets relative to ``movi`` or absolute, told apart as libavformat's
  ``avi_read_idx1`` does: the first entry is moved onto the first chunk of
  ``movi``), then a scan on from the last indexed chunk.  With no index, or
  with an entry that does not point at a chunk of the stream and its size,
  the ``movi`` lists are scanned.
* **Pixels**: ``decode_jpeg`` of each chunk, which is ``cv2.imdecode``
  (IMREAD_COLOR) of it bit for bit, and for a cut chunk ``cv2.imread`` of
  it (the missing blocks libjpeg's; FFMPEG keeps the previous frame's
  there).  FFMPEG decodes with its own IDCT and converts YUV to BGR with
  swscale: its frames are up to tens of levels off libjpeg's on noisy
  frames (ROADMAP C9).
* **fps**: the stream header's dwRate / dwScale (libavformat's fallbacks
  where either is 0), ``CAP_PROP_FPS``; **frame_count**: its dwLength,
  ``CAP_PROP_FRAME_COUNT``.
* **set_pos(i)**: OpenCV's ``CvCapture_FFMPEG::seek`` over libavformat's
  index (:meth:`AviReader.set_pos`): frame i on a file without zero-length
  or broken chunks, and past the end, the end of the stream.

Anything else raises :class:`UnsupportedVideo`, naming the file, its
container and the video stream's fourcc: another codec in AVI, MP4 and
QuickTime, Matroska.  ``runner.open_video`` hands those to OpenCV where it
is installed.
"""

from __future__ import annotations

import bisect
import os
import re
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .jpeg import decode_jpeg, jpeg_header

MJPEG_FOURCCS = (b"MJPG", b"mjpg")
_HEADER = struct.Struct("<4sI")
_INDEX_HEADER = struct.Struct("<HBBI4sQI")  # OpenDML indx / ix## (24 bytes)
_AVIIF_KEYFRAME = 0x10
_SEEK_DELTA = 16  # CvCapture_FFMPEG::seek's first step back
_INT_MAX = 2**31 - 1


class UnsupportedVideo(RuntimeError):
    """A video the port's reader does not decode (it needs OpenCV)."""


@dataclass(frozen=True)
class _Frame:
    pos: int  # the chunk header's offset in the file
    size: int
    pts: int  # in frame periods: every chunk of the stream before it counts one
    key: bool


def _fourcc(b: Optional[bytes]) -> str:
    if not b:
        return "unknown"
    s = b.decode("latin-1")
    return s if s.isprintable() else repr(b)


def sniff(path: str) -> Tuple[str, str]:
    """(container, video fourcc or codec id) of a video file, for messages:
    RIFF AVI (strf's compression), ISO BMFF (the first ``vide`` track's
    sample entry), Matroska (the first ``V_`` CodecID) or unknown."""
    with open(path, "rb") as f:
        head = f.read(1 << 20)
    if head[:4] == b"RIFF":
        form = head[8:12].decode("latin-1").strip()
        m = re.search(rb"strh.{4}vids.{0,120}?strf.{4}.{16}(.{4})", head, re.S)
        return f"RIFF {form}", _fourcc(m.group(1) if m else None)
    if head[4:8] == b"ftyp":
        return "ISO BMFF (ftyp)", _fourcc(_bmff_video_fourcc(head))
    if head[:4] == b"\x1a\x45\xdf\xa3":
        m = re.search(rb"\x86[\x81-\xbf](V_[\x21-\x7e]*)", head)
        return "Matroska", m.group(1).decode() if m else "unknown"
    return "unknown", "unknown"


def _bmff_video_fourcc(data: bytes) -> Optional[bytes]:
    """The sample entry type of the first track whose handler is ``vide``
    (moov/trak/mdia/{hdlr, minf/stbl/stsd})."""

    def boxes(start, end):
        pos = start
        while pos + 8 <= end:
            size, typ = struct.unpack_from(">I4s", data, pos)
            hdr = 8
            if size == 1 and pos + 16 <= end:
                size, hdr = struct.unpack_from(">Q", data, pos + 8)[0], 16
            elif size == 0:
                size = end - pos
            if size < hdr:
                return
            yield typ, pos + hdr, min(pos + size, end)
            pos += size

    def find(start, end, path):
        for typ, a, b in boxes(start, end):
            if typ == path[0]:
                return (a, b) if len(path) == 1 else find(a, b, path[1:])
        return None

    moov = find(0, len(data), (b"moov",))
    if moov is None:
        return None
    for typ, a, b in boxes(*moov):
        mdia = find(a, b, (b"mdia",)) if typ == b"trak" else None
        hdlr = find(*mdia, (b"hdlr",)) if mdia else None
        if hdlr and data[hdlr[0] + 8:hdlr[0] + 12] == b"vide":
            stsd = find(*mdia, (b"minf", b"stbl", b"stsd"))
            if stsd and stsd[0] + 16 <= stsd[1]:
                return data[stsd[0] + 12:stsd[0] + 16]
    return None


def _unsupported(path: str, why: str) -> UnsupportedVideo:
    container, fourcc = sniff(path)
    return UnsupportedVideo(
        f"{path}: {container} container, video fourcc {fourcc}: {why}; only Motion-JPEG "
        f"(MJPG) in AVI is read without OpenCV, so this file needs OpenCV (cv2)")


class AviReader:
    """A Motion-JPEG AVI file, read frame by frame as ``cv2.VideoCapture``
    (FFMPEG) reads it.  Raises OSError when the file cannot be read and
    :class:`UnsupportedVideo` when it is not Motion-JPEG in AVI."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._size = os.fstat(self._f.fileno()).st_size
            self._parse()
        except BaseException:
            self._f.close()
            raise
        self._next = 0  # the frame the next grab takes
        self._first_pts: Optional[int] = None  # of the first frame grabbed
        self._last_pts: Optional[int] = None

    # ------------------------------------------------------------ container

    def _header(self, pos: int) -> Tuple[bytes, int]:
        self._f.seek(pos)
        b = self._f.read(8)
        return _HEADER.unpack(b) if len(b) == 8 else (b"", -1)

    def _read(self, pos: int, n: int) -> bytes:
        self._f.seek(pos)
        return self._f.read(n)

    def _walk(self, start: int, end: int):
        """(offset, fourcc, size) of each chunk from ``start`` to ``end``."""
        pos = start
        while pos + 8 <= end:
            fcc, size = self._header(pos)
            yield pos, fcc, size
            pos += 8 + size + (size & 1)

    def _parse(self) -> None:
        head = self._read(0, 12)
        if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise _unsupported(self.path, "not an AVI file")
        self._movi: List[Tuple[int, int]] = []  # (offset of the 'movi' fourcc, end)
        strls, idx1, frame_period = [], None, 0
        # libavformat's fsize: the first RIFF's declared end where the file
        # is shorter (cut short), so a chunk it cuts is still read
        self._limit = max(self._size, 8 + _HEADER.unpack(self._read(0, 8))[1])
        pos = 0
        while pos + 12 <= self._size:  # RIFF AVI, then OpenDML's RIFF AVIX parts
            fcc, size = self._header(pos)
            form = self._read(pos + 8, 4)
            if fcc != b"RIFF" or form not in (b"AVI ", b"AVIX"):
                break
            end = min(pos + 8 + size, self._size)
            for at, fcc, csize in self._walk(pos + 12, end):
                kind = self._read(at + 8, 4) if fcc == b"LIST" else b""
                if kind == b"movi":
                    self._movi.append((at + 8, min(at + 8 + csize, self._size)))
                elif form == b"AVI " and kind == b"hdrl":
                    for a, f, s in self._walk(at + 12, at + 8 + csize):
                        if f == b"avih" and s >= 4:
                            frame_period = struct.unpack("<I", self._read(a + 8, 4))[0]
                        elif f == b"LIST" and self._read(a + 8, 4) == b"strl":
                            strls.append(dict(self._walk_strl(a + 12, a + 8 + s)))
                elif form == b"AVI " and fcc == b"idx1":
                    idx1 = (at + 8, csize)
            pos += 8 + size + (size & 1)
        n = next((i for i, s in enumerate(strls) if s.get("strh", b"")[:4] == b"vids"), None)
        if n is None:
            raise _unsupported(self.path, "no video stream")
        strl, self._streams = strls[n], len(strls)
        codec = strl.get("strf", bytes(20))[16:20]
        if codec not in MJPEG_FOURCCS:
            raise _unsupported(self.path, "not Motion-JPEG")
        if not self._movi:
            raise _unsupported(self.path, "no movi list")
        scale, rate, start, length = struct.unpack_from("<4I", strl["strh"], 20)
        if not (scale and rate):  # avidec.c: "generated by broken software"
            rate, scale = (1000000, frame_period) if frame_period else (25, 1)
        self.fps = rate / scale
        self._time_base = scale / rate
        self.frame_count = length
        self._ids = (b"%02ddc" % n, b"%02ddb" % n)
        self._start = start
        self.frames = self._index(strl.get("indx"), idx1)
        self._pts = [f.pts for f in self.frames]

    def _walk_strl(self, start: int, end: int):
        for at, fcc, size in self._walk(start, end):
            if fcc in (b"strh", b"strf"):
                yield fcc.decode(), self._read(at + 8, min(size, 64))
            elif fcc == b"indx":
                yield "indx", (at + 8, size)

    # ---------------------------------------------------------------- index

    def _index(self, indx, idx1) -> List[_Frame]:
        entries = None
        if indx is not None:
            entries = self._odml_entries(*indx)
        if entries is None and idx1 is not None:
            entries = self._idx1_entries(*idx1)
        if entries is not None and not self._entries_valid(entries):
            entries = None
        if entries is None:
            return self._scan(self._movi[0][0] + 4, self._start)
        frames, pts, last = [], self._start, None
        for pos, size, key in entries:
            if size and pos != last:
                frames.append(_Frame(pos, size, pts, key))
            pts, last = pts + 1, pos
        if frames and not any(f.key for f in frames):
            frames[0] = _Frame(frames[0].pos, frames[0].size, frames[0].pts, True)
        # what follows the last indexed chunk is read on, as FFMPEG does
        tail = self._after(*entries[-1][:2]) if entries else self._movi[0][0] + 4
        return frames + self._scan(tail, pts)

    def _odml_entries(self, pos: int, size: int, depth: int = 0):
        """(chunk offset, size, key) of each entry of an OpenDML index at
        ``pos``, or None where libavformat's read_odml_index refuses it."""
        if size < _INDEX_HEADER.size or depth > 3:
            return None
        longs, sub, typ, n, chunk_id, base, _ = _INDEX_HEADER.unpack(
            self._read(pos, _INDEX_HEADER.size))
        if chunk_id not in self._ids or sub or typ > 1 or (typ and longs != 2):
            return None
        raw = self._read(pos + _INDEX_HEADER.size, n * (8 if typ else 16))
        if len(raw) < n * (8 if typ else 16):
            return None
        out = []
        if typ:  # AVI_INDEX_OF_CHUNKS: offsets of the data from qwBaseOffset
            for off, ln in struct.iter_unpack("<II", raw):
                out.append((off + base - 8, ln & 0x7FFFFFFF, not ln & 0x80000000))
            return out
        for off, _, _ in struct.iter_unpack("<QII", raw):  # AVI_INDEX_OF_INDEXES
            fcc, sub_size = self._header(off)
            sub_entries = self._odml_entries(off + 8, sub_size, depth + 1)
            if sub_entries is None:
                return None
            out += sub_entries
        return out

    def _idx1_entries(self, pos: int, size: int):
        raw = self._read(pos, size - size % 16)
        first_packet = self._first_packet()
        out, offset = [], None
        for tag, flags, off, ln in struct.iter_unpack("<4sIII", raw):
            stream = (tag[0] - 48) * 10 + tag[1] - 48
            if not 0 <= stream < self._streams or tag[2:] == b"pc":
                continue
            if offset is None:
                offset = 0
                if first_packet and (self._movi[0][0] + 4 != off or off + 500 > first_packet):
                    offset = first_packet - off
            if tag in self._ids:
                out.append((off + offset, ln, bool(flags & _AVIIF_KEYFRAME)))
        return out

    def _first_packet(self) -> int:
        """The first chunk of any stream in the first ``movi`` list (0 for
        none), where libavformat's avi_sync stops."""
        start, end = self._movi[0]
        pos = start + 4
        while pos + 8 <= end:
            fcc, size = self._header(pos)
            if fcc == b"LIST":
                pos += 12
                continue
            if self._stream_chunk(fcc):
                return pos
            pos += 8 + size + (size & 1)
        return 0

    def _stream_chunk(self, fcc: bytes) -> bool:
        return (len(fcc) == 4 and fcc[:2].isdigit() and int(fcc[:2]) < self._streams
                and fcc[2:] != b"ix")

    def _entries_valid(self, entries) -> bool:
        last = -1
        for pos, size, _ in entries:
            if not size:
                continue
            if pos < last or pos + 8 + size > self._limit:
                return False
            fcc, csize = self._header(pos)
            if fcc not in self._ids or csize != size:
                return False
            last = pos
        return True

    def _plausible(self, pos: int) -> bool:
        fcc, size = self._header(pos)
        return size >= 0 and pos + 8 + size <= self._limit and (
            self._stream_chunk(fcc) or fcc in (b"LIST", b"JUNK", b"idx1", b"indx", b"RIFF")
            or fcc[:2] == b"ix" or fcc[2:] == b"ix")

    def _scan(self, start: int, pts: int) -> List[_Frame]:
        """The stream's chunks from ``start`` on, through every ``movi``
        list, in file order.  Bytes that are not a chunk are passed over a
        byte at a time, as libavformat's avi_sync does."""
        frames = []
        for movi, end in self._movi:
            if end <= start:
                continue
            pos = max(start, movi + 4)
            while pos + 8 <= end:
                fcc, size = self._header(pos)
                if fcc == b"LIST":
                    pos += 12
                    continue
                if not self._plausible(pos):
                    pos += 1
                    continue
                if fcc in self._ids:
                    if size:
                        frames.append(_Frame(pos, size, pts, True))
                    pts += 1
                pos = self._after(pos, size)
        return frames

    def _after(self, pos: int, size: int) -> int:
        """The chunk after the one at ``pos``: past its pad byte, or at the
        byte after an odd chunk that was written without one."""
        nxt = pos + 8 + size
        if size & 1 and not self._plausible(nxt + 1) and self._plausible(nxt):
            return nxt
        return nxt + (size & 1)

    # --------------------------------------------------------------- frames

    def chunk(self, i: int) -> bytes:
        """The JPEG bytes of frame ``i``."""
        f = self.frames[i]
        return self._read(f.pos + 8, f.size)

    def _grab(self) -> Optional[bytes]:
        """The next frame's bytes, or None at the end or where they are not
        a JPEG (FFMPEG's decode error); either way the frame is passed."""
        if self._next >= len(self.frames):
            return None
        f = self.frames[self._next]
        self._next += 1
        data = self.chunk(self._next - 1)
        try:
            jpeg_header(data)
        except ValueError:
            self._last_pts = None
            return None
        if self._first_pts is None:
            self._first_pts = f.pts
        self._last_pts = f.pts
        return data

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        """``(True, bgr_u8)`` of the next frame, or ``(False, None)``."""
        data = self._grab()
        if data is None:
            return False, None
        try:
            return True, decode_jpeg(data, name=f"{self.path} frame {self._next - 1}",
                                     truncated_ok=True)
        except ValueError:
            return False, None

    def _seek_pts(self, pts: int) -> None:
        """av_seek_frame(AVSEEK_FLAG_BACKWARD): to the last key frame at or
        before ``pts``; where there is none the position stays."""
        j = bisect.bisect_right(self._pts, pts) - 1
        while j >= 0 and not self.frames[j].key:
            j -= 1
        if j >= 0:
            self._next = j

    def set_pos(self, frame: int) -> bool:
        """Seek so that the next read gives frame ``frame``, in
        ``CvCapture_FFMPEG::seek``'s steps: the index clamped to
        frame_count; a first frame grabbed if none was; a step back of 16
        frames (then half as far again each time the landing is past the
        target) by timestamp to a key frame, then frames grabbed, counted
        one each, up to the one before the target.  Where
        a zero-length chunk lies before the step back's landing, or a chunk
        that is not a JPEG in the frames grabbed, that lands elsewhere, as in
        FFMPEG.  Returns True, as ``cap.set`` does."""
        total = self.frame_count
        target = max(0, min(int(frame), total))
        if self._first_pts is None and total > 1:
            self._grab()
        delta = _SEEK_DELTA
        while True:
            back = max(target - delta, 0)
            if total > 1:  # libavformat's stream start_time is 0
                self._seek_pts(int(back / self.fps / self._time_base + 0.5))
            if target == 0:
                break
            landed = self._grab() is not None
            if target == 1:
                break
            at = self._last_pts - self._first_pts if landed else -1
            if at < 0 or at > target - 1:
                if back == 0 or delta >= _INT_MAX // 4:
                    break
                delta = delta * 2 if delta < 16 else delta * 3 // 2
                continue
            while at < target - 1 and self._grab() is not None:
                at += 1
            break
        return True

    def release(self) -> None:
        self._f.close()
