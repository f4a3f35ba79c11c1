"""Video files read on the host without OpenCV: AVI (the RIFF container
walked with ``struct``), MP4/QuickTime (ISO BMFF, ``bmff.py``) and
Matroska/WebM (EBML, ``matroska.py``), their Motion-JPEG frames decoded by
the port's JPEG codec (``jpeg.py``), their MPEG-4 Part 2 frames by the
port's MPEG-4 decoder (``mpeg4.py``) and their H.264 frames by the port's
H.264 decoder (``h264.py``: High, Main and Constrained Baseline profiles,
4:2:0 8-bit progressive, I, P and B slices, CAVLC or CABAC, the 4x4 and 8x8
transforms and scaling matrices).

The readers have what ``runner.frame_source`` uses of ``cv2.VideoCapture``
and give, for the same file, what the JAX package's reader gives:
``cv2.VideoCapture(path)`` with no backend named, which opens these files
through FFMPEG (libavformat's AVI, ``mov`` and ``matroska`` demuxers,
libavcodec's ``mjpeg``, ``mpeg4`` and ``h264`` decoders).
:func:`open_reader` tries AVI, then ISO BMFF, then Matroska.

* **Frames** (:class:`AviReader`): the chunks of the first video stream
  (``NNdc``/``NNdb``) in file order, through every ``movi`` list, OpenDML's
  ``RIFF AVIX`` parts included.  A zero-length chunk (AVI's "repeat the
  last frame") yields no frame but takes one frame period of the
  timestamps, as in FFMPEG.  A chunk that the end of the file cuts inside
  its scan is a frame, as FFMPEG's decoder ends a scan without EOI; cut
  before its scan, it ends the read.  (:class:`Mp4Reader`): the samples of
  the first video track, after its edit list (``bmff.py``).
  (:class:`MkvReader`): the blocks of the first video track (TrackType 1)
  in file order, laces split and ContentEncoding (header stripping, zlib)
  undone; a block the end of the file cuts ends the read, and a block of a
  track no TrackEntry declares drops the rest of its Cluster, as in
  libavformat (``matroska.py``).
* **The AVI index**: OpenDML's ``indx`` and its ``ix##`` chunks, else
  ``idx1`` (offsets relative to ``movi`` or absolute, told apart as
  libavformat's ``avi_read_idx1`` does: the first entry is moved onto the
  first chunk of ``movi``), then a scan on from the last indexed chunk.
  With no index, or with an entry that does not point at a chunk of the
  stream and its size, the ``movi`` lists are scanned.  Key frames: the
  index's AVIIF_KEYFRAME, or ``stss`` in MP4, or the block's key flag (a
  BlockGroup without ReferenceBlock) in Matroska; a scanned MPEG-4 chunk is
  a key frame where it holds an I-VOP, a scanned H.264 chunk where it holds
  an IDR slice.
* **Pixels**: Motion-JPEG: FFmpeg's ``mjpeg`` decoder and swscale's
  conversion (``jpeg.MjpegDecoder``), equal to cv2's frames bit for bit for
  YCbCr 4:2:0 and 4:2:2 of even height, 4:4:4 and gray; a chunk the end
  of the file cuts keeps the frame before's pixels in the blocks it does
  not reach, as in FFmpeg.  Other layouts (4:2:0 and 4:2:2 of odd height,
  4:1:1, 4:4:0, RGB, CMYK) take libjpeg's arithmetic, ``cv2.imread``'s
  (ROADMAP C9's remainder).  MPEG-4: every packet a read or a
  seek passes goes through the decoder in order (P-VOPs predict from the
  picture before), and its pictures equal cv2's bit for bit.  A packet that
  gives no picture (headers only, a VOP that is not coded) is passed, as
  FFMPEG passes it; one that does not decode ends a sequential read (FFMPEG
  conceals the damage and goes on).  H.264: the same, with FFmpeg's output
  order and delay (a picture may come out after later packets, and the
  pictures held back come out at the end), starting from the delay
  OpenCV's decoder is opened with (MP4: libavformat's estimate from
  ``ctts``; AVI and Matroska: what avformat_find_stream_info's decode of
  the first packets reached); from the start and after a seek, pictures
  show from where FFmpeg's do (an IDR picture, a recovery point SEI, or an
  I picture with few references); a packet that does not decode raises
  ValueError (no concealment).  Frame numbers (for seeks) come from each
  picture's own pts in MP4 and Matroska, and in AVI and Matroska's
  ``V_MS/VFW/FOURCC``, whose packets carry none, from the dts of the packet
  whose decode gave the picture, as OpenCV takes them.
* **fps**: AVI: the stream header's dwRate / dwScale (libavformat's
  fallbacks where either is 0); MP4: the track's average frame rate;
  Matroska: 1e9 / DefaultDuration, or without it the rate
  avformat_find_stream_info finds (``matroska.frame_rate``);
  ``CAP_PROP_FPS``.  **frame_count**: dwLength, or the track's sample
  count, or Matroska's Duration times fps, rounded (negative without a
  Duration), ``CAP_PROP_FRAME_COUNT``.
* **set_pos(i)**: OpenCV's ``CvCapture_FFMPEG::seek`` over libavformat's
  index (:meth:`_Reader.set_pos`): frame i on a file without zero-length,
  broken or not-coded frames, and past the end, the end of the stream;
  Matroska's index is its Cues and every key frame's Cluster
  (:meth:`MkvReader._seek_pts`).

Anything else raises :class:`UnsupportedVideo`, naming the file, its
container and the video stream's fourcc (Matroska: its CodecID), and the
feature where one is refused: other codecs (VP8, VP9, AV1, HEVC, FFV1,
Theora, MPEG-1/2, ProRes, ...), the MPEG-4 features ``mpeg4.py`` refuses,
the H.264 features ``h264.py`` refuses (checked in the parameter sets and
the slice headers of the first packets when the file opens), the MP4
layouts ``bmff.py`` refuses, the Matroska features ``matroska.py`` refuses,
H.264 with B pictures in ``V_MS/VFW/FOURCC`` (libavformat guesses those
pictures' timestamps).  ``runner.open_video`` hands those to OpenCV where
it is installed.
"""

from __future__ import annotations

import bisect
import math
import os
import re
import struct
from typing import List, Optional, Tuple

import numpy as np

from . import bmff, matroska
from .bmff import Sample
from .image_io import decode_bmp, decode_png, decode_pnm, image_format
from .jpeg import MjpegDecoder
from .h264 import H264Decoder, H264Unsupported, sps_frame_rate
from .mpeg4 import Mpeg4Decoder, Mpeg4Unsupported, vol_frame_rate

MJPEG_FOURCCS = (b"MJPG", b"mjpg")
# AVI fourccs libavformat maps to the mpeg4 decoder (ff_codec_bmp_tags,
# matched upper-cased)
MPEG4_FOURCCS = ("FMP4", "DIVX", "DX50", "XVID", "XVIX", "MP4S", "M4S2", "MP4V", "DIV1",
                 "UMP4", "SMP4")
# AVI fourccs libavformat maps to the h264 decoder (ff_codec_bmp_tags,
# matched upper-cased)
H264_FOURCCS = ("H264", "X264", "AVC1", "DAVC", "SMV2", "VSSH", "Q264", "V264", "GAVC", "UMSV",
                "TSHD", "INMX")
BMFF_CODECS = {"mp4v": "mpeg4", "jpeg": "mjpeg", "avc1": "h264", "avc3": "h264"}
# Matroska CodecIDs libavformat maps to the decoders the port has
MKV_CODECS = {"V_MPEG4/ISO/AVC": "h264", "V_MPEG4/ISO/ASP": "mpeg4", "V_MPEG4/ISO/SP": "mpeg4",
              "V_MPEG4/ISO/AP": "mpeg4", "V_MJPEG": "mjpeg"}
MKV_VFW = "V_MS/VFW/FOURCC"  # CodecPrivate: a BITMAPINFOHEADER, as in AVI
EBML_MAGIC = b"\x1a\x45\xdf\xa3"
_VOP = b"\x00\x00\x01\xb6"
_PROBE_PACKETS = 64  # packets whose VOP type is checked when a file opens
_REFUSED_VOPS = {2: "B-VOPs (bidirectional prediction)",
                 3: "S-VOPs (sprites and global motion compensation)"}
_HEADER = struct.Struct("<4sI")
_INDEX_HEADER = struct.Struct("<HBBI4sQI")  # OpenDML indx / ix## (24 bytes)
_AVIIF_KEYFRAME = 0x10
_SEEK_DELTA = 16  # CvCapture_FFMPEG::seek's first step back
_INT_MAX = 2**31 - 1
_NOPTS = -(2**63)  # AV_NOPTS_VALUE
_FPS_PROBE_FRAMES = 20  # avformat_find_stream_info's fps_analyze_framecount
SEQUENCE_FPS = 25.0  # the image2 demuxer's default framerate
_SEQUENCE_START_RANGE = 5  # image2's start_number_range: the first file is numbered 0 to 4
_SINGLE_IMAGE_COUNT = -(2**63)  # CAP_PROP_FRAME_COUNT of one image (its duration is unset)


class UnsupportedVideo(RuntimeError):
    """A video the port's reader does not decode (it needs OpenCV)."""


def _bmp_codec(fourcc: bytes) -> Optional[str]:
    """The decoder libavformat's ff_codec_bmp_tags give a BITMAPINFOHEADER's
    compression fourcc (AVI's ``strf``, Matroska's ``V_MS/VFW/FOURCC``),
    where the port has it."""
    if fourcc in MJPEG_FOURCCS:
        return "mjpeg"
    name = fourcc.decode("latin-1").upper()
    return "mpeg4" if name in MPEG4_FOURCCS else "h264" if name in H264_FOURCCS else None


def _fourcc(b: Optional[bytes]) -> str:
    if not b:
        return "unknown"
    s = b.decode("latin-1")
    return s if s.isprintable() else repr(b)


def sniff(path: str) -> Tuple[str, str]:
    """(container, video fourcc or codec id) of a video file, for messages:
    RIFF AVI (strf's compression), ISO BMFF (the first ``vide`` track's
    sample entry), Matroska or WebM (the first video track's CodecID, or
    the first ``V_`` CodecID where the headers do not parse) or unknown."""
    with open(path, "rb") as f:
        head = f.read(1 << 20)
    if head[:4] == b"RIFF":
        form = head[8:12].decode("latin-1").strip()
        m = re.search(rb"strh.{4}vids.{0,120}?strf.{4}.{16}(.{4})", head, re.S)
        return f"RIFF {form}", _fourcc(m.group(1) if m else None)
    if head[4:8] in _BMFF_TOP:
        with open(path, "rb") as f:
            fourcc = bmff.video_fourcc(f, os.fstat(f.fileno()).st_size)
        return "ISO BMFF (MP4/QuickTime)", _fourcc(fourcc.encode("latin-1") if fourcc else None)
    if head[:4] == EBML_MAGIC:
        with open(path, "rb") as f:
            doc, codec_id = matroska.video_codec(f, os.fstat(f.fileno()).st_size)
        if codec_id is None:
            m = re.search(rb"\x86([\x81-\xbf])(?=V_)", head)
            codec_id = (head[m.end():m.end() + (m.group(1)[0] & 0x3F)].decode("latin-1")
                        if m else "unknown")
        return ("WebM (Matroska)" if doc == "webm" else "Matroska"), codec_id
    return "unknown", "unknown"


_BMFF_TOP = (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip")


def _unsupported(path: str, why: str) -> UnsupportedVideo:
    container, fourcc = sniff(path)
    label = "CodecID" if "Matroska" in container else "fourcc"
    return UnsupportedVideo(
        f"{path}: {container} container, video {label} {fourcc}: {why}; without OpenCV the "
        f"port reads Motion-JPEG, MPEG-4 Part 2 (Simple Profile, I/P) and H.264 "
        f"(High, Main and Constrained Baseline profiles, 4:2:0 8-bit progressive, I/P/B) in AVI, "
        f"MP4, QuickTime and Matroska (MKV), so this file needs OpenCV (cv2)")


def open_reader(path: str) -> "_Reader":
    """The port's reader of ``path``: a printf image sequence where the path
    is a pattern (:func:`sequence_filename`) that names no file itself,
    else by the file's signature AVI, ISO BMFF, Matroska (EBML), or one
    image (:class:`SequenceReader`).  OSError where the file (or the sequence's
    first file) cannot be read, UnsupportedVideo where no reader takes it."""
    if sequence_filename(path, 0) is not None and not os.path.exists(path):
        return SequenceReader(path)
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF" and head[8:12] != b"WEBP":
        return AviReader(path)
    if head[4:8] in _BMFF_TOP:
        return Mp4Reader(path)
    if head[:4] == EBML_MAGIC:
        return MkvReader(path)
    if image_format(head) in SequenceReader.FORMATS:
        return SequenceReader(path)
    raise _unsupported(path, "not an AVI, MP4, QuickTime or Matroska file, nor an image the "
                             "port reads")


class _Reader:
    """What the AVI, MP4 and Matroska readers share: the frame list, the decoders,
    reads and seeks.  A subclass's ``_parse`` sets ``frames``, ``fps``,
    ``frame_count``, ``codec`` ("mjpeg", "mpeg4" or "h264"), ``fourcc``,
    ``_time_base`` (seconds a pts unit), ``_start_time`` (the stream's
    start_time, in pts units), ``_extra`` (MPEG-4 headers or H.264
    parameter sets carried outside the packets) and, for H.264,
    ``_nal_length`` (MP4's NAL length size; 0 for Annex B)."""

    _header_bytes = 0  # bytes before a frame's data at its pos
    _seek_before_first_to_start = False  # mov: a seek before the first entry lands on it
    _number_by_trigger = False  # H.264 pictures numbered by the packet that gave them (AVI)
    # H.264: packets avformat_find_stream_info may decode for the output
    # delay the decoder starts with (0: the container gives the delay)
    _probe_packets = 0

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._decoder = None  # Mpeg4Decoder or H264Decoder
        self._mjpeg: Optional[MjpegDecoder] = None
        self._picture: Optional[np.ndarray] = None  # the last Motion-JPEG frame grabbed
        try:
            self._size = os.fstat(self._f.fileno()).st_size
            self._extra = b""
            self._nal_length = 0
            self._video_delay = 0
            self._parse()
            # what a seek compares: the pts, or with MP4 composition
            # offsets the decode time (libavformat searches its index by dts)
            self._pts = [f.pts if f.dts is None else f.dts for f in self.frames]
            if self.codec == "mpeg4":
                self._open_mpeg4()
            elif self.codec == "h264":
                self._open_h264()
            else:
                self._mjpeg = MjpegDecoder(path)
        except BaseException:
            self.release()
            raise
        self._next = 0  # the frame the next grab takes
        self._first_pts: Optional[int] = None  # of the first frame grabbed
        self._last_pts: Optional[int] = None

    def _parse(self) -> None:
        raise NotImplementedError

    def _read(self, pos: int, n: int) -> bytes:
        self._f.seek(pos)
        return self._f.read(n)

    def packet(self, i: int) -> bytes:
        """The bytes of frame ``i`` (a JPEG, or MPEG-4 headers and a VOP)."""
        f = self.frames[i]
        return self._read(f.pos + self._header_bytes, f.size)

    def _head(self, i: int, n: int) -> bytes:
        """The first ``n`` bytes of frame ``i``."""
        f = self.frames[i]
        return self._read(f.pos + self._header_bytes, min(f.size, n))

    def _open_mpeg4(self) -> None:
        """The decoder, given the VOL headers (the esds's, or those before
        the first VOP of the first frame); the VOP types of the first
        frames are checked so that B- and S-VOPs are refused here."""
        extra = self._extra
        if not extra and self.frames:
            first = self.packet(0)
            at = first.find(_VOP)
            extra = first[:at] if at >= 0 else first
        try:
            self._decoder = Mpeg4Decoder(extra, self.fourcc, self.path)
            for i in range(min(len(self.frames), _PROBE_PACKETS)):
                head = self._head(i, 256)
                at = head.find(_VOP)
                refused = _REFUSED_VOPS.get(head[at + 4] >> 6) if 0 <= at < len(head) - 4 else None
                if refused:
                    raise Mpeg4Unsupported(refused)
        except Mpeg4Unsupported as e:
            raise _unsupported(self.path, f"MPEG-4 feature refused: {e}") from None
        except ValueError as e:
            raise _unsupported(self.path, f"MPEG-4 headers do not decode: {e}") from None

    def _open_h264(self) -> None:
        """The decoder, given the parameter sets carried outside the
        packets; the parameter sets and slice headers of the first packets
        are checked so that refused features are refused here."""
        try:
            if self._probe_packets:
                self._video_delay = self._probe_delay()
            self._decoder = H264Decoder(self._extra, self._nal_length, self.path,
                                        self._video_delay)
            for i in range(min(len(self.frames), _PROBE_PACKETS)):
                self._decoder.probe(self.packet(i))
        except H264Unsupported as e:
            raise _unsupported(self.path, f"H.264 feature refused: {e}") from None
        except ValueError as e:
            raise _unsupported(self.path, f"H.264 headers do not decode: {e}") from None

    def _probe_delay(self) -> int:
        """The output delay avformat_find_stream_info leaves an H.264
        stream: of the packets it reads (``_probe_packets``: AVI's 40, as
        the time base of H.264 counts as unreliable and it looks for 40
        frame durations) it decodes them until it has had 7 pictures (18
        once the delay is 3, 20 from 4) or the end, and the decoder OpenCV
        opens starts with the delay that decode reached.  A packet that does
        not decode ends the probe."""
        dec = H264Decoder(self._extra, self._nal_length, self.path)
        try:
            got = 0
            for i in range(min(len(self.frames), self._probe_packets)):
                need = 7 if dec.delay < 3 else 18 if dec.delay < 4 else 20
                if got >= need:
                    break
                got += dec.advance(self.packet(i), i)
            return dec.delay
        except ValueError:
            return dec.delay
        finally:
            dec.close()

    # --------------------------------------------------------------- frames

    def _grab(self) -> Optional[bytes]:
        """The next shown frame's bytes, or None at the end or where they do
        not decode (FFMPEG's decode error); either way the frame is passed.
        Every packet goes through its decoder here, as FFMPEG decodes each
        frame it grabs: MPEG-4 P-VOPs predict from the picture before, and a
        cut Motion-JPEG frame keeps the picture before's pixels.  H.264 gives
        its pictures in FFmpeg's output order (each with its own packet's
        timestamp), the held-back ones once the packets end; a packet that
        does not decode raises."""
        if self.codec == "h264":
            return self._grab_h264()
        while self._next < len(self.frames):
            f = self.frames[self._next]
            self._next += 1
            data = self.packet(self._next - 1)
            try:
                if self._decoder is None:
                    self._picture = self._mjpeg.decode(data)
                    shown = True
                else:
                    shown = self._decoder.advance(data)
            except Mpeg4Unsupported as e:
                raise _unsupported(self.path, f"MPEG-4 feature refused: {e}") from None
            except ValueError:
                self._last_pts = None
                return None
            if not shown or f.discard:
                continue
            self._shown(f.pts)
            return data
        return None

    def _shown(self, pts: int) -> None:
        if self._first_pts is None:
            self._first_pts = pts
        self._last_pts = pts

    def _grab_h264(self) -> Optional[bytes]:
        dec = self._decoder
        while True:
            data = b""
            trigger: Optional[int] = None  # the packet whose decode gave the picture
            try:
                if self._next < len(self.frames):
                    self._next += 1
                    trigger = self._next - 1
                    data = self.packet(trigger)
                    shown = dec.advance(data, trigger)
                elif not dec.drain():
                    return None
                else:
                    shown = True
            except H264Unsupported as e:
                raise _unsupported(self.path, f"H.264 feature refused: {e}") from None
            except ValueError as e:
                raise ValueError(f"{self.path}: frame {self._next - 1} does not decode: {e}") \
                    from None
            if not shown:
                continue
            f = self.frames[dec.tag]
            if f.discard:
                continue
            if self._number_by_trigger:
                # AVI packets carry no pts: OpenCV numbers a picture by the
                # dts of the packet whose decode gave it (none at the end)
                self._shown(_NOPTS if trigger is None else self.frames[trigger].pts)
            else:
                self._shown(f.pts)
            return data

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        """``(True, bgr_u8)`` of the next frame, or ``(False, None)``."""
        data = self._grab()
        if data is None:
            return False, None
        if self._decoder is not None:
            return True, self._decoder.picture()
        return True, self._picture

    def _frame_number(self, pts: int) -> int:
        """OpenCV's dts_to_frame_number."""
        return int(self.fps * (pts - self._start_time) * self._time_base + 0.5)

    def _seek_pts(self, pts: int) -> None:
        """av_seek_frame(AVSEEK_FLAG_BACKWARD): to the last key frame at or
        before ``pts``; where there is none the position stays (AVI) or, for
        a time before the first frame's, goes to it (mov)."""
        j = bisect.bisect_right(self._pts, pts) - 1
        while j >= 0 and not self.frames[j].key:
            j -= 1
        if j >= 0:
            self._next = j
        elif self._seek_before_first_to_start and self._pts and pts < self._pts[0]:
            self._next = 0

    def set_pos(self, frame: int) -> bool:
        """Seek so that the next read gives frame ``frame``, in
        ``CvCapture_FFMPEG::seek``'s steps: the index clamped to
        frame_count; a first frame grabbed if none was; a step back of 16
        frames (then half as far again each time the landing is past the
        target) by timestamp to a key frame, the decoder flushed, then
        frames grabbed, counted one each, up to the one before the target.
        Where a zero-length chunk lies before the step back's landing, or a
        frame that does not decode in the frames grabbed, that lands
        elsewhere, as in FFMPEG.  Returns True, as ``cap.set`` does."""
        total = self.frame_count
        target = max(0, min(int(frame), total))
        if self._first_pts is None and total > 1:
            self._grab()
        delta = _SEEK_DELTA
        while True:
            back = max(target - delta, 0)
            if total > 1:
                self._seek_pts(self._start_time + int(back / self.fps / self._time_base + 0.5))
            self._flush()
            if target == 0:
                break
            landed = self._grab() is not None
            if target == 1:
                break
            at = (self._frame_number(self._last_pts) - self._frame_number(self._first_pts)
                  if landed else -1)
            if at < 0 or at > target - 1:
                if back == 0 or delta >= _INT_MAX // 4:
                    break
                delta = delta * 2 if delta < 16 else delta * 3 // 2
                continue
            while at < target - 1 and self._grab() is not None:
                at += 1
            break
        return True

    def _flush(self) -> None:
        """avcodec_flush_buffers, after each of a seek's steps."""
        if self._decoder is not None:
            self._decoder.flush()

    def release(self) -> None:
        self._f.close()
        for dec in (self._decoder, self._mjpeg):
            if dec is not None:
                dec.close()


def sequence_filename(pattern: str, number: int) -> Optional[str]:
    """libavutil's av_get_frame_filename2: ``pattern`` with its one ``%d``
    (or ``%Nd``/``%0Nd``, zero-padded to N digits) replaced by ``number``
    and each ``%%`` by ``%``; None where ``pattern`` is not such a pattern
    (no ``%d``, two, or another ``%`` sequence)."""
    out, i, found = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        i += 1
        if c != "%":
            out.append(c)
            continue
        nd = 0
        while i < len(pattern) and "0" <= pattern[i] <= "9":
            nd = nd * 10 + ord(pattern[i]) - 48
            i += 1
        c = pattern[i] if i < len(pattern) else ""
        i += 1
        if c == "%":
            out.append("%")
        elif c == "d" and not found:
            found = True
            out.append("%0*d" % (nd, number))
        else:
            return None
    return "".join(out) if found else None


def _image_range(pattern: str) -> Optional[Tuple[int, int]]:
    """image2's find_image_range: the first readable file numbered 0 to 4,
    then the last, found by steps of 1, 2, 4, ... from the last found (so a
    gap can be stepped over); None where there is no first file."""
    def readable(k: int) -> bool:
        name = sequence_filename(pattern, k)
        return name is not None and os.access(name, os.R_OK)

    first = next((k for k in range(_SEQUENCE_START_RANGE) if readable(k)), None)
    if first is None:
        return None
    last = first
    while True:
        step = 0
        while readable(last + (2 * step or 1)):
            step = 2 * step or 1
            if step >= 1 << 30:
                return None
        if not step:
            return first, last
        last += step


class SequenceReader(_Reader):
    """A printf image sequence (``f_%03d.jpg``), or one image, read as
    ``cv2.VideoCapture`` (FFMPEG's image2 demuxer) reads it:

    * **Frames**: the files numbered from the first of 0 to 4 that exists
      to the last that image2's range search finds (:func:`_image_range`);
      ``frame_count`` counts them, ``fps`` is 25.0.  A file of the range
      that is missing ends the read, and every read after it, until a seek
      (FFMPEG's demuxer stays on it, and its decoder has been drained).
    * **Seeks**: ``set_pos`` as for the other readers; image2 seeks to any
      frame of the range exactly, so every frame is a key frame.
    * **Pixels**, each file by its signature: JPEG through FFmpeg's mjpeg
      arithmetic (``jpeg.MjpegDecoder``); PNG, BMP and PNM as ``cv2.imread``
      reads them (``image_io``), which FFmpeg's decoders and swscale equal,
      except where they differ and FFmpeg's are followed: 16-bit BMP
      samples widened with their top bits, PNM samples below maxval 255
      scaled as FFmpeg scales them.  16-bit PNM, and everything
      ``image_io`` refuses, is refused when the first file is.
    * **One image** (a path with no pattern): cv2 opens it through FFMPEG
      as a stream of one frame whose count it reports as -2^63; a seek
      leaves the position where it is.  The reader matches that.
    """

    FORMATS = ("jpeg", "png", "bmp", "pnm")

    def __init__(self, path: str):
        self.path = path
        self._decoder = None
        self._mjpeg = MjpegDecoder(path)
        self.fps, self._time_base, self._start_time = SEQUENCE_FPS, 1 / SEQUENCE_FPS, 0
        self._next, self._first_pts, self._last_pts = 0, None, None
        self._picture: Optional[np.ndarray] = None
        self._drained = False
        if sequence_filename(path, 0) is None:
            self._first, self.frame_count = None, _SINGLE_IMAGE_COUNT
            first_file = path
        else:
            found = _image_range(path)
            if found is None:
                raise FileNotFoundError(f"{path}: no file of the sequence is numbered 0 to "
                                        f"{_SEQUENCE_START_RANGE - 1}")
            self._first, self.frame_count = found[0], found[1] - found[0] + 1
            first_file = self.file(0)
        with open(first_file, "rb") as f:
            data = f.read()
        try:
            self._decode(data, first_file, MjpegDecoder(first_file))
        except ValueError as e:
            raise UnsupportedVideo(
                f"{path}: image sequence, first file {first_file}: {e}; without OpenCV the "
                f"port reads JPEG, PNG, BMP and PNM (8-bit) image sequences, so this one "
                f"needs OpenCV (cv2)") from None
        self.codec = self.fourcc = image_format(data)

    def file(self, i: int) -> str:
        """The file of frame ``i``."""
        return self.path if self._first is None else sequence_filename(self.path,
                                                                       self._first + i)

    @staticmethod
    def _decode(data: bytes, name: str, mjpeg: MjpegDecoder) -> np.ndarray:
        """One file's pixels as FFMPEG's decoder and swscale give them."""
        fmt = image_format(data)
        if fmt == "jpeg":
            return mjpeg.decode(data)
        if fmt == "png":
            return decode_png(data, path=name)
        if fmt == "bmp":
            return decode_bmp(data, name=name, ffmpeg=True)
        if fmt == "pnm":
            return decode_pnm(data, name=name, ffmpeg=True)
        raise ValueError(f"{name}: {fmt} image")

    def _grab(self) -> Optional[bytes]:
        n = 1 if self._first is None else self.frame_count
        if self._drained or self._next >= n:
            return None
        try:
            with open(self.file(self._next), "rb") as f:
                data = f.read()
        except OSError:  # image2 fails on it, and OpenCV drains the decoder
            self._drained = True
            return None
        self._next += 1
        try:
            self._picture = self._decode(data, self.file(self._next - 1), self._mjpeg)
        except ValueError:
            self._last_pts = None
            return None
        pts = self._next - 1
        if self._first_pts is None:
            self._first_pts = pts
        self._last_pts = pts
        return data

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        if self._grab() is None:
            return False, None
        return True, self._picture

    def _seek_pts(self, pts: int) -> None:
        """image2's img_read_seek: to frame ``pts`` where it lies in the range."""
        if 0 <= pts < self.frame_count:
            self._next = pts

    def _flush(self) -> None:
        self._drained = False

    def release(self) -> None:
        self._mjpeg.close()


class Mp4Reader(_Reader):
    """An MP4 or QuickTime file of MPEG-4 Part 2 (``mp4v``), H.264 (``avc1``,
    ``avc3``: up to High profile) or Motion-JPEG (``jpeg``) video, read
    frame by frame as ``cv2.VideoCapture`` (FFMPEG) reads it.  Raises
    OSError when the file cannot be read and :class:`UnsupportedVideo` for
    any other file."""

    _seek_before_first_to_start = True

    def _parse(self) -> None:
        try:
            track = bmff.parse(self._f, self._size)
        except bmff.BmffRefused as e:
            raise _unsupported(self.path, f"refused: {e}") from None
        except (bmff.BmffError, struct.error, IndexError) as e:
            raise _unsupported(self.path, f"not a readable MP4/QuickTime file: {e}") from None
        self.fourcc = track.fourcc
        self.codec = BMFF_CODECS.get(track.fourcc)
        if self.codec is None:
            raise _unsupported(self.path, "not MPEG-4 Part 2 (mp4v), H.264 (avc1, avc3) or "
                                          "Motion-JPEG (jpeg)")
        if self.codec == "mpeg4" and track.object_type != bmff.MP4_VISUAL:
            raise _unsupported(self.path, f"esds object type {track.object_type} is not "
                                          "MPEG-4 Part 2 video (0x20)")
        if self.codec == "h264" and not track.nal_length:
            raise _unsupported(self.path, f"an {track.fourcc} sample entry without an avcC box")
        self._nal_length = track.nal_length
        self._time_base = 1.0 / track.timescale
        self.fps = track.fps or float(track.timescale)
        self.frame_count = track.frame_count
        self._start_time = track.start_pts
        self._video_delay = track.video_delay
        self._extra = track.extra
        self.frames = track.samples


class MkvReader(_Reader):
    """A Matroska or WebM file of MPEG-4 Part 2 (``V_MPEG4/ISO/ASP``,
    ``/SP``, ``/AP``), H.264 (``V_MPEG4/ISO/AVC``: up to High profile) or
    Motion-JPEG (``V_MJPEG``) video, or of those in ``V_MS/VFW/FOURCC``
    (the AVI fourccs), read frame by frame as ``cv2.VideoCapture`` (FFMPEG)
    reads it (``matroska.py``).  Pictures are numbered by their own block
    timestamps, in ``V_MS/VFW/FOURCC`` by the packet that gave them, as
    libavformat gives those blocks' timestamps as decode times.  Raises
    OSError when the file cannot be read and :class:`UnsupportedVideo` for
    any other file."""

    _probe_packets = 2 * _FPS_PROBE_FRAMES

    def _parse(self) -> None:
        try:
            track = matroska.parse(self._f, self._size)
        except matroska.MkvRefused as e:
            raise _unsupported(self.path, f"refused: {e}") from None
        except (matroska.MkvError, struct.error, IndexError) as e:
            raise _unsupported(self.path, f"not a readable Matroska file: {e}") from None
        self._track = track
        self.fourcc = track.fourcc
        self._extra = track.extra
        if track.fourcc == MKV_VFW:
            if len(track.extra) < 40:
                raise _unsupported(self.path, "a V_MS/VFW/FOURCC CodecPrivate shorter than a "
                                              "BITMAPINFOHEADER")
            self.fourcc = track.extra[16:20].decode("latin-1")
            self._extra = track.extra[40:]  # the extradata after BITMAPINFOHEADER
            self._number_by_trigger = True  # libavformat's ms_compat: block times are dts
            self.codec = _bmp_codec(track.extra[16:20])
            if self.codec is None:
                raise _unsupported(self.path, f"V_MS/VFW/FOURCC {_fourcc(track.extra[16:20])} is "
                                              "not Motion-JPEG, MPEG-4 Part 2 or H.264")
        else:
            self.codec = MKV_CODECS.get(track.fourcc)
            if self.codec is None:
                raise _unsupported(self.path, "not MPEG-4 Part 2 (V_MPEG4/ISO/ASP), H.264 "
                                              "(V_MPEG4/ISO/AVC) or Motion-JPEG (V_MJPEG)")
            if self.codec == "h264":
                try:
                    self._nal_length = bmff.avcc_nal_length(track.extra)
                except bmff.BmffError as e:
                    raise _unsupported(self.path, f"V_MPEG4/ISO/AVC CodecPrivate: {e}") from None
        self.frames = track.samples
        rate = None
        if self.codec == "mpeg4":
            rate = vol_frame_rate(self._extra or (self.packet(0) if self.frames else b""))
        elif self.codec == "h264":
            sps = self._first_sps()
            rate = sps_frame_rate(sps) if sps else None
        self.fps = matroska.frame_rate(track, rate, self.codec == "h264")
        self.frame_count = matroska.frame_count(track, self.fps)
        g = math.gcd(track.timescale, 10**9)
        self._time_base = (track.timescale // g) / (10**9 // g)
        self._start_time = track.start_pts
        self._index = [t for t, _ in track.seek_index]

    def _first_sps(self) -> Optional[bytes]:
        """The first SPS NAL unit: the avcC record's, or in Annex B
        extradata or the first packet."""
        if self._nal_length:
            rec = self._extra
            if len(rec) > 8 and rec[5] & 31:
                n = struct.unpack_from(">H", rec, 6)[0]
                return rec[8:8 + n]
            return None
        for data in (self._extra, self.packet(0) if self.frames else b""):
            for at in _start_codes(data):
                if data[at + 3] & 31 == 7:
                    end = data.find(b"\x00\x00\x01", at + 3)
                    return data[at + 3:end if end >= 0 else len(data)]
        return None

    def _open_h264(self) -> None:
        super()._open_h264()
        if self._number_by_trigger and self._video_delay:
            raise _unsupported(self.path, "V_MS/VFW/FOURCC H.264 with B pictures (reordered "
                                          "output: libavformat guesses their timestamps)")

    def packet(self, i: int) -> bytes:
        """The bytes of frame ``i`` after the track's ContentEncoding."""
        f = self.frames[i]
        return matroska.decode_frame(self._read(f.pos, f.size), self._track.strip,
                                     self._track.zlib)

    def _head(self, i: int, n: int) -> bytes:
        return self.packet(i)[:n]

    def _seek_pts(self, pts: int) -> None:
        """matroska_read_seek (AVSEEK_FLAG_BACKWARD): the last index entry
        at or before ``pts`` (or the first entry, for a time before it);
        the demuxer reads its Cluster from the start, passes the blocks
        before the entry's time, and the frames up to a key frame."""
        if not self._index:
            return
        j = max(0, bisect.bisect_right(self._index, pts) - 1)
        ts, k = self._track.seek_index[j]
        while k < len(self.frames) and not (self.frames[k].key and self.frames[k].pts >= ts):
            k += 1
        self._next = k


class AviReader(_Reader):
    """A Motion-JPEG, MPEG-4 Part 2 or H.264 (Annex B, up to High profile) AVI
    file, read frame by frame as ``cv2.VideoCapture`` (FFMPEG) reads it.
    Raises OSError when the file cannot be read and
    :class:`UnsupportedVideo` for any other file."""

    _header_bytes = 8
    _number_by_trigger = True
    _probe_packets = 2 * _FPS_PROBE_FRAMES


    # ------------------------------------------------------------ container

    def _header(self, pos: int) -> Tuple[bytes, int]:
        self._f.seek(pos)
        b = self._f.read(8)
        return _HEADER.unpack(b) if len(b) == 8 else (b"", -1)

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
        self.fourcc = codec.decode("latin-1")
        self.codec = _bmp_codec(codec)
        if self.codec is None:
            raise _unsupported(self.path, "not Motion-JPEG, MPEG-4 Part 2 or H.264")
        if self.codec == "h264":
            self._extra = strl.get("strf", b"")[40:]  # the extradata after BITMAPINFOHEADER
        if not self._movi:
            raise _unsupported(self.path, "no movi list")
        scale, rate, start, length = struct.unpack_from("<4I", strl["strh"], 20)
        if not (scale and rate):  # avidec.c: "generated by broken software"
            rate, scale = (1000000, frame_period) if frame_period else (25, 1)
        self.fps = rate / scale
        self._time_base = scale / rate
        self._start_time = 0  # libavformat's stream start_time
        self.frame_count = length
        self._ids = (b"%02ddc" % n, b"%02ddb" % n)
        self._start = start
        self.frames = self._index(strl.get("indx"), idx1)

    def _walk_strl(self, start: int, end: int):
        for at, fcc, size in self._walk(start, end):
            if fcc == b"strh":
                yield "strh", self._read(at + 8, min(size, 64))
            elif fcc == b"strf":  # BITMAPINFOHEADER and the codec's extradata
                yield "strf", self._read(at + 8, min(size, 1 << 16))
            elif fcc == b"indx":
                yield "indx", (at + 8, size)

    # ---------------------------------------------------------------- index

    def _index(self, indx, idx1) -> List[Sample]:
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
                frames.append(Sample(pos, size, pts, key))
            pts, last = pts + 1, pos
        if frames and not any(f.key for f in frames):
            frames[0] = Sample(frames[0].pos, frames[0].size, frames[0].pts, True)
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

    def _scan(self, start: int, pts: int) -> List[Sample]:
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
                        frames.append(Sample(pos, size, pts, self._scanned_key(pos, size)))
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

    def _scanned_key(self, pos: int, size: int) -> bool:
        """A chunk found by the scan: a key frame, unless it is an MPEG-4
        chunk whose VOP is not intra (libavformat checks the VOP type) or an
        H.264 chunk without an IDR slice."""
        if self.codec == "h264":
            data = self._read(pos + 8, size)
            return any(data[i + 3] & 31 == 5 for i in _start_codes(data))
        if self.codec != "mpeg4":
            return True
        head = self._read(pos + 8, min(size, 256))
        at = head.find(_VOP)
        return not (0 <= at < len(head) - 4 and head[at + 4] & 0xC0)


def _start_codes(data: bytes):
    """The offsets of the Annex B start codes (00 00 01) in ``data``."""
    at = data.find(b"\x00\x00\x01")
    while 0 <= at < len(data) - 3:
        yield at
        at = data.find(b"\x00\x00\x01", at + 3)
