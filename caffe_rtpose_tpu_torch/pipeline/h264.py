"""H.264 video decoded on the host without OpenCV: a ctypes binding to
``csrc/h264_video.cpp``.

:class:`H264Decoder` decodes the packets (access units) of one stream in
order, as FFmpeg's ``h264`` decoder decodes them for ``cv2.VideoCapture``:
High, Main and Constrained Baseline profile streams (CAVLC or CABAC; I, P
and B slices with explicit weighted prediction of P, direct prediction and
default, explicit or implicit weighted bi-prediction of B; the 4x4 and 8x8
transforms, Intra8x8, flat, default or transmitted scaling matrices and a
chroma QP offset for each of Cb and Cr; 4:2:0 8-bit progressive frames),
with FFmpeg's output order and delay (from the
demuxer's video delay on) and the pictures it shows from a stream's start
or a flush, and each picture, cropped,
as BGR the way OpenCV receives it from swscale (limited or, with the VUI's
``video_full_range_flag``, full range).  A stream feature the decoder does
not take raises :class:`H264Unsupported` naming it; data that does not
decode raises ValueError.

The library is built with ``g++ -O2 -std=c++17 -shared -fPIC`` at first use
into the port's git-ignored ``_build/`` (``_build.build_library``); a
failed build raises with the compiler's output.  ctypes releases the GIL
while a packet decodes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional, Tuple

import numpy as np

from .. import _build
from .matroska import reduce

SRC = os.path.join(_build.CSRC_DIR, "h264_video.cpp")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
HEADERS = (os.path.join(_build.CSRC_DIR, "ffmpeg_dsp.h"),
           os.path.join(_build.CSRC_DIR, "h264_cabac_tables.h"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class H264Unsupported(ValueError):
    """A stream feature the decoder refuses (the message names it)."""


def load() -> ctypes.CDLL:
    """The decoder library, built at first use (once a process)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on PATH: the H.264 decoder ({SRC}) cannot be built")
        lib = ctypes.CDLL(_build.build_library("h264_video", [SRC], gxx, FLAGS, headers=HEADERS))
        vp, cp, i, l = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_long
        lp = ctypes.POINTER(ctypes.c_long)
        lib.crt_h264_create.restype = vp
        lib.crt_h264_create.argtypes = []
        lib.crt_h264_config.restype = i
        lib.crt_h264_config.argtypes = [vp, cp, l, i, cp, i]
        lib.crt_h264_probe.restype = i
        lib.crt_h264_probe.argtypes = [vp, cp, l, cp, i]
        lib.crt_h264_decode.restype = i
        lib.crt_h264_decode.argtypes = [vp, cp, l, l, lp, cp, i]
        lib.crt_h264_drain.restype = i
        lib.crt_h264_drain.argtypes = [vp, lp]
        lib.crt_h264_bgr.restype = i
        lib.crt_h264_bgr.argtypes = [vp, vp, l]
        lib.crt_h264_set_delay.restype = None
        lib.crt_h264_set_delay.argtypes = [vp, i]
        lib.crt_h264_delay.restype = i
        lib.crt_h264_delay.argtypes = [vp]
        lib.crt_h264_flush.restype = None
        lib.crt_h264_flush.argtypes = [vp]
        lib.crt_h264_destroy.restype = None
        lib.crt_h264_destroy.argtypes = [vp]
        _lib = lib
        return lib


def _check(rc: int, err: ctypes.Array, name: str) -> None:
    if rc == -2:
        raise H264Unsupported(err.value.decode(errors="replace"))
    if rc < 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")


class H264Decoder:
    """One H.264 stream.  ``extra``: the parameter sets carried outside the
    packets (an MP4 ``avcC`` record, or Annex B units from an AVI's
    ``strf``), or empty where the packets carry them; ``nal_length_size``:
    bytes of the length before each NAL unit of a packet (MP4: 1, 2 or 4),
    or 0 where packets use Annex B start codes (AVI); ``delay``: the output
    delay (FFmpeg's ``has_b_frames``) to start with, as the demuxer's
    ``video_delay`` sets it."""

    def __init__(self, extra: bytes = b"", nal_length_size: int = 0, name: str = "<h264>",
                 delay: int = 0):
        self._h = None
        self._lib = load()
        self.name = name
        self._h = self._lib.crt_h264_create()
        self._err = ctypes.create_string_buffer(256)
        self._info = (ctypes.c_long * 3)()
        try:
            _check(self._lib.crt_h264_config(self._h, bytes(extra), len(extra), nal_length_size,
                                             self._err, len(self._err)), self._err, name)
            self._lib.crt_h264_set_delay(self._h, delay)
        except BaseException:
            self.close()
            raise
        self.width = self.height = 0
        self.tag = -1  # the packet tag of the last picture given

    def probe(self, packet: bytes) -> None:
        """Reads the parameter sets of ``packet`` and checks its slice
        headers, without decoding: a refused feature raises here."""
        _check(self._lib.crt_h264_probe(self._h, bytes(packet), len(packet), self._err,
                                        len(self._err)), self._err, self.name)

    def _got(self, rc: int) -> bool:
        _check(rc, self._err, self.name)
        if rc == 1:
            self.width, self.height, self.tag = self._info
        return rc == 1

    def advance(self, packet: bytes, tag: int = 0) -> bool:
        """Decodes ``packet`` (one access unit); True where a picture is
        given (it may be an earlier packet's, ``tag`` tells which)."""
        return self._got(self._lib.crt_h264_decode(self._h, bytes(packet), len(packet), tag,
                                                   self._info, self._err, len(self._err)))

    @property
    def delay(self) -> int:
        """The output delay reached (FFmpeg's ``has_b_frames``)."""
        return self._lib.crt_h264_delay(self._h)

    def drain(self) -> bool:
        """At the end of the stream: True where a held-back picture is given."""
        return self._got(self._lib.crt_h264_drain(self._h, self._info))

    def picture(self) -> np.ndarray:
        """The last picture given as BGR u8 (height, width, 3)."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        if self._lib.crt_h264_bgr(self._h, out.ctypes.data, out.size):
            raise ValueError(f"{self.name}: no picture decoded")
        return out

    def flush(self) -> None:
        """``avcodec_flush_buffers``: the pictures held back and the
        references go; what is given next starts as at a stream's start."""
        self._lib.crt_h264_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.crt_h264_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


_HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)


def sps_frame_rate(nal: bytes) -> Optional[Tuple[int, int]]:
    """The frame rate FFmpeg's ``h264`` decoder gives the stream from an SPS
    NAL unit's VUI timing (``avctx->framerate``: time_scale / (2 x
    num_units_in_tick), reduced); None where the SPS has no timing."""
    rbsp = bytearray()
    zeros = 0
    for b in nal[1:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        zeros = zeros + 1 if b == 0 else 0
        rbsp.append(b)
    bits, left = int.from_bytes(rbsp, "big"), 8 * len(rbsp)

    def u(n: int) -> int:
        nonlocal left
        left -= n
        if left < 0:
            raise ValueError("an SPS cut short")
        return (bits >> left) & ((1 << n) - 1)

    def ue() -> int:
        n = 0
        while not u(1):
            n += 1
        return (1 << n) - 1 + u(n)

    def se() -> int:
        v = ue()
        return (v + 1) // 2 if v & 1 else -(v // 2)

    try:
        profile = u(8)
        u(16)
        ue()
        chroma = 1
        if profile in _HIGH_PROFILES:
            chroma = ue()
            if chroma == 3:
                u(1)
            ue(), ue(), u(1)
            if u(1):  # seq_scaling_matrix_present_flag
                for i in range(8 if chroma != 3 else 12):
                    if u(1):
                        last = nxt = 8
                        for _ in range(16 if i < 6 else 64):
                            if nxt:
                                nxt = (last + se() + 256) % 256
                            last = nxt or last
        ue()
        poc_type = ue()
        if poc_type == 0:
            ue()
        elif poc_type == 1:
            u(1), se(), se()
            for _ in range(ue()):
                se()
        ue(), u(1), ue(), ue()
        if not u(1):  # frame_mbs_only_flag
            u(1)
        u(1)
        if u(1):  # frame_cropping_flag
            ue(), ue(), ue(), ue()
        if not u(1):  # vui_parameters_present_flag
            return None
        if u(1) and u(8) == 255:  # aspect_ratio_idc: Extended_SAR
            u(32)
        if u(1):
            u(1)
        if u(1):  # video_signal_type_present_flag
            u(4)
            if u(1):  # colour_description_present_flag
                u(24)
        if u(1):
            ue(), ue()
        if not u(1):  # timing_info_present_flag
            return None
        ticks, scale = u(32), u(32)
    except ValueError:
        return None
    if not ticks or not scale:
        return None
    den, num = reduce(2 * ticks, scale, 1 << 30)
    return num, den
