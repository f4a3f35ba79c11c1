"""MPEG-4 Part 2 video decoded on the host without OpenCV: a ctypes binding
to ``csrc/mpeg4_video.cpp``.

:class:`Mpeg4Decoder` decodes the packets of one stream in order, as
FFmpeg's ``mpeg4`` decoder decodes them for ``cv2.VideoCapture``: I- and
P-VOPs of the Simple Profile streams FFmpeg's encoder writes under OpenCV's
writer (fourcc ``mp4v``, ``XVID``, ``DIVX``), with FFmpeg's IDCT, and each
picture as BGR the way OpenCV receives it from swscale.  A stream feature
the decoder does not take raises :class:`Mpeg4Unsupported` naming it; data
that does not decode raises ValueError.

The library is built with ``g++ -O2 -std=c++17 -shared -fPIC`` at first use
into the port's git-ignored ``_build/`` (``_build.build_library``); a
failed build raises with the compiler's output.  ctypes releases the GIL
while a packet decodes.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import threading
from typing import Optional, Tuple

import numpy as np

from .. import _build

SRC = os.path.join(_build.CSRC_DIR, "mpeg4_video.cpp")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
HEADERS = (os.path.join(_build.CSRC_DIR, "ffmpeg_dsp.h"),)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class Mpeg4Unsupported(ValueError):
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
            raise RuntimeError(f"g++ not found on PATH: the MPEG-4 decoder ({SRC}) cannot be "
                               "built")
        lib = ctypes.CDLL(_build.build_library("mpeg4_video", [SRC], gxx, FLAGS,
                                                 headers=HEADERS))
        vp, cp, i, l = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_long
        lib.crt_mpeg4_create.restype = vp
        lib.crt_mpeg4_create.argtypes = []
        lib.crt_mpeg4_config.restype = i
        lib.crt_mpeg4_config.argtypes = [vp, cp, l, cp, cp, i]
        lib.crt_mpeg4_decode.restype = i
        lib.crt_mpeg4_decode.argtypes = [vp, cp, l, ctypes.POINTER(ctypes.c_int), cp, i]
        lib.crt_mpeg4_bgr.restype = i
        lib.crt_mpeg4_bgr.argtypes = [vp, vp, l]
        lib.crt_mpeg4_flush.restype = None
        lib.crt_mpeg4_flush.argtypes = [vp]
        lib.crt_mpeg4_destroy.restype = None
        lib.crt_mpeg4_destroy.argtypes = [vp]
        _lib = lib
        return lib


def _check(rc: int, err: ctypes.Array, name: str) -> None:
    if rc == -2:
        raise Mpeg4Unsupported(err.value.decode(errors="replace"))
    if rc < 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")


class Mpeg4Decoder:
    """One MPEG-4 Part 2 stream.  ``extra``: the headers carried outside the
    packets (an MP4 ``esds`` DecoderSpecificInfo), or empty where the first
    packet carries them (AVI); ``tag``: the container's codec tag."""

    def __init__(self, extra: bytes = b"", tag: str = "", name: str = "<mpeg4>"):
        self._lib = load()
        self.name = name
        self._h = self._lib.crt_mpeg4_create()
        self._err = ctypes.create_string_buffer(256)
        self._info = (ctypes.c_int * 3)()
        try:
            _check(self._lib.crt_mpeg4_config(self._h, bytes(extra), len(extra),
                                              tag.encode("latin-1"), self._err, len(self._err)),
                   self._err, name)
        except BaseException:
            self.close()
            raise
        self.width = self.height = 0
        self.vop_type = -1  # of the last packet: 0 I, 1 P, -1 none

    def advance(self, packet: bytes) -> bool:
        """Decodes ``packet``; True where it gave a picture."""
        rc = self._lib.crt_mpeg4_decode(self._h, bytes(packet), len(packet), self._info,
                                        self._err, len(self._err))
        _check(rc, self._err, self.name)
        self.width, self.height, self.vop_type = self._info
        return rc == 1

    def picture(self) -> np.ndarray:
        """The last picture as BGR u8 (height, width, 3)."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        if self._lib.crt_mpeg4_bgr(self._h, out.ctypes.data, out.size):
            raise ValueError(f"{self.name}: no picture decoded")
        return out

    def decode(self, packet: bytes) -> Optional[np.ndarray]:
        """The picture ``packet`` gives, or None."""
        return self.picture() if self.advance(packet) else None

    def flush(self) -> None:
        """Forgets the reference picture (``avcodec_flush_buffers``): a
        P-VOP before the next I-VOP predicts from mid-grey, as in FFmpeg."""
        self._lib.crt_mpeg4_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.crt_mpeg4_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def vol_frame_rate(headers: bytes) -> Optional[Tuple[int, int]]:
    """The frame rate FFmpeg's ``mpeg4`` decoder gives the stream from the
    first VOL header in ``headers`` (``avctx->framerate``):
    (vop_time_increment_resolution, fixed_vop_time_increment, or 1 where
    the VOP rate is not fixed); None where there is no VOL header."""
    m = re.search(rb"\x00\x00\x01[\x20-\x2f]", headers)
    if m is None:
        return None
    head = headers[m.end():m.end() + 32]
    bits, left = int.from_bytes(head, "big"), 8 * len(head)

    def u(n: int) -> int:
        nonlocal left
        left -= n
        if left < 0:
            raise ValueError("a VOL header cut short")
        return (bits >> left) & ((1 << n) - 1)

    try:
        u(9)  # random_accessible_vol, video_object_type_indication
        version = 1
        if u(1):  # is_object_layer_identifier
            version = u(4)
            u(3)
        if u(4) == 15:  # aspect_ratio_info: extended PAR
            u(16)
        if u(1):  # vol_control_parameters
            u(3)
            if u(1):  # vbv_parameters
                u(79)
        shape = u(2)
        if shape == 3 and version != 1:
            u(4)
        u(1)
        resolution = u(16)
        u(1)
        if not resolution:
            return None
        return resolution, u(max(1, (resolution - 1).bit_length())) if u(1) else 1
    except ValueError:
        return None
