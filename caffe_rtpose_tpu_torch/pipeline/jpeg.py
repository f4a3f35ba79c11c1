"""JPEG read and written on the host without OpenCV: a ctypes binding to
``csrc/jpeg_codec.cpp``.

The codec repeats libjpeg-turbo's integer arithmetic as OpenCV calls it, so
:func:`decode_jpeg` returns what ``cv2.imdecode`` returns (``IMREAD_COLOR``
BGR, or with ``gray`` the ``IMREAD_GRAYSCALE`` plane, which for a colour
file is libjpeg's Y plane and not a conversion of the BGR image), with the
EXIF orientation applied; and :func:`encode_jpeg` returns the bytes of
``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])``: baseline,
4:2:0 colour or 1-component gray, standard Huffman tables.
:class:`MjpegDecoder` decodes the frames of a Motion-JPEG stream as
``cv2.VideoCapture`` (FFMPEG) gives them instead: FFmpeg's ``mjpeg``
arithmetic and swscale's conversion.

The library is built with ``g++ -O2 -std=c++17 -shared -fPIC`` at first use
into the port's git-ignored ``_build/`` (``_build.build_library``).  There
is no fallback: without g++, or when the build fails, the error names the
compiler and carries its output.  The calls go through ctypes, which
releases the GIL while the codec runs.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional, Tuple

import numpy as np

from .. import _build

SRC = os.path.join(_build.CSRC_DIR, "jpeg_codec.cpp")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
HEADERS = (os.path.join(_build.CSRC_DIR, "ffmpeg_dsp.h"),)
JPEG_EXTENSIONS = (".jpg", ".jpeg")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The codec library, built at first use (once a process)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on PATH: the JPEG codec ({SRC}) cannot be built")
        lib = ctypes.CDLL(_build.build_library("jpeg_codec", [SRC], gxx, FLAGS,
                                                 headers=HEADERS))
        vp, cp, i, l = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_long
        lib.crt_jpeg_header.restype = i
        lib.crt_jpeg_header.argtypes = [cp, l, i, ctypes.POINTER(ctypes.c_int), cp, i]
        lib.crt_jpeg_decode.restype = i
        lib.crt_jpeg_decode.argtypes = [cp, l, i, i, vp, l, cp, i]
        lib.crt_jpeg_encode.restype = i
        lib.crt_jpeg_encode.argtypes = [vp, i, i, i, i, ctypes.POINTER(ctypes.c_void_p),
                                        ctypes.POINTER(ctypes.c_long), cp, i]
        lib.crt_jpeg_free.restype = None
        lib.crt_jpeg_free.argtypes = [vp]
        lib.crt_mjpeg_create.restype = vp
        lib.crt_mjpeg_create.argtypes = []
        lib.crt_mjpeg_destroy.restype = None
        lib.crt_mjpeg_destroy.argtypes = [vp]
        lib.crt_mjpeg_decode.restype = i
        lib.crt_mjpeg_decode.argtypes = [vp, cp, l, vp, l, ctypes.POINTER(ctypes.c_int), cp, i]
        _lib = lib
        return lib


def _check(rc: int, err: ctypes.Array, what: str) -> None:
    if rc != 0:
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation (EXIF values 1-8; others leave the
    image as stored)."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    if flip:
        img = np.flip(img, flip)
    return np.ascontiguousarray(img)


def jpeg_header(data: bytes, name: str = "<jpeg bytes>",
                truncated_ok: bool = False) -> Tuple[int, int, int]:
    """(width, height, EXIF orientation) from a JPEG's markers up to its
    first scan, without decoding it; ValueError where they do not parse."""
    lib = load()
    err = ctypes.create_string_buffer(256)
    info = (ctypes.c_int * 3)()
    _check(lib.crt_jpeg_header(data, len(data), int(truncated_ok), info, err, len(err)), err,
           name)
    return tuple(info)


def decode_jpeg(data: bytes, gray: bool = False, name: str = "<jpeg bytes>",
                truncated_ok: bool = False) -> np.ndarray:
    """JPEG bytes -> BGR u8 (H, W, 3), or with ``gray`` the (H, W) plane, as
    ``cv2.imdecode`` with IMREAD_COLOR / IMREAD_GRAYSCALE.  Truncated data
    raises, as imdecode returns None for it; ``truncated_ok`` reads it as
    ``cv2.imread`` reads a truncated file (the missing blocks keep what the
    scans before gave them, zero in a baseline file, and a progressive file
    is smoothed as libjpeg smooths it)."""
    data = bytes(data)
    w, h, orientation = jpeg_header(data, name, truncated_ok)
    lib = load()
    err = ctypes.create_string_buffer(256)
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    _check(lib.crt_jpeg_decode(data, len(data), int(gray), int(truncated_ok),
                               out.ctypes.data, out.size, err, len(err)), err, name)
    return _orient(out, orientation)


def read_jpeg(path: str, gray: bool = False) -> np.ndarray:
    """The JPEG file at ``path``, as ``cv2.imread`` reads it."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), gray=gray, name=path, truncated_ok=True)


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """A u8 (H, W) gray or (H, W, 3) BGR image -> the bytes of
    ``cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])``."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) u8, got shape {img.shape}")
    lib = load()
    h, w = img.shape[:2]
    ptr, n = ctypes.c_void_p(), ctypes.c_long()
    err = ctypes.create_string_buffer(256)
    quality = min(max(int(quality), 0), 100)
    _check(lib.crt_jpeg_encode(img.ctypes.data, w, h, 1 if img.ndim == 2 else 3, quality,
                               ctypes.byref(ptr), ctypes.byref(n), err, len(err)), err,
           "JPEG encode")
    try:
        return ctypes.string_at(ptr.value, n.value)
    finally:
        lib.crt_jpeg_free(ptr)


class MjpegDecoder:
    """The frames of one Motion-JPEG stream as ``cv2.VideoCapture`` (FFMPEG)
    gives them: FFmpeg's ``mjpeg`` decoder (the DC predictor dequantized and
    started at the level shift, DC clipped to int16, FFmpeg's simple IDCT
    into planes at the stream's own sampling) and swscale's unscaled
    full-range YUV -> BGR24 (one chroma sample for each 2x2 or 2x1 block).

    That arithmetic is taken for YCbCr 4:2:0 and 4:2:2 frames of even height
    (``csrc/jpeg_codec.cpp`` ``ffmpeg_layout``), the layouts swscale's
    unscaled path converts; other layouts (gray, 4:4:4, odd heights, ...)
    go through swscale's scaler in FFmpeg and decode here with libjpeg's
    arithmetic, as ``cv2.imread`` (ROADMAP C9's remainder).
    :attr:`arithmetic` says which the last frame took.  The planes outlive a
    frame: where a frame's data ends inside its scan, the blocks it did not
    reach keep the frame before's pixels, as in FFmpeg's frame buffer.  The
    EXIF orientation is not applied (FFMPEG does not)."""

    def __init__(self, name: str = "<mjpeg>"):
        self._lib = load()
        self.name = name
        self._h = self._lib.crt_mjpeg_create()
        self._err = ctypes.create_string_buffer(256)
        self._arith = ctypes.c_int(0)
        self.arithmetic = ""

    def decode(self, data: bytes) -> np.ndarray:
        """One frame's JPEG bytes -> BGR u8 (H, W, 3); ValueError where they
        do not decode to a picture."""
        data = bytes(data)
        w, h, _ = jpeg_header(data, self.name)  # cut before its scan: no picture
        out = np.empty((h, w, 3), np.uint8)
        _check(self._lib.crt_mjpeg_decode(self._h, data, len(data), out.ctypes.data, out.size,
                                          ctypes.byref(self._arith), self._err,
                                          len(self._err)), self._err, self.name)
        self.arithmetic = "ffmpeg" if self._arith.value else "libjpeg"
        return out

    def close(self) -> None:
        if self._h:
            self._lib.crt_mjpeg_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
