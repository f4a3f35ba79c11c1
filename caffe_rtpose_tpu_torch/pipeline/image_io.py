"""Image files for the pipeline's ``--image_dir`` source, without OpenCV.

:func:`read_image` returns a BGR u8 (H, W, 3) array, as ``cv2.imread(path,
cv2.IMREAD_COLOR)`` does, or with ``gray`` the (H, W) plane of
``cv2.IMREAD_GRAYSCALE``:

* ``.jpg``/``.jpeg``: the port's JPEG codec (``jpeg.py``), libjpeg-turbo's
  arithmetic: the gray plane of a colour JPEG is libjpeg's Y plane, and the
  EXIF orientation is applied;
* ``.png``: 8-bit gray, gray + alpha, RGB or RGBA, not interlaced, decoded
  with ``zlib`` and the five scanline filters in numpy (alpha is dropped);
* ``.bmp``: uncompressed 24- or 32-bit, or 8-bit with a palette, bottom-up
  or top-down rows.

For PNG and BMP, gray is what ``cv2.imread(path, IMREAD_GRAYSCALE)``
returns, in each reader's own arithmetic: a gray PNG's plane, else libpng's
``(9797 R + 19234 G + 3737 B) >> 15``; for an 8- or 24-bit BMP OpenCV's
``(4899 R + 9617 G + 1868 B + 8192) >> 14``, for a 32-bit one the f32
``0.299 R + 0.587 G + 0.114 B`` truncated (equal to cv2 5.0 over the whole
colour cube).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

from .jpeg import JPEG_EXTENSIONS, read_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples a pixel


def read_image(path: str, gray: bool = False) -> np.ndarray:
    """The image at ``path`` as a BGR u8 (H, W, 3) array, or with ``gray``
    its (H, W) gray plane."""
    ext = os.path.splitext(path)[1].lower()
    if ext in JPEG_EXTENSIONS:
        return read_jpeg(path, gray=gray)
    if ext == ".png":
        with open(path, "rb") as f:
            return decode_png(f.read(), gray=gray, path=path)
    if ext == ".bmp":
        with open(path, "rb") as f:
            img, bpp = _decode_bmp(f.read(), path)
        if not gray:
            return img
        b, g, r = (img[..., i].astype(np.int32) for i in range(3))
        if bpp == 32:  # OpenCV's f32 conversion, truncated
            f = np.float32
            y = f(0.299) * r.astype(f) + f(0.587) * g.astype(f) + f(0.114) * b.astype(f)
            return y.astype(np.uint8)
        return ((4899 * r + 9617 * g + 1868 * b + 8192) >> 14).astype(np.uint8)
    raise ValueError(f"{path}: unsupported image type {ext!r}")


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """PNG scanlines (h, 1 + stride), each led by its filter type -> the
    (h, stride) bytes."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = int(raw[y, 0]), raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum along each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: each byte needs its decoded left neighbour
            cur, up = line.tolist(), prior.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"{path}: PNG filter type {ftype} is invalid")
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes, gray: bool = False, path: str = "<png bytes>") -> np.ndarray:
    """PNG bytes -> BGR u8 (H, W, 3), or with ``gray`` the (H, W) gray plane
    (``cv2.imdecode`` with IMREAD_COLOR / IMREAD_GRAYSCALE): a gray PNG's
    own plane, a colour one's converted as libpng converts it,
    ``(9797 R + 19234 G + 3737 B) >> 15``."""
    img = _decode_png(data, path, keep_gray=gray)
    if gray and img.ndim != 2:
        b, g, r = (img[..., i].astype(np.int32) for i in range(3))
        img = ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)
    return img


def encode_png(img: np.ndarray) -> bytes:
    """A u8 (H, W) gray or (H, W, 3) BGR image -> PNG bytes (filter 0 rows,
    zlib)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = img if color == 0 else img[:, :, ::-1].reshape(h, w * 3)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _decode_png(data: bytes, path: str, keep_gray: bool = False) -> np.ndarray:
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"{path}: PNG of bit depth {depth}, color type {color}, interlace "
                         f"{interlace}; 8-bit non-interlaced gray, RGB or RGBA is supported")
    cn = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + w * cn):
        raise ValueError(f"{path}: truncated PNG image data")
    px = _unfilter(raw[: h * (1 + w * cn)].reshape(h, 1 + w * cn), h, w * cn, cn,
                   path).reshape(h, w, cn)
    if cn <= 2:  # gray (+ alpha)
        return px[:, :, 0].copy() if keep_gray else np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, 2::-1])  # RGB(A) -> BGR


def _decode_bmp(data: bytes, path: str) -> Tuple[np.ndarray, int]:
    """BMP bytes -> (BGR u8 (H, W, 3), bits a pixel)."""
    if data[:2] != b"BM" or len(data) < 54:
        raise ValueError(f"{path}: not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    hsize, w, h, _, bpp, comp = struct.unpack("<IiiHHI", data[14:34])
    if bpp not in (8, 24, 32) or comp not in (0, 3) or (comp == 3 and bpp != 32) or w <= 0:
        raise ValueError(f"{path}: BMP of {bpp} bits, compression {comp}; uncompressed 8-, "
                         "24- or 32-bit is supported")
    rows = abs(h)
    stride = (w * bpp // 8 + 3) & ~3
    px = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(rows, stride)
    if bpp == 8:
        n_colors = struct.unpack("<I", data[46:50])[0] or 256
        pal = np.frombuffer(data, np.uint8, n_colors * 4, 14 + hsize).reshape(n_colors, 4)
        img = pal[px[:, :w], :3]
    else:
        img = px[:, : w * bpp // 8].reshape(rows, w, bpp // 8)[:, :, :3]
    if h > 0:  # bottom-up rows
        img = img[::-1]
    return np.ascontiguousarray(img), bpp
