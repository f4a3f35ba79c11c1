"""Image files and encoded images without OpenCV.

:func:`read_image` returns a BGR u8 (H, W, 3) array, as ``cv2.imread(path,
cv2.IMREAD_COLOR)`` does, or with ``gray`` the (H, W) plane of
``cv2.IMREAD_GRAYSCALE``; :func:`decode_image` does the same for bytes, as
``cv2.imdecode``.  The decoder is chosen by the data's signature, as
OpenCV's ``findDecoder`` chooses it, whatever the file's extension:

* JPEG (``FF D8 FF``): the port's JPEG codec (``jpeg.py``), libjpeg-turbo's
  arithmetic: the gray plane of a colour JPEG is libjpeg's Y plane, and the
  EXIF orientation is applied;
* PNG (``\\x89PNG``): 8-bit gray, gray + alpha, RGB or RGBA, not interlaced,
  decoded with ``zlib`` and the five scanline filters in numpy (alpha is
  dropped);
* BMP (``BM``): the layouts OpenCV's ``BmpDecoder`` reads: 1-, 4- and 8-bit
  palettes (RLE4 and RLE8 too), 16-bit 555 and 565 (``BI_BITFIELDS``),
  24-bit, 32-bit (alpha dropped), bottom-up or top-down rows, OS/2 headers;
* PNM (``P1``-``P6``): PBM, PGM and PPM, ASCII and binary, maxval up to
  65535, read as OpenCV's ``PxMDecoder`` reads them (binary samples at or
  below 255 as they are, ASCII ones scaled to 255; 16-bit ones shifted right
  by 8).

Any other signature raises ValueError naming the file and, where the
signature tells it, the format (TIFF, WebP, GIF, ...).

For PNG, BMP and PNM, gray is what ``cv2.imread(path, IMREAD_GRAYSCALE)``
returns, in each reader's own arithmetic: a gray file's plane, a colour
PNG's as libpng converts it, ``(9797 R + 19234 G + 3737 B) >> 15``; OpenCV's
``(4899 R + 9617 G + 1868 B + 8192) >> 14`` for a colour PPM and every BMP
but a 32-bit ``BI_BITFIELDS`` one whose header holds its masks (what
``cv2.imwrite`` writes), for which it is the f32 ``0.299 R + 0.587 G +
0.114 B`` truncated (equal to cv2 5.0 over the whole colour cube).

:func:`encode_bmp` and :func:`encode_pnm` write the bytes ``cv2.imencode``
writes for ``.bmp`` and ``.pbm``/``.pgm``/``.ppm``/``.pnm``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

from .jpeg import decode_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples a pixel
# signatures of the formats cv2 reads that the port does not, for messages
_OTHER_SIGNATURES = (
    (b"II*\0", "TIFF"), (b"MM\0*", "TIFF"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
    (b"\x76\x2f\x31\x01", "OpenEXR"), (b"#?RGBE", "Radiance HDR"),
    (b"#?RADIANCE", "Radiance HDR"), (b"\x59\xa6\x6a\x95", "Sun raster"),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"), (b"\xff\x4f\xff\x51", "JPEG 2000"),
    (b"P7", "PAM"), (b"PF", "PFM"), (b"Pf", "PFM"))
_GRAY_R, _GRAY_G, _GRAY_B = 4899, 9617, 1868  # OpenCV's BGR2Gray, 14 bits


def image_format(data: bytes) -> str:
    """The format OpenCV would decode ``data`` as, from its signature:
    "jpeg", "png", "bmp" or "pnm" (the ones the port reads), another
    format's name, or "unknown"."""
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == PNG_SIGNATURE:
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    if len(data) >= 3 and data[:1] == b"P" and 49 <= data[1] <= 54 and chr(data[2]).isspace():
        return "pnm"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[4:12] in (b"ftypavif", b"ftypavis"):
        return "AVIF"
    for sig, name in _OTHER_SIGNATURES:
        if data.startswith(sig):
            return name
    return "unknown"


def decode_image(data: bytes, gray: bool = False, name: str = "<image bytes>",
                 file: bool = False) -> np.ndarray:
    """Encoded image bytes -> BGR u8 (H, W, 3), or with ``gray`` the (H, W)
    plane, as ``cv2.imdecode`` with IMREAD_COLOR / IMREAD_GRAYSCALE (with
    ``file``, as ``cv2.imread`` reads them from a file: a cut JPEG reads as
    libjpeg's file source reads it).  ValueError where they do not decode,
    naming ``name``."""
    data = bytes(data)
    fmt = image_format(data)
    if fmt == "jpeg":
        return decode_jpeg(data, gray=gray, name=name, truncated_ok=file)
    if fmt == "png":
        return decode_png(data, gray=gray, path=name)
    if fmt == "bmp":
        return decode_bmp(data, gray=gray, name=name)
    if fmt == "pnm":
        return decode_pnm(data, gray=gray, name=name)
    what = "an unknown format" if fmt == "unknown" else fmt
    raise ValueError(f"{name}: {what} image; without OpenCV the port reads JPEG, PNG, BMP "
                     "and PNM (PBM, PGM, PPM)")


def read_image(path: str, gray: bool = False) -> np.ndarray:
    """The image at ``path`` as a BGR u8 (H, W, 3) array, or with ``gray``
    its (H, W) gray plane, decoded by its signature (:func:`decode_image`);
    ValueError where the file cannot be read or decoded."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise ValueError(f"{path}: cannot be read ({e.strerror or e})") from e
    return decode_image(data, gray=gray, name=path, file=True)


def _bgr2gray(img: np.ndarray) -> np.ndarray:
    """OpenCV's icvCvt_BGR2Gray_8u_C3C1R: (4899 R + 9617 G + 1868 B + 8192) >> 14."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    return ((_GRAY_R * r + _GRAY_G * g + _GRAY_B * b + 8192) >> 14).astype(np.uint8)


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


# ------------------------------------------------------------------- BMP


class _Bytes:
    """A little-endian reader over ``data`` that raises ValueError past its
    end (OpenCV's stream throws there, and imread gives nothing)."""

    def __init__(self, data: bytes, name: str, pos: int = 0):
        self.data, self.name, self.pos = data, name, pos

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"{self.name}: the data ends before the image does")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]


def decode_bmp(data: bytes, gray: bool = False, name: str = "<bmp bytes>",
               ffmpeg: bool = False) -> np.ndarray:
    """BMP bytes -> BGR u8 (H, W, 3), or with ``gray`` the (H, W) plane, as
    OpenCV's BmpDecoder with IMREAD_COLOR / IMREAD_GRAYSCALE (``ffmpeg``: as
    :func:`_decode_bmp` says)."""
    img, f32_gray = _decode_bmp(data, name, ffmpeg)
    if not gray:
        return img
    if f32_gray:  # OpenCV's f32 conversion, truncated
        f = np.float32
        b, g, r = (img[..., i].astype(f) for i in range(3))
        return (f(0.299) * r + f(0.587) * g + f(0.114) * b).astype(np.uint8)
    return _bgr2gray(img)


def _decode_bmp(data: bytes, path: str, ffmpeg: bool = False) -> Tuple[np.ndarray, bool]:
    """BMP bytes -> (BGR u8 (H, W, 3), whether OpenCV's gray read of it is
    the f32 conversion), as OpenCV's BmpDecoder reads them.  A 32-bit
    BI_BITFIELDS file whose header holds its masks (56 bytes or more) is
    read through them (each an 8-bit field), and its gray read is the f32
    one; any other 32-bit file is BGRA as stored.  ``ffmpeg``: 16-bit
    samples widened as FFmpeg's bmp decoder and swscale widen them (the top
    bits repeated below), not as OpenCV (zeros below)."""
    s = _Bytes(data, path, 10)
    offset = s.i32()
    size = s.i32()
    rle, palette, ok = 0, np.zeros((256, 3), np.uint8), False
    if size >= 36:
        w, h, bpp, rle = s.i32(), s.i32(), s.i32() >> 16, s.i32()
        s.take(12)
        clrused = s.i32()
        s.pos = 14 + size
        ok = w > 0 and h != 0 and 0 <= rle <= 3 and (
            (bpp in (1, 4, 8, 24, 32) and rle == 0) or (bpp in (16, 32) and rle in (0, 3))
            or (bpp == 4 and rle == 2) or (bpp == 8 and rle == 1))
        if ok and bpp <= 8:
            if not 0 <= clrused <= 256:
                raise ValueError(f"{path}: BMP palette of {clrused} colours")
            n = clrused or 1 << bpp
            palette[:n] = np.frombuffer(s.take(4 * n), np.uint8).reshape(n, 4)[:, :3]
        elif ok and bpp == 16 and rle == 3:
            red, green, blue = s.i32(), s.i32(), s.i32()
            if (blue, green, red) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (blue, green, red) != (0x1F, 0x7E0, 0xF800):
                raise ValueError(f"{path}: 16-bit BMP with bit masks R {red:#x} G {green:#x} B "
                                 f"{blue:#x}; 555 and 565 are read")
        elif ok and bpp == 16:
            bpp = 15
    elif size == 12:  # OS/2 BITMAPCOREHEADER
        w, h, bpp = s.u16(), s.u16(), s.i32() >> 16
        ok = w > 0 and h != 0 and bpp in (1, 4, 8, 24, 32)
        if ok and bpp <= 8:
            n = 1 << bpp
            palette[:n] = np.frombuffer(s.take(3 * n), np.uint8).reshape(n, 3)
    masks = None
    if ok and bpp == 32 and rle == 3 and size >= 56:
        masks = struct.unpack_from("<3I", data, 54)  # R, G, B
        if any(m == 0 or m >> ((m & -m).bit_length() - 1) != 0xFF for m in masks):
            raise ValueError(f"{path}: 32-bit BMP with bit masks "
                             f"{', '.join(hex(m) for m in masks)}; 8-bit fields are read")
    if not ok:
        raise ValueError(f"{path}: BMP of header size {size}, {bpp if size >= 12 else '?'} bits, "
                         f"compression {rle}; OpenCV's layouts are read (1-, 4-, 8-bit "
                         "palettes, RLE4, RLE8, 16-bit 555/565, 24- and 32-bit)")
    rows = abs(h)
    if rows * w * 3 >= 1 << 30:
        raise ValueError(f"{path}: BMP of {w}x{rows} is too large")
    s.pos = offset
    if rle in (1, 2):
        img = palette[_rle(s, w, rows, bpp)]
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
        px = np.frombuffer(s.take(pitch * rows), np.uint8).reshape(rows, pitch)
        if bpp <= 8:
            idx = np.unpackbits(px, axis=1).reshape(rows, -1, bpp) if bpp < 8 else px[:, :, None]
            if bpp < 8:
                idx = (idx * (1 << np.arange(bpp - 1, -1, -1, dtype=np.uint8))).sum(-1)
            img = palette[idx[:, :w].reshape(rows, w)]
        elif bpp in (15, 16):
            t = px[:, :2 * w].view("<u2").astype(np.int32)
            if bpp == 15:
                img = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8], -1)
            else:
                img = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8], -1)
            if ffmpeg:
                img |= img >> np.array([5, 5 if bpp == 15 else 6, 5])
            img = img.astype(np.uint8)
        elif masks:
            v = px[:, :4 * w].view("<u4")
            img = np.stack([(v & m) >> ((m & -m).bit_length() - 1) for m in masks[::-1]], -1)
            img = img.astype(np.uint8)
        else:
            img = px[:, : w * bpp // 8].reshape(rows, w, bpp // 8)[:, :, :3]
    if h > 0:  # bottom-up rows
        img = img[::-1]
    return np.ascontiguousarray(img), masks is not None


def _rle(s: _Bytes, w: int, height: int, bpp: int) -> np.ndarray:
    """BMP_RLE8 / BMP_RLE4 data -> (height, w) palette indices, in stream row
    order, as OpenCV's BmpDecoder writes them: what the stream skips (the
    rest of a line, of the image, a delta) takes index 0, an RLE8 run that
    ends a line moves to the next (and an end of line right after it does
    not move again), an RLE4 one does not; in RLE4 the end of the bitmap
    fills only the rest of its line and a delta only its columns."""
    out = np.zeros((height, w), np.uint8)
    x = y = 0

    def fill(count: int, val: int) -> None:  # FillUniColor
        nonlocal x, y
        while True:
            n = min(count, w - x)
            out[y, x:x + n] = val
            x += n
            count -= n
            if x >= w:
                x = 0
                y += 1
                if y >= height:
                    return
            if count <= 0:
                return

    bad = ValueError(f"{s.name}: an RLE run past the end of its line")
    line_end_flag = 0
    while True:
        n, code = s.u8(), s.u8()
        if n:  # encoded mode
            if x + n > w:
                raise bad
            if bpp == 8:
                prev = y
                fill(n, code)
                line_end_flag = y - prev
                if y >= height:
                    break
            else:
                out[y, x:x + n] = np.where(np.arange(n) & 1, code & 15, code >> 4)
                x += n
        elif code > 2:  # absolute mode
            if x + code > w:
                raise bad
            raw = np.frombuffer(s.take(((code + 1) & ~1) if bpp == 8
                                       else ((((code + 1) >> 1) + 1) & ~1)), np.uint8)
            if bpp == 4:
                raw = np.stack([raw >> 4, raw & 15], -1).reshape(-1)
            out[y, x:x + code] = raw[:code]
            x += code
            line_end_flag = 0
        else:  # 0 end of line, 1 end of bitmap, 2 delta
            shift, lines = w - x, height - y
            if bpp == 8 and not (code or not line_end_flag or shift < w):
                line_end_flag = 0
                continue
            if code == 2:
                shift, lines = s.u8(), s.u8()
            if code and bpp == 8:
                shift += lines * w
            if bpp == 8 and y >= height:
                break
            fill(shift, 0)
            line_end_flag = 0
            if y >= height:
                break
    return out


def encode_bmp(img: np.ndarray) -> bytes:
    """A u8 (H, W) gray or (H, W, 3) BGR image -> the bytes of
    ``cv2.imencode(".bmp", img)``: BITMAPINFOHEADER, bottom-up rows padded
    to 4 bytes, 8-bit gray with a gray palette or 24-bit colour."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    h, w = img.shape[:2]
    cn = 1 if img.ndim == 2 else img.shape[2]
    step = (w * cn + 3) & ~3
    head = 14 + 40 + (1024 if cn == 1 else 0)
    out = bytearray(b"BM" + struct.pack("<IiiiiiHHiiiiii", step * h + head, 0, head, 40, w, h, 1,
                                        cn * 8, 0, 0, 0, 0, 0, 0))
    if cn == 1:
        out += (np.arange(256, dtype=np.uint8)[:, None] * np.array([1, 1, 1, 0], np.uint8)).tobytes()
    rows = np.zeros((h, step), np.uint8)
    rows[:, :w * cn] = img.reshape(h, w * cn)
    return bytes(out + rows[::-1].tobytes())


# ------------------------------------------------------------------- PNM


def _pnm_number(s: _Bytes, maxdigits: int = 0) -> int:
    """OpenCV's ReadNumber: whitespace and '#' comments skipped, then the
    digits (at most ``maxdigits``); the byte after the number is consumed."""
    code = s.u8()
    while not 48 <= code <= 57:
        if code == 35:  # '#': to the end of the line
            while code not in (10, 13):
                code = s.u8()
            code = s.u8()
        elif chr(code).isspace():
            while chr(code).isspace():
                code = s.u8()
        else:
            raise ValueError(f"{s.name}: PNM: unexpected byte {code:#x} where a number belongs")
    val = digits = 0
    while True:
        val = val * 10 + code - 48
        if val > 2**31 - 1:
            raise ValueError(f"{s.name}: PNM: number too large")
        digits += 1
        if maxdigits and digits >= maxdigits:
            break
        code = s.u8()
        if not 48 <= code <= 57:
            break
    return val


def decode_pnm(data: bytes, gray: bool = False, name: str = "<pnm bytes>",
               ffmpeg: bool = False) -> np.ndarray:
    """PBM, PGM or PPM bytes (P1-P6) -> BGR u8 (H, W, 3), or with ``gray``
    the (H, W) plane, as OpenCV's PxMDecoder with IMREAD_COLOR /
    IMREAD_GRAYSCALE: PBM 1 is black; binary samples of maxval up to 255 as
    they are, ASCII ones clipped to maxval and scaled by 255 / maxval
    (integer division); 16-bit ones (maxval over 255) clipped (ASCII) and
    shifted right by 8.  ``ffmpeg``: as FFmpeg's pnm decoder: ASCII samples
    scaled with rounding (one over maxval is an error), binary ones below
    maxval 255 scaled by its 7-bit factor; 16-bit files are refused (swscale
    dithers them to 8 bits)."""
    s = _Bytes(data, name)
    if s.u8() != 80 or not 49 <= data[1] <= 54:
        raise ValueError(f"{name}: not a PBM, PGM or PPM file")
    kind = s.u8() - 48
    binary, cn = kind >= 4, (1, 1, 3)[(kind - 1) % 3]
    bits = (kind - 1) % 3 == 0
    w, h = _pnm_number(s), _pnm_number(s)
    maxval = 1 if bits else _pnm_number(s)
    if not (w > 0 and h > 0 and 0 < maxval < 1 << 16):
        raise ValueError(f"{name}: PNM of {w}x{h}, maxval {maxval}")
    if w > 1 << 20 or h > 1 << 20 or w * h > 1 << 30:
        raise ValueError(f"{name}: PNM of {w}x{h} is too large")
    wide = maxval > 255
    if ffmpeg and wide:
        raise ValueError(f"{name}: 16-bit PNM (maxval {maxval})")
    n = w * h * cn
    if bits:
        if binary:
            px = np.unpackbits(np.frombuffer(s.take(((w + 7) // 8) * h), np.uint8)
                               .reshape(h, -1), axis=1)[:, :w]
        else:
            px = np.array([_pnm_number(s, 1) != 0 for _ in range(n)], np.uint8).reshape(h, w)
        px = (1 - px) * 255  # 1 is black
    elif binary:
        raw = s.take(n * (2 if wide else 1))
        px = (np.frombuffer(raw, ">u2") >> 8 if wide else np.frombuffer(raw, np.uint8))
        if ffmpeg and maxval < 255:
            f = (255 * 128 + maxval // 2) // maxval
            px = ((px.astype(np.int64) * f + 64) >> 7) & 0xFF
    else:
        codes = np.array([_pnm_number(s) for _ in range(n)], np.int64)
        if ffmpeg:
            if codes.max() > maxval:
                raise ValueError(f"{name}: PNM sample {codes.max()} over maxval {maxval}")
            px = (255 * codes + maxval // 2) // maxval
        else:
            codes = np.minimum(codes, maxval)
            px = codes >> 8 if wide else codes * 255 // maxval
    px = np.asarray(px, np.uint8).reshape(h, w, cn)
    if cn == 1:
        return px[:, :, 0].copy() if gray else np.repeat(px, 3, axis=2)
    bgr = np.ascontiguousarray(px[:, :, ::-1])
    return _bgr2gray(bgr) if gray else bgr


PNM_KINDS = {"pbm": 1, "pgm": 2, "ppm": 3, "pnm": 0}


def encode_pnm(img: np.ndarray, kind: str = "pnm") -> bytes:
    """A u8 image -> the bytes of ``cv2.imencode("." + kind, img)`` (binary,
    OpenCV's PxMEncoder): ``pnm`` writes PGM for one channel and PPM for
    three; ``pbm`` takes one channel (0 is black, anything else white),
    ``pgm`` one and ``ppm`` three."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    cn = 1 if img.ndim == 2 else img.shape[2]
    mode = PNM_KINDS[kind] or (2 if cn == 1 else 3)
    if (mode in (1, 2) and cn != 1) or (mode == 3 and cn != 3):
        raise ValueError(f"encode_pnm: .{kind} takes a {'gray' if mode < 3 else 'BGR'} image, "
                         f"got shape {img.shape}")
    h, w = img.shape[:2]
    head = b"P%d\n%d %d\n" % (mode + 3, w, h) + (b"" if mode == 1 else b"255\n")
    if mode == 1:
        return head + np.packbits(img == 0, axis=1).tobytes()
    return head + (img[:, :, ::-1] if cn == 3 else img).tobytes()
