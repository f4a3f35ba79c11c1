"""``cv2.putText`` of OpenCV 5.0 on u8 images, without OpenCV.

OpenCV 5 no longer strokes Hershey fonts: ``putText(img, text, org,
FONT_HERSHEY_SIMPLEX, scale, color, thickness)`` draws anti-aliased glyphs of
the TrueType font it embeds, "Rubik for OpenCV Light" (a variable font with
one ``wght`` axis, 300-900), whatever the line type.  The port carries that
font (``caffe_rtpose_tpu_torch/fonts/``, SIL Open Font License 1.1) and
draws it as OpenCV does, value for value:

* the Hershey face, scale and thickness become a pixel size and a weight:
  ``size = cvRound(scale * 100 / 3.7)``, weight 400 for a thickness up to 1
  and 600 above (``hersheyToTruetype``);
* the font is scaled by ``size / ascent``, and each glyph's outline is the
  instance OpenCV's TrueType reader builds at that weight
  (:meth:`Font.glyph_opencv`: 16.16 tuple scalars, integer deltas);
* the outline is flattened and rasterised by ``csrc/glyph_raster.cpp``
  (stb_truetype's rasteriser, with OpenCV's padded glyph box);
* the pen starts at ``org`` on the baseline and moves by each glyph's advance
  in whole pixels (``cvRound(advance * scale * 64) >> 6``); there is no
  kerning, and the text is clipped at the image's edges, not wrapped;
* each glyph is blended on its own, in order: ``dst + round((color - dst) *
  a / 255)`` for coverage ``a``.

Glyph bitmaps are cached by (glyph, size, weight), which is all a raster
depends on.  ``tests/test_torch_text.py`` holds :func:`put_text_u8` against
``cv2.putText`` on the cases that ``tests/text_cases.py`` pins.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .. import _build
from .truetype import Font, Glyph, load_font

FONT_HERSHEY_SIMPLEX = 0

SRC = os.path.join(_build.CSRC_DIR, "glyph_raster.cpp")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
_F32 = np.float32

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The rasteriser library, built at first use (once a process)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on PATH: the glyph rasteriser ({SRC}) cannot "
                               "be built")
        lib = ctypes.CDLL(_build.build_library("glyph_raster", [SRC], gxx, FLAGS))
        i, f, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        lib.crt_glyph_raster.restype = i
        lib.crt_glyph_raster.argtypes = [vp, i, f, f, i, i, i, i, vp]
        _lib = lib
        return lib


def hershey_to_truetype(font_face: int, scale: float, thickness: int) -> Tuple[int, int]:
    """OpenCV 5's (pixel size, weight) for a Hershey face, scale and
    thickness; only ``FONT_HERSHEY_SIMPLEX`` is drawn by the port."""
    if font_face != FONT_HERSHEY_SIMPLEX:
        raise ValueError(f"font face {font_face}: only FONT_HERSHEY_SIMPLEX "
                         f"({FONT_HERSHEY_SIMPLEX}) is drawn")
    if not scale > 0:
        raise ValueError(f"font scale {scale}: a positive scale is drawn")
    return int(np.rint(float(scale) * 100.0 / 3.7)), (600 if thickness > 1 else 400)


def glyph_vertices(g: Glyph) -> np.ndarray:
    """stb_truetype's vertices of an outline with integer points, as an
    (n, 5) int32 array of (type, x, y, cx, cy): 1 moves, 2 draws a line, 3
    a quadratic curve; two off-curve points in a row imply the on-curve
    point between them, rounded down (``>> 1``)."""
    pts = [(int(x), int(y)) for x, y in g.points]
    on = [bool(v) for v in g.on_curve]
    out: List[Tuple[int, int, int, int, int]] = []
    n = len(pts)
    contour = 0
    next_move = 0
    was_off = start_off = False
    sx = sy = cx = cy = scx = scy = 0

    def close():
        if start_off:
            if was_off:
                out.append((3, (cx + scx) >> 1, (cy + scy) >> 1, cx, cy))
            out.append((3, sx, sy, scx, scy))
        elif was_off:
            out.append((3, sx, sy, cx, cy))
        else:
            out.append((2, sx, sy, 0, 0))

    i = 0
    while i < n:
        x, y = pts[i]
        if i == next_move:
            if i:
                close()
            start_off = not on[i]
            if start_off:
                scx, scy = x, y
                if not on[i + 1]:
                    sx, sy = (x + pts[i + 1][0]) >> 1, (y + pts[i + 1][1]) >> 1
                else:
                    sx, sy = pts[i + 1]
                    i += 1
            else:
                sx, sy = x, y
            out.append((1, sx, sy, 0, 0))
            was_off = False
            next_move = g.ends[contour] + 1
            contour += 1
        elif not on[i]:
            if was_off:
                out.append((3, (cx + x) >> 1, (cy + y) >> 1, cx, cy))
            cx, cy = x, y
            was_off = True
        else:
            out.append((3, x, y, cx, cy) if was_off else (2, x, y, 0, 0))
            was_off = False
        i += 1
    if n:
        close()
    return np.asarray(out, np.int32).reshape(-1, 5)


class GlyphBitmap(NamedTuple):
    """A glyph drawn at one size and weight: its coverage ``mask``
    cropped to its ink, the offset of the mask's top-left pixel from the
    pen on the baseline, and the advance in whole pixels."""

    mask: np.ndarray
    dx: int
    dy: int
    advance: int


class TextRenderer:
    """OpenCV 5's TrueType ``putText`` for one font, with a glyph cache."""

    def __init__(self, font: Font):
        self.font = font
        self._cache: Dict[Tuple[int, int, int], GlyphBitmap] = {}
        self._norms: Dict[int, Tuple[int, ...]] = {}
        self._missing = font.glyph_index(ord("?"))

    def scale(self, size: int) -> np.float32:
        """Font units to pixels at pixel size ``size``."""
        return _F32(size) / _F32(self.font.ascent)

    def glyph(self, codepoint: int, size: int, weight: int) -> GlyphBitmap:
        """The bitmap of ``codepoint`` (a question mark where the font has
        no glyph for it) at ``size`` and ``weight``."""
        gid = self.font.glyph_index(codepoint) or self._missing
        key = (gid, int(size), int(weight))
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = self._draw(gid, int(size), int(weight))
        return hit

    def _draw(self, gid: int, size: int, weight: int) -> GlyphBitmap:
        norm = self._norms.get(weight)
        if norm is None:
            norm = self._norms[weight] = self.font.normalize({"wght": weight})
        g = self.font.glyph_opencv(gid, norm)
        s = self.scale(size)
        advance = int(np.rint(float(_F32(g.advance) * s) * 64)) >> 6
        empty = GlyphBitmap(np.zeros((0, 0), np.uint8), 0, 0, advance)
        if len(g.points) == 0:
            return empty
        # the glyph box as stbtt_GetGlyphBitmapBox computes it in f32, from
        # the glyf header's box (OpenCV sizes the bitmap by it, not by the
        # varied points), grown by OpenCV's pad: a tenth of the larger side,
        # rounded up, plus 10 pixels
        x0, y0, x1, y1 = (_F32(v) for v in g.bbox)
        ix0, iy0 = int(np.floor(x0 * s)), int(np.floor(-y1 * s))
        ix1, iy1 = int(np.ceil(x1 * s)), int(np.ceil(-y0 * s))
        pad = max((iy1 - iy0 + 9) // 10, (ix1 - ix0 + 9) // 10) + 10
        w, h = ix1 - ix0 + 2 * pad, iy1 - iy0 + 2 * pad
        verts = np.ascontiguousarray(glyph_vertices(g))
        out = np.zeros((h, w), np.uint8)
        rc = load().crt_glyph_raster(verts.ctypes.data, len(verts), s, _F32(pad), ix0, iy0, w,
                                     h, out.ctypes.data)
        if rc != 0:
            raise ValueError(f"glyph {gid} at size {size}: the rasteriser refused its box {w}x{h}")
        rows, cols = np.nonzero(out.any(1))[0], np.nonzero(out.any(0))[0]
        if len(rows) == 0:
            return empty
        r0, r1, c0, c1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
        return GlyphBitmap(np.ascontiguousarray(out[r0:r1, c0:c1]), int(ix0 - pad + c0),
                           int(iy0 - pad + r0), advance)

    def put_text(self, img: np.ndarray, text: str, org: Sequence[int], size: int, weight: int,
                 color: Sequence[int]) -> np.ndarray:
        """Draw ``text`` on u8 ``img`` (H, W) or (H, W, C) in place, the
        pen starting at ``org`` = (x, y) on the baseline."""
        h, w = img.shape[:2]
        col = np.asarray([int(np.clip(round(float(c)), 0, 255)) for c in color], np.int32)
        cn = 1 if img.ndim == 2 else img.shape[2]
        col = col[:cn] if len(col) >= cn else np.pad(col, (0, cn - len(col)))
        x, y = int(org[0]), int(org[1])
        for ch in text:
            gb = self.glyph(ord(ch), size, weight)
            gh, gw = gb.mask.shape
            if gh:
                top, left = y + gb.dy, x + gb.dx
                r0, c0 = max(top, 0), max(left, 0)
                r1, c1 = min(top + gh, h), min(left + gw, w)
                if r0 < r1 and c0 < c1:
                    a = gb.mask[r0 - top:r1 - top, c0 - left:c1 - left].astype(np.int32)
                    dst = img[r0:r1, c0:c1]
                    if cn == 1 and img.ndim == 2:
                        d = dst.astype(np.int32)
                        dst[...] = d + ((col[0] - d) * a + 127) // 255
                    else:
                        d = dst.astype(np.int32)
                        dst[...] = d + ((col - d) * a[..., None] + 127) // 255
            x += gb.advance
        return img


_renderer: Optional[TextRenderer] = None


def renderer() -> TextRenderer:
    """The renderer of the port's font (parsed once a process)."""
    global _renderer
    if _renderer is None:
        with _lock:
            if _renderer is None:
                _renderer = TextRenderer(load_font())
    return _renderer


def put_text_u8(img: np.ndarray, text: str, org: Sequence[int], font_face: int, scale: float,
                color: Sequence[int], thickness: int = 1) -> np.ndarray:
    """``cv2.putText(img, text, org, font_face, scale, color, thickness)``
    of OpenCV 5.0 on a u8 (H, W) or (H, W, C) ``img``, in place; returns
    ``img``.  ``font_face`` must be ``FONT_HERSHEY_SIMPLEX``; the line type
    does not change OpenCV 5's raster and is not taken."""
    if not isinstance(img, np.ndarray) or img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError("put_text_u8 draws on a u8 (H, W) or (H, W, C) numpy array")
    size, weight = hershey_to_truetype(font_face, scale, thickness)
    return renderer().put_text(img, text, org, size, weight, color)
