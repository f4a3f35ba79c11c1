"""OpenCV's u8 image operations in numpy, bit for bit with OpenCV 5.0.

The JAX package calls these through ``cv2``; the machine with the card has no
OpenCV, so the port computes them itself, in the integer and f32 arithmetic
OpenCV uses, and ``tests/test_torch_imgproc.py`` holds each against ``cv2``:

* :func:`bgr2lab_u8`, :func:`lab2bgr_u8`: ``cv2.cvtColor`` with
  ``COLOR_BGR2Lab`` / ``COLOR_Lab2BGR`` on u8 (``RGB2Lab_b`` and
  ``Lab2RGBinteger`` of ``color_lab.cpp``: 12-bit colour coefficients, the
  sRGB gamma and Lab cube-root tables, the L -> y and a, b -> x, z tables,
  the inverse gamma table).  The tables are built at first use as OpenCV
  builds them in its ``softfloat`` arithmetic; equal to ``cv2`` over the
  whole 2^24 cube each way.
* :func:`clahe_u8`: ``cv2.createCLAHE(clip, (tiles, tiles)).apply``
  (``CLAHE_CalcLut_Body`` and ``CLAHE_Interpolation_Body``).
* :func:`line_u8`: ``cv2.line`` with ``LINE_8`` and no sub-pixel shift
  (``drawing.cpp``: the 8-connected line iterator for thickness 1; for a
  thicker line the segment clipped to the image grown by the thickness, the
  offset quadrilateral filled in 16.16 fixed point with its edges drawn,
  and a filled circle at each end).
* :func:`resize_linear_u8`: ``cv2.resize`` with ``INTER_LINEAR`` on u8
  (11-bit coefficients, an integer horizontal pass, the vertical pass
  rounded as ``VResizeLinearVec_32s8u`` rounds; an exact halving of both
  axes is ``INTER_AREA``'s 2x2 average, as ``cv::resize`` does).
  :func:`linear_axis` and :func:`linear_passes` are the fixed point that
  ``pose/preprocess.resize_area`` uses where an axis grows.

Every function takes and returns numpy arrays and refuses, with
``ValueError``, a dtype or channel count the port never passes.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache
from types import SimpleNamespace
from typing import Sequence, Tuple, Union

import numpy as np

_F32 = np.float32


def _check_u8(img: np.ndarray, what: str, channels: Tuple[int, ...]) -> np.ndarray:
    """``img`` as a u8 array of one of ``channels`` (0: a 2-D image), else
    ValueError naming the dtype or shape."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"{what} takes a u8 image, not {img.dtype}")
    cn = 0 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else -1)
    if cn not in channels or min(img.shape[:2], default=0) < 1:
        shapes = " or ".join("(H, W)" if c == 0 else f"(H, W, {c})" for c in channels)
        raise ValueError(f"{what} takes an image of shape {shapes}, not {img.shape}")
    return img


# ------------------------------------------------------------------ Lab

LAB_SHIFT, GAMMA_SHIFT = 12, 3  # lab_shift (= xyz_shift), gamma_shift
LAB_SHIFT2 = LAB_SHIFT + GAMMA_SHIFT
CBRT_TAB = 256 * 3 // 2 * (1 << GAMMA_SHIFT)  # LAB_CBRT_TAB_SIZE_B
INV_GAMMA_SHIFT = 12
BASE_SHIFT = 14  # Lab2RGBinteger's base_shift
BASE = 1 << BASE_SHIFT
MIN_AB = -8145  # minABvalue: the least a, b -> x, z table index

# OpenCV's sRGB -> XYZ and XYZ -> sRGB matrices (rows X, Y, Z and R, G, B)
# and its D65 white point
SRGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
XYZ2SRGB = ((3.240479, -1.53715, -0.498535),
            (-0.969256, 1.875991, 0.041556),
            (0.055648, -0.204043, 1.057311))
D65 = (0.950456, 1.0, 1.088754)


def _round_f32(v) -> np.ndarray:
    """``cvRound`` of f32 values: to the nearest integer, ties to even."""
    return np.rint(np.asarray(v, _F32)).astype(np.int64)


def _srgb_gamma(x: np.ndarray) -> np.ndarray:
    """``applyGamma``: f32 in, computed in f64, rounded to f32."""
    x = x.astype(np.float64)
    lin = x / (323 / 25)
    pw = np.power((x + 11 / 200) / (1 + 11 / 200), 12 / 5)
    return np.where(x <= 809 / 20000, lin, pw).astype(_F32)


def _srgb_inv_gamma(x: np.ndarray) -> np.ndarray:
    """``applyInvGamma``: f32 in, computed in f64, rounded to f32."""
    x = x.astype(np.float64)
    lin = x * (323 / 25)
    pw = np.power(x, 1 / (12 / 5)) * (1 + 11 / 200) - 11 / 200
    return np.where(x <= 7827 / 2500000, lin, pw).astype(_F32)


def _softfloat_cbrt(x: np.ndarray) -> np.ndarray:
    """OpenCV's ``softfloat`` cube root of positive f32 values: the argument
    reduced to fr in [1/8, 1), Turkowski's quartic rational approximation
    in f64, and the quotient's mantissa cut (not rounded) to 24 bits.  It
    is not the correctly rounded cube root: one entry of the Lab table
    (x = 324/2040) lands a unit lower because of the cut."""
    mant, e = np.frexp(x.astype(np.float64))  # x = mant * 2^e, mant in [1/2, 1)
    ex = e - 1
    shx = np.fmod(ex, 3)
    shx = np.where(shx >= 0, shx - 3, shx)
    fr = np.ldexp(2 * mant, shx)
    num = (((45.2548339756803022511987494 * fr + 192.2798368355061050458134625) * fr
            + 119.1654824285581628956914143) * fr + 13.43250139086239872172837314) * fr \
        + 0.1636161226585754240958355063
    den = (((14.80884093219134573786480845 * fr + 151.9714051044435648658557668) * fr
            + 168.5254414101568283957668343) * fr + 33.9905941350215598754191872) * fr + 1.0
    q = num / den  # in [1/2, 1)
    cut = np.floor(np.ldexp(q, 24))
    return np.ldexp(cut, (ex - shx) // 3 - 24).astype(_F32)


def _fma_f32(a: _F32, b: _F32, c: _F32) -> _F32:
    """``mulAdd``: a * b + c rounded once to f32 (to nearest, ties to even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = _F32(float(exact))
    cands = (np.nextafter(near, _F32(-np.inf)), near, np.nextafter(near, _F32(np.inf)))
    dist = [abs(Fraction(float(v)) - exact) for v in cands]
    best = min(dist)
    ties = [v for v, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda v: int(v.view(np.uint32)) & 1)


def _desc(x: np.ndarray, n: int) -> np.ndarray:
    """``CV_DESCALE``: x / 2^n rounded half up."""
    return (x + (1 << (n - 1))) >> n


@lru_cache(maxsize=1)
def _lab_tables() -> SimpleNamespace:
    """The 8-bit Lab tables and coefficients, as ``initLabTabs`` and the
    ``RGB2Lab_b``/``Lab2RGBinteger`` constructors build them for BGR."""
    f255 = _F32(255)
    i256 = np.arange(256)
    # sRGBGammaTab_b: cvRound(255 * 8 * gamma(i / 255)), in f32
    gamma = _round_f32(_F32(255 * (1 << GAMMA_SHIFT))
                       * _srgb_gamma((i256.astype(_F32) / f255).astype(_F32)))
    # LabCbrtTab_b: cvRound(2^15 * f(x)), x = i * f32(1 / 2040)
    lthresh = _F32(216) / _F32(24389)
    lscale = _F32(841) / _F32(108)
    lbias = _F32(16) / _F32(116)
    x = (np.arange(CBRT_TAB).astype(_F32) * (_F32(1) / (f255 * _F32(1 << GAMMA_SHIFT)))).astype(_F32)
    f = np.zeros(CBRT_TAB, _F32)
    big = x >= lthresh
    f[big] = _softfloat_cbrt(x[big])
    f[~big] = [_fma_f32(v, lscale, lbias) for v in x[~big]]
    cbrt = _round_f32(_F32(1 << LAB_SHIFT2) * f)
    # the forward coefficients: cvRound(2^12 * M[i][j] / white[i]), src order B, G, R
    fwd = np.array([[round(math.ldexp(SRGB2XYZ[i][j], LAB_SHIFT) / D65[i]) for j in (2, 1, 0)]
                    for i in range(3)], np.int64)
    # LabToYF_b: L -> (y, ify) in 14-bit fixed point, from f32 arithmetic
    y_tab = np.zeros(256, np.int64)
    ify_tab = np.zeros(256, np.int64)
    for i in range(256):
        if i <= 20:
            y_tab[i] = _round_f32(_F32(i * BASE * 20 * 9) / _F32(17 * 29 * 29 * 29))
            ify_tab[i] = _round_f32(_F32(BASE) * (_F32(16) / _F32(116)
                                                  + _F32(i * 5) / _F32(3 * 17 * 29)))
        else:
            fy = _F32(i * 100 * BASE) / _F32(255 * 116) + _F32(16 * BASE) / _F32(116)
            ify_tab[i] = _round_f32(fy)
            y_tab[i] = _round_f32(fy * fy * fy / _F32(BASE * BASE))
    # abToXZ_b: f(x), f(z) in 14-bit fixed point -> x, z, in C's int arithmetic
    v = np.arange(MIN_AB, BASE * 9 // 4 + MIN_AB, dtype=np.int64)
    lin = np.sign(v) * (np.abs(v) * 108 // 841) - BASE * 16 // 116 * 108 // 841
    cube = (v * v // BASE) * v // BASE  # v > 3390 here: no negative division
    ab_xz = np.where(v <= 3390, lin, cube)
    # sRGBInvGammaTab_b: cvRound(255 * invgamma(i / 4096))
    xi = (np.arange(1 << INV_GAMMA_SHIFT).astype(_F32) * _F32(1.0 / (1 << INV_GAMMA_SHIFT))).astype(_F32)
    inv_gamma = _round_f32(f255 * _srgb_inv_gamma(xi))
    # the inverse coefficients: cvRound(2^12 * M[row][j] * white[j]), rows B, G, R
    inv = np.array([[round(math.ldexp(XYZ2SRGB[r][j], LAB_SHIFT) * D65[j]) for j in range(3)]
                    for r in (2, 1, 0)], np.int64)
    return SimpleNamespace(gamma=gamma, cbrt=cbrt, fwd=fwd, y=y_tab, ify=ify_tab,
                           ab_xz=ab_xz, inv_gamma=inv_gamma, inv=inv)


def bgr2lab_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2Lab)`` for a u8 (H, W, 3) image:
    (H, W, 3) u8 L * 255/100, a + 128, b + 128."""
    img = _check_u8(img, "bgr2lab_u8", (3,))
    t = _lab_tables()
    lin = t.gamma[img]  # (H, W, 3) gamma-expanded B, G, R, 11 bits
    out = np.empty(img.shape, np.uint8)
    fx, fy, fz = (t.cbrt[_desc(lin @ t.fwd[i], LAB_SHIFT)] for i in range(3))
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << LAB_SHIFT2) + 50) // 100)
    half = 128 * (1 << LAB_SHIFT2)
    out[..., 0] = np.clip(_desc(l_scale * fy + l_shift, LAB_SHIFT2), 0, 255)
    out[..., 1] = np.clip(_desc(500 * (fx - fy) + half, LAB_SHIFT2), 0, 255)
    out[..., 2] = np.clip(_desc(200 * (fy - fz) + half, LAB_SHIFT2), 0, 255)
    return out


def lab2bgr_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_Lab2BGR)`` for a u8 (H, W, 3) Lab image
    (OpenCV's bit-exact integer path)."""
    img = _check_u8(img, "lab2bgr_u8", (3,))
    t = _lab_tables()
    lab = img.astype(np.int64)
    y, ify = t.y[lab[..., 0]], t.ify[lab[..., 0]]
    adiv = ((5 * lab[..., 1] * 53687 + (1 << 7)) >> 13) - 128 * BASE // 500
    bdiv = ((lab[..., 2] * 41943 + (1 << 4)) >> 9) - 128 * BASE // 200 + 1
    x = t.ab_xz[ify + adiv - MIN_AB]
    z = t.ab_xz[ify - bdiv - MIN_AB]
    shift = LAB_SHIFT + BASE_SHIFT - INV_GAMMA_SHIFT
    out = np.empty(img.shape, np.uint8)
    for c in range(3):
        k = t.inv[c]
        v = _desc(k[0] * x + k[1] * y + k[2] * z, shift)
        out[..., c] = t.inv_gamma[np.clip(v, 0, (1 << INV_GAMMA_SHIFT) - 1)]
    return out


# ---------------------------------------------------------------- CLAHE


def _reflect101(n: int, n_out: int) -> np.ndarray:
    """Source indices of ``n_out`` positions along an axis of ``n``, past
    the end by ``BORDER_REFLECT_101`` (``borderInterpolate``)."""
    if n == 1:
        return np.zeros(n_out, np.intp)
    i = np.arange(n_out) % (2 * (n - 1))
    return np.where(i < n, i, 2 * (n - 1) - i)


def clahe_u8(gray: np.ndarray, clip_limit: float = 40.0, tiles: int = 8) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, (tiles, tiles)).apply(gray)`` for a u8
    (H, W) image.  ``clip_limit <= 0`` clips nothing."""
    gray = _check_u8(gray, "clahe_u8", (0,))
    tiles = int(tiles)
    if tiles < 1:
        raise ValueError(f"clahe_u8 needs at least one tile a side, not {tiles}")
    h, w = gray.shape
    src = gray
    if h % tiles or w % tiles:
        # OpenCV grows both axes by tiles - size % tiles: a whole extra row
        # (or column) of tiles where that axis already divides
        src = gray[_reflect101(h, h + tiles - h % tiles)][:, _reflect101(w, w + tiles - w % tiles)]
    th, tw = src.shape[0] // tiles, src.shape[1] // tiles
    area = th * tw
    # one histogram a tile, from one bincount over tile-offset values
    tile = (np.arange(src.shape[0]) // th)[:, None] * tiles + np.arange(src.shape[1]) // tw
    hist = np.bincount((tile * 256 + src).ravel(),
                       minlength=tiles * tiles * 256).reshape(-1, 256)
    if clip_limit > 0:
        clip = max(int(clip_limit * area / 256), 1)
        clipped = np.maximum(hist - clip, 0).sum(1)
        hist = np.minimum(hist, clip) + (clipped // 256)[:, None]
        residual = clipped % 256
        step = np.maximum(256 // np.maximum(residual, 1), 1)[:, None]
        i = np.arange(256)
        hist += (i % step == 0) & (i // step < residual[:, None])
    lut = np.clip(np.rint(np.cumsum(hist, 1).astype(_F32) * (_F32(255) / _F32(area))), 0, 255)
    lut = lut.astype(_F32)

    def axis(n: int, size: int):
        t = (np.arange(n, dtype=_F32) * (_F32(1) / _F32(size)) - _F32(0.5)).astype(_F32)
        t1 = np.floor(t).astype(np.int64)
        a = (t - t1.astype(_F32)).astype(_F32)
        return np.maximum(t1, 0), np.minimum(t1 + 1, tiles - 1), _F32(1) - a, a

    ty1, ty2, ya1, ya = axis(h, th)
    tx1, tx2, xa1, xa = axis(w, tw)
    v = gray.astype(np.intp)

    def row(ty):  # the LUT plane of tile row ty, blended across the tile columns
        return (lut[ty[:, None] * tiles + tx1, v] * xa1
                + lut[ty[:, None] * tiles + tx2, v] * xa)

    res = row(ty1) * ya1[:, None] + row(ty2) * ya[:, None]
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


# ------------------------------------------------------ INTER_LINEAR (u8)

COEF_BITS = 11  # INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS


def linear_axis(n_src: int, n_dst: int, area: bool = False, clamp: bool = True):
    """One axis of ``cv::resize``'s linear interpolation: (n_dst,) first and
    second source index and their 11-bit coefficients.

    ``area``: INTER_AREA's coefficients (``fx = (dx+1) - (sx+1)/scale``,
    used where an axis grows), else INTER_LINEAR's half-pixel ones.
    ``clamp``: the horizontal axis, where an output whose first tap falls
    before the first or on the last source pixel takes that pixel alone;
    the vertical axis keeps its weights and reads the edge row twice."""
    inv = n_dst / n_src  # inv_scale, then scale = 1 / inv_scale, in double
    scale = 1.0 / inv
    d = np.arange(n_dst, dtype=np.float64)
    if area:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv).astype(_F32)
        f = np.where(f <= 0, _F32(0), f - np.floor(f)).astype(_F32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(_F32)
        s = np.floor(f).astype(np.int64)
        f = (f - s.astype(_F32)).astype(_F32)
    if clamp:
        for edge, to in ((s < 0, 0), (s >= n_src - 1, n_src - 1)):
            f[edge], s[edge] = 0, to
    coef = lambda v: np.rint(v * _F32(COEF_SCALE)).astype(np.int64)  # noqa: E731
    return (np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1),
            coef(_F32(1) - f), coef(f))


def linear_passes(src: np.ndarray, cn: int, x_axis, y_axis) -> np.ndarray:
    """(sh, sw*cn) u8 -> (dh, dw*cn) u8 through :func:`linear_axis` tables,
    in OpenCV's fixed point: ``HResizeLinear`` on int sums, then
    ``VResizeLinear<uchar, int, short>`` as its vector form rounds it."""
    x0, x1, a0, a1 = x_axis
    y0, y1, b0, b1 = y_axis
    col = lambda xs: (xs[:, None] * cn + np.arange(cn)).reshape(-1)  # noqa: E731
    rows = src.astype(np.int64)
    horiz = (rows[:, col(x0)] * np.repeat(a0, cn) + rows[:, col(x1)] * np.repeat(a1, cn)) >> 4
    out = (((b0[:, None] * horiz[y0]) >> 16) + ((b1[:, None] * horiz[y1]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_linear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h))`` (INTER_LINEAR) for a u8 (H, W) or
    (H, W, C) image, bit for bit."""
    img = _check_u8(img, "resize_linear_u8", (0, 1, 3))
    out_h, out_w = int(out_h), int(out_w)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"resize_linear_u8 needs a positive size, not {out_h}x{out_w}")
    h, w = img.shape[:2]
    cn = img.shape[2] if img.ndim == 3 else 1
    if 1.0 / (out_w / w) == 2.0 and 1.0 / (out_h / h) == 2.0:
        # cv::resize takes INTER_AREA's 2x2 average for an exact halving
        q = img.reshape(out_h, 2, out_w, 2, cn).astype(np.int32)
        out = (q[:, 0, :, 0] + q[:, 0, :, 1] + q[:, 1, :, 0] + q[:, 1, :, 1] + 2) >> 2
        return out.astype(np.uint8).reshape((out_h, out_w) + img.shape[2:])
    out = linear_passes(img.reshape(h, w * cn), cn,
                        linear_axis(w, out_w, clamp=True), linear_axis(h, out_h, clamp=False))
    return out.reshape((out_h, out_w) + img.shape[2:])


# ----------------------------------------------------------- cv2.line

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
Point = Tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, p1: Point, p2: Point):
    """``cv::clipLine`` to the rectangle [0, w) x [0, h): the clipped
    endpoints, or None where the segment misses it."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


class _Mask:
    """The bool mask of the pixels a stroke paints, kept over a window
    ``[y0, y0 + rows) x [x0, x0 + cols)`` of an (h, w) image: the drawing
    code clips to the whole image and writes through :meth:`points` and
    :meth:`span` in image coordinates."""

    def __init__(self, h: int, w: int, x0: int, y0: int, x1: int, y1: int):
        self.h, self.w = h, w
        self.x0, self.y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, w - 1), min(y1, h - 1)
        self.arr = np.zeros((max(y1 - self.y0 + 1, 0), max(x1 - self.x0 + 1, 0)), bool)

    def points(self, xs: np.ndarray, ys: np.ndarray) -> None:
        self.arr[ys - self.y0, xs - self.x0] = True

    def span(self, y: int, xa: int, xb: int) -> None:
        """Row ``y`` from ``xa`` to ``xb`` inclusive, clipped to the image."""
        if 0 <= y < self.h and xb >= 0 and xa < self.w:
            self.arr[y - self.y0, max(xa, 0) - self.x0:min(xb, self.w - 1) - self.x0 + 1] = True

    def spans(self, ys: np.ndarray, xa: np.ndarray, xb: np.ndarray) -> None:
        """:meth:`span` for distinct rows ``ys`` (0 <= ys < h) at once."""
        keep = (xb >= 0) & (xa < self.w)
        cols = np.arange(self.x0, self.x0 + self.arr.shape[1])
        self.arr[ys[keep] - self.y0] |= ((cols >= xa[keep, None]) & (cols <= xb[keep, None]))


def _line8(mask: _Mask, p1: Point, p2: Point) -> None:
    """The thickness-1 ``Line``: ``LineIterator`` with 8-connectivity, left
    to right, after ``clipLine``."""
    h, w = mask.h, mask.w
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        clipped = _clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    (x1, y1), (x2, y2) = p1, p2
    dx, dy, sy = x2 - x1, abs(y2 - y1), (1 if y2 >= y1 else -1)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # Bresenham's error term e_k = dx - 2dy(k+1) + 2dx m_k steps the minor axis
    # where it is negative: m_k = ceil((2dy k - dx) / 2dx) steps by pixel k
    k = np.arange(dx + 1, dtype=np.int64)
    minor = -((dx - 2 * dy * k) // (2 * dx)) if dx else np.zeros(1, np.int64)
    if vert:
        xs, ys = x1 + minor, y1 + sy * k
    else:
        xs, ys = x1 + k, y1 + sy * minor
    mask.points(xs, ys)


def _line2(mask: _Mask, p1: Point, p2: Point) -> None:
    """``Line2``: a line between 16.16 fixed-point points, clipped to the
    image in that fixed point, stepping one pixel along its major axis."""
    h, w = mask.h, mask.w
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    half = XY_ONE >> 1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        step = _cdiv(dy << XY_SHIFT, abs(dx) | 1)
        k = np.arange(((x2 - x1) >> XY_SHIFT) + 1, dtype=np.int64)
        xs, ys = ((x1 + half) >> XY_SHIFT) + k, (y1 + half + k * step) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        step = _cdiv(dx << XY_SHIFT, abs(dy) | 1)
        k = np.arange(((y2 - y1) >> XY_SHIFT) + 1, dtype=np.int64)
        xs, ys = (x1 + half + k * step) >> XY_SHIFT, ((y1 + half) >> XY_SHIFT) + k
    # and the far end (after the swap) rounded to its pixel
    xs = np.append(xs, (x2 + half) >> XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> XY_SHIFT)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    mask.points(xs[inside], ys[inside])


def _fill_convex_poly(mask: _Mask, v: Sequence[Point]) -> None:
    """``FillConvexPoly`` of 16.16 fixed-point vertices with ``LINE_8``: the
    edges drawn by :func:`_line2`, then the rows between the two edge walks
    filled (each edge's x advanced by its rounded slope a row), a run of
    rows between two vertices at a time."""
    h, w = mask.h, mask.w
    n = len(v)
    delta = XY_ONE >> 1
    imin = min(range(n), key=lambda i: (v[i][1], i))
    p0 = v[-1]
    for p in v:
        _line2(mask, p0, p)
        p0 = p
    xs_all = [p[0] for p in v]
    ys_all = [p[1] for p in v]
    xmin, xmax = (min(xs_all) + delta) >> XY_SHIFT, (max(xs_all) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys_all) + delta) >> XY_SHIFT, (max(ys_all) + delta) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    # per edge walk: [vertex index, direction, x, dx, end row]
    walk = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in walk:
            if y < e[4]:
                continue
            idx0 = e[0]
            idx = (idx0 + e[1]) % n
            while edges > 0:
                edges -= 1
                ty = (v[idx][1] + delta) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e[0], e[2], e[4] = idx, xs, ty
                    e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    break
                idx0, idx = idx, (idx + e[1]) % n
            else:
                edges -= 1
        if edges < 0:
            break
        # the rows up to the next vertex, each walk's x advanced by its slope
        y_next = min(walk[0][4], walk[1][4], ymax + 1)
        k = np.arange(max(-y, 0), y_next - y, dtype=np.int64)
        if k.size:
            xa, xb = walk[0][2] + k * walk[0][3], walk[1][2] + k * walk[1][3]
            mask.spans(y + k, (np.minimum(xa, xb) + delta) >> XY_SHIFT,
                       (np.maximum(xa, xb) + delta) >> XY_SHIFT)
        walk[0][2] += (y_next - y) * walk[0][3]
        walk[1][2] += (y_next - y) * walk[1][3]
        y = y_next
        if y > ymax:
            break


def _fill_circle(mask: _Mask, cx: int, cy: int, radius: int) -> None:
    """``Circle`` filled: the midpoint circle's rows."""
    h, w, span = mask.h, mask.w, mask.span
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        if cx - dx < w and cx + dx >= 0 and cy - dx < h and cy + dx >= 0:
            span(cy - dy, cx - dx, cx + dx)
            span(cy + dy, cx - dx, cx + dx)
            if cx - dy < w and cx + dy >= 0:
                span(cy - dx, cx - dy, cx + dy)
                span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        m = (err <= 0) - 1
        err -= minus & m
        dx += m
        minus -= m & 2


def _line_mask(h: int, w: int, p0: Point, p1: Point, thickness: int = 1) -> _Mask:
    """The pixels ``cv2.line`` paints (LINE_8, shift 0), over the stroke's
    bounding box; every pixel takes the one colour, so the order of the
    parts does not matter."""
    p0, p1 = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    t = thickness
    # the quadrilateral reaches t/2 + 1/2 past the segment, the circles (t + 1) / 2
    grow = 0 if t <= 1 else (t >> 1) + 1
    mask = _Mask(h, w, min(p0[0], p1[0]) - grow, min(p0[1], p1[1]) - grow,
                 max(p0[0], p1[0]) + grow, max(p0[1], p1[1]) + grow)
    if t <= 1:
        _line8(mask, p0, p1)
        return mask
    # cv::line clips the segment to the image grown by the thickness
    clipped = _clip_line(w + 2 * t, h + 2 * t, (p0[0] + t, p0[1] + t), (p1[0] + t, p1[1] + t))
    if clipped is None:
        return mask
    (ax, ay), (bx, by) = clipped
    P0, P1 = ((ax - t) << XY_SHIFT, (ay - t) << XY_SHIFT), ((bx - t) << XY_SHIFT, (by - t) << XY_SHIFT)
    # ThickLine: the quadrilateral offset by half the thickness
    dx, dy = (P0[0] - P1[0]) / XY_ONE, (P1[1] - P0[1]) / XY_ONE
    r = dx * dx + dy * dy
    half = t << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (t & 1) * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(mask, [(P0[0] + ox, P0[1] + oy), (P0[0] - ox, P0[1] - oy),
                                 (P1[0] - ox, P1[1] - oy), (P1[0] + ox, P1[1] + oy)])
    radius = (half + (XY_ONE >> 1)) >> XY_SHIFT
    for P in (P0, P1):
        _fill_circle(mask, (P[0] + (XY_ONE >> 1)) >> XY_SHIFT, (P[1] + (XY_ONE >> 1)) >> XY_SHIFT, radius)
    return mask


def line_u8(img: np.ndarray, p0: Point, p1: Point, color: Union[float, Sequence[float]],
            thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p0, p1, color, thickness)`` (LINE_8, shift 0) on a u8
    (H, W) or (H, W, 3) image, in place; returns ``img``."""
    _check_u8(img, "line_u8", (0, 1, 3))
    if not isinstance(img, np.ndarray):
        raise ValueError("line_u8 draws in place: it takes a numpy array")
    thickness = int(thickness)
    if not 0 < thickness <= 32767:
        raise ValueError(f"line_u8 takes a thickness in 1..32767, not {thickness}")
    cn = img.shape[2] if img.ndim == 3 else 1
    c = np.atleast_1d(np.asarray(color, np.float64))
    c = np.concatenate([c, np.zeros(max(cn - c.size, 0))])[:cn]  # a Scalar's missing channels are 0
    c = np.clip(np.rint(c), 0, 255).astype(np.uint8)
    m = _line_mask(img.shape[0], img.shape[1], p0, p1, thickness)
    rows, cols = m.arr.shape
    img[m.y0:m.y0 + rows, m.x0:m.x0 + cols][m.arr] = c if img.ndim == 3 else c[0]
    return img
