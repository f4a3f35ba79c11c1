"""A TrueType (sfnt) reader in numpy, for the font OpenCV 5 draws text with.

``caffe_rtpose_tpu_torch/utils/text.py`` rasterises glyphs from what this
module reads.  It reads what a variable TrueType font with quadratic
outlines needs to give a glyph's outline and advance at an instance:

* ``head``, ``hhea``, ``maxp``, ``hmtx``, ``loca``;
* ``cmap`` subtables of formats 4 and 12 (the Unicode ones);
* ``glyf``: simple glyphs and composite ones (offsets, scales, 2x2
  transforms and point-matched components);
* ``fvar`` and ``avar`` (a user coordinate to a normalized one, on the
  F2Dot14 grid as the OpenType specification rounds it);
* ``gvar``: shared and private tuples, intermediate regions, shared and
  private point numbers, and the interpolation (IUP) of the points a tuple
  leaves out;
* ``HVAR``: the advance widths at an instance (its item variation store
  and delta-set index map).

:meth:`Font.glyph` gives a glyph's outline at an instance as the
specification computes it (f64 deltas); ``tests/test_torch_text.py`` holds
it, the advances and the character map against fontTools.
:meth:`Font.glyph_opencv` gives the outline OpenCV 5's reader builds (16.16
tuple scalars, integer deltas, every point floored), which the text overlay
draws.  The port's font is
``caffe_rtpose_tpu_torch/fonts/Rubik-OpenCV-Light.ttf`` (SIL Open Font
License 1.1, ``fonts/OFL.txt``), found by a path relative to this module.
"""

from __future__ import annotations

import os
import struct
from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

FONTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "fonts")
RUBIK_PATH = os.path.join(FONTS_DIR, "Rubik-OpenCV-Light.ttf")
RUBIK_SHA256 = "7cdd1f5e7f04df8091c98e3ff2060b5f0d231b2582e344e7727581b7841c7b77"

# simple-glyph flags
_ON_CURVE, _X_SHORT, _Y_SHORT, _REPEAT, _X_SAME, _Y_SAME = 1, 2, 4, 8, 16, 32
# composite-glyph flags
_ARG_WORDS, _ARGS_XY, _SCALE, _MORE = 0x1, 0x2, 0x8, 0x20
_XY_SCALE, _TWO_BY_TWO, _SCALED_OFFSET = 0x40, 0x80, 0x800
# gvar
_SHARED_POINTS, _COUNT_MASK = 0x8000, 0x0FFF
_EMBEDDED_PEAK, _INTERMEDIATE, _PRIVATE_POINTS, _TUPLE_INDEX = 0x8000, 0x4000, 0x2000, 0x0FFF

_MAX_COMPOSITE_DEPTH = 8


class Axis(NamedTuple):
    tag: str
    minimum: float
    default: float
    maximum: float


class Glyph(NamedTuple):
    """A glyph's outline at an instance, in font units.

    ``points`` is (n, 2) f64, ``on_curve`` (n,) bool and ``ends`` the index
    of each contour's last point; ``advance`` and ``lsb`` come from the
    varied phantom points; ``bbox`` is (xMin, yMin, xMax, yMax) of the glyf
    header, which variations do not change."""

    points: np.ndarray
    on_curve: np.ndarray
    ends: Tuple[int, ...]
    advance: float
    lsb: float
    bbox: Tuple[int, int, int, int]


def _f2dot14(v: int) -> float:
    return v / 16384.0


def _tdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated towards zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _avar_map(n: int, seg: np.ndarray) -> int:
    """F2Dot14 ``n`` through an ``avar`` segment map of F2Dot14 (from, to)
    rows: linear on the segment whose start it reaches, rounded half up."""
    for i in range(1, len(seg)):
        f0, t0 = int(seg[i - 1, 0]), int(seg[i - 1, 1])
        f1, t1 = int(seg[i, 0]), int(seg[i, 1])
        if f1 <= f0 or t1 < t0:
            return n  # not a valid map: left out
        if f0 <= n < f1:
            return t0 + ((n - f0) * (t1 - t0) + ((f1 - f0) >> 1)) // (f1 - f0)
    return int(seg[-1, 1]) if n == int(seg[-1, 0]) else n


def _fixed_scalar(v: Sequence[int], region, intermediate: bool) -> int:
    """A gvar tuple's scalar at F2Dot14 ``v`` in 16.16 fixed point, each
    axis's factor applied by a truncating division, as OpenCV 5 does."""
    lo, peak, hi = region
    s = 0x10000
    for x, a, p, b in zip(v, lo, peak, hi):
        x, a, p, b = int(x), int(a), int(p), int(b)
        if p == 0 or p == x:
            continue
        if x == 0:
            return 0
        if intermediate:
            if b < x or a > x:
                return 0
            s = _tdiv(s * (x - a), p - a) if p > x else _tdiv(s * (b - x), b - p)
        elif (x > 0 and x <= p) or (x < 0 and x >= p):
            s = _tdiv(s * x, p)
        else:
            return 0
    return s


def _region_scalar(v: Sequence[float], start: Sequence[float], peak: Sequence[float],
                   end: Sequence[float]) -> float:
    """The scalar of a variation region (or a gvar tuple) at ``v``, in f64."""
    s = 1.0
    for x, lo, pk, hi in zip(v, start, peak, end):
        if pk == 0.0 or x == pk:
            continue
        if lo > pk or pk > hi or (lo < 0.0 < hi):
            continue  # an invalid region axis is ignored
        if x <= lo or x >= hi:
            return 0.0
        s *= (x - lo) / (pk - lo) if x < pk else (hi - x) / (hi - pk)
    return s


def _iup(coords: np.ndarray, deltas: np.ndarray, touched: np.ndarray,
         ends: Sequence[int], truncate: bool = False) -> np.ndarray:
    """gvar's IUP: the deltas of each contour's untouched points from their
    touched neighbours, x and y apart.  In f64 as the specification (and
    fontTools) computes it, or with ``truncate`` on integer deltas, each
    interpolated delta truncated towards zero, as OpenCV 5 does."""
    out = np.where(touched[:, None], deltas, 0)
    start = 0
    for end in ends:
        idx = np.arange(start, end + 1)
        ref = idx[touched[idx]]
        start = end + 1
        if len(ref) == 0 or len(ref) == len(idx):
            continue
        if len(ref) == 1:
            out[idx] = deltas[ref[0]]
            continue
        for k in range(len(ref)):
            r1, r2 = ref[k], ref[(k + 1) % len(ref)]
            # the untouched points strictly between r1 and r2, cyclically
            if r2 > r1:
                between = np.arange(r1 + 1, r2)
            else:
                between = np.concatenate([np.arange(r1 + 1, idx[-1] + 1), np.arange(idx[0], r2)])
            if len(between) == 0:
                continue
            for j in (0, 1):
                x1, x2 = coords[r1, j], coords[r2, j]
                d1, d2 = deltas[r1, j], deltas[r2, j]
                if x1 == x2:
                    out[between, j] = d1 if d1 == d2 else 0
                    continue
                if x1 > x2:
                    x1, x2, d1, d2 = x2, x1, d2, d1
                x = coords[between, j]
                if truncate:
                    num = d1 * (x2 - x1) + (x - x1) * (d2 - d1)
                    inner = np.sign(num) * (np.abs(num) // (x2 - x1))
                else:
                    inner = d1 + (x - x1) * ((d2 - d1) / (x2 - x1))
                out[between, j] = np.where(x <= x1, d1, np.where(x >= x2, d2, inner))
    return out


class Font:
    """A TrueType font with quadratic outlines, read from ``data``."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        tag = self.data[:4]
        if tag not in (b"\x00\x01\x00\x00", b"true"):
            raise ValueError(f"not a TrueType font with glyf outlines (sfnt version {tag!r})")
        (n,) = struct.unpack_from(">H", self.data, 4)
        self.tables: Dict[str, Tuple[int, int]] = {}
        for i in range(n):
            t, _, off, length = struct.unpack_from(">4sIII", self.data, 12 + 16 * i)
            self.tables[t.decode("latin-1")] = (off, length)
        for need in ("head", "hhea", "maxp", "hmtx", "loca", "glyf", "cmap"):
            if need not in self.tables:
                raise ValueError(f"the font has no {need!r} table")
        head = self._off("head")
        self.units_per_em = self._u16(head + 18)
        self.bbox = struct.unpack_from(">hhhh", self.data, head + 36)
        self._long_loca = self._i16(head + 50) == 1
        self.num_glyphs = self._u16(self._off("maxp") + 4)
        hhea = self._off("hhea")
        self.ascent, self.descent, self.line_gap = struct.unpack_from(">hhh", self.data, hhea + 4)
        self._num_hmetrics = self._u16(hhea + 34)
        self._read_hmtx()
        self._read_loca()
        self.cmap = self._read_cmap()
        self.axes: Tuple[Axis, ...] = self._read_fvar()
        self._avar = self._read_avar()
        self._gvar = self._read_gvar_header()
        self._hvar = self._read_hvar()

    # ------------------------------------------------------------ bytes

    def _off(self, tag: str) -> int:
        return self.tables[tag][0]

    def _u16(self, o: int) -> int:
        return struct.unpack_from(">H", self.data, o)[0]

    def _i16(self, o: int) -> int:
        return struct.unpack_from(">h", self.data, o)[0]

    def _u32(self, o: int) -> int:
        return struct.unpack_from(">I", self.data, o)[0]

    def _array(self, o: int, n: int, dtype: str) -> np.ndarray:
        return np.frombuffer(self.data, dtype=dtype, count=n, offset=o).astype(np.int64)

    # ------------------------------------------------------------ tables

    def _read_hmtx(self):
        o, nh, ng = self._off("hmtx"), self._num_hmetrics, self.num_glyphs
        pairs = self._array(o, 2 * nh, ">i2").reshape(nh, 2)
        adv = np.empty(ng, np.int64)
        lsb = np.empty(ng, np.int64)
        adv[:nh] = pairs[:, 0] & 0xFFFF  # advanceWidth is unsigned
        lsb[:nh] = pairs[:, 1]
        adv[nh:] = adv[nh - 1]
        lsb[nh:] = self._array(o + 4 * nh, ng - nh, ">i2")
        self.advances, self.lsbs = adv, lsb

    def _read_loca(self):
        o, ng = self._off("loca"), self.num_glyphs
        if self._long_loca:
            self._loca = self._array(o, ng + 1, ">u4")
        else:
            self._loca = self._array(o, ng + 1, ">u2") * 2

    def _read_cmap(self) -> Dict[int, int]:
        o = self._off("cmap")
        n = self._u16(o + 2)
        best: Optional[Tuple[int, int]] = None  # (rank, offset)
        for i in range(n):
            pid, eid, sub = struct.unpack_from(">HHI", self.data, o + 4 + 8 * i)
            fmt = self._u16(o + sub)
            rank = {(3, 10): 0, (0, 4): 1, (0, 6): 1, (3, 1): 2, (0, 3): 3}.get((pid, eid))
            if rank is None and pid == 0:
                rank = 4
            if rank is None or fmt not in (4, 12):
                continue
            if best is None or rank < best[0]:
                best = (rank, o + sub)
        if best is None:
            raise ValueError("the font has no Unicode cmap subtable of format 4 or 12")
        return self._cmap12(best[1]) if self._u16(best[1]) == 12 else self._cmap4(best[1])

    def _cmap4(self, o: int) -> Dict[int, int]:
        seg = self._u16(o + 6) // 2
        ends = self._array(o + 14, seg, ">u2")
        starts = self._array(o + 16 + 2 * seg, seg, ">u2")
        deltas = self._array(o + 16 + 4 * seg, seg, ">i2")
        ro_at = o + 16 + 6 * seg
        ranges = self._array(ro_at, seg, ">u2")
        out: Dict[int, int] = {}
        for i in range(seg):
            for c in range(int(starts[i]), int(ends[i]) + 1):
                if c == 0xFFFF:
                    continue
                if ranges[i] == 0:
                    g = (c + int(deltas[i])) & 0xFFFF
                else:
                    at = ro_at + 2 * i + int(ranges[i]) + 2 * (c - int(starts[i]))
                    g = self._u16(at)
                    if g:
                        g = (g + int(deltas[i])) & 0xFFFF
                if g:
                    out[c] = g
        return out

    def _cmap12(self, o: int) -> Dict[int, int]:
        n = self._u32(o + 12)
        groups = self._array(o + 16, 3 * n, ">u4").reshape(n, 3)
        out: Dict[int, int] = {}
        for start, end, g in groups:
            for c in range(int(start), int(end) + 1):
                out[c] = int(g) + c - int(start)
        return out

    def _read_fvar(self) -> Tuple[Axis, ...]:
        if "fvar" not in self.tables:
            return ()
        o = self._off("fvar")
        axes_at = o + self._u16(o + 4)
        count, size = self._u16(o + 8), self._u16(o + 10)
        axes = []
        for i in range(count):
            tag, mn, df, mx = struct.unpack_from(">4siii", self.data, axes_at + i * size)
            axes.append(Axis(tag.decode("latin-1"), mn / 65536.0, df / 65536.0, mx / 65536.0))
        return tuple(axes)

    def _read_avar(self) -> List[Optional[np.ndarray]]:
        maps: List[Optional[np.ndarray]] = [None] * len(self.axes)
        if "avar" not in self.tables:
            return maps
        o = self._off("avar")
        count = self._u16(o + 6)
        at = o + 8
        for i in range(min(count, len(maps))):
            n = self._u16(at)
            maps[i] = self._array(at + 2, 2 * n, ">i2").reshape(n, 2)
            at += 2 + 4 * n
        return maps

    def _read_gvar_header(self):
        if "gvar" not in self.tables:
            return None
        o = self._off("gvar")
        axis_count, shared_n, shared_at, glyph_n, flags, data_at = struct.unpack_from(
            ">HHIHHI", self.data, o + 4)
        if axis_count != len(self.axes):
            raise ValueError(f"gvar has {axis_count} axes and fvar {len(self.axes)}")
        if flags & 1:
            offs = self._array(o + 20, glyph_n + 1, ">u4")
        else:
            offs = self._array(o + 20, glyph_n + 1, ">u2") * 2
        shared = self._array(o + shared_at, shared_n * axis_count, ">i2")
        shared = shared.reshape(shared_n, axis_count)
        return dict(offs=offs + o + data_at, shared=shared)

    def _read_hvar(self):
        if "HVAR" not in self.tables:
            return None
        o = self._off("HVAR")
        store_at, adv_map_at = struct.unpack_from(">II", self.data, o + 4)
        return dict(store=self._read_item_store(o + store_at),
                    adv_map=self._read_index_map(o + adv_map_at) if adv_map_at else None)

    def _read_index_map(self, o: int) -> np.ndarray:
        fmt, entry = self.data[o], self.data[o + 1]
        if fmt == 0:
            n, at = self._u16(o + 2), o + 4
        else:
            n, at = self._u32(o + 2), o + 6
        size = ((entry >> 4) & 3) + 1
        inner_bits = (entry & 0xF) + 1
        raw = np.frombuffer(self.data, np.uint8, n * size, at).reshape(n, size).astype(np.int64)
        val = np.zeros(n, np.int64)
        for k in range(size):
            val = (val << 8) | raw[:, k]
        return np.stack([val >> inner_bits, val & ((1 << inner_bits) - 1)], 1)

    def _read_item_store(self, o: int):
        regions_at, n_data = self._u32(o + 2), self._u16(o + 6)
        ra = o + regions_at
        axis_n, region_n = self._u16(ra), self._u16(ra + 2)
        regions = self._array(ra + 4, region_n * axis_n * 3, ">i2")
        regions = regions.reshape(region_n, axis_n, 3) / 16384.0
        datas = []
        for i in range(n_data):
            d = o + self._u32(o + 8 + 4 * i)
            items, words, ridx_n = self._u16(d), self._u16(d + 2), self._u16(d + 4)
            long_words = bool(words & 0x8000)
            words &= 0x7FFF
            ridx = self._array(d + 6, ridx_n, ">u2")
            big, small = (">i4", ">i2") if long_words else (">i2", "i1")
            bsz, ssz = (4, 2) if long_words else (2, 1)
            row = words * bsz + (ridx_n - words) * ssz
            at = d + 6 + 2 * ridx_n
            deltas = np.zeros((items, ridx_n), np.int64)
            buf = np.frombuffer(self.data, np.uint8, items * row, at).reshape(items, row)
            if words:
                deltas[:, :words] = np.ascontiguousarray(buf[:, :words * bsz]).view(big)
            if ridx_n > words:
                deltas[:, words:] = np.ascontiguousarray(buf[:, words * bsz:]).view(small)
            datas.append((ridx, deltas))
        return dict(regions=regions, datas=datas)

    # ------------------------------------------------------------ lookups

    def glyph_index(self, codepoint: int) -> int:
        """The glyph of a code point; 0 (.notdef) where the cmap has none."""
        return self.cmap.get(int(codepoint), 0)

    def normalize(self, coords: Optional[Dict[str, float]] = None) -> Tuple[int, ...]:
        """A user location (``{"wght": 400}``; an axis left out sits at its
        default) as F2Dot14 normalized coordinates, in the integer
        arithmetic OpenCV 5 uses: the value clamped to the axis, its offset
        from the default over the distance to the end, rounded half up to
        1/16384, then mapped through the ``avar`` segment whose start it
        reaches, rounded half up again."""
        coords = coords or {}
        unknown = set(coords) - {a.tag for a in self.axes}
        if unknown:
            raise ValueError(f"the font has no axis {sorted(unknown)}")
        out = []
        for i, ax in enumerate(self.axes):
            fx = lambda x: int(round(x * 65536))  # noqa: E731 — fvar's 16.16
            lo, df, hi = fx(ax.minimum), fx(ax.default), fx(ax.maximum)
            v = min(max(fx(coords.get(ax.tag, ax.default)), lo), hi)
            if v < df:
                n = -((((df - v) << 14) + (df - lo) // 2) // (df - lo))
            elif v > df:
                n = (((v - df) << 14) + (hi - df) // 2) // (hi - df)
            else:
                n = 0
            seg = self._avar[i]
            if seg is not None and len(seg) > 1:
                n = _avar_map(n, seg)
            out.append(min(max(n, -16384), 16384))
        return tuple(out)

    def advance(self, glyph: int, norm: Sequence[int] = ()) -> float:
        """The advance width of ``glyph`` at F2Dot14 ``norm`` in font
        units, from ``hmtx`` and ``HVAR``."""
        adv = float(self.advances[glyph])
        if self._hvar is None or not any(norm):
            return adv
        m = self._hvar["adv_map"]
        if m is None:
            outer, inner = 0, glyph
        else:
            outer, inner = m[min(glyph, len(m) - 1)]
        v = np.asarray(norm, np.float64) / 16384.0
        return adv + self._store_delta(self._hvar["store"], int(outer), int(inner), v)

    def _store_delta(self, store, outer: int, inner: int, norm: Sequence[float]) -> float:
        ridx, deltas = store["datas"][outer]
        total = 0.0
        for k, r in enumerate(ridx):
            reg = store["regions"][r]
            s = _region_scalar(norm, reg[:, 0], reg[:, 1], reg[:, 2])
            if s:
                total += s * float(deltas[inner, k])
        return total

    # ------------------------------------------------------------ outlines

    def _glyph_bytes(self, glyph: int) -> bytes:
        if not 0 <= glyph < self.num_glyphs:
            raise ValueError(f"glyph {glyph} outside the font's {self.num_glyphs}")
        o = self._off("glyf")
        return self.data[o + self._loca[glyph]:o + self._loca[glyph + 1]]

    def _simple(self, b: bytes, n_contours: int):
        ends = np.frombuffer(b, ">u2", n_contours, 10).astype(np.int64)
        n = int(ends[-1]) + 1 if n_contours else 0
        at = 10 + 2 * n_contours
        at += 2 + struct.unpack_from(">H", b, at)[0]  # skip the instructions
        flags = np.empty(n, np.uint8)
        i = 0
        while i < n:
            f = b[at]
            at += 1
            flags[i] = f
            i += 1
            if f & _REPEAT:
                r = b[at]
                at += 1
                flags[i:i + r] = f
                i += r
        coords = np.zeros((n, 2), np.int64)
        for axis, short, same in ((0, _X_SHORT, _X_SAME), (1, _Y_SHORT, _Y_SAME)):
            v = 0
            for k in range(n):
                f = flags[k]
                if f & short:
                    d = b[at]
                    at += 1
                    v += d if f & same else -d
                elif not f & same:
                    v += struct.unpack_from(">h", b, at)[0]
                    at += 2
                coords[k, axis] = v
        return coords, (flags & _ON_CURVE).astype(bool), tuple(int(e) for e in ends)

    def _components(self, b: bytes):
        comps = []
        at = 10
        while True:
            flags, g = struct.unpack_from(">HH", b, at)
            at += 4
            if flags & _ARG_WORDS:
                a1, a2 = struct.unpack_from(">hh" if flags & _ARGS_XY else ">HH", b, at)
                at += 4
            else:
                a1, a2 = struct.unpack_from(">bb" if flags & _ARGS_XY else ">BB", b, at)
                at += 2
            m = (1.0, 0.0, 0.0, 1.0)
            if flags & _SCALE:
                s = _f2dot14(struct.unpack_from(">h", b, at)[0])
                at += 2
                m = (s, 0.0, 0.0, s)
            elif flags & _XY_SCALE:
                sx, sy = struct.unpack_from(">hh", b, at)
                at += 4
                m = (_f2dot14(sx), 0.0, 0.0, _f2dot14(sy))
            elif flags & _TWO_BY_TWO:
                m = tuple(_f2dot14(v) for v in struct.unpack_from(">hhhh", b, at))
                at += 8
            comps.append((flags, g, a1, a2, m))
            if not flags & _MORE:
                return comps

    def _tuples(self, glyph: int, n_pts: int):
        """The gvar tuples of ``glyph`` (``n_pts`` points with the four
        phantom ones): for each, its (start, peak, end) F2Dot14 rows, the
        raw deltas as an (n_pts, 2) int array and the mask of the points it
        names (all where it names none)."""
        gv = self._gvar
        if gv is None:
            return
        start, stop = gv["offs"][glyph], gv["offs"][glyph + 1]
        if start == stop:
            return
        b = self.data
        count_word, data_off = struct.unpack_from(">HH", b, start)
        at = start + 4
        ser = start + data_off
        axis_n = len(self.axes)
        shared_pts = None
        if count_word & _SHARED_POINTS:
            shared_pts, ser = _read_points(b, ser, n_pts)
        for _ in range(count_word & _COUNT_MASK):
            size, index = struct.unpack_from(">HH", b, at)
            at += 4
            if index & _EMBEDDED_PEAK:
                peak = self._array(at, axis_n, ">i2")
                at += 2 * axis_n
            else:
                peak = gv["shared"][index & _TUPLE_INDEX]
            if index & _INTERMEDIATE:
                lo = self._array(at, axis_n, ">i2")
                hi = self._array(at + 2 * axis_n, axis_n, ">i2")
                at += 4 * axis_n
                intermediate = True
            else:
                lo, hi = np.minimum(peak, 0), np.maximum(peak, 0)
                intermediate = False
            body, ser = ser, ser + size
            pts = shared_pts
            if index & _PRIVATE_POINTS:
                pts, body = _read_points(b, body, n_pts)
            n = n_pts if pts is None else len(pts)
            dx, body = _read_deltas(b, body, n)
            dy, body = _read_deltas(b, body, n)
            idx = np.arange(n_pts) if pts is None else pts
            keep = idx < n_pts
            d = np.zeros((n_pts, 2), np.int64)
            d[idx[keep], 0] = dx[keep]
            d[idx[keep], 1] = dy[keep]
            touched = np.zeros(n_pts, bool)
            touched[idx[keep]] = True
            yield (lo, peak, hi, intermediate), d, touched

    def _deltas(self, glyph: int, coords: np.ndarray, ends: Sequence[int],
                norm: Sequence[int], iup: bool) -> np.ndarray:
        """The gvar deltas of ``coords`` (the glyph's points, then its four
        phantom points) at F2Dot14 ``norm``, summed over the glyph's
        tuples in f64 as the OpenType specification states them."""
        total = np.zeros(coords.shape, np.float64)
        if not any(norm):
            return total
        v = np.asarray(norm, np.float64) / 16384.0
        n_out = len(coords) - 4
        for (lo, peak, hi, _), d, touched in self._tuples(glyph, len(coords)):
            s = _region_scalar(v, lo / 16384.0, peak / 16384.0, hi / 16384.0)
            if s == 0.0:
                continue
            d = d.astype(np.float64)
            if iup and not touched[:n_out].all():
                d[:n_out] = _iup(coords[:n_out].astype(np.float64), d[:n_out],
                                 touched[:n_out], ends)
            total += s * d
        return total

    def glyph(self, glyph: int, norm: Sequence[int] = ()) -> Glyph:
        """The outline of ``glyph`` at F2Dot14 ``norm`` (see
        :meth:`normalize`), composites resolved, in font units, as the
        OpenType specification computes it (f64 deltas and IUP)."""
        return self._glyph(int(glyph), tuple(int(v) for v in norm), 0)

    def glyph_opencv(self, glyph: int, norm: Sequence[int] = ()) -> Glyph:
        """The outline of simple ``glyph`` at F2Dot14 ``norm`` as OpenCV 5's
        TrueType reader builds it: each tuple's scalar in 16.16 fixed
        point, its IUP deltas truncated to integers, each delta times the
        scalar floored to 1/256 and summed, and every point floored to an
        integer.  ``points`` are integers (f64); ``advance`` is the
        ``hmtx`` advance plus the floored deltas of the phantom points.  A
        composite glyph raises ValueError."""
        glyph = int(glyph)
        b = self._glyph_bytes(glyph)
        adv, lsb = int(self.advances[glyph]), int(self.lsbs[glyph])
        if len(b) == 0:
            return Glyph(np.zeros((0, 2)), np.zeros(0, bool), (), float(adv), float(lsb),
                         (0, 0, 0, 0))
        n_contours = struct.unpack_from(">h", b, 0)[0]
        bbox = struct.unpack_from(">hhhh", b, 2)
        if n_contours < 0:
            raise ValueError(f"glyph {glyph} is a composite glyph")
        coords, on, ends = self._simple(b, n_contours)
        phantom = np.array([[bbox[0] - lsb, 0], [bbox[0] - lsb + adv, 0], [0, 0], [0, 0]], np.int64)
        allc = np.concatenate([coords, phantom])
        acc = np.zeros(allc.shape, np.int64)  # in 1/256 units
        n_out = len(coords)
        if any(norm):
            for region, d, touched in self._tuples(glyph, len(allc)):
                s = _fixed_scalar(norm, region[:3], region[3])
                if s == 0:
                    continue
                if not touched[:n_out].all():
                    d[:n_out] = _iup(coords, d[:n_out], touched[:n_out], ends, truncate=True)
                acc += (d * s) >> 8
        pts = allc + (acc >> 8)
        ph = pts[-4:]
        return Glyph(pts[:-4].astype(np.float64), on, ends, float(ph[1, 0] - ph[0, 0]),
                     float(bbox[0] - ph[0, 0]), bbox)

    def _glyph(self, glyph: int, norm: Tuple[int, ...], depth: int) -> Glyph:
        if depth > _MAX_COMPOSITE_DEPTH:
            raise ValueError(f"composite glyphs nest deeper than {_MAX_COMPOSITE_DEPTH}")
        b = self._glyph_bytes(glyph)
        adv, lsb = int(self.advances[glyph]), int(self.lsbs[glyph])
        if len(b) == 0:
            n_contours, bbox = 0, (0, 0, 0, 0)
        else:
            n_contours = struct.unpack_from(">h", b, 0)[0]
            bbox = struct.unpack_from(">hhhh", b, 2)
        x_min = bbox[0]
        # phantom points: left side bearing origin, advance, top, bottom
        phantom = np.array([[x_min - lsb, 0], [x_min - lsb + adv, 0], [0, 0], [0, 0]], np.int64)
        if n_contours >= 0:
            if n_contours:
                coords, on, ends = self._simple(b, n_contours)
            else:
                coords, on, ends = np.zeros((0, 2), np.int64), np.zeros(0, bool), ()
            allc = np.concatenate([coords, phantom])
            pts = allc + self._deltas(glyph, allc, ends, norm, iup=True)
            ph = pts[-4:]
            return Glyph(pts[:-4], on, ends, float(ph[1, 0] - ph[0, 0]),
                         float(x_min - ph[0, 0]), bbox)
        comps = self._components(b)
        offs = np.array([[c[2], c[3]] if c[0] & _ARGS_XY else [0, 0] for c in comps], np.int64)
        allc = np.concatenate([offs, phantom])
        varied = allc + self._deltas(glyph, allc, (), norm, iup=False)
        points: List[np.ndarray] = []
        ons: List[np.ndarray] = []
        ends_all: List[int] = []
        n_done = 0
        for k, (flags, g, a1, a2, m) in enumerate(comps):
            sub = self._glyph(g, norm, depth + 1)
            mat = np.array([[m[0], m[1]], [m[2], m[3]]], np.float64)
            p = sub.points @ mat
            if flags & _ARGS_XY:
                off = varied[k]
                if flags & _SCALED_OFFSET:
                    off = off @ mat
            else:  # point a1 of the glyph so far meets point a2 of this one
                done = np.concatenate(points) if points else np.zeros((0, 2))
                off = done[a1] - p[a2]
            points.append(p + off)
            ons.append(sub.on_curve)
            ends_all.extend(e + n_done for e in sub.ends)
            n_done += len(p)
        ph = varied[-4:]
        pts = np.concatenate(points) if points else np.zeros((0, 2))
        on = np.concatenate(ons) if ons else np.zeros(0, bool)
        return Glyph(pts, on, tuple(ends_all), float(ph[1, 0] - ph[0, 0]),
                     float(x_min - ph[0, 0]), bbox)


def _read_points(b: bytes, at: int, n_pts: int) -> Tuple[Optional[np.ndarray], int]:
    """gvar's packed point numbers at ``at``: None for "all points"."""
    n = b[at]
    at += 1
    if n & 0x80:
        n = ((n & 0x7F) << 8) | b[at]
        at += 1
    if n == 0:
        return None, at
    out = np.empty(n, np.int64)
    i = v = 0
    while i < n:
        c = b[at]
        at += 1
        run = (c & 0x7F) + 1
        if c & 0x80:
            vals = np.frombuffer(b, ">u2", run, at).astype(np.int64)
            at += 2 * run
        else:
            vals = np.frombuffer(b, np.uint8, run, at).astype(np.int64)
            at += run
        run = min(run, n - i)
        out[i:i + run] = v + np.cumsum(vals[:run])
        v = int(out[i + run - 1])
        i += run
    return out, at


def _read_deltas(b: bytes, at: int, n: int) -> Tuple[np.ndarray, int]:
    """gvar's packed deltas at ``at``: ``n`` values."""
    out = np.zeros(n, np.float64)
    i = 0
    while i < n:
        c = b[at]
        at += 1
        run = (c & 0x3F) + 1
        take = min(run, n - i)
        if c & 0x80:
            pass  # a run of zeros
        elif c & 0x40:
            out[i:i + take] = np.frombuffer(b, ">i2", run, at)[:take]
            at += 2 * run
        else:
            out[i:i + take] = np.frombuffer(b, np.int8, run, at)[:take]
            at += run
        i += run
    return out, at


@lru_cache(maxsize=None)
def load_font(path: str = RUBIK_PATH) -> Font:
    """The font at ``path``, read once a process."""
    with open(path, "rb") as f:
        return Font(f.read())
