"""H.264 streams for the port's H.264 decoder
(``caffe_rtpose_tpu_torch/csrc/h264_video.cpp`` behind ``pipeline/h264.py``)
and the results pinned for them (numpy and ``struct`` only, so that
``chip_smoke.py`` can load this module on a machine without OpenCV).

* A syntax writer (:class:`Writer`) that emits valid Constrained Baseline,
  Main and High profile bitstreams from a seed: SPS (frame cropping, POC
  types 0 and 2, VUI with the video range, timing and bitstream
  restriction), PPS, slices of I and P type (several a picture, each with
  its own QP, deblocking idc and offsets and CABAC init table; reference
  list modification; explicit weighted prediction; sliding-window and
  MMCO 1 marking; non-reference pictures), recovery point SEIs, streams
  that start on a non-IDR picture, and macroblocks of every I and P
  ``mb_type`` and sub-type: I_PCM, all 9 + 4 + 4 intra modes (only those
  whose neighbours are available), residual blocks with level escapes,
  ``mb_qp_delta`` wrapping through QP 0-51, and motion vector differences
  that reach every sub-pel phase and far out of the picture; B slices;
  High profile's 8x8 transform, Intra8x8, scaling lists in the SPS and
  the PPS and two chroma QP offsets.  Each element
  goes through a coder, CAVLC (:class:`Cavlc`) or CABAC (:class:`CabacCoder`:
  the arithmetic encoder of 9.3.4 and the context selection the decoder
  mirrors, from the decoder's own tables); the writer draws the same values
  whichever codes them, so a CABAC case and its CAVLC twin (:func:`twin`)
  are the same pictures.  The writer is no encoder: the pictures are what
  the syntax says, and FFmpeg (``cv2.VideoCapture``) is the judge of what
  they are.  It tracks what a valid stream needs: the coders' neighbour
  contexts, the intra mode predictors and neighbour availability, and the
  reference pictures.
* Muxers: MP4 and QuickTime (``avc1`` + ``avcC``, ``stss`` listing the key
  pictures, through ``mp4_cases.write_mp4``) and AVI (Annex B chunks,
  ``idx1`` with AVIIF_KEYFRAME on the key pictures, ``avi_cases.write_avi``).
* CASES, HIGH (High profile), REFUSED and HIGH_REFUSED (one stream a
  refusal) and PINNED: what the JAX package's reader
  (``cv2.VideoCapture`` in ``caffe_rtpose_tpu.pipeline.runner``) gives for
  each case.
* :func:`encode_clip`: the 8 1280x720 frames of ``jpeg_frames.frame`` coded
  as real pictures (the first row of macroblocks I_PCM, the rest
  Intra16x16 vertical, then P pictures predicted from the picture before);
  ``encode_clip(clip_frames(), 26)`` is ``tests/data/h264_720p.mp4`` and
  ``encode_clip(clip_frames(), 26, cabac=True)``
  ``tests/data/h264_cabac_720p.mp4`` and ``encode_clip(clip_frames(), 26,
  cabac=True, bframes=True)`` ``tests/data/h264_b_720p.mp4`` (I P B B with
  composition offsets) and ``encode_clip(clip_frames(), 26, cabac=True,
  bframes=True, high=True)`` ``tests/data/h264_high_720p.mp4`` (the same
  under High profile: Intra8x8 below the first row, the 8x8 transform in P
  and B), for chip_smoke's CLI run.

``tests/test_torch_h264.py`` and ``tests/test_torch_h264_high.py`` hold
PINNED against the JAX reader and the port; ``chip_smoke.py``'s video
phase holds the port on the card's host to them.
"""

import functools
import os
import re
import struct

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CLIP_SIZE = (74, 100)  # (h, w): coded as 112x80 and cropped
CLIP_FRAMES = 26
SEEKS = (0, 1, 3, 11, 12, 13, 20, 25, 26, 40)
CLIP_SEEKS = (0, 1, 3, 5)  # a 720p clip's: each seek decodes on from its IDR picture
READ_AFTER_SEEK = 3
CLIP_720P = os.path.join(DATA, "h264_720p.mp4")
CLIP_CABAC_720P = os.path.join(DATA, "h264_cabac_720p.mp4")
CLIP_B_720P = os.path.join(DATA, "h264_b_720p.mp4")
CLIP_HIGH_720P = os.path.join(DATA, "h264_high_720p.mp4")

# ------------------------------------------------------------ CAVLC tables
# H.264 Table 9-5 (coeff_token) by nC class 0 <= nC < 2, 2 <= nC < 4,
# 4 <= nC < 8, 8 <= nC, each indexed TotalCoeff * 4 + TrailingOnes, and
# for chroma DC (nC = -1); Tables 9-7 to 9-10 (total_zeros, run_before).
COEFF_TOKEN_LEN = (
    (1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8,
     13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15,
     15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16),
    (2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6,
     11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13,
     12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14),
    (4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4,
     7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9,
     10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10),
    (6,) * 68,
)
COEFF_TOKEN_BITS = (
    (1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4,
     11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8,
     15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8),
    (3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8,
     15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12,
     11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4),
    (15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10,
     9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12,
     8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2),
    (3, 0, 0, 0) + tuple((tc - 1) * 4 + t1 if t1 <= tc else 0
                         for tc in range(1, 17) for t1 in range(4)),
)
CHROMA_DC_COEFF_TOKEN_LEN = (2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7)
CHROMA_DC_COEFF_TOKEN_BITS = (1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0)
TOTAL_ZEROS_LEN = (
    (1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9), (3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6),
    (4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6), (5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5),
    (4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5), (6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6),
    (6, 5, 3, 3, 3, 2, 3, 4, 3, 6), (6, 4, 5, 3, 2, 2, 3, 3, 6), (6, 6, 4, 2, 2, 3, 2, 5),
    (5, 5, 3, 2, 2, 2, 4), (4, 4, 3, 3, 1, 3), (4, 4, 2, 1, 3), (3, 3, 1, 2), (2, 2, 1), (1, 1))
TOTAL_ZEROS_BITS = (
    (1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1), (7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0),
    (5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0), (3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0),
    (5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0), (1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0),
    (1, 1, 5, 4, 3, 3, 2, 1, 1, 0), (1, 1, 1, 3, 3, 2, 2, 1, 0), (1, 0, 1, 3, 2, 1, 1, 1),
    (1, 0, 1, 3, 2, 1, 1), (0, 1, 1, 2, 1, 3), (0, 1, 1, 1, 1), (0, 1, 1, 1), (0, 1, 1), (0, 1))
CHROMA_DC_TOTAL_ZEROS_LEN = ((1, 2, 3, 3), (1, 2, 2), (1, 1))
CHROMA_DC_TOTAL_ZEROS_BITS = ((1, 1, 1, 0), (1, 1, 0), (1, 0))
RUN_LEN = ((1, 1), (1, 2, 2), (2, 2, 2, 2), (2, 2, 2, 3, 3), (2, 2, 3, 3, 3, 3),
           (2, 3, 3, 3, 3, 3, 3), (3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11))
RUN_BITS = ((1, 0), (1, 1, 0), (3, 2, 1, 0), (3, 2, 1, 1, 0), (3, 2, 3, 2, 1, 0),
            (3, 0, 1, 3, 2, 5, 4), (7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1))
# coded_block_pattern's me(v) mapping (Table 9-4): codeNum -> cbp
INTRA_CBP = (47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46, 16, 3, 5, 10, 12,
             19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4, 8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33,
             34, 36, 40, 38, 41)
INTER_CBP = (0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13, 14, 6, 9, 31, 35, 37,
             42, 44, 33, 34, 36, 40, 39, 43, 45, 46, 17, 18, 20, 24, 19, 21, 26, 28, 23, 27,
             29, 30, 22, 25, 38, 41)
_INTRA_CODE = {c: i for i, c in enumerate(INTRA_CBP)}
_INTER_CODE = {c: i for i, c in enumerate(INTER_CBP)}
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)  # scan -> raster (y * 4 + x)


# ------------------------------------------------------------------- bits

class Bits:
    """An RBSP written MSB first."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def u(self, v: int, n: int) -> None:
        if n <= 0:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 255)
        self.acc &= (1 << self.n) - 1

    def ue(self, v: int) -> None:
        v += 1
        k = v.bit_length()
        self.u(0, k - 1)
        self.u(v, k)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, v: int, top: int) -> None:
        if top > 1:
            self.ue(v)
        else:
            self.u(1 - v, 1)

    def align(self) -> None:
        if self.n:
            self.u(0, 8 - self.n)

    def trailing(self) -> bytes:
        self.u(1, 1)
        self.align()
        return bytes(self.out)


def nal(ref_idc: int, typ: int, rbsp: bytes) -> bytes:
    """A NAL unit (header byte and emulation-prevention bytes)."""
    out, zeros = bytearray([ref_idc << 5 | typ]), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


# ----------------------------------------------------------- residuals

def _ctoken(nc: int):
    if nc == -1:
        return CHROMA_DC_COEFF_TOKEN_LEN, CHROMA_DC_COEFF_TOKEN_BITS
    k = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
    return COEFF_TOKEN_LEN[k], COEFF_TOKEN_BITS[k]


def residual_block(bw: Bits, coeffs, nc: int, seen=None) -> int:
    """One CAVLC residual block of ``coeffs`` (scan order, maxNumCoeff
    long); returns TotalCoeff.  ``seen`` collects the coeff_token table
    and the level_prefix escapes (14, 15) it writes."""
    maxnum = len(coeffs)
    coeffs = [int(c) for c in coeffs]
    nz = [i for i, c in enumerate(coeffs) if c]
    tc = len(nz)
    levels = [coeffs[i] for i in reversed(nz)]
    t1 = 0
    for lv in levels:
        if abs(lv) != 1 or t1 == 3:
            break
        t1 += 1
    lens, bits = _ctoken(nc)
    if seen is not None:
        seen.add(("coeff_token", -1 if nc == -1 else 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8
                  else 3))
    bw.u(bits[tc * 4 + t1], lens[tc * 4 + t1])
    if not tc:
        return 0
    suffix = 1 if tc > 10 and t1 < 3 else 0
    for i, lv in enumerate(levels):
        if i < t1:
            bw.u(lv < 0, 1)
            continue
        code = 2 * lv - 2 if lv > 0 else -2 * lv - 1
        if i == t1 and t1 < 3:
            code -= 2
        if suffix == 0:
            if code < 14:
                bw.u(1, code + 1)
            elif code < 30:
                if seen is not None:
                    seen.add(("level_prefix", 14))
                bw.u(1, 15)
                bw.u(code - 14, 4)
            else:
                assert code - 30 < 4096, lv
                if seen is not None:
                    seen.add(("level_prefix", 15))
                bw.u(1, 16)
                bw.u(code - 30, 12)
        elif code < 15 << suffix:
            bw.u(1, (code >> suffix) + 1)
            bw.u(code & ((1 << suffix) - 1), suffix)
        else:
            assert code - (15 << suffix) < 4096, lv
            if seen is not None:
                seen.add(("level_prefix", 15))
            bw.u(1, 16)
            bw.u(code - (15 << suffix), 12)
        if suffix == 0:
            suffix = 1
        if abs(lv) > 3 << (suffix - 1) and suffix < 6:
            suffix += 1
    zeros = nz[-1] + 1 - tc
    if tc < maxnum:
        if maxnum == 4:
            bw.u(CHROMA_DC_TOTAL_ZEROS_BITS[tc - 1][zeros],
                 CHROMA_DC_TOTAL_ZEROS_LEN[tc - 1][zeros])
        else:
            bw.u(TOTAL_ZEROS_BITS[tc - 1][zeros], TOTAL_ZEROS_LEN[tc - 1][zeros])
    pos = nz[::-1]
    for i in range(tc - 1):
        if zeros <= 0:
            break
        run = pos[i] - pos[i + 1] - 1
        k = min(zeros, 7) - 1
        bw.u(RUN_BITS[k][run], RUN_LEN[k][run])
        zeros -= run
    return tc


# ---------------------------------------------- the transforms' range
# 8.5.10-8.5.12: a conforming stream keeps every scaled coefficient and
# every intermediate of the inverse transforms within 16 bits (FFmpeg
# stores them as int16); the writer keeps a margin for the rounding term.
NORM_ADJUST = ((10, 16, 13), (11, 18, 14), (13, 20, 16), (14, 23, 18), (16, 25, 20),
               (18, 29, 23))
CHROMA_QP = tuple(range(30)) + (29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37,
                                 38, 38, 38, 39, 39, 39, 39)
_LIMIT = 32000


def _in_range(*vals) -> bool:
    return all(-_LIMIT <= v <= _LIMIT for v in vals)


def block_fits(levels, q: int, dc=None, scale=None) -> bool:
    """Whether a 4x4 block of ``levels`` (16 in scan order; with ``dc``,
    the scaled DC replaces the first) stays in range at QP ``q`` under the
    scaling list ``scale`` (raster; None: Flat_16)."""
    # each 1-D pass's outputs are at most the sum of its inputs' magnitudes
    wmax = 16 if scale is None else max(scale)
    bound = int(np.abs(np.asarray(levels[dc is not None:])).sum()) * \
        (((29 * wmax << (q // 6)) + 15) // 16)
    if bound + abs(dc or 0) <= _LIMIT:
        return True
    d = [0] * 16
    for i, lv in enumerate(levels):
        r = ZIGZAG[i]
        if i == 0 and dc is not None:
            d[r] = dc
            continue
        x, y = r & 3, r >> 2
        k = 0 if not (x & 1 or y & 1) else 1 if x & 1 and y & 1 else 2
        w = 16 if scale is None else scale[r]
        d[r] = (int(lv) * (w * NORM_ADJUST[q % 6][k] << (q // 6)) + 8) >> 4
    if not _in_range(*d):
        return False
    for y in range(4):
        r = d[4 * y:4 * y + 4]
        e = (r[0] + r[2], r[0] - r[2], (r[1] >> 1) - r[3], r[1] + (r[3] >> 1))
        d[4 * y:4 * y + 4] = (e[0] + e[3], e[1] + e[2], e[1] - e[2], e[0] - e[3])
        if not _in_range(*e, *d[4 * y:4 * y + 4]):
            return False
    for x in range(4):
        c = d[x::4]
        g = (c[0] + c[2], c[0] - c[2], (c[1] >> 1) - c[3], c[1] + (c[3] >> 1))
        if not _in_range(*g, g[0] + g[3], g[1] + g[2], g[1] - g[2], g[0] - g[3]):
            return False
    return True


def luma_dc(levels, q: int, w00: int = 16):
    """The scaled Intra16x16 DCs (raster) of DC ``levels`` (scan order), or
    None where the Hadamard leaves the range; ``w00``: the intra Y list's
    first weight."""
    c = [0] * 16
    for i, lv in enumerate(levels):
        c[ZIGZAG[i]] = int(lv)
    h = ((1, 1, 1, 1), (1, 1, -1, -1), (1, -1, -1, 1), (1, -1, 1, -1))
    f = [sum(h[i][k] * c[4 * k + l] * h[l][j] for k in range(4) for l in range(4))
         for i in range(4) for j in range(4)]
    ls = w00 * NORM_ADJUST[q % 6][0]
    out = [(v * ls) << (q // 6 - 6) if q >= 36 else (v * ls + (1 << (5 - q // 6))) >> (6 - q // 6)
           for v in f]
    return out if _in_range(*f, *out) else None


def chroma_dc(levels, qc: int, w00: int = 16):
    """The scaled chroma DCs of the 2x2 DC ``levels``, or None out of range."""
    c0, c1, c2, c3 = (int(v) for v in levels)
    f = (c0 + c1 + c2 + c3, c0 - c1 + c2 - c3, c0 + c1 - c2 - c3, c0 - c1 - c2 + c3)
    out = [((v * w00 * NORM_ADJUST[qc % 6][0]) << (qc // 6)) >> 5 for v in f]
    return out if _in_range(*f, *out) else None


# 8.5.13: the 8x8 blocks.  ZIGZAG8: scan position -> raster (y * 8 + x);
# normAdjust8x8 by QP % 6 and the position class of (y % 4, x % 4).
ZIGZAG8 = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
           27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
           44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
NORM_ADJUST8 = ((20, 18, 32, 19, 25, 24), (22, 19, 35, 21, 28, 26), (26, 23, 42, 24, 33, 31),
                (28, 25, 45, 26, 35, 33), (32, 28, 51, 30, 40, 38), (36, 32, 58, 34, 46, 43))
_CLASS8 = ((0, 3, 4, 3), (3, 1, 5, 1), (4, 5, 2, 5), (3, 1, 5, 1))


def dequant8(levels, q: int, scale=None):
    """The scaled coefficients (raster 8x8) of an 8x8 block's ``levels``
    (64 in scan order) under the scaling list ``scale`` (raster; None:
    Flat_16): (c * LevelScale8x8 << q / 6 + 32) >> 6."""
    d = [0] * 64
    for i, lv in enumerate(levels):
        if lv:
            r = ZIGZAG8[i]
            w = 16 if scale is None else scale[r]
            ls = w * NORM_ADJUST8[q % 6][_CLASS8[(r >> 3) & 3][r & 3]]
            d[r] = (int(lv) * (ls << (q // 6)) + 32) >> 6
    return d


def idct8_pass(v):
    """One 1-D pass of the 8x8 inverse transform (8.5.13.2) over 8 values:
    the outputs, or None where the magnitudes of an intermediate's terms sum
    past the range (FFmpeg's SIMD transform adds them in 16 bits, in its
    own order)."""
    d0, d1, d2, d3, d4, d5, d6, d7 = v
    terms = ((d0, d4), (d0, -d4), (d2 >> 1, -d6), (d2, d6 >> 1), (-d3, d5, -d7, -(d7 >> 1)),
             (d1, d7, -d3, -(d3 >> 1)), (-d1, d7, d5, d5 >> 1), (d3, d5, d1, d1 >> 1))
    if any(sum(abs(t) for t in ts) > _LIMIT for ts in terms):
        return None
    a0, a4, a2, a6, a1, a3, a5, a7 = (sum(ts) for ts in terms)
    pairs = ((a0, a6), (a4, a2), (a4, -a2), (a0, -a6), (a1, a7 >> 2), (a7, -(a1 >> 2)),
             (a3, a5 >> 2), (a3 >> 2, -a5))
    if any(abs(x) + abs(y) > _LIMIT for x, y in pairs):
        return None
    b0, b2, b4, b6, b1, b7, b3, b5 = (x + y for x, y in pairs)
    outs = ((b0, b7), (b2, b5), (b4, b3), (b6, b1), (b6, -b1), (b4, -b3), (b2, -b5), (b0, -b7))
    if any(abs(x) + abs(y) > _LIMIT for x, y in outs):
        return None
    return [x + y for x, y in outs]


def block8_fits(levels, q: int, scale=None) -> bool:
    """Whether an 8x8 block of ``levels`` (64 in scan order) keeps its
    scaled coefficients and every intermediate of the inverse transform
    within 16 bits at QP ``q`` under ``scale``."""
    wmax = 16 if scale is None else max(scale)
    # the terms of a pass sum to at most 4 times its inputs' magnitudes
    bound = int(np.abs(np.asarray(levels)).sum()) * (((58 * wmax << (q // 6)) + 63) // 64 + 1)
    if 16 * bound <= _LIMIT:
        return True
    d = dequant8(levels, q, scale)
    if not _in_range(*d):
        return False
    rows = [idct8_pass(d[8 * y:8 * y + 8]) for y in range(8)]
    if any(r is None for r in rows):
        return False
    return all(idct8_pass([rows[y][x] for y in range(8)]) is not None for x in range(8))


def idct8(d):
    """8.5.13.2 on (..., 8, 8) int64 arrays: rows, then columns, (x + 32) >> 6."""
    d = np.asarray(d, np.int64)
    for axis in (-1, -2):
        v = [np.take(d, k, axis) for k in range(8)]
        a0, a4 = v[0] + v[4], v[0] - v[4]
        a2, a6 = (v[2] >> 1) - v[6], v[2] + (v[6] >> 1)
        a1 = -v[3] + v[5] - v[7] - (v[7] >> 1)
        a3 = v[1] + v[7] - v[3] - (v[3] >> 1)
        a5 = -v[1] + v[7] + v[5] + (v[5] >> 1)
        a7 = v[3] + v[5] + v[1] + (v[1] >> 1)
        b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
        b1, b7, b3, b5 = a1 + (a7 >> 2), a7 - (a1 >> 2), a3 + (a5 >> 2), (a3 >> 2) - a5
        d = np.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5, b0 - b7], axis)
    return (d + 32) >> 6


# ------------------------------------------------------- scaling matrices
# Tables 7-3 and 7-4 (raster): Default_4x4_Intra/Inter, Default_8x8_Intra/Inter
DEFAULT4 = ((6, 13, 20, 28, 13, 20, 28, 32, 20, 28, 32, 37, 28, 32, 37, 42),
            (10, 14, 20, 24, 14, 20, 24, 27, 20, 24, 27, 30, 24, 27, 30, 34))
DEFAULT8 = ((6, 10, 13, 16, 18, 23, 25, 27, 10, 11, 16, 18, 23, 25, 27, 29, 13, 16, 18, 23, 25, 27,
             29, 31, 16, 18, 23, 25, 27, 29, 31, 33, 18, 23, 25, 27, 29, 31, 33, 36, 23, 25, 27,
             29, 31, 33, 36, 38, 25, 27, 29, 31, 33, 36, 38, 40, 27, 29, 31, 33, 36, 38, 40, 42),
            (9, 13, 15, 17, 19, 21, 22, 24, 13, 13, 17, 19, 21, 22, 24, 25, 15, 17, 19, 21, 22, 24,
             25, 27, 17, 19, 21, 22, 24, 25, 27, 28, 19, 21, 22, 24, 25, 27, 28, 30, 21, 22, 24,
             25, 27, 28, 30, 32, 22, 24, 25, 27, 28, 30, 32, 33, 24, 25, 27, 28, 30, 32, 33, 35))
FLAT4, FLAT8 = (16,) * 16, (16,) * 64


def write_scaling_lists(bw: Bits, spec, seen=None) -> None:
    """scaling_list_present_flag and each list of ``spec`` (6 4x4 lists, then
    the 8x8 ones): None absent (its fall-back), "default"
    (useDefaultScalingMatrixFlag: a first delta_scale that makes nextScale
    0), or the weights in zigzag order, whose tail of repeats of the weight
    before it ends on a nextScale of 0."""
    for i, entry in enumerate(spec):
        bw.u(entry is not None, 1)
        if entry is None:
            continue
        if entry == "default":
            bw.se(-8)
            continue
        vals = list(entry)
        end = len(vals)
        while end > 1 and vals[end - 1] == vals[end - 2]:
            end -= 1
        last = 8
        for v in vals[:end]:
            bw.se((v - last + 128) % 256 - 128)
            last = v
        if end < len(vals):
            bw.se((-last + 128) % 256 - 128)  # nextScale 0: the rest repeat the last
            if seen is not None:
                seen.add(("scaling", "repeat"))


def scaling_matrices(spec, seq=None):
    """The 6 4x4 and 2 8x8 lists (raster) a parameter set's ``spec`` gives
    (None: no scaling_matrix_present_flag; then an SPS has Flat_16 and a PPS
    its SPS's): an absent list falls back under rule A (SPS, or a PPS whose
    SPS has no lists: Default_* for lists 0, 3, 6 and 7) or rule B (the
    SPS's), each other 4x4 list to the one before.  ``seq``: the SPS's
    (lists, whether it has them), for a PPS; a PPS spec of 6 leaves the 8x8
    lists the SPS's."""
    if spec is None:
        return seq[0] if seq else ([FLAT4] * 6 + [FLAT8] * 2)
    rule_b = bool(seq and seq[1])
    out = []
    for i in range(6):
        entry = spec[i]
        if entry is None:
            out.append((seq[0][i] if rule_b else DEFAULT4[i // 3]) if i % 3 == 0 else out[i - 1])
        elif entry == "default":
            out.append(DEFAULT4[i // 3])
        else:
            out.append(tuple(entry[ZIGZAG.index(r)] for r in range(16)))
    for k in range(2):
        entry = spec[6 + k] if len(spec) > 6 else "keep"
        if entry == "keep":
            out.append(seq[0][6 + k] if seq else FLAT8)
        elif entry is None:
            out.append(seq[0][6 + k] if rule_b else DEFAULT8[k])
        elif entry == "default":
            out.append(DEFAULT8[k])
        else:
            out.append(tuple(entry[ZIGZAG8.index(r)] for r in range(64)))
    return out


# ------------------------------------------------------------------ CABAC

def _cabac_tables():
    """rangeTabLPS, transIdxLPS and the (m, n) pairs (by [I, idc 0, 1, 2]
    and ctxIdx) of the decoder's header, read from its text."""
    path = os.path.join(os.path.dirname(DATA), os.pardir, "caffe_rtpose_tpu_torch", "csrc",
                        "h264_cabac_tables.h")
    with open(path) as f:
        text = re.sub(r"//[^\n]*", "", f.read())

    def ints(name):
        return [int(v) for v in re.findall(r"-?\d+", text.split(name)[1].split("};")[0][1:])]

    rng, lps, init = ints("kRangeLps[64][4] ="), ints("kTransLps[64] ="), \
        ints("kInit[4][kCtxCount][2] =")
    n = int(re.search(r"kCtxCount = (\d+);", text).group(1))
    return ([rng[4 * i:4 * i + 4] for i in range(64)], lps,
            [[(init[2 * n * t + 2 * c], init[2 * n * t + 2 * c + 1]) for c in range(n)]
             for t in range(4)])


RANGE_LPS, TRANS_LPS, CABAC_INIT = _cabac_tables()
# ctxBlockCatOffset of coded_block_flag, the significance maps and
# coeff_abs_level_minus1 (Table 9-40), by ctxBlockCat 0-4
CBF_OFFSET, SIG_OFFSET, ABS_OFFSET = (0, 4, 8, 12, 16), (0, 15, 29, 44, 47), (0, 10, 20, 30, 39)
# Table 9-43 (frame-coded): ctxIdxInc of significant_coeff_flag and
# last_significant_coeff_flag of an 8x8 block (ctxBlockCat 5) by scan position
SIG8 = (0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5, 4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8,
        7, 7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11, 12, 13, 11, 6, 9, 14, 10, 9, 11,
        12, 13, 11, 14, 10, 12)
LAST8 = (0,) + (1,) * 15 + (2,) * 16 + (3,) * 8 + (4,) * 8 + (5,) * 4 + (6,) * 4 + (7,) * 4 + (8,) * 3


class CabacEncoder:
    """The arithmetic encoder of 9.3.4 writing into a Bits (byte aligned
    when it starts), and the context variables ((pStateIdx << 1) | valMPS)."""

    def __init__(self, bw: Bits, table: int, qp: int):
        self.bw = bw
        q = min(max(qp, 0), 51)
        self.state = []
        for m, n in CABAC_INIT[table]:
            pre = min(max(((m * q) >> 4) + n, 1), 126)
            self.state.append((63 - pre) << 1 if pre <= 63 else (pre - 64) << 1 | 1)
        self.restart()

    def restart(self) -> None:
        self.low, self.range, self.outstanding, self.first = 0, 510, 0, True

    def _put(self, b: int) -> None:
        if self.first:
            self.first = False
        else:
            self.bw.u(b, 1)
        while self.outstanding:
            self.bw.u(1 - b, 1)
            self.outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, b) -> None:
        st = self.state[ctx]
        s, mps = st >> 1, st & 1
        lps = RANGE_LPS[s][(self.range >> 6) & 3]
        self.range -= lps
        if int(b) != mps:
            self.low += self.range
            self.range = lps
            if s == 0:
                mps = 1 - mps
            s = TRANS_LPS[s]
        elif s < 62:
            s += 1
        self.state[ctx] = s << 1 | mps
        self._renorm()

    def bypass(self, b) -> None:
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, b) -> None:
        """A bin of end_of_slice_flag or I_PCM; 1 flushes (the last bit
        written is then the rbsp_stop_one_bit, or the bit before
        pcm_alignment_zero_bit)."""
        self.range -= 2
        if not b:
            self._renorm()
            return
        self.low += self.range
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.bw.u(((self.low >> 7) & 3) | 1, 2)

    def eg(self, v: int, k: int) -> None:
        """The k-th order Exp-Golomb suffix of UEGk, in bypass bins."""
        while v >= 1 << k:
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((v >> k) & 1)


class _Coder:
    """What a macroblock's syntax elements are written with: CAVLC
    (:class:`Cavlc`) or CABAC (:class:`CabacCoder`).  The writer draws the
    same values from its random stream whichever codes them; the coder
    keeps the neighbour state each needs in ``st`` (a :class:`Writer`).
    ``p_slice``: an inter slice (P or B); ``b_slice``: a B slice."""

    def __init__(self, st, bw: Bits, p_slice: bool, b_slice: bool = False):
        self.st, self.bw, self.p_slice, self.b_slice = st, bw, p_slice, b_slice

    def _ref_state(self, m, x, y, pw, ph, r, l=0) -> None:
        for j in range(y // 4, (y + ph) // 4):
            for i in range(x // 4, (x + pw) // 4):
                self.st.refidx_l[l][m][j * 4 + i] = r


class Cavlc(_Coder):
    codes_p8x8ref0 = True

    def __init__(self, st, bw, p_slice, b_slice=False):
        super().__init__(st, bw, p_slice, b_slice)
        self.run = 0

    def skip(self, m) -> None:
        self.run += 1

    def mb_start(self, m) -> None:
        if self.p_slice:
            self.bw.ue(self.run)
            self.run = 0

    def mb_end(self, m, last) -> None:
        pass

    def finish(self) -> bytes:
        if self.run:
            self.bw.ue(self.run)
        return self.bw.trailing()

    def mb_type_i(self, m, t) -> None:
        self.bw.ue(t + (23 if self.b_slice else 5 if self.p_slice else 0))

    def pcm(self, data: bytes) -> None:
        self.bw.align()
        self.bw.out += data

    def mb_type_p(self, m, t) -> None:
        self.bw.ue(t)

    mb_type_b = mb_type_p

    def sub_mb_type(self, sb) -> None:
        self.bw.ue(sb)

    def i4_mode(self, pred, mode) -> None:
        self.bw.u(mode == pred, 1)
        if mode != pred:
            self.bw.u(mode if mode < pred else mode - 1, 3)

    def chroma_mode(self, m, cmode) -> None:
        self.st.cmode[m] = cmode
        self.bw.ue(cmode)

    def cbp(self, m, cbp, intra) -> None:
        self.st.cbp[m] = cbp
        self.bw.ue((_INTRA_CODE if intra else _INTER_CODE)[cbp])

    def qp_delta(self, d) -> None:
        self.bw.se(d)

    def ref(self, m, x, y, pw, ph, r, active, l=0) -> None:
        self._ref_state(m, x, y, pw, ph, r, l)
        if active > 1:
            self.bw.te(r, active - 1)

    def mvd(self, m, x, y, pw, ph, c, v, l=0) -> None:
        self.bw.se(v)

    def block(self, m, cat, x, y, c, coeffs) -> int:
        nc = -1 if cat == 3 else self.st._nc(m, x, y, c if cat == 4 else None)
        tc = residual_block(self.bw, coeffs, nc, self.st.seen)
        if tc and cat in (0, 3):
            self.st.dcf[m] |= 1 if cat == 0 else 2 << c
        return tc

    def transform8(self, m, flag) -> None:
        self.st.t8[m] = flag
        self.st.seen.add(("transform_size_8x8_flag", self.st.kind[m] == "i4", flag))
        self.bw.u(flag, 1)

    def block8(self, m, b8, coeffs) -> None:
        """An 8x8 block (64 in scan order) as four interleaved 4x4 blocks:
        coefficient k of the i-th is at 4k + i; each has its own nC and
        TotalCoeff."""
        for i4 in range(4):
            bx, by = _blk_xy(4 * b8 + i4)
            self.st.tcl[m][by * 4 + bx] = residual_block(
                self.bw, coeffs[i4::4], self.st._nc(m, bx, by, None), self.st.seen)


class CabacCoder(_Coder):
    codes_p8x8ref0 = False  # no binarization: P_8x8 with every ref_idx 0 instead

    def __init__(self, st, bw, p_slice, idc, qp, b_slice=False):
        super().__init__(st, bw, p_slice, b_slice)
        while bw.n:  # cabac_alignment_one_bit
            bw.u(1, 1)
        self.e = CabacEncoder(bw, 1 + idc if p_slice else 0, qp)
        self.last_dqp = self.dqp = 0

    def _ab(self, m):
        return self.st._nb(m, -1, 0), self.st._nb(m, 0, -1)

    def _skip_flag(self, m, b) -> None:
        self.e.decision((24 if self.b_slice else 11) + sum(
            n is not None and self.st.kind[n] != "skip" for n in self._ab(m)), b)

    def skip(self, m) -> None:
        self._skip_flag(m, 1)
        self.dqp = 0

    def mb_start(self, m) -> None:
        self.dqp = 0
        if self.p_slice:
            self._skip_flag(m, 0)

    def mb_end(self, m, last) -> None:
        self.last_dqp = self.dqp
        self.e.terminate(last)

    def finish(self) -> bytes:
        self.bw.align()
        return bytes(self.bw.out)

    def mb_type_i(self, m, t) -> None:
        e, st = self.e, self.st
        if self.b_slice:  # the prefix 1 1 1 1 0 1, then the suffix from ctxIdxOffset 32
            self._b_prefix(m, 13)
            base, k, i = 32, 33, 0
            ctx = 32
        elif self.p_slice:
            e.decision(14, 1)
            base, k, i = 17, 18, 0
            ctx = 17
        else:
            base, k, i = 3, 6, 1
            ctx = 3 + sum(n is not None and st.kind[n] != "i4" for n in self._ab(m))
        e.decision(ctx, t != 0)
        if t == 0:
            return
        e.terminate(t == 25)
        if t == 25:
            st.seen.add(("cabac I_PCM", self.p_slice))
            return
        u = t - 1
        pred, cbp_c, luma = u % 4, u // 4 % 3, u >= 12
        e.decision(k, luma)
        e.decision(k + 1, cbp_c != 0)
        if cbp_c:
            e.decision(k + 1 + i, cbp_c == 2)
        e.decision(k + 2 + i, pred >> 1)
        e.decision(k + 2 + 2 * i, pred & 1)

    def pcm(self, data: bytes) -> None:
        self.bw.align()
        self.bw.out += data
        self.e.restart()

    def _b_prefix(self, m, bits, extra=None) -> None:
        """The bins of a B mb_type (Table 9-37) from the third on, after
        1 1: four bits (ctxIdx 31, then 32), and a fifth for types 12-21."""
        e = self.e
        self._b_first(m, 1)
        e.decision(30, 1)
        e.decision(31, bits >> 3 & 1)
        for k in (2, 1, 0):
            e.decision(32, bits >> k & 1)
        if extra is not None:
            e.decision(32, extra)

    def _b_first(self, m, b) -> None:
        st = self.st
        self.e.decision(27 + sum(n is not None and not st.direct[n] & 16 for n in self._ab(m)), b)

    def mb_type_b(self, m, t) -> None:
        """B mb_types 0-22 (FFmpeg's decode_cabac_mb_type_b's bins)."""
        e = self.e
        if t == 0:
            self._b_first(m, 0)
        elif t <= 2:
            self._b_first(m, 1)
            e.decision(30, 0)
            e.decision(32, t == 2)
        elif t <= 10:
            self._b_prefix(m, t - 3)
        elif t in (11, 22):
            self._b_prefix(m, 14 if t == 11 else 15)
        else:
            self._b_prefix(m, (t + 4) >> 1, (t + 4) & 1)

    def mb_type_p(self, m, t) -> None:
        assert t < 4, "P_8x8ref0 has no CABAC binarization"
        e = self.e
        e.decision(14, 0)
        if t in (0, 3):
            e.decision(15, 0)
            e.decision(16, t == 3)
        else:
            e.decision(15, 1)
            e.decision(17, t == 1)

    def sub_mb_type(self, sb) -> None:
        e = self.e
        if self.b_slice:  # Table 9-38's B binarization
            e.decision(36, sb != 0)
            if not sb:
                return
            e.decision(37, sb > 2)
            if sb <= 2:
                e.decision(39, sb == 2)
                return
            e.decision(38, sb >= 7)
            if sb >= 11:
                e.decision(39, 1)
                e.decision(39, sb == 12)
                return
            v = sb - 7 if sb >= 7 else sb - 3
            if sb >= 7:
                e.decision(39, 0)
            e.decision(39, v >> 1)
            e.decision(39, v & 1)
            return
        e.decision(21, sb == 0)
        if sb:
            e.decision(22, sb != 1)
            if sb != 1:
                e.decision(23, sb == 2)

    def i4_mode(self, pred, mode) -> None:
        self.e.decision(68, mode == pred)
        if mode != pred:
            rem = mode if mode < pred else mode - 1
            for k in range(3):
                self.e.decision(69, (rem >> k) & 1)

    def chroma_mode(self, m, cmode) -> None:
        st = self.st
        st.cmode[m] = cmode
        ctx = 64 + sum(n is not None and st.kind[n] in ("i4", "i16") and st.cmode[n] != 0
                       for n in self._ab(m))
        self.e.decision(ctx, cmode != 0)
        if cmode:
            self.e.decision(67, cmode != 1)
            if cmode != 1:
                self.e.decision(67, cmode == 3)

    def cbp(self, m, cbp, intra) -> None:
        st, e = self.st, self.e
        st.cbp[m] = cbp
        a, b = self._ab(m)

        def luma(n, b8):
            if n is None or st.kind[n] == "pcm":
                return 0
            return int(st.kind[n] == "skip" or not (st.cbp[n] >> b8) & 1)

        def cur(b8):
            return int(not (cbp >> b8) & 1)

        e.decision(73 + luma(a, 1) + 2 * luma(b, 2), cbp & 1)
        e.decision(73 + cur(0) + 2 * luma(b, 3), (cbp >> 1) & 1)
        e.decision(73 + luma(a, 3) + 2 * cur(0), (cbp >> 2) & 1)
        e.decision(73 + cur(2) + 2 * cur(1), (cbp >> 3) & 1)

        def chroma(n, bin_):
            if n is None or st.kind[n] == "skip":
                return 0
            if st.kind[n] == "pcm":
                return 1
            c = st.cbp[n] >> 4
            return int(c == 2 if bin_ else c != 0)

        e.decision(77 + chroma(a, 0) + 2 * chroma(b, 0), cbp >> 4 != 0)
        if cbp >> 4:
            e.decision(81 + chroma(a, 1) + 2 * chroma(b, 1), cbp >> 4 == 2)

    def qp_delta(self, d) -> None:
        e = self.e
        self.dqp = d
        v = 2 * d - 1 if d > 0 else -2 * d
        e.decision(60 + (self.last_dqp != 0), v > 0)
        if v:
            for k in range(1, v):
                e.decision(62 if k == 1 else 63, 1)
            e.decision(62 if v == 1 else 63, 0)

    def ref(self, m, x, y, pw, ph, r, active, l=0) -> None:
        st, refidx = self.st, self.st.refidx_l[l]

        def at(xx, yy):  # a partition in direct mode counts as 0
            if xx >= 0 and yy >= 0:
                return refidx[m][(yy // 4) * 4 + xx // 4]
            n = st._nb(m, -1 if xx < 0 else 0, -1 if yy < 0 else 0)
            if n is None or st.kind[n] != "p":
                return 0
            bx, by = (xx % 16) // 4, (yy % 16) // 4
            if st.direct[n] >> ((by // 2) * 2 + bx // 2) & 1:
                return 0
            return refidx[n][by * 4 + bx]

        if active > 1:
            ctx = int(at(x - 1, y) > 0) + 2 * int(at(x, y - 1) > 0)
            self.e.decision(54 + ctx, r > 0)
            if r:
                c = 4
                for _ in range(1, r):
                    self.e.decision(54 + c, 1)
                    c = 5
                self.e.decision(54 + c, 0)
        self._ref_state(m, x, y, pw, ph, r, l)

    def _amvd(self, m, x, y, c, l):
        amvd = self.st.amvd_l[l]
        if x >= 0 and y >= 0:
            return amvd[m][(y // 4) * 4 + x // 4][c]
        n = self.st._nb(m, -1 if x < 0 else 0, -1 if y < 0 else 0)
        return 0 if n is None else amvd[n][((y % 16) // 4) * 4 + (x % 16) // 4][c]

    def mvd(self, m, x, y, pw, ph, c, v, l=0) -> None:
        e, base = self.e, 47 if c else 40
        total = self._amvd(m, x - 1, y, c, l) + self._amvd(m, x, y - 1, c, l)
        a = abs(v)
        e.decision(base + (0 if total < 3 else 1 if total <= 32 else 2), a > 0)
        if a:
            for k in range(1, min(a, 9)):
                e.decision(base + min(k + 2, 6), 1)
            if a < 9:
                e.decision(base + min(a + 2, 6), 0)
            else:
                self.st.seen.add(("cabac mvd suffix", 1))
                e.eg(a - 9, 3)
            e.bypass(v < 0)
        for j in range(y // 4, (y + ph) // 4):
            for i in range(x // 4, (x + pw) // 4):
                self.st.amvd_l[l][m][j * 4 + i][c] = min(a, 70)

    def _cbf_inc(self, m, cat, x, y, c):
        st = self.st
        intra = st.kind[m] in ("i4", "i16", "pcm")

        def term(n, bx, by):
            if n is None:
                return int(intra)
            k = st.kind[n]
            if k in ("pcm", "skip"):
                return int(k == "pcm")
            cbp = st.cbp[n]
            if cat == 0:
                return int(k == "i16" and st.dcf[n] & 1)
            if cat == 3:
                return int(cbp >> 4 != 0 and (st.dcf[n] >> (1 + c)) & 1)
            if cat == 4:
                return int(cbp >> 4 == 2 and st.tcc[n][c][by * 2 + bx] != 0)
            return int((cbp >> (by // 2 * 2 + bx // 2)) & 1 and st.tcl[n][by * 4 + bx] != 0)

        if cat in (0, 3):
            a, b = (term(n, 0, 0) for n in self._ab(m))
        else:
            size = 2 if cat == 4 else 4
            a = term(m, x - 1, y) if x else term(st._nb(m, -1, 0), size - 1, y)
            b = term(m, x, y - 1) if y else term(st._nb(m, 0, -1), x, size - 1)
        return CBF_OFFSET[cat] + a + 2 * b

    def block(self, m, cat, x, y, c, coeffs) -> int:
        e = self.e
        coeffs = [int(v) for v in coeffs]
        nz = [i for i, v in enumerate(coeffs) if v]
        e.decision(85 + self._cbf_inc(m, cat, x, y, c), bool(nz))
        if not nz:
            return 0
        if cat in (0, 3):
            self.st.dcf[m] |= 1 if cat == 0 else 2 << c
        for i in range(len(coeffs) - 1):
            inc = min(i, 2) if cat == 3 else i
            e.decision(105 + SIG_OFFSET[cat] + inc, coeffs[i] != 0)
            if coeffs[i]:
                e.decision(166 + SIG_OFFSET[cat] + inc, i == nz[-1])
                if i == nz[-1]:
                    break
        gt1 = eq1 = 0
        base = 227 + ABS_OFFSET[cat]
        for i in reversed(nz):
            a = abs(coeffs[i]) - 1
            e.decision(base + (0 if gt1 else min(4, 1 + eq1)), a > 0)
            if a:
                ctx = base + 5 + min(4 - (cat == 3), gt1)
                for _ in range(1, min(a, 14)):
                    e.decision(ctx, 1)
                if a < 14:
                    e.decision(ctx, 0)
                else:
                    self.st.seen.add(("cabac level suffix", 1))
                    e.eg(a - 14, 0)
                gt1 += 1
            else:
                eq1 += 1
            e.bypass(coeffs[i] < 0)
        return len(nz)

    def transform8(self, m, flag) -> None:
        st = self.st
        ctx = 399 + sum(n is not None and st.t8[n] for n in self._ab(m))
        st.t8[m] = flag
        st.seen.update({("transform_size_8x8_flag", st.kind[m] == "i4", flag), ("ctx", ctx)})
        self.e.decision(ctx, flag)

    def block8(self, m, b8, coeffs) -> None:
        """An 8x8 block of ctxBlockCat 5 (64 in scan order, at least one
        not 0: its coded_block_flag is inferred): Table 9-43's significance
        contexts from ctxIdx 402 and 417, levels from 426; each of its 4x4
        blocks counts its coefficients (coded_block_flag's context)."""
        e, st = self.e, self.st
        coeffs = [int(v) for v in coeffs]
        nz = [i for i, v in enumerate(coeffs) if v]
        assert nz, "CABAC codes no 8x8 block without coefficients"
        for i in range(63):
            e.decision(402 + SIG8[i], coeffs[i] != 0)
            st.seen.add(("ctx", 402 + SIG8[i]))
            if coeffs[i]:
                e.decision(417 + LAST8[i], i == nz[-1])
                st.seen.add(("ctx", 417 + LAST8[i]))
                if i == nz[-1]:
                    break
        gt1 = eq1 = 0
        for i in reversed(nz):
            a = abs(coeffs[i]) - 1
            ctx = 426 + (0 if gt1 else min(4, 1 + eq1))
            e.decision(ctx, a > 0)
            st.seen.add(("ctx", ctx))
            if a:
                ctx = 426 + 5 + min(4, gt1)
                st.seen.add(("ctx", ctx))
                for _ in range(1, min(a, 14)):
                    e.decision(ctx, 1)
                if a < 14:
                    e.decision(ctx, 0)
                else:
                    st.seen.add(("cabac level suffix", 5))
                    e.eg(a - 14, 0)
                gt1 += 1
            else:
                eq1 += 1
            e.bypass(coeffs[i] < 0)
        for k in range(4):
            bx, by = _blk_xy(4 * b8 + k)
            st.tcl[m][by * 4 + bx] = len(nz)


# -------------------------------------------------------------- streams

# (mode, needs) of the intra predictions: needs A (left), B (top), D (top-left)
I4_NEEDS = ("B", "A", "", "B", "ABD", "ABD", "ABD", "B", "A")
I16_NEEDS = ("B", "A", "", "ABD")
CHROMA_NEEDS = ("", "A", "B", "ABD")
SUB_PARTS = (1, 2, 2, 4)  # 8x8, 8x4, 4x8, 4x4
# a B slice's macroblocks: B_Skip, B_Direct_16x16, B_{L0,L1,Bi}_16x16, the
# two-partition types, B_8x8, intra; and the share of I slices after a B
# picture's first
B_MIX = dict(skip=3, direct=2, b16=2, b2=2, b8x8=2, intra=1)
B_ISLICES = 0.25
# Table 7-14: the prediction modes (bit 0 list 0, bit 1 list 1) of the two
# partitions of B mb_types 4-21, by (mb_type - 4) // 2; Table 7-18: a B
# sub_mb_type's mode (0 direct) and shape (0 8x8, 1 8x4, 2 4x8, 3 4x4)
B_MODES = ((1, 1), (2, 2), (1, 2), (2, 1), (1, 3), (2, 3), (3, 1), (3, 2), (3, 3))
B_SUB = ((0, 0), (1, 0), (2, 0), (3, 0), (1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (1, 3),
         (2, 3), (3, 3))


def _defaults():
    return dict(
        size=CLIP_SIZE, frames=CLIP_FRAMES, idr=(0, 12, 24), intra=(), nonref=(),
        poc_type=0, poc_step=2, log2_max_frame_num=4, log2_max_poc_lsb=6,
        max_refs=1, refs_default=1, override=0.0, modify=0.0, mmco=0.0,
        vui=False, full_range=None, timing=False, reorder=None,
        slices=(1,), deblock=((0, 0, 0),), qp=(26, 26), chroma_offset=0, qp_walk=0,
        i_mix=dict(pcm=1, i4=3, i16=3), p_mix=dict(skip=4, p16=2, p16x8=1, p8x16=1, p8x8=1,
                                                    p8x8ref0=0, intra=1),
        density=0.3, big=0.02, mvd=8, far=0.0, slice_types=(0, 2),
        container="mp4", fourcc="H264", nal_length=4, inband=False, strf=False, poc_order=None,
        aud=False, sei=False, keys=None, recovery={}, cut=0, seed=0,
        # B pictures: how many between anchors (I or P pictures), the middle
        # one a reference (pyramid), direct mode ("spatial", "temporal" or
        # "mix": drawn a slice), weighted_bipred_idc, direct_8x8_inference,
        # num_ref_idx_l1_default; MP4 composition offsets ("v0": shifted to
        # stay >= 0, "v1": signed) and whether an edit list goes with them
        bframes=0, pyramid=False, direct="spatial", bipred=0, direct8x8=1, refs_l1=1,
        ctts="v0", elst=True, order=None)


class Writer:
    """Writes the NAL units of one stream, picture by picture."""

    def __init__(self, **kw):
        p = _defaults()
        p.update(kw)
        self.p = p
        self.rs = np.random.RandomState(p["seed"])
        h, w = p["size"]
        self.mbw, self.mbh = -(-w // 16), -(-h // 16)
        self.nmb = self.mbw * self.mbh
        self.max_fn = 1 << p["log2_max_frame_num"]
        self.refs = []  # frame_num of each short-term reference picture
        self.frame_num = 0
        self.prev_ref_fn = 0
        self.idr_id = 0
        self.since_idr = 0
        # Under Baseline, Main or Extended with constraint_set0, 1 or 2
        # FFmpeg reads no PPS past redundant_pic_cnt_present_flag (a case's
        # ``pps_ext`` writes what it ignores): one chroma offset, no lists
        self.high = p.get("profile", 66) == 100
        second = p.get("chroma_offset2", p["chroma_offset"]) if self.high else p["chroma_offset"]
        self.chroma_offsets = (p["chroma_offset"], second)
        self.seen = set()  # the syntax written: (element, value)
        # High profile: the 8x8 transform, the scaling lists of the SPS and
        # the PPS (drawn from a stream of their own) and the lists in use
        self.transform8 = self.high and bool(p.get("transform_8x8"))
        lrs = np.random.RandomState(p["seed"] + 1000003)
        self.sps_spec = self._lists(lrs, p.get("sps_scaling"))
        pps_spec = p.get("pps_scaling")
        self.pps_spec = self._lists(lrs, None if pps_spec is None else
                                    pps_spec[:8 if self.transform8 else 6])
        seq = scaling_matrices(self.sps_spec)
        lists = scaling_matrices(self.pps_spec if self.high else None,
                                 (seq, self.sps_spec is not None))
        self.scale4, self.scale8 = lists[:6], lists[6:]
        self.order, self.bpics = self.decode_order()
        self.idr_at = 0

    def _lists(self, lrs, codes):
        """A parameter set's scaling list spec (write_scaling_lists) from
        case codes (None, "default" or "explicit" a list; None: no
        scaling_matrix_present_flag): explicit weights in zigzag order,
        rising from a base in the case's ``scale_range``, half of them with a
        tail of repeats."""
        if codes is None:
            return None
        lo, hi = self.p.get("scale_range", (4, 48))
        out = []
        for i, code in enumerate(codes):
            n = 16 if i < 6 else 64
            if code != "explicit":
                out.append(code)
                continue
            vals = np.sort(lrs.randint(lo, hi + 1, n))
            if lrs.rand() < 0.5:
                k = int(lrs.randint(1, n))
                vals[k:] = vals[k - 1]
            out.append(tuple(int(v) for v in vals))
        return out

    # ------------------------------------------------------------ headers
    def sps(self, sps_id: int = 0) -> bytes:
        p, bw = self.p, Bits()
        h, w = p["size"]
        profile = p.get("profile", 66)
        bw.u(profile, 8)
        # constraint_set0 and 1 (Constrained Baseline), or 1 (Main)
        bw.u({66: 0b11000000, 77: 0b01000000}.get(profile, 0), 8)
        bw.u(p.get("level", 30), 8)
        bw.ue(sps_id)
        if p.get("profile", 66) in (100, 110, 122, 244):
            bw.ue(p.get("chroma_format", 1))
            bw.ue(p.get("bit_depth", 8) - 8)
            bw.ue(p.get("bit_depth", 8) - 8)
            bw.u(0, 1)  # qpprime_y_zero_transform_bypass_flag
            # seq_scaling_matrix_present_flag; a list left out takes the
            # fall-back rule A (Default_*, not Flat_16, for lists 0, 3, 6, 7)
            bw.u(self.sps_spec is not None, 1)
            if self.sps_spec is not None:
                self.seen.add(("scaling", "sps", tuple(e if e is None or e == "default"
                                                       else "explicit" for e in self.sps_spec)))
                write_scaling_lists(bw, self.sps_spec, self.seen)
        bw.ue(p["log2_max_frame_num"] - 4)
        bw.ue(p["poc_type"])
        if p["poc_type"] == 0:
            bw.ue(p["log2_max_poc_lsb"] - 4)
        elif p["poc_type"] == 1:
            bw.u(1, 1)  # delta_pic_order_always_zero_flag
            bw.se(0)
            bw.se(0)
            bw.ue(0)
        bw.ue(p["max_refs"])
        bw.u(p.get("gaps", 0), 1)
        bw.ue(self.mbw - 1)
        bw.ue(self.mbh - 1)
        bw.u(p.get("frame_mbs_only", 1), 1)
        if not p.get("frame_mbs_only", 1):
            bw.u(p.get("mbaff", 0), 1)
        bw.u(p["direct8x8"], 1)
        crop_r, crop_b = (self.mbw * 16 - w) // 2, (self.mbh * 16 - h) // 2
        bw.u(bool(crop_r or crop_b), 1)
        if crop_r or crop_b:
            bw.ue(0)
            bw.ue(crop_r)
            bw.ue(0)
            bw.ue(crop_b)
        bw.u(bool(p["vui"]), 1)
        if p["vui"]:
            bw.u(0, 1)  # aspect_ratio_info
            bw.u(0, 1)  # overscan
            bw.u(p["full_range"] is not None, 1)
            if p["full_range"] is not None:
                bw.u(5, 3)
                bw.u(p["full_range"], 1)
                bw.u(0, 1)  # colour_description
            bw.u(0, 1)  # chroma_loc_info
            bw.u(bool(p["timing"]), 1)
            if p["timing"]:
                bw.u(1, 32)
                bw.u(50, 32)
                bw.u(1, 1)
            bw.u(0, 1)  # nal_hrd
            bw.u(0, 1)  # vcl_hrd
            bw.u(0, 1)  # pic_struct
            bw.u(p["reorder"] is not None, 1)
            if p["reorder"] is not None:
                bw.u(1, 1)
                bw.ue(2)
                bw.ue(1)
                bw.ue(16)
                bw.ue(16)
                bw.ue(p["reorder"])
                bw.ue(max(p["max_refs"], p["reorder"]))
        return nal(3, 7, bw.trailing())

    def pps(self, pps_id: int = 0) -> bytes:
        p, bw = self.p, Bits()
        bw.ue(pps_id)
        bw.ue(0)
        bw.u(p.get("cabac", 0), 1)
        bw.u(0, 1)
        bw.ue(p.get("slice_groups", 1) - 1)
        if p.get("slice_groups", 1) > 1:
            bw.ue(0)  # interleaved
            for _ in range(p["slice_groups"]):
                bw.ue(0)
        bw.ue(p["refs_default"] - 1)
        bw.ue(p["refs_l1"] - 1)
        bw.u(p.get("weighted", 0), 1)
        bw.u(p["bipred"], 2)
        bw.se(p["qp"][0] - 26)
        bw.se(0)
        bw.se(p["chroma_offset"])
        bw.u(1, 1)  # deblocking_filter_control_present_flag
        bw.u(p.get("constrained_intra", 0), 1)
        bw.u(p.get("redundant", 0), 1)
        if self.high or p.get("pps_ext"):
            self.seen.add(("pps extension", self.high))
            bw.u(self.transform8 or not self.high, 1)
            bw.u(self.pps_spec is not None, 1)  # pic_scaling_matrix_present_flag
            if self.pps_spec is not None:
                self.seen.add(("scaling", "pps", tuple(e if e is None or e == "default"
                                                       else "explicit" for e in self.pps_spec),
                               self.sps_spec is not None))
                write_scaling_lists(bw, self.pps_spec, self.seen)
            bw.se(p.get("chroma_offset2", p["chroma_offset"]))  # second_chroma_qp_index_offset
        return nal(3, 8, bw.trailing())

    # ------------------------------------------------------------ pictures
    def decode_order(self):
        """The display indices of the frames in decode order, and the B
        pictures among them (display index -> whether a reference): between
        IDR pictures an anchor every ``bframes`` + 1 frames and the last
        frame before the next IDR picture, each coded before the B pictures
        that precede it; with ``pyramid`` the middle B picture of each run
        is coded first and is a reference."""
        p = self.p
        n = p["frames"] + p["cut"]
        if not p["bframes"]:
            return list(range(n)), {}
        order, bpics = [], {}
        starts = sorted({0, *[i for i in p["idr"] if i < n]})
        for a, b in zip(starts, starts[1:] + [n]):
            anchors = list(range(a, b, p["bframes"] + 1))
            if anchors[-1] != b - 1:
                anchors.append(b - 1)
            order.append(anchors[0])
            for prev, nxt in zip(anchors, anchors[1:]):
                order.append(nxt)
                run = list(range(prev + 1, nxt))
                if p["pyramid"] and len(run) > 2:
                    mid = run[len(run) // 2]
                    run = [mid] + [r for r in run if r != mid]
                    bpics[mid] = True
                order += run
                bpics.update({r: bpics.get(r, False) for r in run})
        return order, bpics

    def picture(self, i: int):
        """The NAL units of frame ``i`` (display index; frames come in
        decode order, which equals display order unless there are B
        pictures)."""
        p, rs = self.p, self.rs
        idr = i in p["idr"]
        kind = "I" if idr or i in p["intra"] else "B" if i in self.bpics else "P"
        self.index = i
        if i == p.get("gap_at"):
            self.frame_num = (self.frame_num + 1) % self.max_fn  # skip a frame_num
        if kind == "B":
            ref_idc = int(rs.randint(1, 4)) if self.bpics[i] else 0
        else:
            ref_idc = 0 if i in p["nonref"] else int(rs.randint(1, 4))
        if idr:
            self.refs, self.since_idr = [], 0
            self.frame_num = 0
            self.idr_id ^= 1
            self.idr_at = i
        k = self.since_idr
        if p["poc_order"] == "swap" and k:  # display order 0, 2, 1, 4, 3, ...
            k = k + 1 if k % 2 else k - 1
        if p["bframes"]:
            k = i - self.idr_at
        poc = (p["poc_step"] * k) % (1 << p["log2_max_poc_lsb"])
        self.since_idr += 1
        cur_fn = self.frame_num
        # the reference pictures by descending PicNum (the initial list)
        picnums = sorted(((fn - self.max_fn if fn > cur_fn else fn) for fn in self.refs),
                         reverse=True)
        nals = []
        nslices = int(rs.choice(p["slices"]))
        self.seen.add(("slices", nslices))
        cuts = sorted(rs.choice(np.arange(1, self.nmb), nslices - 1, replace=False)) \
            if nslices > 1 else []
        bounds = [0, *[int(c) for c in cuts], self.nmb]
        self.new_state()
        marking = None
        if ref_idc and not idr:
            marking = self._marking(cur_fn)
            if marking and kind == "B":
                self.seen.add(("mmco B", 1))
        for s in range(nslices):
            if kind == "B":
                stype = 1 if s == 0 or rs.rand() >= B_ISLICES else 2
            else:
                stype = 2 if kind == "I" else (0 if s == 0 or rs.rand() > 0.25 else 2)
            nals.append(self._slice(s, bounds[s], bounds[s + 1], stype, idr, ref_idc, cur_fn,
                                    poc, picnums, marking))
        if p.get("aso"):
            nals.reverse()
        if i == p.get("partition_at"):  # slice data partition A in place of the first slice
            nals[0] = bytes([nals[0][0] & 0xE0 | 2]) + nals[0][1:]
        if ref_idc:
            if marking:
                for d in marking:
                    victim = (cur_fn - (d + 1)) % self.max_fn
                    self.refs.remove(victim)
            elif len(self.refs) >= max(p["max_refs"], 1):
                wraps = [fn - self.max_fn if fn > cur_fn else fn for fn in self.refs]
                self.refs.pop(int(np.argmin(wraps)))
            self.refs.append(cur_fn)
            self.frame_num = (cur_fn + 1) % self.max_fn
        return nals

    def new_state(self) -> None:
        """The per-picture macroblock state the coders' contexts read:
        non-zero coefficients (luma 4x4, chroma AC), intra 4x4 modes,
        coded_block_pattern, DC coded_block_flags (bit 0 luma, 1 Cb, 2
        Cr), intra chroma mode, reference indices and absolute mvds."""
        self.kind = [None] * self.nmb
        self.slc = [-1] * self.nmb
        self.tcl = np.zeros((self.nmb, 16), np.int32)
        self.tcc = np.zeros((self.nmb, 2, 4), np.int32)
        self.i4 = np.full((self.nmb, 16), -1, np.int32)
        self.cbp = [0] * self.nmb
        self.dcf = [0] * self.nmb
        self.cmode = [0] * self.nmb
        self.refidx = [[-1] * 16 for _ in range(self.nmb)]
        self.amvd = [[[0, 0] for _ in range(16)] for _ in range(self.nmb)]
        self.refidx_l = (self.refidx, [[-1] * 16 for _ in range(self.nmb)])
        self.amvd_l = (self.amvd, [[[0, 0] for _ in range(16)] for _ in range(self.nmb)])
        self.direct = [0] * self.nmb  # B: the 8x8 blocks in direct mode; 16: B_Skip, B_Direct_16x16
        self.t8 = [False] * self.nmb  # transform_size_8x8_flag

    def coder(self, bw, p_slice, idc, qp, b_slice=False) -> _Coder:
        if self.p.get("cabac"):
            self.seen.add(("cabac_init_idc", idc if p_slice else "I"))
            return CabacCoder(self, bw, p_slice, idc, qp, b_slice)
        return Cavlc(self, bw, p_slice, b_slice)

    def _marking(self, cur_fn):
        """MMCO 1 operations (difference_of_pic_nums_minus1 each), or None
        for the sliding window."""
        p, rs = self.p, self.rs
        if not self.refs or rs.rand() >= p["mmco"]:
            return None
        full = len(self.refs) >= p["max_refs"]
        picnums = [fn - self.max_fn if fn > cur_fn else fn for fn in self.refs]
        n = 1 if full or len(picnums) == 1 else int(rs.randint(1, len(picnums) + 1))
        victims = rs.choice(picnums, min(n, len(picnums)), replace=False)
        return [int(cur_fn - v - 1) for v in victims]

    def _slice(self, s, first, end, stype, idr, ref_idc, cur_fn, poc, picnums, marking):
        p, rs = self.p, self.rs
        bw = Bits()
        bw.ue(first)
        written = stype
        if stype == 0 and 3 in p["slice_types"]:  # SP in place of P (refused)
            written = 3
        bw.ue(written + 5 if 5 in p["slice_types"] else written)
        bw.ue(0)
        bw.u(cur_fn, p["log2_max_frame_num"])
        if idr:
            bw.ue(self.idr_id)
        if p["poc_type"] == 0:
            bw.u(poc, p["log2_max_poc_lsb"])
        active = p["refs_default"]
        nref = len(picnums)
        if stype == 1:
            self._b_header(bw, cur_fn, picnums)
            active = self.active_l[0]
        elif stype == 0:
            if rs.rand() < p["override"] or active > nref:
                # never more entries than reference pictures
                active = min(int(rs.randint(1, 5)), nref) if active <= nref else nref
                bw.u(1, 1)
                bw.ue(active - 1)
            else:
                bw.u(0, 1)
            if nref and rs.rand() < p["modify"]:
                self.seen.add(("ref_pic_list_modification", 1))
                self._modification(bw, cur_fn, picnums, active)
            else:
                bw.u(0, 1)
            if p.get("weighted"):
                self._pred_weight_table(bw, active)
        if ref_idc:
            if idr:
                bw.u(0, 1)
                bw.u(p.get("long_term", 0), 1)
            elif self.index == p.get("mmco5_at"):
                bw.u(1, 1)
                bw.ue(5)
                bw.ue(0)
            elif marking:
                self.seen.add(("mmco", 1))
                bw.u(1, 1)
                for d in marking:
                    bw.ue(1)
                    bw.ue(d)
                bw.ue(0)
            else:
                bw.u(0, 1)
        idcs = p.get("cabac_init", (0, 1, 2))
        init_idc = idcs[(self.index * 7 + s) % len(idcs)]  # not drawn: CAVLC twins draw alike
        if p.get("cabac") and stype != 2:
            bw.ue(init_idc)
        qp = int(rs.randint(p["qp"][0], p["qp"][1] + 1))
        bw.se(qp - p["qp"][0])
        self.qp = qp
        idc, a, b = p["deblock"][int(rs.randint(len(p["deblock"])))]
        bw.ue(idc)
        if idc != 1:
            bw.se(a)
            bw.se(b)
        self.seen.update({("qp", qp), ("deblock", idc) + ((a, b) if idc != 1 else ())})
        self.nrefs = min(active, nref)
        self.seen.add(("references", self.nrefs))
        self.active = active
        e = self.coder(bw, stype != 2, init_idc, qp, stype == 1)
        for m in range(first, end):
            self.slc[m] = s
            if stype == 1:
                t = self._choose(B_MIX)
                self.seen.add(("B macroblock", t))
                if t == "skip":
                    self.kind[m] = "skip"
                    self.direct[m] = 31
                    e.skip(m)
                else:
                    e.mb_start(m)
                    if t == "intra":
                        self._intra_mb(e, m)
                    else:
                        self._b_mb(e, m, t)
            elif stype == 0:
                t = self._choose(p["p_mix"])
                if t == "p8x8ref0" and active < 2:
                    t = "p8x8"
                if t == "skip":
                    self.kind[m] = "skip"
                    self.refidx[m] = [0] * 16
                    e.skip(m)
                else:
                    e.mb_start(m)
                    if t == "intra":
                        self._intra_mb(e, m)
                    else:
                        self._inter_mb(e, m, t)
            else:
                e.mb_start(m)
                self._intra_mb(e, m)
            e.mb_end(m, m == end - 1)
        return nal(ref_idc, 5 if idr else 1, e.finish())

    def _b_header(self, bw, cur_fn, picnums) -> None:
        """A B slice's header fields from direct_spatial_mv_pred_flag to the
        pred_weight_table: num_ref_idx_l0/l1_active (never more than the
        reference pictures), list modification of each list (with
        ``l1_long_term`` a long-term picture named in list 1) and, with
        weighted_bipred_idc 1, both lists' weights."""
        p, rs = self.p, self.rs
        direct = p["direct"] if p["direct"] != "mix" else ("spatial", "temporal")[rs.randint(2)]
        self.seen.add(("direct", direct))
        bw.u(direct == "spatial", 1)
        nref = len(picnums)
        active = [min(p["refs_default"], nref), min(p["refs_l1"], nref)]
        if rs.rand() < p["override"] or p["refs_default"] > nref or p["refs_l1"] > nref:
            active = [int(rs.randint(1, nref + 1)) for _ in range(2)]
            bw.u(1, 1)
            bw.ue(active[0] - 1)
            bw.ue(active[1] - 1)
        else:
            bw.u(0, 1)
        self.active_l, self.nrefs_l = active, active
        self.seen.update({("references B", a) for a in active})
        for l in range(2):
            if l == 1 and p.get("l1_long_term"):
                bw.u(1, 1)
                bw.ue(2)  # long_term_pic_num
                bw.ue(0)
                bw.ue(3)
                continue
            if not rs.rand() < p["modify"]:
                bw.u(0, 1)
                continue
            self.seen.add(("list modification B", l))
            self._modification(bw, cur_fn, picnums, active[l])
        if p["bipred"] == 1:
            self._bipred_weight_table(bw, active)

    def _modification(self, bw, cur_fn, picnums, active) -> None:
        """ref_pic_list_modification_flag 1 and 1 to ``active`` operations,
        each naming one of the reference pictures (``picnums``)."""
        bw.u(1, 1)
        pred = cur_fn
        for _ in range(int(self.rs.randint(1, active + 1))):
            d = (pred - int(self.rs.choice(picnums))) % self.max_fn
            if d:
                bw.ue(0)
                bw.ue(d - 1)
                pred = (pred - d) % self.max_fn
            else:
                bw.ue(1)
                bw.ue(self.max_fn - 1)
        bw.ue(3)

    def _bipred_weight_table(self, bw, active) -> None:
        """Explicit weights of both lists with denominators 0-6, every pair
        of a list 0 and a list 1 weight summing to -128..128 (a conforming
        stream; with them the 16-bit sums of FFmpeg's SIMD weighting never
        saturate where it matters), drawn near the default or anywhere, and
        clamped to that; a default too far goes written."""
        rs = self.rs
        logs = [int(rs.randint(7)), int(rs.randint(7))]
        bw.ue(logs[0])
        bw.ue(logs[1])
        table = [[], []]  # a list, an entry: (luma (w, o), chroma ((w, o), (w, o))) or None
        for l in range(2):
            for _ in range(active[l]):
                entry = []
                for k in range(2):
                    if rs.rand() < 0.25:
                        entry.append(None)
                        continue
                    entry.append([self._weight_pair(logs[k]) for _ in range(1 + k)])
                table[l].append(entry)
        for k in range(2):  # clamp list 1's weights against all of list 0's
            for c in range(1 + k):
                w0 = [e[k][c][0] if e[k] else 1 << logs[k] for e in table[0]]
                lo, hi = max(-128, -128 - min(w0)), min(127, 128 - max(w0))
                for e in table[1]:
                    if e[k] is None:
                        if lo <= 1 << logs[k] <= hi:
                            continue
                        e[k] = [(1 << logs[k], 0) for _ in range(1 + k)]
                    w, o = e[k][c]
                    e[k][c] = (min(max(w, lo), hi), o)
        for l in range(2):
            for entry in table[l]:
                for k, pairs in enumerate(entry):
                    bw.u(pairs is not None, 1)
                    if pairs is None:
                        continue
                    self.seen.add(("weights B", ("luma", "chroma")[k]))
                    for w, o in pairs:
                        bw.se(w)
                        bw.se(o)

    def _weight_pair(self, log):
        """A weight and offset near the default 2^log or anywhere in -128..127."""
        rs = self.rs
        if rs.rand() < 0.15:
            return int(rs.randint(-128, 128)), int(rs.randint(-128, 128))
        return (min((1 << log) + int(rs.randint(-(1 << log) // 2 - 2, (1 << log) // 2 + 3)), 127),
                int(rs.randint(-24, 25)))

    def _pred_weight_table(self, bw, active) -> None:
        """Denominators 0-7; for each ref_idx the luma and the chroma
        weights and offsets, near the default or anywhere in -128..127, or
        the flag 0."""
        rs = self.rs
        logs = [int(rs.randint(8)), int(rs.randint(8))]
        bw.ue(logs[0])
        bw.ue(logs[1])
        for _ in range(active):
            for k in range(2):  # luma, then chroma
                if rs.rand() < 0.25:
                    bw.u(0, 1)
                    continue
                bw.u(1, 1)
                self.seen.add(("weights", ("luma", "chroma")[k]))
                for _ in range(1 + k):
                    w, o = self._weight_pair(logs[k])
                    bw.se(w)
                    bw.se(o)

    def _choose(self, mix):
        """A key of ``mix`` drawn with the weights its values give."""
        x = self.rs.rand() * sum(mix.values())
        for k, v in mix.items():
            x -= v
            if x < 0:
                return k
        return next(k for k, v in mix.items() if v)

    # -------------------------------------------------------- neighbours
    def _nb(self, m, dx, dy):
        """The macroblock at (dx, dy) from ``m`` where it is available."""
        x, y = m % self.mbw + dx, m // self.mbw + dy
        if not (0 <= x < self.mbw and 0 <= y < self.mbh):
            return None
        n = y * self.mbw + x
        return n if n < m and self.slc[n] == self.slc[m] else None

    def _nc(self, m, bx, by, arr):
        """nC of 4x4 block (bx, by) of ``arr`` (tcl: 4x4 of luma, else a
        chroma component's 2x2)."""
        size = 4 if arr is None else 2
        get = (lambda n, x, y: self.tcl[n][y * 4 + x]) if arr is None else \
            (lambda n, x, y: self.tcc[n][arr][y * 2 + x])
        na = nb = None
        if bx > 0:
            na = get(m, bx - 1, by)
        else:
            a = self._nb(m, -1, 0)
            if a is not None:
                na = get(a, size - 1, by)
        if by > 0:
            nb = get(m, bx, by - 1)
        else:
            b = self._nb(m, 0, -1)
            if b is not None:
                nb = get(b, bx, size - 1)
        if na is not None and nb is not None:
            return (int(na) + int(nb) + 1) >> 1
        return int(na if na is not None else nb if nb is not None else 0)

    def _fitted(self, n, fits):
        """Coefficients for a block of ``n`` that ``fits`` accepts (halved
        towards 0 until it does)."""
        c = self._coeffs(n)
        while not fits(c):
            c = np.fix(c / 2).astype(np.int64)
        return c

    def _block(self, e, m, cat, bx, by, c, q, dc=None, scale=None):
        """A 16-coefficient block, or with ``dc`` an AC block of 15 after it,
        under the scaling list ``scale``."""
        if dc is None:
            v = self._fitted(16, lambda v: block_fits(v, q, scale=scale))
        else:
            v = self._fitted(15, lambda v: block_fits(np.concatenate([[0], v]), q, dc, scale))
        return e.block(m, cat, bx, by, c, v)

    def _qp_draw(self):
        return int(self.rs.randint(-26, 26)) if self.rs.rand() < 0.5 else 0

    def _qp_delta(self, e):
        d = self._qp_draw()
        e.qp_delta(d)
        self.qp = (self.qp + d + 52) % 52
        self.seen.add(("qp", self.qp))

    def _coeffs(self, n):
        """A block's levels: none, a few or many, mostly +-1 and small, some
        large (level_prefix escapes)."""
        rs, p = self.rs, self.p
        out = np.zeros(n, np.int64)
        if rs.rand() < p["density"]:
            k = int(rs.randint(1, n + 1)) if rs.rand() < 0.3 else int(rs.randint(1, min(n, 5) + 1))
            u = rs.rand(4, k)
            mag = np.where(u[0] < 0.6, 1, 2 + (u[1] * u[1] * 8).astype(np.int64))
            mag = np.where(u[2] < p["big"], 20 + (u[1] * 1480).astype(np.int64), mag)
            out[rs.permutation(n)[:k]] = np.where(u[3] < 0.5, -mag, mag)
        return out

    # ------------------------------------------------------- macroblocks
    def _avail(self, m):
        return {"A": self._nb(m, -1, 0) is not None, "B": self._nb(m, 0, -1) is not None,
                "D": self._nb(m, -1, -1) is not None}

    def _intra_mb(self, e, m):
        rs, p = self.rs, self.p
        t = self._choose(p["i_mix"])
        av = self._avail(m)
        if t == "pcm":
            e.mb_type_i(m, 25)
            self.seen.add(("mb_type I", 25))
            e.pcm(rs.randint(0, 256, 384).astype(np.uint8).tobytes())
            self.kind[m] = "pcm"
            self.tcl[m] = 16
            self.tcc[m] = 16
            return
        cmode = _pick(rs, [c for c, need in enumerate(CHROMA_NEEDS) if all(av[k] for k in need)])
        if t == "i16":
            mode = _pick(rs, [c for c, need in enumerate(I16_NEEDS) if all(av[k] for k in need)])
            cbp_l = 15 if rs.rand() < 0.5 else 0
            cbp_c = int(rs.randint(3))
            e.mb_type_i(m, 1 + mode + 4 * cbp_c + (12 if cbp_l else 0))
            self.seen.update({("mb_type I", 1 + mode + 4 * cbp_c + (12 if cbp_l else 0)),
                              ("Intra16x16", mode), ("chroma", cmode)})
            e.chroma_mode(m, cmode)
            self._qp_delta(e)
            self.kind[m] = "i16"
            self.cbp[m] = cbp_l | cbp_c << 4
            w00 = self.scale4[0][0]
            dcl = self._fitted(16, lambda c: luma_dc(c, self.qp, w00) is not None)
            e.block(m, 0, 0, 0, 0, dcl)
            dcy = luma_dc(dcl, self.qp, w00)
            for blk in range(16):
                bx, by = _blk_xy(blk)
                tc = self._block(e, m, 1, bx, by, 0, self.qp, dcy[by * 4 + bx],
                                 self.scale4[0]) if cbp_l else 0
                self.tcl[m][by * 4 + bx] = tc
            self._chroma(e, m, cbp_c, True)
            return
        e.mb_type_i(m, 0)
        self.seen.update({("mb_type I", 0), ("chroma", cmode)})
        self.kind[m] = "i4"
        if self.transform8:
            t8 = bool(rs.rand() < p.get("t8", 0.5))
            e.transform8(m, t8)
            if t8:
                for b8 in range(4):
                    bx, by = 2 * (b8 % 2), 2 * (b8 // 2)
                    tl = (av["B"] if bx else av["A"] if by else av["D"]) if not (bx and by) else True
                    have = {"A": bx > 0 or av["A"], "B": by > 0 or av["B"], "D": tl}
                    mode = _pick(rs, [c for c, need in enumerate(I4_NEEDS)
                                      if all(have[k] for k in need)])
                    e.i4_mode(self._i4_pred(m, bx, by), mode)
                    for k in range(4):
                        self.i4[m][(by + k // 2) * 4 + bx + k % 2] = mode
                    self.seen.add(("Intra8x8", mode))
                e.chroma_mode(m, cmode)
                self._cbp_residual(e, m, True, t8=True)
                return
        for blk in range(16):
            bx, by = _blk_xy(blk)
            left = bx > 0 or av["A"]
            top = by > 0 or av["B"]
            if bx > 0 and by > 0:
                tl = True
            elif bx == 0 and by > 0:
                tl = av["A"]
            elif by == 0 and bx > 0:
                tl = av["B"]
            else:
                tl = av["D"]
            have = {"A": left, "B": top, "D": tl}
            mode = _pick(rs, [c for c, need in enumerate(I4_NEEDS) if all(have[k] for k in need)])
            e.i4_mode(self._i4_pred(m, bx, by), mode)
            self.i4[m][by * 4 + bx] = mode
            self.seen.add(("Intra4x4", mode))
        e.chroma_mode(m, cmode)
        self._cbp_residual(e, m, True)

    def _i4_pred(self, m, bx, by):
        def side(dx, dy, x, y):
            if (dx and bx > 0) or (dy and by > 0):
                return int(self.i4[m][y * 4 + x])
            n = self._nb(m, dx, dy)
            if n is None:
                return None
            return int(self.i4[n][y * 4 + x]) if self.kind[n] == "i4" else 2
        a = side(-1, 0, (bx - 1) % 4, by)
        b = side(0, -1, bx, (by - 1) % 4)
        return 2 if a is None or b is None else min(a, b)

    def _cbp_residual(self, e, m, intra, allow8=False, t8=False):
        """coded_block_pattern, transform_size_8x8_flag (of an inter
        macroblock that ``allow8``s it, under a PPS with the 8x8 transform;
        I_NxN has coded it, ``t8``), mb_qp_delta and the residual."""
        rs = self.rs
        cbp = int(rs.randint(48))
        flag = self.transform8 and not intra and allow8 and bool(cbp & 15)
        if flag:
            t8 = bool(rs.rand() < self.p.get("t8", 0.5))
        if t8:
            return self._residual8(e, m, intra, cbp, flag)
        e.cbp(m, cbp, intra)
        if flag:
            e.transform8(m, False)
        if cbp:
            self._qp_delta(e)
        scale = self.scale4[0 if intra else 3]
        for blk in range(16):
            bx, by = _blk_xy(blk)
            tc = self._block(e, m, 2, bx, by, 0, self.qp, scale=scale) \
                if cbp >> (blk // 4) & 1 else 0
            self.tcl[m][by * 4 + bx] = tc
        self._chroma(e, m, cbp >> 4, intra)

    def _residual8(self, e, m, intra, cbp, flag):
        """The same with the 8x8 transform: the QP and the 8x8 blocks are
        drawn before coded_block_pattern is coded, as a coded 8x8 block must
        hold a coefficient under CABAC: an empty one takes a DC of 1, and
        one where even that leaves 16 bits is not coded (its bit cleared)."""
        d = self._qp_draw() if cbp else 0
        q = (self.qp + d + 52) % 52
        scale = self.scale8[0 if intra else 1]
        blocks = {}
        for b8 in range(4):
            if not cbp >> b8 & 1:
                continue
            v = self._fitted(64, lambda v: block8_fits(v, q, scale))
            if not v.any():
                v[0] = 1
                if not block8_fits(v, q, scale):
                    cbp &= ~(1 << b8)
                    self.seen.add(("8x8 block dropped", 1))
                    continue
            blocks[b8] = v
        e.cbp(m, cbp, intra)
        if flag and cbp & 15:
            e.transform8(m, True)
        if cbp:
            e.qp_delta(d)
            self.qp = q
            self.seen.add(("qp", q))
        for b8, v in blocks.items():
            self.seen.add(("8x8 block", intra))
            e.block8(m, b8, v)
        self._chroma(e, m, cbp >> 4, intra)

    def _chroma(self, e, m, cbp_c, intra):
        qcs = [CHROMA_QP[min(max(self.qp + off, 0), 51)] for off in self.chroma_offsets]
        scales = self.scale4[1:3] if intra else self.scale4[4:6]
        dcs = [[0] * 4, [0] * 4]
        if cbp_c:
            for c in range(2):
                lv = self._fitted(4, lambda v: chroma_dc(v, qcs[c], scales[c][0]) is not None)
                e.block(m, 3, 0, 0, c, lv)
                dcs[c] = chroma_dc(lv, qcs[c], scales[c][0])
        for c in range(2):
            for blk in range(4):
                bx, by = blk % 2, blk // 2
                tc = self._block(e, m, 4, bx, by, c, qcs[c], dcs[c][blk], scales[c]) \
                    if cbp_c == 2 else 0
                self.tcc[m][c][by * 2 + bx] = tc

    def _mvd(self):
        rs, p = self.rs, self.p
        if rs.rand() < p["far"]:
            return int(rs.randint(300, 2000) * (1 if rs.rand() < 0.5 else -1))
        return int(rs.randint(-p["mvd"], p["mvd"] + 1))

    def _ref(self):
        return int(self.rs.randint(self.nrefs)) if self.nrefs > 1 else 0

    def _inter_mb(self, e, m, t):
        """P_L0_16x16, 16x8, 8x16, P_8x8 and P_8x8ref0 (which CABAC cannot
        code: there it is P_8x8 with every ref_idx 0, the same prediction)."""
        rs = self.rs
        self.kind[m] = "p"
        if t in ("p16", "p16x8", "p8x16"):
            k = ("p16", "p16x8", "p8x16").index(t)
            e.mb_type_p(m, k)
            self.seen.add(("mb_type P", k))
            parts = [(0, 0, 16, 16)] if k == 0 else [(0, 8 * i, 16, 8) if k == 1 else
                                                     (8 * i, 0, 8, 16) for i in range(2)]
            refs = [self._ref() for _ in parts]
            for (x, y, w, h), r in zip(parts, refs):
                e.ref(m, x, y, w, h, r, self.active)
        else:
            ref0 = t == "p8x8ref0"
            e.mb_type_p(m, 4 if ref0 and e.codes_p8x8ref0 else 3)
            subs = [int(rs.randint(4)) for _ in range(4)]
            self.seen.update({("mb_type P", 4 if ref0 else 3), *(("sub_mb_type", sb) for sb in subs)})
            for sb in subs:
                e.sub_mb_type(sb)
            for i in range(4):
                r = 0 if ref0 else self._ref() if self.active > 1 else 0
                # P_8x8ref0 codes no ref_idx
                e.ref(m, 8 * (i % 2), 8 * (i // 2), 8, 8, r,
                      1 if ref0 and e.codes_p8x8ref0 else self.active)
            parts = []
            for i, sb in enumerate(subs):
                x0, y0 = 8 * (i % 2), 8 * (i // 2)
                w, h = (8, 8, 4, 4)[sb], (8, 4, 8, 4)[sb]
                parts += [(x0 + w * (k % (8 // w)), y0 + h * (k // (8 // w)), w, h)
                          for k in range(SUB_PARTS[sb])]
        for x, y, w, h in parts:
            for c in range(2):
                e.mvd(m, x, y, w, h, c, self._mvd())
        self._cbp_residual(e, m, False, allow8=all(w == 8 and h == 8 or w == 16 or h == 16
                                                   for x, y, w, h in parts))

    def _b_mb(self, e, m, t):
        """A B macroblock other than B_Skip: B_Direct_16x16 ("direct"),
        B_{L0,L1,Bi}_16x16 ("b16"), the two-partition types 4-21 ("b2") or
        B_8x8 with its four sub_mb_types ("b8x8")."""
        rs = self.rs
        self.kind[m] = "p"
        if t == "direct":
            e.mb_type_b(m, 0)
            self.direct[m] = 31
            self.seen.add(("mb_type B", 0))
            self._cbp_residual(e, m, False, allow8=bool(self.p["direct8x8"]))
            return
        mb = 1 + int(rs.randint(3)) if t == "b16" else 4 + int(rs.randint(18)) if t == "b2" else 22
        e.mb_type_b(m, mb)
        self.seen.add(("mb_type B", mb))
        subs = []
        if mb <= 3:
            parts = [(0, 0, 16, 16, mb, -1)]
        elif mb < 22:
            k, modes = mb - 4, B_MODES[(mb - 4) // 2]
            parts = [(0, 8 * i, 16, 8, modes[i], -1) if k % 2 == 0 else
                     (8 * i, 0, 8, 16, modes[i], -1) for i in range(2)]
        else:
            subs = [int(rs.randint(13)) for _ in range(4)]
            self.seen.update(("sub_mb_type B", sb) for sb in subs)
            for sb in subs:
                e.sub_mb_type(sb)
            parts = []
            for i, sb in enumerate(subs):
                mode, shape = B_SUB[sb]
                if not mode:
                    self.direct[m] |= 1 << i
                    continue
                w, h = (8, 8, 4, 4)[shape], (8, 4, 8, 4)[shape]
                x0, y0 = 8 * (i % 2), 8 * (i // 2)
                parts += [(x0 + w * (k % (8 // w)), y0 + h * (k // (8 // w)), w, h, mode, i)
                          for k in range(SUB_PARTS[shape])]
        for l in range(2):  # ref_idx_l0 of every partition (sub-macroblock), then ref_idx_l1
            if mb < 22:
                for x, y, w, h, mode, _ in parts:
                    if mode >> l & 1:
                        e.ref(m, x, y, w, h, self._ref_l(l), self.active_l[l], l)
            else:
                for i, sb in enumerate(subs):
                    if B_SUB[sb][0] >> l & 1:
                        e.ref(m, 8 * (i % 2), 8 * (i // 2), 8, 8, self._ref_l(l), self.active_l[l], l)
        for l in range(2):
            for x, y, w, h, mode, _ in parts:
                if mode >> l & 1:
                    for c in range(2):
                        e.mvd(m, x, y, w, h, c, self._mvd(), l)
        # no partition below 8x8; a direct 8x8 block only with direct_8x8_inference_flag
        allow8 = all(B_SUB[sb][1] == 0 if B_SUB[sb][0] else self.p["direct8x8"] for sb in subs)
        self._cbp_residual(e, m, False, allow8=bool(allow8))

    def _ref_l(self, l):
        return int(self.rs.randint(self.nrefs_l[l])) if self.nrefs_l[l] > 1 else 0

    # ------------------------------------------------------------- stream
    def packets(self):
        """One access unit a frame, in decode order: lists of NAL units."""
        p = self.p
        out = []
        for i in self.order:
            nals = self.picture(i)
            if i in p["recovery"]:
                nals = [recovery_sei(p["recovery"][i])] + nals
            if p["aud"]:
                nals = [nal(0, 9, bytes([0xF0]))] + nals  # primary_pic_type 7
            if p["sei"]:  # user data unregistered
                nals = [nal(0, 6, bytes([5, 17]) + bytes(16) + b"x" + b"\x80")] + nals
            if (i in p["idr"] or i == p["cut"]) and p["inband"]:
                nals = [self.sps(), self.pps()] + nals
            out.append(nals)
        return out[p["cut"]:]


def recovery_sei(frame_cnt: int) -> bytes:
    """An SEI NAL unit of one recovery point message (payload type 6):
    recovery_frame_cnt, exact_match_flag 1, broken_link_flag 0."""
    bw = Bits()
    bw.ue(frame_cnt)
    bw.u(0b1000, 4)  # exact_match, broken_link, changing_slice_group_idc (2 bits)
    bw.align()
    payload = bytes(bw.out)
    return nal(0, 6, bytes([6, len(payload)]) + payload + b"\x80")


def _pick(rs, items):
    return items[int(rs.randint(len(items)))]


def _blk_xy(blk: int):
    """(x, y) in 4x4 units of luma4x4BlkIdx ``blk``."""
    return (blk // 4 % 2) * 2 + blk % 2, (blk // 8) * 2 + blk % 4 // 2


# ------------------------------------------------------------- containers

def avcc(sps: bytes, pps: bytes, nal_length: int = 4) -> bytes:
    """An AVCDecoderConfigurationRecord (the avcC box's body)."""
    return (bytes([1, sps[1], sps[2], sps[3], 0xFC | (nal_length - 1), 0xE1])
            + struct.pack(">H", len(sps)) + sps + b"\x01" + struct.pack(">H", len(pps)) + pps)


def annexb(nals) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)


def prefixed(nals, size: int) -> bytes:
    return b"".join(n.__len__().to_bytes(size, "big") + n for n in nals)


def write(p: dict, units, sps: bytes, pps: bytes) -> bytes:
    """The file of stream ``units`` (NAL units a frame) in ``p``'s container."""
    import avi_cases
    import mp4_cases

    h, w = p["size"]
    keys = [k - p["cut"] for k in (p["idr"] if p["keys"] is None else p["keys"])
            if k >= p["cut"]]
    order = p["order"] or list(range(len(units)))  # display index by decode index
    if p["order"]:
        keys = [order.index(k) for k in keys]
    if p["container"] == "avi":
        return avi_cases.write_avi([annexb(u) for u in units], w, h,
                                   fourcc=p["fourcc"].encode(), keys=keys,
                                   extradata=annexb([sps, pps]) if p["strf"] else b"")
    record = avcc(sps, pps, p["nal_length"])
    if p["inband"]:  # avc3: the parameter sets are in the samples only
        record = record[:5] + b"\xe0\x00"
    box = struct.pack(">I", 8 + len(record)) + b"avcC" + record
    kw = {}
    if order != sorted(order):  # composition offsets, as libavformat's mov muxer writes them
        delay = max(d - v for d, v in enumerate(order))  # frames
        signed = p["ctts"] == "v1"
        kw = dict(ctts=[(v - d + (0 if signed else delay)) * 512 for d, v in enumerate(order)],
                  ctts_version=int(signed), elst=p["elst"], edit_frames=len(units),
                  media_time=0 if signed else delay)
    return mp4_cases.write_mp4([prefixed(u, p["nal_length"]) for u in units], w, h,
                               fourcc=b"avc3" if p["inband"] else b"avc1", config=box, keys=keys,
                               brand=b"qt  " if p["container"] == "mov" else b"isom", **kw)


def _make(kw: dict):
    """(params, NAL units a frame in decode order, sps, pps, the syntax
    written) of a stream; params["order"] holds the display index of each
    frame where B pictures reorder them."""
    p = _defaults()
    p.update(kw)
    wr = Writer(**p)
    sps, pps = wr.sps(), wr.pps()
    units = wr.packets()
    p["order"] = wr.order[p["cut"]:] if p["bframes"] else None
    return p, units, sps, pps, wr.seen


@functools.lru_cache(maxsize=None)
def stream(name: str):
    """(params, NAL units a frame, sps, pps) of case ``name`` (made once);
    SEEN[name] is then the syntax the writer wrote."""
    p, units, sps, pps, SEEN[name] = _make(_params(name))
    return p, units, sps, pps


def build_twin(name: str) -> bytes:
    """The file of CABAC case ``name``'s CAVLC twin (:func:`twin`)."""
    p, units, sps, pps, _ = _make(twin(name))
    return write(p, units, sps, pps)


SEEN = {}  # case -> the (element, value) pairs its writer wrote


@functools.lru_cache(maxsize=None)
def build(name: str) -> bytes:
    """The file bytes of CASES / REFUSED ``name`` (made once)."""
    p, units, sps, pps = stream(name)
    return write(p, units, sps, pps)


def _params(name: str) -> dict:
    for table in (CASES, HIGH):
        if name in table:
            return table[name]
    return (REFUSED.get(name) or HIGH_REFUSED[name])[0]


def suffix(name: str) -> str:
    p = _defaults()
    p.update(_params(name))
    return "." + p["container"]


# ------------------------------------------------------- real pictures

_CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]], np.int64)
_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)
_H2 = np.array([[1, 1], [1, -1]], np.int64)
_MF = np.array([[13107, 5243, 8066], [11916, 4660, 7490], [10082, 4194, 6554],
                [9362, 3647, 5825], [8192, 3355, 5243], [7282, 2893, 4559]], np.int64)
_POS = np.array([[0 if not (x & 1 or y & 1) else 1 if x & 1 and y & 1 else 2 for x in range(4)]
                 for y in range(4)])


def _yuv420(bgr):
    """BT.601 limited-range planes of a BGR u8 image (int64)."""
    b, g, r = (bgr[..., i].astype(np.float64) for i in range(3))
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    cb = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    cr = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    sub = lambda c: c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean((1, 3))
    return [np.clip(np.round(p), 0, 255).astype(np.int64) for p in (y, sub(cb), sub(cr))]


def _blocks(plane):
    """(rows/4, cols/4, 4, 4) view of a plane."""
    h, w = plane.shape
    return plane.reshape(h // 4, 4, w // 4, 4).swapaxes(1, 2)


def _unblocks(b):
    return b.swapaxes(1, 2).reshape(b.shape[0] * 4, b.shape[1] * 4)


def _quant(w, q, intra, shift=0, mf=None):
    mf = _MF[q % 6][_POS] if mf is None else mf
    qbits = 15 + q // 6 + shift
    f = (1 << qbits) // (3 if intra else 6)
    return np.sign(w) * ((np.abs(w) * mf + f) >> qbits)


def _dequant(lv, q):
    return (lv * np.array(NORM_ADJUST)[q % 6][_POS]) << (q // 6)


def _idct(d):
    """8.5.12 on (..., 4, 4), rows then columns, (x + 32) >> 6."""
    d = d.copy()
    for axis in (-1, -2):
        d = np.moveaxis(d, axis, -1)
        e0, e1 = d[..., 0] + d[..., 2], d[..., 0] - d[..., 2]
        e2, e3 = (d[..., 1] >> 1) - d[..., 3], d[..., 1] + (d[..., 3] >> 1)
        d = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)
        d = np.moveaxis(d, -1, axis)
    return (d + 32) >> 6


def _residual(res, q, intra, dc_mode):
    """Levels (raster 4x4 blocks) and reconstructed residual of ``res``
    ((n, 4, 4, 4, 4) blocks of n macroblocks' 16x16 or 8x8 planes).
    ``dc_mode``: "luma16" (Intra16x16 DC), "chroma" (2x2 DC) or None."""
    w = np.einsum("ij,...jk,lk->...il", _CF, res, _CF)
    lv = _quant(w, q, intra)
    dc_lv = None
    if dc_mode == "luma16":
        dc = np.einsum("ij,...jk,kl->...il", _H4, w[..., 0, 0], _H4) >> 1
        dc_lv = _quant(dc, q, intra, 1, _MF[q % 6][0])
    elif dc_mode == "chroma":
        dc = np.einsum("ij,...jk,kl->...il", _H2, w[..., 0, 0], _H2)
        dc_lv = _quant(dc, q, intra, 1, _MF[q % 6][0])
    if dc_lv is not None:
        lv[..., 0, 0] = 0
    d = _dequant(lv, q)
    if dc_mode == "luma16":
        f = np.einsum("ij,...jk,kl->...il", _H4, dc_lv, _H4)
        ls = 16 * NORM_ADJUST[q % 6][0]
        d[..., 0, 0] = (f * ls) << (q // 6 - 6) if q >= 36 else \
            (f * ls + (1 << (5 - q // 6))) >> (6 - q // 6)
    elif dc_mode == "chroma":
        f = np.einsum("ij,...jk,kl->...il", _H2, dc_lv, _H2)
        d[..., 0, 0] = ((f * 16 * NORM_ADJUST[q % 6][0]) << (q // 6)) >> 5
    return lv, dc_lv, _idct(d)


def _scan(block):
    return [int(v) for v in block.reshape(16)[list(ZIGZAG)]]


# The 8x8 inverse transform's basis (a column a coefficient; orthogonal)
_CI8 = np.array([idct8_pass(list(1024 * np.eye(8, dtype=np.int64)[k])) for k in range(8)],
                np.float64).T / 1024
_LS8 = np.array([[[NORM_ADJUST8[m][_CLASS8[y & 3][x & 3]] * 16 for x in range(8)] for y in range(8)]
                 for m in range(6)], np.int64)  # LevelScale8x8 of Flat_16


def _levels8(res, q, intra):
    """Levels (raster 8x8 blocks) and reconstructed residual of ``res``
    ((..., 8, 8)) under Flat_16: each level the residual's projection on its
    basis image in units of its dequantised step, rounded with a dead zone."""
    step = (_LS8[q % 6] << (q // 6)) / 64.0 / 64.0  # a level's scaled coefficient / 64
    norms = np.einsum("ij,ij->j", _CI8, _CI8)
    proj = np.einsum("ai,...ab,bj->...ij", _CI8, res.astype(np.float64), _CI8)
    lv = proj / (np.outer(norms, norms) * step)
    lv = (np.sign(lv) * np.floor(np.abs(lv) + (1 / 3 if intra else 1 / 6))).astype(np.int64)
    d = (lv * (_LS8[q % 6] << (q // 6)) + 32) >> 6
    return lv, idct8(d)


def _scan8(block):
    return [int(v) for v in block.reshape(64)[list(ZIGZAG8)]]


class _ClipWriter:
    """Codes whole pictures: an IDR picture whose first row of macroblocks
    is I_PCM and whose others are Intra16x16 vertical (chroma vertical),
    then P pictures predicted from the picture before at zero motion
    (P_L0_16x16, or P_Skip where nothing is coded), in CAVLC or CABAC.  The
    encoder's own reconstruction leaves out the deblocking filter: the
    drift is harmless.  With ``bframes`` (CABAC, as x264's Main profile
    writes it: ``--bframes 2 --direct spatial --weightb``, no pyramid) the
    anchors are every third picture and the last, and the non-reference B
    pictures between them are predicted from the anchors on either side at
    zero motion with implicit weights (B_Bi_16x16, or B_Skip, whose
    spatial direct prediction is the same, where nothing is coded).  With
    ``high`` (High profile, as x264's default with ``--cqm flat``): the IDR
    picture's macroblocks below the first row are I_NxN with Intra8x8
    vertical in each 8x8 block, and the luma residual of P and B
    macroblocks uses the 8x8 transform."""

    def __init__(self, h, w, qp, cabac=False, bframes=False, high=False):
        self.h, self.w, self.qp, self.cabac, self.high = h, w, qp, cabac, high
        self.mbw, self.mbh = -(-w // 16), -(-h // 16)  # the frame cropped from the coded size
        kw = dict(max_refs=2, vui=True, reorder=1, bipred=2) if bframes else dict(max_refs=1)
        if high:
            kw.update(transform_8x8=1)
        self.wr = Writer(size=(h, w), log2_max_frame_num=4, log2_max_poc_lsb=8, qp=(qp, qp),
                         cabac=int(cabac), profile=100 if high else 77 if cabac else 66, **kw)
        self.recon = None
        self.anchors = {}  # display index -> the reconstructed planes of an anchor

    def b_picture(self, bgr, i, fn, prev, nxt):
        """B picture ``i`` (frame_num ``fn``) between anchors ``prev`` and
        ``nxt`` (display indices)."""
        pad = ((0, self.mbh * 16 - self.h), (0, self.mbw * 16 - self.w), (0, 0))
        planes = _yuv420(np.pad(bgr, pad, mode="edge"))
        # the implicit weights of refIdx 0 in each list (8.4.2.3.1): w1 = DistScaleFactor >> 2
        tb, td = 2 * (i - prev), 2 * (nxt - prev)
        w1 = (tb * ((16384 + td // 2) // td) + 32) >> 8
        w0 = 64 - w1
        bw = Bits()
        bw.ue(0)
        bw.ue(6)  # B, every slice of the picture
        bw.ue(0)
        bw.u(fn % 16, 4)
        bw.u(2 * i, 8)
        bw.u(1, 1)  # direct_spatial_mv_pred_flag
        bw.u(0, 1)  # num_ref_idx_active_override_flag
        bw.u(0, 1)  # ref_pic_list_modification_flag_l0
        bw.u(0, 1)  # ref_pic_list_modification_flag_l1
        bw.ue(0)  # cabac_init_idc
        bw.se(0)
        bw.ue(0)
        bw.se(0)
        bw.se(0)
        mbw, mbh, q = self.mbw, self.mbh, self.qp
        coded = {}
        for c, n in ((0, 16), (1, 8), (2, 8)):
            pred = (self.anchors[prev][c] * w0 + self.anchors[nxt][c] * w1 + 32) >> 6
            if c == 0 and self.high:
                res = (planes[0] - pred).reshape(mbh, 2, 8, mbw, 2, 8).transpose(0, 3, 1, 4, 2, 5)
                coded[0] = (_levels8(res, q, False)[0], None)
                continue
            blk = _blocks(planes[c] - pred).reshape(mbh, n // 4, mbw, n // 4, 4, 4)
            lv, dc_lv, _ = _residual(blk.transpose(0, 2, 1, 3, 4, 5), q if c == 0 else CHROMA_QP[q],
                                     False, None if c == 0 else "chroma")
            coded[c] = (lv, dc_lv)
        st = self.wr
        st.new_state()
        st.slc = [0] * st.nmb
        e = st.coder(bw, True, 0, q, b_slice=True)
        for my in range(mbh):
            for mx in range(mbw):
                m = my * mbw + mx
                ly, u, v = (coded[c][0][my, mx] for c in range(3))
                udc, vdc = coded[1][1][my, mx], coded[2][1][my, mx]
                cbp_c, cbp_l = self._cbp(ly, u, v, udc, vdc)
                if not cbp_l and not cbp_c:
                    st.kind[m] = "skip"
                    st.direct[m] = 31
                    e.skip(m)
                    e.mb_end(m, m == st.nmb - 1)
                    continue
                e.mb_start(m)
                st.kind[m] = "p"
                e.mb_type_b(m, 3)  # B_Bi_16x16
                for l in range(2):
                    e.ref(m, 0, 0, 16, 16, 0, 1, l)
                for l in range(2):
                    e.mvd(m, 0, 0, 16, 16, 0, 0, l)
                    e.mvd(m, 0, 0, 16, 16, 1, 0, l)
                e.cbp(m, cbp_l | cbp_c << 4, False)
                if self.high and cbp_l:
                    e.transform8(m, True)
                e.qp_delta(0)
                self._blocks(e, m, ly, u, v, udc, vdc, cbp_l, cbp_c, False)
                e.mb_end(m, m == st.nmb - 1)
        return [nal(0, 1, e.finish())]

    @staticmethod
    def _cbp(ly, u, v, udc, vdc):
        """(chroma, luma) coded_block_pattern of a macroblock's levels (the
        luma part as an inter macroblock codes it; ``ly``: (4, 4, 4, 4)
        4x4 blocks, or (2, 2, 8, 8) 8x8 blocks)."""
        cbp_c = 2 if (u.reshape(2, 2, 16)[..., 1:].any() or v.reshape(2, 2, 16)[..., 1:].any()) \
            else 1 if (udc.any() or vdc.any()) else 0
        if ly.shape[-1] == 8:
            nz8 = [ly[k // 2, k % 2].any() for k in range(4)]
        else:
            nz8 = [ly[2 * (k // 2):2 * (k // 2) + 2, 2 * (k % 2):2 * (k % 2) + 2].any()
                   for k in range(4)]
        return cbp_c, sum(1 << k for k in range(4) if nz8[k])

    def _blocks(self, e, m, ly, u, v, udc, vdc, cbp_l, cbp_c, intra16):
        """A macroblock's residual blocks after its header: luma (the AC
        blocks of Intra16x16, or the 4x4 blocks of each coded 8x8), chroma
        DC and AC."""
        st = self.wr
        if ly.shape[-1] == 8:  # the 8x8 transform
            for b8 in range(4):
                if cbp_l >> b8 & 1:
                    e.block8(m, b8, _scan8(ly[b8 // 2, b8 % 2]))
        for blk in range(16 if ly.shape[-1] == 4 else 0):
            bx, by = _blk_xy(blk)
            if intra16 and cbp_l:
                st.tcl[m][by * 4 + bx] = e.block(m, 1, bx, by, 0, _scan(ly[by, bx])[1:])
            elif not intra16 and cbp_l >> (blk // 4) & 1:
                st.tcl[m][by * 4 + bx] = e.block(m, 2, bx, by, 0, _scan(ly[by, bx]))
        if cbp_c:
            for c, dcv in enumerate((udc, vdc)):
                e.block(m, 3, 0, 0, c, [int(x) for x in dcv.reshape(4)])
        for c, pl in enumerate((u, v)):
            for k in range(4):
                bx, by = k % 2, k // 2
                if cbp_c == 2:
                    st.tcc[m][c][by * 2 + bx] = e.block(m, 4, bx, by, c, _scan(pl[by, bx])[1:])

    def _intra8_row(self, src, recon, my, q):
        """The luma levels ((mbw, 2, 2, 8, 8)) of macroblock row ``my`` (below
        the first) coded as Intra8x8 vertical, and its reconstruction into
        ``recon``: each 8x8 block predicts from the filtered samples above it
        (8.3.2.2.1; p[8..15, -1] from the macroblock above, or above right,
        or the block above right, else p[7, -1] repeated; p[-1, -1] where the
        block on the left is there), the top blocks of the row first."""
        mbw, y0 = self.mbw, my * 16
        lv = np.zeros((mbw, 2, 2, 8, 8), np.int64)
        for by in range(2):
            yy = y0 + 8 * by
            above = recon[yy - 1]
            for bx in range(2):
                xs = np.arange(mbw) * 16 + 8 * bx
                t = np.stack([above[xs + i] for i in range(8)], 1)  # p[0..7, -1]
                if (bx, by) == (1, 1):
                    right_ok = np.zeros(mbw, bool)
                elif (bx, by) == (1, 0):
                    right_ok = np.arange(mbw) < mbw - 1  # the macroblock above right
                else:
                    right_ok = np.ones(mbw, bool)
                t8 = np.where(right_ok, above[np.minimum(xs + 8, recon.shape[1] - 1)], t[:, 7])
                c = np.where(xs > 0, above[np.maximum(xs - 1, 0)], t[:, 0])  # p[-1, -1] or none
                p = np.empty((mbw, 8), np.int64)
                p[:, 0] = (c + 2 * t[:, 0] + t[:, 1] + 2) >> 2
                p[:, 1:7] = (t[:, :6] + 2 * t[:, 1:7] + t[:, 2:8] + 2) >> 2
                p[:, 7] = (t[:, 6] + 2 * t[:, 7] + t8 + 2) >> 2
                pred = np.repeat(p[:, None, :], 8, 1)
                blk = np.stack([src[yy:yy + 8, x:x + 8] for x in xs]) - pred
                lv[:, by, bx], r = _levels8(blk, q, True)
                out = np.clip(pred + r, 0, 255)
                for k, x in enumerate(xs):
                    recon[yy:yy + 8, x:x + 8] = out[k]
        return lv

    def picture(self, bgr, i, fn=None):
        pad = ((0, self.mbh * 16 - self.h), (0, self.mbw * 16 - self.w), (0, 0))
        planes = _yuv420(np.pad(bgr, pad, mode="edge"))
        bw = Bits()
        idr = i == 0
        bw.ue(0)
        bw.ue(7 if idr else 5)
        bw.ue(0)
        bw.u((i if fn is None else fn) % 16, 4)
        if idr:
            bw.ue(0)
        bw.u(2 * i, 8)
        if not idr:
            bw.u(0, 1)  # num_ref_idx_active_override_flag
            bw.u(0, 1)  # ref_pic_list_modification_flag
        bw.u(0, 1)
        if idr:
            bw.u(0, 1)
        elif self.cabac:
            bw.ue(0)  # cabac_init_idc
        bw.se(0)
        bw.ue(0)
        bw.se(0)
        bw.se(0)
        mbw, mbh, q = self.mbw, self.mbh, self.qp
        qc = CHROMA_QP[q]
        recon = [np.zeros_like(p) for p in planes]
        if idr:
            recon[0][:16], recon[1][:8], recon[2][:8] = planes[0][:16], planes[1][:8], planes[2][:8]
            coded = {}
            for my in range(1, mbh):
                coded[my] = []
                for c, n in ((0, 16), (1, 8), (2, 8)):
                    y0 = my * n
                    if c == 0 and self.high:
                        coded[my].append((self._intra8_row(planes[0], recon[0], my, q), None))
                        continue
                    pred = np.repeat(recon[c][y0 - 1:y0], n, 0)
                    res = planes[c][y0:y0 + n] - pred
                    blk = _blocks(res).reshape(n // 4, mbw, n // 4, 4, 4).transpose(1, 0, 2, 3, 4)
                    lv, dc_lv, r = _residual(blk, q if c == 0 else qc, True,
                                             "luma16" if c == 0 else "chroma")
                    out = _unblocks(r.transpose(1, 0, 2, 3, 4).reshape(n // 4, mbw * n // 4, 4, 4))
                    recon[c][y0:y0 + n] = np.clip(pred + out, 0, 255)
                    coded[my].append((lv, dc_lv))
        else:
            coded = {}
            ref = self.recon
            for c, n in ((0, 16), (1, 8), (2, 8)):
                res = planes[c] - ref[c]
                if c == 0 and self.high:
                    lv, r = _levels8(res.reshape(mbh, 2, 8, mbw, 2, 8).transpose(0, 3, 1, 4, 2, 5),
                                     q, False)
                    recon[0] = np.clip(ref[0] + r.transpose(0, 2, 4, 1, 3, 5).reshape(res.shape),
                                       0, 255)
                    coded[0] = (lv, None)
                    continue
                blk = _blocks(res).reshape(mbh, n // 4, mbw, n // 4, 4, 4)
                blk = blk.transpose(0, 2, 1, 3, 4, 5)
                lv, dc_lv, r = _residual(blk, q if c == 0 else qc, False,
                                         None if c == 0 else "chroma")
                out = r.transpose(0, 2, 1, 3, 4, 5).reshape(mbh * n // 4, mbw * n // 4, 4, 4)
                recon[c] = np.clip(ref[c] + _unblocks(out), 0, 255)
                coded[c] = (lv, dc_lv)
        st = self.wr
        st.new_state()
        st.slc = [0] * st.nmb
        e = st.coder(bw, not idr, 0, q)
        for my in range(mbh):
            for mx in range(mbw):
                m = my * mbw + mx
                if idr and my == 0:
                    e.mb_start(m)
                    e.mb_type_i(m, 25)
                    e.pcm(b"".join(planes[c][:n, mx * n:(mx + 1) * n].astype(np.uint8).tobytes()
                                   for c, n in ((0, 16), (1, 8), (2, 8))))
                    st.kind[m] = "pcm"
                    st.tcl[m] = 16
                    st.tcc[m] = 16
                    e.mb_end(m, m == st.nmb - 1)
                    continue
                if idr:
                    (ly, ldc), (u, udc), (v, vdc) = coded[my]
                    ly, u, v = ly[mx], u[mx], v[mx]
                    ldc, udc, vdc = None if ldc is None else ldc[mx], udc[mx], vdc[mx]
                else:
                    ly, u, v = (coded[c][0][my, mx] for c in range(3))
                    udc, vdc = coded[1][1][my, mx], coded[2][1][my, mx]
                    ldc = None
                cbp_c, cbp_l = self._cbp(ly, u, v, udc, vdc)
                if idr and self.high:  # I_NxN, Intra8x8 vertical in each 8x8 block
                    e.mb_start(m)
                    e.mb_type_i(m, 0)
                    st.kind[m] = "i4"
                    e.transform8(m, True)
                    st.i4[m][:] = 0
                    for b8 in range(4):
                        e.i4_mode(st._i4_pred(m, 2 * (b8 % 2), 2 * (b8 // 2)), 0)
                    e.chroma_mode(m, 2)  # vertical
                    e.cbp(m, cbp_l | cbp_c << 4, True)
                    if cbp_l or cbp_c:
                        e.qp_delta(0)
                elif idr:
                    cbp_l = 15 if ly.reshape(4, 4, 16)[..., 1:].any() else 0
                    e.mb_start(m)
                    e.mb_type_i(m, 1 + 4 * cbp_c + (12 if cbp_l else 0))
                    e.chroma_mode(m, 2)  # vertical
                    e.qp_delta(0)
                    st.kind[m] = "i16"
                    st.cbp[m] = cbp_l | cbp_c << 4
                    e.block(m, 0, 0, 0, 0, _scan(ldc))
                else:
                    if not cbp_l and not cbp_c:
                        st.kind[m] = "skip"
                        st.refidx[m] = [0] * 16
                        e.skip(m)
                        e.mb_end(m, m == st.nmb - 1)
                        continue
                    e.mb_start(m)
                    st.kind[m] = "p"
                    e.mb_type_p(m, 0)  # P_L0_16x16
                    e.ref(m, 0, 0, 16, 16, 0, 1)
                    e.mvd(m, 0, 0, 16, 16, 0, 0)
                    e.mvd(m, 0, 0, 16, 16, 1, 0)
                    e.cbp(m, cbp_l | cbp_c << 4, False)
                    if self.high and cbp_l:
                        e.transform8(m, True)
                    e.qp_delta(0)
                self._blocks(e, m, ly, u, v, udc, vdc, cbp_l, cbp_c, idr and not self.high)
                e.mb_end(m, m == st.nmb - 1)
        self.recon = recon
        self.anchors[i] = recon
        return [nal(3, 5 if idr else 1, e.finish())]


def encode_clip(frames, qp: int = 30, cabac: bool = False, bframes: bool = False,
                high: bool = False) -> bytes:
    """An MP4 of ``frames`` (BGR u8 of even sizes; coded at multiples of 16
    and cropped) as real pictures at QP ``qp`` (:class:`_ClipWriter`), in
    CAVLC (Constrained Baseline) or CABAC (Main profile): the same
    macroblocks and levels either way, so the same decoded frames.  With
    ``bframes`` (CABAC): I P B B, two B pictures between anchors, with
    composition offsets, an edit list and num_reorder_frames 1.  With
    ``high``: High profile (see :class:`_ClipWriter`)."""
    h, w = frames[0].shape[:2]
    cw = _ClipWriter(h, w, qp, cabac, bframes, high)
    p = _defaults()
    p.update(size=(h, w), idr=(0,))
    if not bframes:
        units = [cw.picture(f, i) for i, f in enumerate(frames)]
        return write(p, units, cw.wr.sps(), cw.wr.pps())
    n = len(frames)
    anchors = sorted({*range(0, n, 3), n - 1})
    order, units, fn = [0], [cw.picture(frames[0], 0, 0)], 1
    for prev, nxt in zip(anchors, anchors[1:]):
        order.append(nxt)
        units.append(cw.picture(frames[nxt], nxt, fn))
        fn += 1
        for i in range(prev + 1, nxt):
            order.append(i)
            units.append(cw.b_picture(frames[i], i, fn, prev, nxt))
    p.update(order=order)
    return write(p, units, cw.wr.sps(), cw.wr.pps())


def clip_frames():
    """The 720p clip's source frames: ``jpeg_frames.frame``'s first 8."""
    import jpeg_frames

    return [jpeg_frames.frame(720, 1280, i) for i in range(8)]


# Each case is a stream of CLIP_FRAMES frames at CLIP_SIZE (coded 112x80),
# I/IDR at 0, 12 and 24 unless it says otherwise.
CASES = {
    # I_PCM and P_Skip, POC type 0: the simplest pictures
    "pcm_skip": dict(seed=1, i_mix=dict(pcm=1), p_mix=dict(skip=6, p16=1), density=0.0),
    # every intra macroblock type and mode, one to four slices, QPs 0-51
    # through mb_qp_delta, chroma offset -7, deblocking idc 0 and 2
    "intra": dict(seed=2, idr=(0, 12, 24), intra=tuple(range(26)), slices=(1, 2, 4),
                  qp=(0, 51), chroma_offset=-7, deblock=((0, 0, 0), (2, 3, -2), (0, -6, 6))),
    # every inter type and sub-type, up to 4 references, list modification,
    # MMCO 1, num_ref_idx override, vectors far out of the picture; POC 2
    "inter": dict(seed=3, poc_type=2, max_refs=4, refs_default=3, override=0.3, modify=0.5,
                  mmco=0.3, far=0.03, mvd=40, slices=(1, 3), qp=(10, 40), chroma_offset=5,
                  p_mix=dict(skip=3, p16=2, p16x8=2, p8x16=2, p8x8=3, p8x8ref0=1, intra=1),
                  deblock=((0, 2, 2), (0, -3, 1), (2, 6, 6), (1, 0, 0))),
    # QuickTime, several slices mixing I and P, idc 2, non-reference frames
    "mixed_mov": dict(seed=4, container="mov", max_refs=2, refs_default=2, slices=(2, 5),
                      nonref=(3, 7, 15, 16, 21), deblock=((2, 0, 0), (0, -6, -6)), qp=(18, 34),
                      aud=True, sei=True),
    # AVI (Annex B, SPS/PPS in the IDR chunks), POC type 2
    "avi": dict(seed=5, container="avi", inband=True, fourcc="H264", poc_type=2, max_refs=2,
                refs_default=2, slices=(1, 2), nonref=(5, 9, 17)),
    "avi_x264": dict(seed=6, container="avi", inband=True, fourcc="X264", max_refs=3,
                     refs_default=1, override=0.5, modify=0.4, slice_types=(0, 2, 5)),
    # the parameter sets in strf's extradata, not in the chunks; fourcc avc1
    "avi_strf": dict(seed=14, container="avi", strf=True, fourcc="avc1", max_refs=2,
                     refs_default=2),
    # POC out of decode order (display 0, 2, 1, 4, 3, ...: P pictures only)
    "avi_poc_order": dict(seed=15, container="avi", inband=True, poc_order="swap", idr=(0,),
                          max_refs=2, refs_default=2),
    # avc3: the parameter sets in the IDR samples, none in avcC
    "avc3": dict(seed=16, inband=True, max_refs=2, refs_default=2, slices=(1, 2)),
    # one IDR: frame_num and POC lsb wrap; I pictures at 8 and 16 not in stss
    "one_idr": dict(seed=7, idr=(0,), intra=(8, 16), max_refs=3, refs_default=3, mmco=0.4,
                    log2_max_poc_lsb=4, modify=0.3),
    # the VUI: full range, timing, no reordering
    "full_range": dict(seed=8, vui=True, full_range=1, timing=True, reorder=0,
                       i_mix=dict(pcm=2, i4=1, i16=1)),
    "limited_vui": dict(seed=9, vui=True, full_range=0, i_mix=dict(pcm=2, i4=1, i16=1)),
    # FFmpeg's output delay: num_reorder_frames 1, and POC steps of 4
    "reorder1": dict(seed=10, vui=True, reorder=1, max_refs=2, refs_default=2),
    "poc_step4": dict(seed=11, poc_step=4, max_refs=2, refs_default=1),
    # NAL length sizes 2 and 1 (small slices)
    "nal_length2": dict(seed=12, nal_length=2, slices=(2, 3)),
    "nal_length1": dict(seed=13, nal_length=1, slices=(35,), i_mix=dict(i16=1, i4=1),
                        density=0.08, big=0.0),
    # Main profile, CABAC: every I mb_type and mode, QPs 0-51, I_PCM
    "cabac_intra": dict(seed=17, frames=12, profile=77, cabac=1, intra=tuple(range(12)),
                        slices=(1, 2, 4), qp=(0, 51), chroma_offset=-7,
                        deblock=((0, 0, 0), (2, 3, -2), (0, -6, 6))),
    # every P partition and sub-type (P_8x8ref0 is P_8x8 with every ref_idx
    # 0 under CABAC), 4 references, list modification, far vectors, I_PCM
    # and intra types in P slices
    "cabac_inter": dict(seed=18, profile=77, cabac=1, poc_type=2, max_refs=4, refs_default=3,
                        override=0.3, modify=0.5, mmco=0.3, far=0.03, mvd=40, slices=(1, 3),
                        qp=(10, 40), chroma_offset=5,
                        p_mix=dict(skip=3, p16=2, p16x8=2, p8x16=2, p8x8=3, p8x8ref0=1, intra=1),
                        deblock=((0, 2, 2), (0, -3, 1), (2, 6, 6), (1, 0, 0))),
    # QuickTime, up to 5 slices mixing I and P, each with its cabac_init_idc
    "cabac_slices": dict(seed=19, frames=12, profile=77, cabac=1, container="mov", max_refs=2,
                         refs_default=2, slices=(2, 5), nonref=(3, 7), qp=(18, 34),
                         deblock=((2, 0, 0), (0, -6, -6)), aud=True, sei=True),
    # explicit weighted prediction of P slices, CABAC in AVI and CAVLC in MP4
    "cabac_weighted": dict(seed=20, frames=12, profile=77, cabac=1, weighted=1, container="avi",
                           inband=True, max_refs=3, refs_default=2, override=0.5, modify=0.4,
                           mvd=12, p_mix=dict(skip=2, p16=2, p16x8=1, p8x16=1, p8x8=2, intra=1)),
    "cavlc_weighted": dict(seed=21, frames=12, profile=77, weighted=1, max_refs=3, refs_default=3,
                           modify=0.4, mvd=12,
                           p_mix=dict(skip=2, p16=2, p16x8=1, p8x16=1, p8x8=2, p8x8ref0=1)),
    # FFmpeg's output delay under Main profile: num_reorder_frames 1
    "cabac_reorder1": dict(seed=22, frames=12, profile=77, cabac=1, vui=True, reorder=1,
                           max_refs=2, refs_default=2),
    # B slices (Main profile), MP4 with ctts and elst unless said otherwise:
    # one B picture between anchors, num_reorder_frames 1
    "b_slices": dict(seed=23, frames=6, idr=(0,), profile=77, bframes=1, vui=True, reorder=1,
                     max_refs=2, refs_default=1, mvd=12),
    # two B pictures, CABAC
    "cabac_b_slices": dict(seed=24, frames=6, idr=(0,), profile=77, cabac=1, bframes=2, vui=True,
                           reorder=2, max_refs=2, refs_default=1, mvd=12),
    # spatial direct with direct_8x8_inference 1, 2-3 references a list,
    # list modification of both, every B mb_type and sub_mb_type
    "cabac_b_spatial": dict(seed=25, profile=77, cabac=1, bframes=2, direct="spatial", max_refs=3,
                            refs_default=2, refs_l1=2, override=0.3, modify=0.4, vui=True,
                            reorder=2, mvd=12, qp=(16, 40)),
    # temporal direct with direct_8x8_inference 0, up to 4 references a
    # list, several slices (I among B), QuickTime with signed offsets (ctts
    # version 1)
    "cabac_b_temporal": dict(seed=26, profile=77, cabac=1, bframes=2, direct="temporal",
                             direct8x8=0, max_refs=4, refs_default=4, refs_l1=4, override=0.3,
                             modify=0.4, container="mov", ctts="v1", vui=True, reorder=2,
                             mvd=12, slices=(1, 3), deblock=((0, 0, 0), (0, -3, 3), (2, 2, 2))),
    # reference B pictures (a pyramid of three) with MMCO 1, implicit
    # weights, spatial and temporal direct by slice; no bitstream
    # restriction (FFmpeg's POC heuristic sets the delay) and no edit list
    "cabac_b_pyramid": dict(seed=31, profile=77, cabac=1, bframes=3, pyramid=True, direct="mix",
                            bipred=2, max_refs=4, refs_default=2, refs_l1=2, mmco=0.6,
                            elst=False, mvd=12),
    # explicit weighted bi-prediction, direct_8x8_inference 0, AVI
    "cabac_b_explicit": dict(seed=28, profile=77, cabac=1, bframes=1, bipred=1, direct="mix",
                             direct8x8=0, container="avi", inband=True, max_refs=3,
                             refs_default=2, refs_l1=2, vui=True, reorder=1, modify=0.3, mvd=12),
    # AVI without bitstream restriction, and open GOPs: I pictures (key
    # frames in idx1) every 4 frames after the IDR picture, each followed in
    # decode order by the B picture before it
    "b_avi_open_gop": dict(seed=29, profile=77, bframes=1, idr=(0,), intra=(4, 8, 12, 16, 20, 24),
                           keys=(0, 4, 8, 12, 16, 20, 24), container="avi", inband=True,
                           max_refs=2, refs_default=1, mvd=12),
    "cabac_b_open_gop": dict(seed=30, profile=77, cabac=1, bframes=1, idr=(0,),
                             intra=(4, 8, 12, 16, 20, 24), keys=(0, 4, 8, 12, 16, 20, 24),
                             max_refs=2, refs_default=1, mvd=12, bipred=2),
}

# C10: streams that do not start on an IDR picture (I pictures at 0 and 12
# in stss / idx1 unless said otherwise), each in MP4, QuickTime and AVI
# (parameter sets in strf) with 1 or 3 references:
# (a) an I picture at 0 and 12, no IDR picture, no SEI;
# (b) the same with a recovery point SEI (recovery_frame_cnt 0) at 0;
# (c) a stream cut at a P picture (the sixth of 31) whose recovery point SEI
#     names the P picture 3 frames on, I picture at 7;
# (d) an I picture at 0 and an IDR picture at 12.
C10 = {"a": dict(idr=(), intra=(0, 12), keys=(0, 12)),
       "b": dict(idr=(), intra=(0, 12), keys=(0, 12), recovery={0: 0}),
       "c": dict(idr=(0,), intra=(12,), keys=(0, 12), cut=5, recovery={5: 3}),
       "d": dict(idr=(12,), intra=(0,), keys=(0, 12))}
for _i, (_k, _refs, _box) in enumerate((k, r, b) for k in C10 for r in (1, 3)
                                      for b in ("mp4", "mov", "avi")):
    CASES[f"c10_{_k}{_refs}_{_box}"] = dict(
        C10[_k], seed=40 + _i, container=_box, strf=_box == "avi", max_refs=_refs,
        refs_default=_refs, density=0.1, p_mix=dict(skip=3, p16=2, p8x8=1, intra=1))
CABAC = [name for name, kw in CASES.items() if kw.get("cabac")]

# High profile (profile_idc 100: the 8x8 transform, Intra8x8, scaling
# lists, a chroma QP offset for each of Cb and Cr), 12 frames unless said
# otherwise: tests/test_torch_h264_high.py holds them.  Codes of a scaling
# list: None absent (its fall-back rule), "default" (useDefaultScalingMatrixFlag),
# "explicit" (weights drawn in ``scale_range``).
_HI = dict(frames=12, profile=100, transform_8x8=1)
HIGH = {
    # I pictures all I_8x8 (every mode whose neighbours exist, one to four
    # slices: picture and slice edges), QPs 0-51, deblocking idc 0 and 2
    "high_intra": dict(_HI, seed=60, cabac=1, intra=tuple(range(12)), i_mix=dict(i4=1), t8=1.0,
                       slices=(1, 2, 4), qp=(0, 51), chroma_offset=-4, chroma_offset2=3,
                       deblock=((0, 0, 0), (2, 3, -2), (0, -6, 6))),
    # I_8x8 beside I_4x4, Intra16x16 and I_PCM in one picture, then P, QuickTime
    "high_intra_mix": dict(_HI, seed=61, container="mov", intra=(0, 4, 8),
                           i_mix=dict(pcm=1, i4=4, i16=2), t8=0.5, slices=(1, 2), qp=(12, 40)),
    # P slices: 8x8-transform macroblocks beside 4x4 ones, P_8x8 whose
    # sub-partitions forbid the flag, 3 references, AVI
    "high_p": dict(_HI, seed=62, cabac=1, container="avi", inband=True, max_refs=3,
                   refs_default=2, override=0.3, modify=0.3, mvd=16, qp=(10, 44),
                   p_mix=dict(skip=3, p16=2, p16x8=2, p8x16=2, p8x8=4, intra=1),
                   deblock=((0, 0, 0), (0, -3, 3), (1, 0, 0))),
    # B slices with direct_8x8_inference_flag 1: B_Skip, B_Direct_16x16 and
    # B_8x8 with direct sub-blocks beside 8x8-transform macroblocks, a
    # reference-B pyramid, spatial and temporal direct; MP4 with ctts
    "high_b": dict(_HI, seed=63, frames=26, cabac=1, bframes=3, pyramid=True, direct="mix",
                   bipred=2, max_refs=4, refs_default=2, refs_l1=2, vui=True, reorder=2, mvd=12,
                   qp=(16, 40)),
    # SPS lists: explicit, use-default and absent (rule A) in one SPS
    "high_sps_lists": dict(_HI, seed=64, max_refs=2, refs_default=2, qp=(14, 38),
                           sps_scaling=("explicit", "default", None, "explicit", None, "default",
                                        "explicit", "default")),
    # an SPS whose flag is set with no list present: rule A gives the
    # Default_* matrices (not Flat_16), CABAC in QuickTime
    "high_sps_default": dict(_HI, seed=65, cabac=1, container="mov", qp=(16, 36),
                             sps_scaling=(None,) * 8),
    # PPS lists overriding the SPS's (rule B: an absent list takes the SPS's)
    "high_pps_lists": dict(_HI, seed=66, container="avi", inband=True, qp=(14, 38),
                           sps_scaling=("explicit", None, "explicit", "explicit", "default", None,
                                        "explicit", "explicit"),
                           pps_scaling=(None, "explicit", None, "default", None, "explicit", None,
                                        "explicit")),
    # PPS lists under an SPS without lists (rule A again), wide weights
    "high_pps_only": dict(_HI, seed=67, cabac=1, qp=(10, 40), scale_range=(2, 96),
                          pps_scaling=("explicit", "explicit", None, None, "explicit", "default",
                                       "explicit", None)),
    # second_chroma_qp_index_offset apart from the first at QPs 0-51; no 8x8
    # transform, the PPS's six 4x4 lists (the 8x8 ones stay the SPS's)
    "high_chroma_qp": dict(_HI, seed=68, transform_8x8=0, container="avi", strf=True,
                           qp=(0, 51), chroma_offset=9, chroma_offset2=-12,
                           pps_scaling=("explicit", "explicit", "explicit", None, None, None)),
    # QPs 0-51 and large levels: the 8x8 blocks' intermediates up to the
    # 16-bit limits the writer keeps
    "high_limits": dict(_HI, seed=69, cabac=1, qp=(0, 51), density=0.9, big=0.4, t8=1.0,
                        max_refs=2, refs_default=2, mvd=12,
                        p_mix=dict(skip=1, p16=3, p8x8=1, intra=2)),
    # Main profile (constraint_set1) whose PPS carries the High fields
    # (transform_8x8_mode_flag 1, lists, a second chroma offset): FFmpeg
    # reads none of them, and the slices are coded without them
    "main_pps_ext": dict(frames=12, seed=70, profile=77, pps_ext=True, chroma_offset=4,
                         chroma_offset2=-8, qp=(16, 36), i_mix=dict(i4=3, i16=1),
                         pps_scaling=("explicit",) * 8),
}
HIGH_CABAC = [name for name, kw in HIGH.items() if kw.get("cabac")]


def twin(name: str) -> dict:
    """The CAVLC twin of CABAC case ``name``: the same draws from the same
    seed, so the same macroblocks and the same decoded frames."""
    return dict(CASES.get(name) or HIGH[name], cabac=0)

# name -> (stream keywords, the words the refusal names); 6 frames each
REFUSED = {
    "interlaced": (dict(frames=6, frame_mbs_only=0), "field"),
    "slice_groups": (dict(frames=6, slice_groups=2), "slice groups"),
    "redundant": (dict(frames=6, redundant=1), "redundant pictures"),
    "chroma_422": (dict(frames=6, profile=122, chroma_format=2), "chroma_format_idc 2"),
    "bit_depth_10": (dict(frames=6, profile=110, bit_depth=10), "bit depth 10"),
    "constrained_intra": (dict(frames=6, constrained_intra=1), "constrained_intra_pred"),
    "poc_type_1": (dict(frames=6, poc_type=1), "pic_order_cnt_type 1"),
    "sp_slices": (dict(frames=6, slice_types=(3,), idr=(0,)), "SP and SI slices"),
    "slice_order": (dict(frames=6, aso=True, slices=(3,)), "arbitrary slice order"),
    "frame_num_gap": (dict(frames=6, gap_at=5, gaps=1), "gaps in frame_num"),
    "long_term": (dict(frames=6, long_term=1), "long-term reference pictures"),
    "mmco5": (dict(frames=6, mmco5_at=4), "memory_management_control_operation 5"),
    "data_partitioning": (dict(frames=6, partition_at=3), "data partitioning"),
    # what Main and High profile files hold beyond what is decoded, under CABAC
    "cabac_mbaff": (dict(frames=6, profile=77, cabac=1, frame_mbs_only=0, mbaff=1), "MBAFF"),
    # what stays refused inside B slices: a long-term picture named in list 1
    "b_long_term_l1": (dict(frames=6, profile=77, bframes=1, idr=(0,), l1_long_term=True),
                       "long-term reference pictures"),
    "cabac_b_long_term_l1": (dict(frames=6, profile=77, cabac=1, bframes=2, idr=(0,),
                                  l1_long_term=True), "long-term reference pictures"),
}


# what High profile allows beyond what is decoded (tests/test_torch_h264_high.py)
HIGH_REFUSED = {
    "monochrome": (dict(frames=6, profile=100, chroma_format=0), "monochrome"),
}


def seeks(name: str):
    """The start_frame and ui seek targets PINNED holds for ``name``."""
    return CLIP_SEEKS if name.endswith("_720p") else SEEKS


def _reads(n, targets=SEEKS):
    """The reads PINNED holds for a clip of ``n`` frames that shows them in
    turn: frame ids index the frames a read from the start gives, and every
    start_frame and ui seek to k (made once 2 frames were read) reads on
    from frame k."""
    ids = tuple(range(n))
    after = {k: ids[k:k + READ_AFTER_SEEK] for k in targets}
    return dict(order=ids, start=after, ui=dict(after))


def _open_gop_reads(n):
    """The reads of the open-GOP cases, as FFmpeg gives them: a seek's step
    back lands on the I picture at 4 or 8, and the B picture after it in
    decode order (which predicts from pictures before the I picture) is not
    shown, so the frames counted from there run one ahead: start_frame and
    ui seeks to 20 read on from 21, and to 25 or later read nothing."""
    out = _reads(n)
    for k in ("start", "ui"):
        out[k].update({20: (21, 22, 23), 25: (), 26: (), 40: ()})
    return out


def _cut_reads(n):
    """The reads of C10's stream (c), which FFmpeg shows from its recovery
    point: ``n`` frames from the start, three from a start_frame of 0, and
    none after any other start_frame or ui seek (each lands before the
    recovery point, and OpenCV's frame numbers, taken from the first frame
    shown at open, never reach the target)."""
    return dict(order=tuple(range(n)), start={k: (0, 1, 2) if k == 0 else () for k in SEEKS},
                ui={k: () for k in SEEKS})


# What the JAX package's reader gives for each case: frame_count and fps as
# cv2.VideoCapture reports them, the reads (see _reads; the frames are
# identified by equality with those a read from the start gives) and the
# sha256 of the frames a read from the start gives, in order (FFmpeg's
# decode and swscale's conversion, which the port's equal bit for bit).
PINNED = {
    "pcm_skip": dict(count=26, fps=25.0, **_reads(26),
                 sha256="4683312305719ed663ec5e2f017ec10cfd713d95b6ec84e387b7e5eecf701c1c"),
    "intra": dict(count=26, fps=25.0, **_reads(26),
                 sha256="ca8950eb38500ab5de11cc54e5528bd15714ada5a3c117b63144e99644c8456d"),
    "inter": dict(count=26, fps=25.0, **_reads(26),
                 sha256="2a3ffdfd2abac89106463dc2bc993b65dbdffefb96d4cd62ec07f2e9bda803b8"),
    "mixed_mov": dict(count=26, fps=25.0, **_reads(26),
                 sha256="4bba323213b15e9cf35cca9d8c6a40ef3829393e0ef1200097d01733c5a07b93"),
    "avi": dict(count=26, fps=25.0, **_reads(26),
                 sha256="7d179d82b78f81e8c23a27efd5dfb7e22d476d48fe7cb39956a38a029edc4a6d"),
    "avi_x264": dict(count=26, fps=25.0, **_reads(26),
                 sha256="8adc7b7ef21fe8d74517dad4e7dd24d43153ed94d7e3dc4724ade3b277bc5b98"),
    "avi_strf": dict(count=26, fps=25.0, **_reads(26),
                 sha256="c149528e2408d3cebe6ec0f13710360f72cab656e503eaa56c39c7be97fed0bb"),
    "avi_poc_order": dict(count=26, fps=25.0, **_reads(26),
                 sha256="f89c760d2b12468bd29d72eb6888c30b8796ac9cf257484b048f210908054b84"),
    "avc3": dict(count=26, fps=25.0, **_reads(26),
                 sha256="fa127e0f08f6a5040e4ae4f107564523838cfc5ff40acb13cd0adc58931c6d5f"),
    "one_idr": dict(count=26, fps=25.0, **_reads(26),
                 sha256="7adf7dadeaac516c64778b7c1750a8014ef8e0b41d07c29c335ab841169719a5"),
    "full_range": dict(count=26, fps=25.0, **_reads(26),
                 sha256="e8bf901f89dce1d4b21bd5656f91f914ad333dbc8b745977e3061f348b3449eb"),
    "limited_vui": dict(count=26, fps=25.0, **_reads(26),
                 sha256="e5bd5a40c72f43aa9beeaf3081912ad37afbdcf1dfd330d5aad51d41bae10934"),
    "reorder1": dict(count=26, fps=25.0, **_reads(26),
                 sha256="9e3883d03f04833cc809993e5f160cd90b0aa9a29091cc8c5ea26b54dc3c5de7"),
    "poc_step4": dict(count=26, fps=25.0, **_reads(26),
                 sha256="579bc8c5413328839a5414c33055558ebdf60cd42c6ffd78fcb81ecf66a01b5b"),
    "nal_length2": dict(count=26, fps=25.0, **_reads(26),
                 sha256="3c8e36c5fa6682393eac010512b2775449b279bacbd63d579df58dc94f18a537"),
    "nal_length1": dict(count=26, fps=25.0, **_reads(26),
                 sha256="04fd00ec7ae21b513c4804086681a71896bcca459a13d4acbd3328744e18eb35"),
    "cabac_intra": dict(count=12, fps=25.0,
                 sha256="3d77a33abd519b1060952fd24c9ef29d3f2273c6cd56f7c5174bd160c3927e79"),
    "cabac_inter": dict(count=26, fps=25.0, **_reads(26),
                 sha256="e8e49df8bd2f10ef82e98deac4695ebb16be01b70c189507020d920fdd0c8ff9"),
    "cabac_slices": dict(count=12, fps=25.0,
                 sha256="4d52bbac1505ffd7cb5126e4ef27f69c79f60ba4ae4f64c7bd003de74de5c6f3"),
    "cabac_weighted": dict(count=12, fps=25.0,
                 sha256="ba215957cc0c042f70684d4cd6d5f5e9f5e5e6e5c2f19bc41877a0299e15bd12"),
    "cavlc_weighted": dict(count=12, fps=25.0,
                 sha256="60ef5400d4611bda32b91e4826c66365122b9403ae82e93651e9b67d5e5d15e5"),
    "cabac_reorder1": dict(count=12, fps=25.0,
                 sha256="7638b230669c1b9a14c176fd8c8d5b8f763ca23cf43822e9459bdcbabfaaeb32"),
    "c10_a1_mp4": dict(count=26, fps=25.0, **_reads(25),
                 sha256="fb5c52d8a238c9378293fe9adac090e770537fc318fb07ed5c56d87ea4914d0d"),
    "c10_a1_mov": dict(count=26, fps=25.0, **_reads(25),
                 sha256="c93710751a4eae03717e7dc59a9082c78537cfb7a3a7a6dbdf5612b76854bac7"),
    "c10_a1_avi": dict(count=26, fps=25.0, **_reads(25),
                 sha256="3dd300e587f8bfa77073ecb7db898a9311e6f5f1b50d9b944c3d9325721cfbb5"),
    "c10_a3_mp4": dict(count=26, fps=25.0, **_reads(25),
                 sha256="5e6dae82ce5366d26595f1c22f5224181ce78da14d030598432486ea374ebc41"),
    "c10_a3_mov": dict(count=26, fps=25.0, **_reads(25),
                 sha256="80d0b32a1f4f965ea7e3b3a93c45292cbdf91df4ca6b2595d1451d11952aa66f"),
    "c10_a3_avi": dict(count=26, fps=25.0, **_reads(25),
                 sha256="7c933786017f29b9105766bb285493321fcf00a511072452252338edbf129259"),
    "c10_b1_mp4": dict(count=26, fps=25.0, **_reads(26),
                 sha256="2f93a237ab5e12d33af2fe75bf3cadfa09ac563f90c7b82689b0f0b759f2d137"),
    "c10_b1_mov": dict(count=26, fps=25.0, **_reads(26),
                 sha256="cd5d0ccb2186be221ebcda1e4560be31060ebe41234f44b260e3f639e6fc803f"),
    "c10_b1_avi": dict(count=26, fps=25.0, **_reads(26),
                 sha256="298ac141f7ae78512e7066c70bc2a8febd4831b3935e514d20e57a23baedb69b"),
    "c10_b3_mp4": dict(count=26, fps=25.0, **_reads(26),
                 sha256="4aa147ef93788ba97f07c01eba9d54090cd33f0eb33828cbc8cf330c1610d049"),
    "c10_b3_mov": dict(count=26, fps=25.0, **_reads(26),
                 sha256="e210418fcf2d7bb728a2e9e1c9895a16bc4b6c4305221883011d97dca939c435"),
    "c10_b3_avi": dict(count=26, fps=25.0, **_reads(26),
                 sha256="72c111a7516b9b6b27c22bd205cc0526687638531d55cb5fa32ab2de98d1f0fd"),
    "c10_c1_mp4": dict(count=26, fps=25.0, **_cut_reads(23),
                 sha256="15f05c7ce2089689ee4d1e84d7c09ad0d598b69f2363ec8d2130f7ae07a10377"),
    "c10_c1_mov": dict(count=26, fps=25.0, **_cut_reads(23),
                 sha256="2cfb952afb1eeec5afa8cb93470b5a9dccca23c9257ae0bd39223940fff660b5"),
    "c10_c1_avi": dict(count=26, fps=25.0, **_cut_reads(23),
                 sha256="88a3875874d09fb71a2c3e9733b3545108f1028473a3a10802538967000320af"),
    "c10_c3_mp4": dict(count=26, fps=25.0, **_cut_reads(23),
                 sha256="78c2ef371770a7de4bb739c5d79158e49216182e41e6480d7b94361b725bb7da"),
    "c10_c3_mov": dict(count=26, fps=25.0, **_cut_reads(23),
                 sha256="59f115145887a07521c39fc9d48098bf2d7670123002a39578f32acfa5f0ddaf"),
    "c10_c3_avi": dict(count=26, fps=25.0, **_cut_reads(23),
                 sha256="b9bd35b63e6309f59dc0dfa99867a19822107b0241531202df24c6b1f8f5b8fb"),
    "c10_d1_mp4": dict(count=26, fps=25.0, **_reads(25),
                 sha256="824aef465f72b1408a45a361f200038869c4be73177dfd0b5ea738263de14432"),
    "c10_d1_mov": dict(count=26, fps=25.0, **_reads(25),
                 sha256="23db258537182197f8100b40dc8a00121e9e2b9bb566b16729db566eaa3b15c7"),
    "c10_d1_avi": dict(count=26, fps=25.0, **_reads(25),
                 sha256="e7ea9a98eb19c754bc1fc934112d6bcef75090e0df305151d21f42104e9e4eec"),
    "c10_d3_mp4": dict(count=26, fps=25.0, **_reads(25),
                 sha256="e397f55054a03e8d222c58ef6d3e5d7395fd6f01365d168530059a714a8056d3"),
    "c10_d3_mov": dict(count=26, fps=25.0, **_reads(25),
                 sha256="a2459c49bfe535fae37aa95b97fab96abb45b10c32f37f3fa2bdd9d0240f2bf9"),
    "c10_d3_avi": dict(count=26, fps=25.0, **_reads(25),
                 sha256="48b3640fce160184a320b9c881ba64520ce209345442c247ef58b97139cb03b5"),
    "b_slices": dict(count=6, fps=25.0, **_reads(6),
                 sha256="df406d6bdad00d1d4f8aa89905b1dcd6790af266ea36e3b1c62a0460d823ea6d"),
    "cabac_b_slices": dict(count=6, fps=25.0, **_reads(6),
                 sha256="af82c9b2b5b1bf7dcfcc4c026408aa8bf059bb3f96bcf1be06c189175b517b7c"),
    "cabac_b_spatial": dict(count=26, fps=25.0, **_reads(26),
                 sha256="e8c56c276ded79351477ad2422a1a6629f1333fd0ed5d049af97ef90cd6045b7"),
    "cabac_b_temporal": dict(count=26, fps=25.0, **_reads(26),
                 sha256="11ecd63a62205acbba58eb049e76240b404b13581ecab8aa0ab7e41bd246a1fe"),
    "cabac_b_pyramid": dict(count=26, fps=25.0, **_reads(26),
                 sha256="643f8775018068d1d666b51615210434d180f690e1d3dd9d1d5a7d97d6b5d914"),
    "cabac_b_explicit": dict(count=26, fps=25.0, **_reads(26),
                 sha256="b4093043c861beeef1c77df2b2cbc0eb0ea24f65c52400686248b20d4f1a4858"),
    "b_avi_open_gop": dict(count=26, fps=25.0, **_open_gop_reads(26),
                 sha256="883ffeeca3ff34cc8a35336df1c80e9c1105df4adb2d8e2aecc1801a696adf5b"),
    "cabac_b_open_gop": dict(count=26, fps=25.0, **_open_gop_reads(26),
                 sha256="27f158b1900ab759a43a92a97b50d2177c1817bfb0930fec2eef2c166d0fce36"),
    "h264_720p": dict(count=8, fps=25.0,
                 sha256="2e9fadb6c3d8ef65d3ac18c86733d1ebe5bf57276bc70fcdad5c69d9d5b80b6f"),
}
PINNED["h264_cabac_720p"] = PINNED["h264_720p"]  # the same frames, coded with CABAC
PINNED["h264_b_720p"] = dict(count=8, fps=25.0,
                             sha256="5b0d4bdf69f2eb327bc6494324784c57dee8e5a05cc52812b27c96a9ddea6041")
# the High profile cases and clip (tests/test_torch_h264_high.py)
PINNED.update({
    "high_intra": dict(count=12, fps=25.0, **_reads(12),
                sha256="36bd2db2506aaa85ab789e3a3e4572f9276cd1c59c7ec9b0347beef4b1097a6b"),
    "high_intra_mix": dict(count=12, fps=25.0, **_reads(12),
                sha256="a889c267887eee22396433bec1b58e4618847695849067f367a5269c11791dac"),
    "high_p": dict(count=12, fps=25.0, **_reads(12),
                sha256="4c71d79973513f9cfb5eeac252a23d93bdaaf39dd79a3f09421376dc44584606"),
    "high_b": dict(count=26, fps=25.0, **_reads(26),
                sha256="c48530ff79c9162d8abc0d0a18efed0e5556728094af2e9c9855f4e4e3e85e76"),
    "high_sps_lists": dict(count=12, fps=25.0, **_reads(12),
                sha256="5caf47b30b8b05406bf7d7ba0c27ae0b334c8b15036b2ccb22646056fee5fae3"),
    "high_sps_default": dict(count=12, fps=25.0, **_reads(12),
                sha256="bf5157c18e82b5b0a35f4249f2fd897c94adb9a24bcdd4331af37970fabcce03"),
    "high_pps_lists": dict(count=12, fps=25.0, **_reads(12),
                sha256="68e6b0b3b5308c32d95ff047a6860c54b3b65b6bf9da11d97b3ca53005d31cfc"),
    "high_pps_only": dict(count=12, fps=25.0, **_reads(12),
                sha256="1a5f934e30d9784512f70d8ae48f14f19d1bd533ddfda4ad68d48116ed92be36"),
    "high_chroma_qp": dict(count=12, fps=25.0, **_reads(12),
                sha256="2f11f3b43c74d0b31afb9ed8259dfe9b4d900bdae753b21d61b2da505dc19a8e"),
    "main_pps_ext": dict(count=12, fps=25.0, **_reads(12),
                sha256="dfe9103a8d203483526680b22892cb15e37aa07f10970f465b1db9138e20866e"),
    "high_limits": dict(count=12, fps=25.0, **_reads(12),
                sha256="ebf06d0a2a45e7c17afb600c1042ae4015591ba3b9a6b418855aea85885a68c5"),
    "h264_high_720p": dict(count=8, fps=25.0, **_reads(8, CLIP_SEEKS),
                sha256="f3d72e9cf69231747994bd7b7aa39c04715ddc7fed02344c054e4fc248fba6ed"),
})
