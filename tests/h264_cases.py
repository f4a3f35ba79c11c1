"""H.264 Constrained Baseline streams for the port's H.264 decoder
(``caffe_rtpose_tpu_torch/csrc/h264_video.cpp`` behind ``pipeline/h264.py``)
and the results pinned for them (numpy and ``struct`` only, so that
``chip_smoke.py`` can load this module on a machine without OpenCV).

* A syntax writer (:class:`Writer`) that emits valid Constrained Baseline
  bitstreams from a seed: SPS (frame cropping, POC types 0 and 2, VUI with
  the video range, timing and bitstream restriction), PPS, slices of I and
  P type (several a picture, each with its own QP and deblocking idc and
  offsets; reference list modification; sliding-window and MMCO 1
  marking; non-reference pictures) and CAVLC macroblocks of every I and P
  ``mb_type`` and sub-type: I_PCM, all 9 + 4 + 4 intra modes (only those
  whose neighbours are available), residual blocks of every ``coeff_token``
  table with level escapes, ``mb_qp_delta`` wrapping through QP 0-51, and
  motion vector differences that reach every sub-pel phase and far out of
  the picture.  The writer is no encoder: the pictures are what the syntax
  says, and FFmpeg (``cv2.VideoCapture``) is the judge of what they are.
  It tracks what a valid stream needs: the nC contexts, the intra mode
  predictors and neighbour availability, and the reference pictures.
* Muxers: MP4 and QuickTime (``avc1`` + ``avcC``, ``stss`` listing the IDR
  pictures, through ``mp4_cases.write_mp4``) and AVI (Annex B chunks,
  ``idx1`` with AVIIF_KEYFRAME on the IDR pictures, ``avi_cases.write_avi``).
* CASES, REFUSED (one stream a refusal) and PINNED: what the JAX package's
  reader (``cv2.VideoCapture`` in ``caffe_rtpose_tpu.pipeline.runner``)
  gives for each case.
* :func:`encode_clip`: the 8 1280x720 frames of ``jpeg_frames.frame`` coded
  as real pictures (the first row of macroblocks I_PCM, the rest
  Intra16x16 vertical, then P pictures predicted from the picture before),
  committed as ``tests/data/h264_720p.mp4`` for chip_smoke's CLI run.

``tests/test_torch_h264.py`` holds PINNED against the JAX reader and the
port; ``chip_smoke.py``'s video phase holds the port on the card's host to
them.
"""

import functools
import os
import struct

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CLIP_SIZE = (74, 100)  # (h, w): coded as 112x80 and cropped
CLIP_FRAMES = 26
SEEKS = (0, 1, 3, 11, 12, 13, 20, 25, 26, 40)
READ_AFTER_SEEK = 3
CLIP_720P = os.path.join(DATA, "h264_720p.mp4")

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


def block_fits(levels, q: int, dc=None) -> bool:
    """Whether a 4x4 block of ``levels`` (16 in scan order; with ``dc``,
    the scaled DC replaces the first) stays in range at QP ``q``."""
    # each 1-D pass's outputs are at most the sum of its inputs' magnitudes
    bound = int(np.abs(np.asarray(levels[dc is not None:])).sum()) * (29 << (q // 6))
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
        d[r] = (int(lv) * NORM_ADJUST[q % 6][k]) << (q // 6)
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


def luma_dc(levels, q: int):
    """The scaled Intra16x16 DCs (raster) of DC ``levels`` (scan order), or
    None where the Hadamard leaves the range."""
    c = [0] * 16
    for i, lv in enumerate(levels):
        c[ZIGZAG[i]] = int(lv)
    h = ((1, 1, 1, 1), (1, 1, -1, -1), (1, -1, -1, 1), (1, -1, 1, -1))
    f = [sum(h[i][k] * c[4 * k + l] * h[l][j] for k in range(4) for l in range(4))
         for i in range(4) for j in range(4)]
    ls = 16 * NORM_ADJUST[q % 6][0]
    out = [(v * ls) << (q // 6 - 6) if q >= 36 else (v * ls + (1 << (5 - q // 6))) >> (6 - q // 6)
           for v in f]
    return out if _in_range(*f, *out) else None


def chroma_dc(levels, qc: int):
    """The scaled chroma DCs of the 2x2 DC ``levels``, or None out of range."""
    c0, c1, c2, c3 = (int(v) for v in levels)
    f = (c0 + c1 + c2 + c3, c0 - c1 + c2 - c3, c0 + c1 - c2 - c3, c0 - c1 - c2 + c3)
    out = [((v * 16 * NORM_ADJUST[qc % 6][0]) << (qc // 6)) >> 5 for v in f]
    return out if _in_range(*f, *out) else None


# -------------------------------------------------------------- streams

# (mode, needs) of the intra predictions: needs A (left), B (top), D (top-left)
I4_NEEDS = ("B", "A", "", "B", "ABD", "ABD", "ABD", "B", "A")
I16_NEEDS = ("B", "A", "", "ABD")
CHROMA_NEEDS = ("", "A", "B", "ABD")
SUB_PARTS = (1, 2, 2, 4)  # 8x8, 8x4, 4x8, 4x4


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
        aud=False, sei=False, seed=0)


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
        self.chroma_offsets = (p["chroma_offset"], p["chroma_offset"])
        self.seen = set()  # the syntax written: (element, value)

    # ------------------------------------------------------------ headers
    def sps(self, sps_id: int = 0) -> bytes:
        p, bw = self.p, Bits()
        h, w = p["size"]
        bw.u(p.get("profile", 66), 8)
        bw.u(0b11000000, 8)  # constraint_set0 and 1: Constrained Baseline
        bw.u(p.get("level", 30), 8)
        bw.ue(sps_id)
        if p.get("profile", 66) in (100, 110, 122, 244):
            bw.ue(p.get("chroma_format", 1))
            bw.ue(p.get("bit_depth", 8) - 8)
            bw.ue(p.get("bit_depth", 8) - 8)
            bw.u(0, 1)
            bw.u(bool(p.get("scaling")), 1)
            if p.get("scaling"):
                bw.u(0, 8)  # no list present: the fall-back rule (flat)
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
            bw.u(0, 1)
        bw.u(1, 1)  # direct_8x8_inference_flag
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
        bw.ue(0)
        bw.u(p.get("weighted", 0), 1)
        bw.u(0, 2)
        bw.se(p["qp"][0] - 26)
        bw.se(0)
        bw.se(p["chroma_offset"])
        bw.u(1, 1)  # deblocking_filter_control_present_flag
        bw.u(p.get("constrained_intra", 0), 1)
        bw.u(p.get("redundant", 0), 1)
        if p.get("transform_8x8"):
            bw.u(1, 1)
            bw.u(0, 1)
            bw.se(0)
        return nal(3, 8, bw.trailing())

    # ------------------------------------------------------------ pictures
    def picture(self, i: int):
        """The NAL units of frame ``i`` (in decode order = display order)."""
        p, rs = self.p, self.rs
        idr = i in p["idr"]
        kind = "I" if idr or i in p["intra"] else "P"
        self.index = i
        if i == p.get("gap_at"):
            self.frame_num = (self.frame_num + 1) % self.max_fn  # skip a frame_num
        ref_idc = 0 if i in p["nonref"] else int(rs.randint(1, 4))
        if idr:
            self.refs, self.since_idr = [], 0
            self.frame_num = 0
            self.idr_id ^= 1
        k = self.since_idr
        if p["poc_order"] == "swap" and k:  # display order 0, 2, 1, 4, 3, ...
            k = k + 1 if k % 2 else k - 1
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
        self.kind = [None] * self.nmb
        self.slc = [-1] * self.nmb
        self.tcl = np.zeros((self.nmb, 16), np.int32)
        self.tcc = np.zeros((self.nmb, 2, 4), np.int32)
        self.i4 = np.full((self.nmb, 16), -1, np.int32)
        marking = None
        if ref_idc and not idr:
            marking = self._marking(cur_fn)
        for s in range(nslices):
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
        for other in (1, 3):  # B or SP in place of P (refused)
            if stype == 0 and other in p["slice_types"]:
                written = other
        bw.ue(written + 5 if 5 in p["slice_types"] else written)
        bw.ue(0)
        bw.u(cur_fn, p["log2_max_frame_num"])
        if idr:
            bw.ue(self.idr_id)
        if p["poc_type"] == 0:
            bw.u(poc, p["log2_max_poc_lsb"])
        active = p["refs_default"]
        nref = len(picnums)
        if stype == 0:
            if rs.rand() < p["override"] or active > nref:
                # never more entries than reference pictures
                active = min(int(rs.randint(1, 5)), nref) if active <= nref else nref
                bw.u(1, 1)
                bw.ue(active - 1)
            else:
                bw.u(0, 1)
            if nref and rs.rand() < p["modify"]:
                self.seen.add(("ref_pic_list_modification", 1))
                bw.u(1, 1)
                pred = cur_fn
                for _ in range(int(rs.randint(1, active + 1))):
                    target = int(rs.choice(picnums))
                    d = (pred - target) % self.max_fn
                    if d:
                        bw.ue(0)
                        bw.ue(d - 1)
                        pred = (pred - d) % self.max_fn
                    else:
                        bw.ue(1)
                        bw.ue(self.max_fn - 1)
                bw.ue(3)
            else:
                bw.u(0, 1)
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
        skip = 0
        for m in range(first, end):
            self.slc[m] = s
            if stype == 0:
                t = self._choose(p["p_mix"])
                if t == "p8x8ref0" and active < 2:
                    t = "p8x8"
                if t == "skip":
                    skip += 1
                    self.kind[m] = "skip"
                    continue
                bw.ue(skip)
                skip = 0
                if t == "intra":
                    self._intra_mb(bw, m, 5)
                else:
                    self._inter_mb(bw, m, t)
            else:
                self._intra_mb(bw, m, 0)
        if skip:
            bw.ue(skip)
        return nal(ref_idc, 5 if idr else 1, bw.trailing())

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

    def _block(self, bw, m, bx, by, arr, q, dc=None):
        """A 16-coefficient block, or with ``dc`` an AC block of 15 after it."""
        if dc is None:
            c = self._fitted(16, lambda c: block_fits(c, q))
        else:
            c = self._fitted(15, lambda c: block_fits(np.concatenate([[0], c]), q, dc))
        return residual_block(bw, c, self._nc(m, bx, by, arr), self.seen)

    def _qp_delta(self, bw):
        d = int(self.rs.randint(-26, 26)) if self.rs.rand() < 0.5 else 0
        bw.se(d)
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

    def _intra_mb(self, bw, m, base):
        rs, p = self.rs, self.p
        t = self._choose(p["i_mix"])
        av = self._avail(m)
        if t == "pcm":
            bw.ue(base + 25)
            self.seen.add(("mb_type I", 25))
            bw.align()
            bw.out += rs.randint(0, 256, 384).astype(np.uint8).tobytes()
            self.kind[m] = "pcm"
            self.tcl[m] = 16
            self.tcc[m] = 16
            return
        cmode = _pick(rs, [c for c, need in enumerate(CHROMA_NEEDS) if all(av[k] for k in need)])
        if t == "i16":
            mode = _pick(rs, [c for c, need in enumerate(I16_NEEDS) if all(av[k] for k in need)])
            cbp_l = 15 if rs.rand() < 0.5 else 0
            cbp_c = int(rs.randint(3))
            bw.ue(base + 1 + mode + 4 * cbp_c + (12 if cbp_l else 0))
            self.seen.update({("mb_type I", 1 + mode + 4 * cbp_c + (12 if cbp_l else 0)),
                              ("Intra16x16", mode), ("chroma", cmode)})
            bw.ue(cmode)
            self._qp_delta(bw)
            self.kind[m] = "i16"
            dcl = self._fitted(16, lambda c: luma_dc(c, self.qp) is not None)
            residual_block(bw, dcl, self._nc(m, 0, 0, None), self.seen)
            dcy = luma_dc(dcl, self.qp)
            for blk in range(16):
                bx, by = _blk_xy(blk)
                tc = self._block(bw, m, bx, by, None, self.qp, dcy[by * 4 + bx]) if cbp_l else 0
                self.tcl[m][by * 4 + bx] = tc
            self._chroma(bw, m, cbp_c)
            return
        bw.ue(base)
        self.seen.update({("mb_type I", 0), ("chroma", cmode)})
        self.kind[m] = "i4"
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
            pred = self._i4_pred(m, bx, by)
            if mode == pred:
                bw.u(1, 1)
            else:
                bw.u(0, 1)
                bw.u(mode if mode < pred else mode - 1, 3)
            self.i4[m][by * 4 + bx] = mode
            self.seen.add(("Intra4x4", mode))
        bw.ue(cmode)
        self._cbp_residual(bw, m, _INTRA_CODE)

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

    def _cbp_residual(self, bw, m, table):
        rs = self.rs
        cbp = int(rs.randint(48))
        bw.ue(table[cbp])
        if cbp:
            self._qp_delta(bw)
        for blk in range(16):
            bx, by = _blk_xy(blk)
            tc = self._block(bw, m, bx, by, None, self.qp) if cbp >> (blk // 4) & 1 else 0
            self.tcl[m][by * 4 + bx] = tc
        self._chroma(bw, m, cbp >> 4)

    def _chroma(self, bw, m, cbp_c):
        qcs = [CHROMA_QP[min(max(self.qp + off, 0), 51)] for off in self.chroma_offsets]
        dcs = [[0] * 4, [0] * 4]
        if cbp_c:
            for c in range(2):
                lv = self._fitted(4, lambda v: chroma_dc(v, qcs[c]) is not None)
                residual_block(bw, lv, -1, self.seen)
                dcs[c] = chroma_dc(lv, qcs[c])
        for c in range(2):
            for blk in range(4):
                bx, by = blk % 2, blk // 2
                tc = self._block(bw, m, bx, by, c, qcs[c], dcs[c][blk]) if cbp_c == 2 else 0
                self.tcc[m][c][by * 2 + bx] = tc

    def _mvd(self):
        rs, p = self.rs, self.p
        if rs.rand() < p["far"]:
            return int(rs.randint(300, 2000) * (1 if rs.rand() < 0.5 else -1))
        return int(rs.randint(-p["mvd"], p["mvd"] + 1))

    def _ref(self):
        return int(self.rs.randint(self.nrefs)) if self.nrefs > 1 else 0

    def _inter_mb(self, bw, m, t):
        rs = self.rs
        self.kind[m] = "p"
        coded_refs = self.active > 1
        if t in ("p16", "p16x8", "p8x16"):
            n = 1 if t == "p16" else 2
            bw.ue(("p16", "p16x8", "p8x16").index(t))
            self.seen.add(("mb_type P", ("p16", "p16x8", "p8x16").index(t)))
            refs = [self._ref() for _ in range(n)]
            if coded_refs:
                for r in refs:
                    bw.te(r, self.active - 1)
            for _ in range(n):
                bw.se(self._mvd())
                bw.se(self._mvd())
        else:
            bw.ue(3 if t == "p8x8" else 4)
            subs = [int(rs.randint(4)) for _ in range(4)]
            self.seen.update({("mb_type P", 3 if t == "p8x8" else 4),
                              *(("sub_mb_type", sb) for sb in subs)})
            for sb in subs:
                bw.ue(sb)
            if coded_refs and t == "p8x8":
                for _ in range(4):
                    bw.te(self._ref(), self.active - 1)
            for sb in subs:
                for _ in range(SUB_PARTS[sb]):
                    bw.se(self._mvd())
                    bw.se(self._mvd())
        self._cbp_residual(bw, m, _INTER_CODE)

    # ------------------------------------------------------------- stream
    def packets(self):
        """One access unit a frame: lists of NAL units."""
        p = self.p
        out = []
        for i in range(p["frames"]):
            nals = self.picture(i)
            if p["aud"]:
                nals = [nal(0, 9, bytes([0xF0]))] + nals  # primary_pic_type 7
            if p["sei"]:  # user data unregistered
                nals = [nal(0, 6, bytes([5, 17]) + bytes(16) + b"x" + b"\x80")] + nals
            if i in p["idr"] and p["inband"]:
                nals = [self.sps(), self.pps()] + nals
            out.append(nals)
        return out


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
    keys = list(p["idr"])
    if p["container"] == "avi":
        return avi_cases.write_avi([annexb(u) for u in units], w, h,
                                   fourcc=p["fourcc"].encode(), keys=keys,
                                   extradata=annexb([sps, pps]) if p["strf"] else b"")
    record = avcc(sps, pps, p["nal_length"])
    if p["inband"]:  # avc3: the parameter sets are in the samples only
        record = record[:5] + b"\xe0\x00"
    box = struct.pack(">I", 8 + len(record)) + b"avcC" + record
    return mp4_cases.write_mp4([prefixed(u, p["nal_length"]) for u in units], w, h,
                               fourcc=b"avc3" if p["inband"] else b"avc1", config=box, keys=keys,
                               brand=b"qt  " if p["container"] == "mov" else b"isom")


@functools.lru_cache(maxsize=None)
def stream(name: str):
    """(params, NAL units a frame, sps, pps) of case ``name`` (made once);
    SEEN[name] is then the syntax the writer wrote."""
    p = _defaults()
    p.update(CASES.get(name) or REFUSED[name][0])
    wr = Writer(**p)
    sps, pps = wr.sps(), wr.pps()
    units = wr.packets()
    SEEN[name] = wr.seen
    return p, units, sps, pps


SEEN = {}  # case -> the (element, value) pairs its writer wrote


def build(name: str) -> bytes:
    """The file bytes of CASES / REFUSED ``name``."""
    p, units, sps, pps = stream(name)
    return write(p, units, sps, pps)


def suffix(name: str) -> str:
    p = _defaults()
    p.update(CASES.get(name) or REFUSED[name][0])
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


class _ClipWriter:
    """Codes whole pictures: an IDR picture whose first row of macroblocks
    is I_PCM and whose others are Intra16x16 vertical (chroma vertical),
    then P pictures predicted from the picture before at zero motion
    (P_L0_16x16, or P_Skip where nothing is coded).  The encoder's own
    reconstruction leaves out the deblocking filter: the drift is harmless."""

    def __init__(self, h, w, qp):
        self.h, self.w, self.qp = h, w, qp
        self.mbw, self.mbh = -(-w // 16), -(-h // 16)  # the frame cropped from the coded size
        self.wr = Writer(size=(h, w), max_refs=1, log2_max_frame_num=4, log2_max_poc_lsb=8,
                         qp=(qp, qp))
        self.recon = None

    def _nc(self, tc, mbx, mby, bx, by, size):
        na = tc[mby, mbx - 1][by, size - 1] if bx == 0 and mbx > 0 else \
            tc[mby, mbx][by, bx - 1] if bx > 0 else None
        nb = tc[mby - 1, mbx][size - 1, bx] if by == 0 and mby > 0 else \
            tc[mby, mbx][by - 1, bx] if by > 0 else None
        if na is not None and nb is not None:
            return (int(na) + int(nb) + 1) >> 1
        return int(na if na is not None else nb if nb is not None else 0)

    def picture(self, bgr, i):
        pad = ((0, self.mbh * 16 - self.h), (0, self.mbw * 16 - self.w), (0, 0))
        planes = _yuv420(np.pad(bgr, pad, mode="edge"))
        bw = Bits()
        idr = i == 0
        bw.ue(0)
        bw.ue(7 if idr else 5)
        bw.ue(0)
        bw.u(i % 16, 4)
        if idr:
            bw.ue(0)
        bw.u(2 * i, 8)
        if not idr:
            bw.u(0, 1)  # num_ref_idx_active_override_flag
            bw.u(0, 1)  # ref_pic_list_modification_flag
        bw.u(0, 1)
        if idr:
            bw.u(0, 1)
        bw.se(0)
        bw.ue(0)
        bw.se(0)
        bw.se(0)
        mbw, mbh, q = self.mbw, self.mbh, self.qp
        qc = CHROMA_QP[q]
        tcl = np.zeros((mbh, mbw, 4, 4), np.int64)
        tcc = np.zeros((2, mbh, mbw, 2, 2), np.int64)
        recon = [np.zeros_like(p) for p in planes]
        if idr:
            rows = [[recon[0][:16].copy()] + [r[:8].copy() for r in recon[1:]]]
            recon[0][:16], recon[1][:8], recon[2][:8] = planes[0][:16], planes[1][:8], planes[2][:8]
            tcl[0] = 16
            tcc[:, 0] = 16
            coded = {}
            for my in range(1, mbh):
                coded[my] = []
                for c, n in ((0, 16), (1, 8), (2, 8)):
                    y0 = my * n
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
                blk = _blocks(res).reshape(mbh, n // 4, mbw, n // 4, 4, 4)
                blk = blk.transpose(0, 2, 1, 3, 4, 5)
                lv, dc_lv, r = _residual(blk, q if c == 0 else qc, False,
                                         None if c == 0 else "chroma")
                out = r.transpose(0, 2, 1, 3, 4, 5).reshape(mbh * n // 4, mbw * n // 4, 4, 4)
                recon[c] = np.clip(ref[c] + _unblocks(out), 0, 255)
                coded[c] = (lv, dc_lv)
        skip = 0
        for my in range(mbh):
            for mx in range(mbw):
                if idr and my == 0:
                    bw.ue(25)
                    bw.align()
                    for c, n in ((0, 16), (1, 8), (2, 8)):
                        bw.out += planes[c][:n, mx * n:(mx + 1) * n].astype(np.uint8).tobytes()
                    continue
                if idr:
                    (ly, ldc), (u, udc), (v, vdc) = coded[my]
                    ly, u, v = ly[mx], u[mx], v[mx]
                    ldc, udc, vdc = ldc[mx], udc[mx], vdc[mx]
                else:
                    ly, u, v = (coded[c][0][my, mx] for c in range(3))
                    udc, vdc = coded[1][1][my, mx], coded[2][1][my, mx]
                    ldc = None
                cbp_c = 2 if (u[..., :, :].reshape(2, 2, 16)[..., 1:].any()
                              or v.reshape(2, 2, 16)[..., 1:].any()) else \
                    1 if (udc.any() or vdc.any()) else 0
                if idr:
                    cbp_l = 15 if ly.reshape(4, 4, 16)[..., 1:].any() else 0
                    bw.ue(1 + 4 * cbp_c + (12 if cbp_l else 0))
                    bw.ue(2)  # chroma vertical
                    bw.se(0)
                    residual_block(bw, _scan(ldc), self._nc(tcl, mx, my, 0, 0, 4))
                else:
                    nz8 = [ly[2 * (k // 2):2 * (k // 2) + 2, 2 * (k % 2):2 * (k % 2) + 2].any()
                           for k in range(4)]
                    cbp_l = sum(1 << k for k in range(4) if nz8[k])
                    if not cbp_l and not cbp_c:
                        skip += 1
                        continue
                    bw.ue(skip)
                    skip = 0
                    bw.ue(0)  # P_L0_16x16
                    bw.se(0)
                    bw.se(0)
                    bw.ue(_INTER_CODE[cbp_l | cbp_c << 4])
                    bw.se(0)
                for blk in range(16):
                    bx, by = _blk_xy(blk)
                    if idr and cbp_l:
                        tcl[my, mx, by, bx] = residual_block(
                            bw, _scan(ly[by, bx])[1:], self._nc(tcl, mx, my, bx, by, 4))
                    elif not idr and cbp_l >> (blk // 4) & 1:
                        tcl[my, mx, by, bx] = residual_block(
                            bw, _scan(ly[by, bx]), self._nc(tcl, mx, my, bx, by, 4))
                if cbp_c:
                    for dcv in (udc, vdc):
                        residual_block(bw, [int(x) for x in dcv.reshape(4)], -1)
                for c, pl in enumerate((u, v)):
                    for k in range(4):
                        bx, by = k % 2, k // 2
                        if cbp_c == 2:
                            tcc[c, my, mx, by, bx] = residual_block(
                                bw, _scan(pl[by, bx])[1:], self._nc(tcc[c], mx, my, bx, by, 2))
        if skip:
            bw.ue(skip)
        self.recon = recon
        return [nal(3, 5 if idr else 1, bw.trailing())]


def encode_clip(frames, qp: int = 30) -> bytes:
    """An MP4 of ``frames`` (BGR u8 of even sizes; coded at multiples of 16
    and cropped) as real pictures at QP ``qp`` (:class:`_ClipWriter`)."""
    h, w = frames[0].shape[:2]
    cw = _ClipWriter(h, w, qp)
    p = _defaults()
    p.update(size=(h, w), idr=(0,))
    units = [cw.picture(f, i) for i, f in enumerate(frames)]
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
}

# name -> (stream keywords, the words the refusal names); 6 frames each
REFUSED = {
    "cabac": (dict(frames=6, cabac=1), "CABAC"),
    "b_slices": (dict(frames=6, slice_types=(1,), idr=(0,)), "B slices"),
    "interlaced": (dict(frames=6, frame_mbs_only=0), "field"),
    "slice_groups": (dict(frames=6, slice_groups=2), "slice groups"),
    "weighted": (dict(frames=6, weighted=1), "weighted prediction"),
    "redundant": (dict(frames=6, redundant=1), "redundant pictures"),
    "chroma_422": (dict(frames=6, profile=122, chroma_format=2), "chroma_format_idc 2"),
    "bit_depth_10": (dict(frames=6, profile=110, bit_depth=10), "bit depth 10"),
    "transform_8x8": (dict(frames=6, profile=100, transform_8x8=1), "8x8 transform"),
    "constrained_intra": (dict(frames=6, constrained_intra=1), "constrained_intra_pred"),
    "poc_type_1": (dict(frames=6, poc_type=1), "pic_order_cnt_type 1"),
    "sp_slices": (dict(frames=6, slice_types=(3,), idr=(0,)), "SP and SI slices"),
    "slice_order": (dict(frames=6, aso=True, slices=(3,)), "arbitrary slice order"),
    "scaling_matrix": (dict(frames=6, profile=100, scaling=True), "scaling matrices"),
    "frame_num_gap": (dict(frames=6, gap_at=5, gaps=1), "gaps in frame_num"),
    "long_term": (dict(frames=6, long_term=1), "long-term reference pictures"),
    "mmco5": (dict(frames=6, mmco5_at=4), "memory_management_control_operation 5"),
    "data_partitioning": (dict(frames=6, partition_at=3), "data partitioning"),
}


def _reads(n):
    """The reads PINNED holds for a clip of ``n`` frames that shows them in
    turn: frame ids index the frames a read from the start gives, and every
    start_frame and ui seek to k (made once 2 frames were read) reads on
    from frame k."""
    ids = tuple(range(n))
    after = {k: ids[k:k + READ_AFTER_SEEK] for k in SEEKS}
    return dict(order=ids, start=after, ui=dict(after))


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
    "h264_720p": dict(count=8, fps=25.0,
                 sha256="2e9fadb6c3d8ef65d3ac18c86733d1ebe5bf57276bc70fcdad5c69d9d5b80b6f"),
}
