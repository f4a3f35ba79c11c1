"""Frame preprocessing: aspect-preserving display warp + per-scale resize,
center-pad and normalize — the reference producer's semantics
(process_and_pad_image rtpose.cpp:239-269; scale loop rtpose.cpp:508-518;
display warp rtpose.cpp:325-338/475-487) — and the u8 transfer formats.

The port of ``caffe_rtpose_tpu/pose/preprocess.py`` without OpenCV (the
machine with the card has no ``cv2``); both resamplers are numpy:

* :func:`resize_area` is OpenCV's ``INTER_AREA`` for u8 downscales, bit for
  bit: the integer-ratio path (``resizeAreaFast``: block sums, the 2x2 case
  rounded half up as its SIMD form does, the others ``cvRound(sum *
  (1.f/area))``) and the box-overlap path (``resizeArea``: per source row a
  horizontal pass of f32 products ``S * alpha`` summed in tap order, then
  per output row the rows weighted by ``beta`` in the same order, rounded
  half to even), with the tap tables of ``computeResizeAreaTab``.  Where
  either axis grows, OpenCV's other ``INTER_AREA`` branch, bit for bit: the
  linear resize with area coefficients (``fx = (dx+1) - (sx+1)/scale``,
  clamped as ``cv::resize`` clamps them) in its fixed-point u8 arithmetic
  (11-bit coefficients, an integer horizontal pass, the vertical pass
  ``VResizeLinear`` rounds), which ``utils/imgproc.py`` holds for this and
  for INTER_LINEAR.
* :func:`warp_to_display` is ``cv2.warpAffine`` with a diagonal matrix,
  ``INTER_CUBIC`` (A = -0.75), a black constant border.  OpenCV 4's
  fixed-point remap (32 sub-pixel phases, 15-bit coefficients) is not what
  OpenCV 5.0 computes there: its result follows exact coordinates and f32
  weights.  This function does that, separably in f32, and lands within one
  u8 level of OpenCV 5.0 on every pixel, equal on all but ~0.1-0.7 % of
  them (``tests/test_torch_preprocess.py``).  The identity warp (same size,
  scale 1) returns the frame itself, as the JAX package does.

The JAX package's ``CRT_NATIVE_WARP`` path (``native/cvwarp.cpp`` linked
against the system OpenCV) is not ported.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple, Union

import numpy as np

from ..utils import imgproc


def display_scale(ori_w: int, ori_h: int, disp_w: int, disp_h: int) -> float:
    """Aspect-preserving scale into the display canvas (rtpose.cpp:325-330)."""
    if ori_w / float(ori_h) > disp_w / float(disp_h):
        return disp_w / float(ori_w)
    return disp_h / float(ori_h)


# ------------------------------------------------------------ INTER_CUBIC


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """(n,) f32 sub-pixel offsets -> (n, 4) f32 weights of OpenCV's
    ``interpolateCubic`` (A = -0.75), in its operation order."""
    f = np.float32
    A, one = f(-0.75), f(1.0)
    t = t.astype(np.float32)
    u = t + one
    c0 = ((A * u - f(5) * A) * u + f(8) * A) * u - f(4) * A
    c1 = ((A + f(2)) * t - (A + f(3))) * t * t + one
    r = one - t
    c2 = ((A + f(2)) * r - (A + f(3))) * r * r + one
    return np.stack([c0, c1, c2, one - c0 - c1 - c2], -1)


def _cubic_axis(n_out: int, n_src: int, inv: float, pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """One axis of the warp: output i samples source coordinate i * inv ->
    (n_out, 4) row indices into the zero-padded source, (n_out, 4) weights."""
    c = np.arange(n_out, dtype=np.float64) * inv
    i0 = np.floor(c)
    w = _cubic_weights(c - i0)
    idx = np.clip(i0.astype(np.int64) - 1 + pad, 0, n_src + 2 * pad - 4)
    return idx[:, None] + np.arange(4), w


def warp_to_display(img_bgr: np.ndarray, disp_w: int, disp_h: int) -> Tuple[np.ndarray, float]:
    """Scale about the origin into a (disp_h, disp_w) canvas, black-padded
    bottom/right (``cv2.warpAffine`` with a diagonal matrix, INTER_CUBIC)."""
    scale = display_scale(img_bgr.shape[1], img_bgr.shape[0], disp_w, disp_h)
    if scale == 1.0 and img_bgr.shape[:2] == (disp_h, disp_w):
        # identity warp: bicubic at integer sample points copies the pixel,
        # so the frame itself is the result (and the realtime producer
        # skips its largest cost)
        return img_bgr, scale
    src = np.asarray(img_bgr, np.uint8)
    sh, sw = src.shape[:2]
    src = src.reshape(sh, sw, -1)
    # the inverse map as warpAffine forms it: 1 / det times the diagonal
    inv = scale * (1.0 / (scale * scale))
    pad = 4  # reaches past the last tap of any output inside the frame
    ys, wy = _cubic_axis(disp_h, sh, inv, pad)
    xs, wx = _cubic_axis(disp_w, sw, inv, pad)
    padded = np.zeros((sh + 2 * pad, sw + 2 * pad, src.shape[2]), np.uint8)
    padded[pad : pad + sh, pad : pad + sw] = src
    # the horizontal pass over every source row, then the vertical one
    horiz = padded.take(xs[:, 0], axis=1).astype(np.float32)
    horiz *= wx[:, 0, None]
    for j in range(1, 4):
        t = padded.take(xs[:, j], axis=1).astype(np.float32)
        t *= wx[:, j, None]
        horiz += t
    out = horiz.take(ys[:, 0], axis=0)
    out *= wy[:, 0, None, None]
    for i in range(1, 4):
        t = horiz.take(ys[:, i], axis=0)
        t *= wy[:, i, None, None]
        out += t
    np.rint(out, out=out)
    np.clip(out, 0, 255, out=out)
    return out.astype(np.uint8).reshape(disp_h, disp_w, *img_bgr.shape[2:]), scale


# -------------------------------------------------------------- INTER_AREA


@lru_cache(maxsize=64)
def _area_taps(n_src: int, n_dst: int, scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """``computeResizeAreaTab`` as (n_dst, K) source indices and f32 weights
    per output, in table order, zero-weight padded (adding 0 * x changes no
    f32 sum)."""
    taps = []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_src - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    k = max(len(r) for r in taps)
    idx = np.zeros((n_dst, k), np.intp)
    wgt = np.zeros((n_dst, k), np.float32)
    for d, row in enumerate(taps):
        for j, (s, a) in enumerate(row):
            idx[d, j], wgt[d, j] = s, np.float32(a)
    return idx, wgt


def resize_area(img: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """``cv2.resize(img, (dst_w, dst_h), interpolation=cv2.INTER_AREA)`` for
    an (H, W, C) or (H, W) u8 image, bit for bit."""
    img = np.asarray(img, np.uint8)
    sh, sw = img.shape[:2]
    if (sw, sh) == (dst_w, dst_h):
        return img.copy()
    # the scales as cv::resize forms them: 1 / (dst / src)
    scale_x, scale_y = 1.0 / (dst_w / sw), 1.0 / (dst_h / sh)
    cn = img.shape[2] if img.ndim == 3 else 1
    src = img.reshape(sh, sw * cn)
    if scale_x < 1 or scale_y < 1:
        # the linear resize with area coefficients (utils/imgproc's fixed point)
        out = imgproc.linear_passes(src, cn, imgproc.linear_axis(sw, dst_w, area=True, clamp=True),
                                    imgproc.linear_axis(sh, dst_h, area=True, clamp=False))
        return out.reshape((dst_h, dst_w) + img.shape[2:])
    ix, iy = int(round(scale_x)), int(round(scale_y))
    eps = sys.float_info.epsilon  # OpenCV's DBL_EPSILON test for an integer ratio
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
        cells = src.reshape(dst_h, iy, dst_w, ix, cn)
        blocks = np.zeros((dst_h, dst_w, cn), np.int32)
        for a in range(iy):
            for b in range(ix):
                blocks += cells[:, a, :, b]
        if ix == iy == 2:
            out = (blocks + 2) >> 2
        else:
            out = np.rint(blocks.astype(np.float32) * np.float32(1.0 / (ix * iy)))
        return out.astype(np.uint8).reshape((dst_h, dst_w) + img.shape[2:])
    xi, xw = _area_taps(sw, dst_w, scale_x)
    yi, yw = _area_taps(sh, dst_h, scale_y)
    # each tap's channels on the (H, W*cn) view
    cols = (xi[:, :, None] * cn + np.arange(cn)).transpose(1, 0, 2).reshape(xi.shape[1], -1)
    wcol = np.repeat(xw.T, cn, axis=1)
    buf = src.take(cols[0], axis=1).astype(np.float32)
    buf *= wcol[0]
    for k in range(1, cols.shape[0]):
        t = src.take(cols[k], axis=1).astype(np.float32)
        t *= wcol[k]
        buf += t
    out = buf.take(yi[:, 0], axis=0)
    out *= yw[:, 0, None]
    for k in range(1, yi.shape[1]):
        t = buf.take(yi[:, k], axis=0)
        t *= yw[:, k, None]
        out += t
    np.rint(out, out=out)
    np.clip(out, 0, 255, out=out)
    return out.astype(np.uint8).reshape((dst_h, dst_w) + img.shape[2:])


# ------------------------------------------------------------ net inputs


def pad_and_normalize(img_bgr: np.ndarray, tw: int, th: int, normalize: bool) -> np.ndarray:
    """process_and_pad_image: center-place into (th, tw), x/256 - 0.5, CHW."""
    oh, ow = img_bgr.shape[:2]
    padw = (tw - ow) // 2
    padh = (th - oh) // 2
    if padw < 0 or padh < 0:
        raise ValueError("Image too big for target size.")
    out = np.zeros((3, th, tw), np.float32)
    img = img_bgr.astype(np.float32)
    if normalize:
        img = img / 256.0 - 0.5
    out[:, padh : padh + oh, padw : padw + ow] = img.transpose(2, 0, 1)
    return out


def scale_dims(net_w: int, net_h: int, scale: float) -> Tuple[int, int]:
    """Per-scale target dims: 16 * ceil(net_dim * scale / 16) (rtpose.cpp:509-511)."""
    tw = 16 * int(math.ceil(net_w * scale / 16))
    th = 16 * int(math.ceil(net_h * scale / 16))
    if tw > net_w or th > net_h:
        raise ValueError("scale produces dims above net resolution")
    return tw, th


def make_net_input(
    img_bgr: np.ndarray,
    net_w: int,
    net_h: int,
    num_scales: int = 1,
    start_scale: float = 1.0,
    scale_gap: float = 0.3,
) -> np.ndarray:
    """Display-res frame -> (num_scales, 3, net_h, net_w) float32 net input
    (INTER_AREA per-scale resize + center pad + /256-0.5)."""
    out = np.zeros((num_scales, 3, net_h, net_w), np.float32)
    for i in range(num_scales):
        tw, th = scale_dims(net_w, net_h, start_scale - i * scale_gap)
        out[i] = pad_and_normalize(resize_area(img_bgr, tw, th), net_w, net_h, normalize=True)
    return out


def region_boxes(net_w: int, net_h: int, num_scales: int, start_scale: float, scale_gap: float):
    """Static per-scale image regions inside the padded canvas:
    (y0, y1, x0, x1) per scale."""
    boxes = []
    for i in range(num_scales):
        tw, th = scale_dims(net_w, net_h, start_scale - i * scale_gap)
        padw = (net_w - tw) // 2
        padh = (net_h - th) // 2
        boxes.append((padh, padh + th, padw, padw + tw))
    return boxes


def make_net_input_u8(
    img_bgr: np.ndarray,
    net_w: int,
    net_h: int,
    num_scales: int = 1,
    start_scale: float = 1.0,
    scale_gap: float = 0.3,
) -> np.ndarray:
    """u8 transfer format: (S, net_h, net_w, 3) padded canvases, NHWC.

    4x smaller host->device payload than the f32 canvas; the device applies
    x/256 - 0.5 inside the image region and zero outside (exact in f32, so
    bit-identical to process_and_pad_image + normalize).
    """
    out = np.zeros((num_scales, net_h, net_w, 3), np.uint8)
    for i, (y0, y1, x0, x1) in enumerate(
        region_boxes(net_w, net_h, num_scales, start_scale, scale_gap)
    ):
        out[i, y0:y1, x0:x1] = resize_area(img_bgr, x1 - x0, y1 - y0)
    return out


def packed_regions(net_w: int, net_h: int, num_scales: int,
                   start_scale: float, scale_gap: float):
    """Layout of the scale-sublinear u8 transfer buffer: per scale
    (th, tw, padh, padw, byte_offset), plus the total byte count.

    Scale n's live region is only (tw_n, th_n) inside the padded canvas
    (padw = (net_w - tw)//2, imresize_layer.cu:110-140 pad math); shipping
    the padding bytes over the host->device link is pure waste, so the
    packed format concatenates just the live regions."""
    regs = []
    off = 0
    for i in range(num_scales):
        tw, th = scale_dims(net_w, net_h, start_scale - i * scale_gap)
        regs.append((th, tw, (net_h - th) // 2, (net_w - tw) // 2, off))
        off += th * tw * 3
    return regs, off


def make_net_input_u8_packed(
    img_bgr: np.ndarray,
    net_w: int,
    net_h: int,
    num_scales: int = 1,
    start_scale: float = 1.0,
    scale_gap: float = 0.3,
) -> np.ndarray:
    """Scale-sublinear u8 transfer format: one flat (total_bytes,) buffer of
    concatenated per-scale live regions (no padding bytes).  The device
    normalizes and zero-pads each region back into its (net_h, net_w)
    canvas — bit-identical to make_net_input_u8 + the on-device mask
    normalize, at ~57% of the upload bytes for the reference 3-scale
    config."""
    regs, total = packed_regions(net_w, net_h, num_scales, start_scale, scale_gap)
    out = np.empty(total, np.uint8)
    for th, tw, _, _, off in regs:
        out[off : off + th * tw * 3] = resize_area(img_bgr, tw, th).reshape(-1)
    return out


def area_axis_matrix(dst: int, src: int) -> np.ndarray:
    """(dst, src) INTER_AREA weights for one axis (box-overlap / "pixel
    area relation", the cv2 float path for arbitrary downscale ratios).
    Row i averages src interval [i*src/dst, (i+1)*src/dst); rows sum to 1,
    so the matrix commutes with the affine u8 -> x/256-0.5 normalize."""
    if dst > src:
        raise ValueError("area_axis_matrix is for downscale only")
    r = src / float(dst)
    m = np.zeros((dst, src), np.float32)
    for i in range(dst):
        lo, hi = i * r, (i + 1) * r
        j0, j1 = int(math.floor(lo)), int(math.ceil(hi))
        for j in range(j0, min(j1, src)):
            m[i, j] = (min(j + 1, hi) - max(j, lo)) / r
    return m


def make_net_input_u8_base(
    img_bgr: np.ndarray,
    net_w: int,
    net_h: int,
    start_scale: float = 1.0,
) -> np.ndarray:
    """Device-rescale transfer format: ONE flat u8 buffer of the LARGEST
    scale's live region; the device derives every smaller scale from it
    with INTER_AREA matmuls (area_axis_matrix) and zero-pads the canvases.

    Documented divergence vs the reference (opt-in, --device_rescale):
    the reference resizes the display frame independently per scale
    (rtpose.cpp:508-518); deriving scale n from the scale-0 canvas is a
    resize-of-a-resize, so pixels differ at the level of interpolation
    rounding (~1-2 u8 levels), in exchange for a multi-scale upload that
    costs the same bytes as single-scale."""
    tw, th = scale_dims(net_w, net_h, start_scale)
    return np.ascontiguousarray(resize_area(img_bgr, tw, th).reshape(-1))


@dataclass
class PreprocessedFrame:
    net_input: np.ndarray  # the estimator's transfer format
    display: Optional[np.ndarray]  # (disp_h, disp_w, 3) u8 warped frame
    scale: float  # display scale vs original (for JSON 1/scale rescale)
    ori_width: int
    ori_height: int


def preprocess_frame(
    img_bgr: np.ndarray,
    net_w: int,
    net_h: int,
    disp_w: Optional[int] = None,
    disp_h: Optional[int] = None,
    num_scales: int = 1,
    start_scale: float = 1.0,
    scale_gap: float = 0.3,
    u8: Union[bool, str] = False,
) -> PreprocessedFrame:
    """Full producer-side transform for one frame (getFrameFromDir path).
    ``u8=True`` emits the raw (S, H, W, 3) u8 canvases for estimators built
    with ``input_u8`` (normalization runs on device); ``u8="packed"`` emits
    the flat live-region buffer (make_net_input_u8_packed); ``u8="base"``
    the largest scale's live region alone (make_net_input_u8_base)."""
    ori_h, ori_w = img_bgr.shape[:2]
    if disp_w is None or disp_h is None:
        display, scale = img_bgr, 1.0
    else:
        display, scale = warp_to_display(img_bgr, disp_w, disp_h)
    if u8 == "base":
        net_input = make_net_input_u8_base(display, net_w, net_h, start_scale)
    else:
        make = (make_net_input_u8_packed if u8 == "packed"
                else make_net_input_u8 if u8 else make_net_input)
        net_input = make(display, net_w, net_h, num_scales, start_scale, scale_gap)
    return PreprocessedFrame(
        net_input=net_input, display=display, scale=scale, ori_width=ori_w, ori_height=ori_h
    )
