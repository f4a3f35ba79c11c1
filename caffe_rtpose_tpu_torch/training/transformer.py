"""CPM training data transformer: augmentation chain + PAF/heatmap label
generation, mirroring the reference DataTransformer CPM path
(src/caffe/data_transformer.cpp:1146-2560).

Pipeline (Transform_nv, TRAIN phase, :1323-1339):
    scale -> rotate -> croppad -> flip      (in that exact order)
then mask downsampling by stride and label generation.

Label layout for np=56 / COCO (mode 5, generateLabelMap :2216-2267):
    channels [0, np)        per-part loss weights = mask_miss (0 if isVisible==3)
    channel  np             mask_miss
    channels [np+1, np+39)  19 PAF pairs via putVecMaps (x, y interleaved)
    channels [np+39, np+57) 18 part gaussians via putGaussianMaps
    channel  2*np+1         background = max(1 - max(parts), 0)

Numerical notes kept faithful:
* putGaussianMaps accumulates per person and clamps at 1 after each add;
  grid sample positions are start + g*stride with start = stride/2 - 0.5;
  contributions with exponent > ln(100) are skipped (:2002-2019).
* putVecMaps scales centers by 0.125 (stride-8 hardcoded in the reference)
  and carries a counting bug: the count matrix is never incremented on first
  write (:2100-2105), so overlapping limbs resolve to LAST WRITER, not the
  average.  We reproduce that behavior for parity.
* croppad fills with (128,128,128), mask_miss with 255; the net input is
  (pixel - 128)/256 (:1358-1361), unlike the demo's /256-0.5.

The port of ``caffe_rtpose_tpu/training/transformer.py`` without OpenCV (the
machine with the card has none).  Its two cubic resamplers are numpy, each a
sum of 16 whole-array tap gathers with OpenCV's cubic weights (A = -0.75,
``pose/preprocess._cubic_weights``) in f32:

* :func:`resize_cubic` is ``cv2.resize(..., fx, fy, INTER_CUBIC)``:
  half-pixel centres, edge rows and columns repeated;
* :func:`warp_affine_cubic` is ``cv2.warpAffine(..., INTER_CUBIC,
  BORDER_CONSTANT)``: the inverted matrix as ``invertAffineTransform`` forms
  it, source coordinates rounded to f32, taps outside the image at the
  border value.

Both land within one u8 level of OpenCV 5.0 on every pixel and equal it on
all but a few hundredths of a percent of them
(``tests/test_torch_transformer.py``).  :func:`rotation_matrix_2d` is
``cv2.getRotationMatrix2D`` in its closed form, bit for bit, so joints (and
every label channel drawn from them) match the JAX chain exactly.
:func:`clahe` (``do_clahe``, off by default) is OpenCV's 8-bit Lab
conversions and CLAHE in numpy (``utils/imgproc.py``), bit for bit, with no
``cv2``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..pose.preprocess import _cubic_weights
from ..utils import imgproc
from .joints import swap_left_right

# COCO keypoint (17) -> "ours" (18, with neck) mapping (:1026-1042)
COCO_TO_OURS_1 = [1, 6, 7, 9, 11, 6, 8, 10, 13, 15, 17, 12, 14, 16, 3, 2, 5, 4]
COCO_TO_OURS_2 = [1, 7, 7, 9, 11, 6, 8, 10, 13, 15, 17, 12, 14, 16, 3, 2, 5, 4]

# PAF limb endpoints, 1-indexed into the 18-part set (:2231-2232)
MID_1 = [2, 9, 10, 2, 12, 13, 2, 3, 4, 3, 2, 6, 7, 6, 2, 1, 1, 15, 16]
MID_2 = [9, 10, 11, 12, 13, 14, 3, 4, 5, 17, 6, 7, 8, 18, 1, 15, 16, 17, 18]

# left/right part swap for np=56 flips (:1845-1852), 1-indexed
SWAP_RIGHT_56 = [3, 4, 5, 9, 10, 11, 15, 17]
SWAP_LEFT_56 = [6, 7, 8, 12, 13, 14, 16, 18]


@dataclass
class Person:
    joints: np.ndarray  # (np, 2) float32
    visible: np.ndarray  # (np,) int: 0/1 visible-ish, 2 = outside, 3 = absent
    objpos: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))


@dataclass
class Meta:
    """MetaData analog (data_transformer.hpp); joints already in the 18-part
    'ours' order (use transform_joints_coco for raw COCO 17-kpt annots)."""

    people: List[Person]  # [0] is joint_self
    scale_self: float = 1.0

    @property
    def main(self) -> Person:
        return self.people[0]

    @property
    def others(self) -> List[Person]:
        return self.people[1:]


def transform_joints_coco(joints17: np.ndarray, visible17: np.ndarray):
    """COCO 17 kpts -> 18-part 'ours' order with synthesized neck
    (TransformJoints np==56, :1026-1042)."""
    j = np.zeros((18, 2), np.float32)
    v = np.zeros(18, np.int32)
    for i in range(18):
        a, b = COCO_TO_OURS_1[i] - 1, COCO_TO_OURS_2[i] - 1
        j[i] = (joints17[a] + joints17[b]) * 0.5
        if visible17[a] == 2 or visible17[b] == 2:
            v[i] = 2
        elif visible17[a] == 3 or visible17[b] == 3:
            v[i] = 3
        else:
            v[i] = int(bool(visible17[a]) and bool(visible17[b]))
    return j, v


@dataclass
class AugParams:
    """TransformationParameter CPM knobs (caffe.proto:430-470)."""

    stride: int = 8
    crop_size_x: int = 368
    crop_size_y: int = 368
    target_dist: float = 0.6
    scale_prob: float = 1.0
    scale_min: float = 0.5
    scale_max: float = 1.1
    max_rotate_degree: float = 40.0
    center_perterb_max: float = 40.0
    flip_prob: float = 0.5
    sigma: float = 7.0
    transform_body_joint: bool = True
    np: int = 56
    do_clahe: bool = False  # CLAHE on L in Lab (clahe(), numpy, no OpenCV)
    clahe_tile_size: int = 8
    clahe_clip_limit: int = 4


@dataclass
class AugSelection:
    scale: float = 1.0
    degree: float = 0.0
    crop: Tuple[int, int] = (0, 0)
    flip: bool = False


def _apply_points(people: List[Person], fn):
    for p in people:
        p.objpos = fn(p.objpos[None])[0]
        p.joints = fn(p.joints)


# ------------------------------------------------------- cubic resamplers


def _resize_taps(n_out: int, n_src: int, inv: float) -> Tuple[np.ndarray, np.ndarray]:
    """One axis of ``cv::resize`` INTER_CUBIC: output i samples source
    coordinate (i + 0.5) * inv - 0.5 (f32) -> (n_out, 4) source indices,
    clamped to the edge, and (n_out, 4) f32 weights."""
    c = ((np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5).astype(np.float32)
    i0 = np.floor(c)
    w = _cubic_weights(c - i0)
    idx = np.clip(i0.astype(np.int64)[:, None] - 1 + np.arange(4), 0, n_src - 1)
    return idx, w


def resize_cubic(img: np.ndarray, fx: float, fy: Optional[float] = None) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=fx, fy=fy, interpolation=INTER_CUBIC)``
    for a u8 (H, W) or (H, W, C) image: the output size is the input's times
    the factor, rounded half to even; an unchanged size is a copy."""
    fy = fx if fy is None else fy
    h, w = img.shape[:2]
    oh, ow = int(np.rint(h * fy)), int(np.rint(w * fx))
    if (oh, ow) == (h, w):
        return img.copy()
    src = np.asarray(img, np.uint8).reshape(h, w, -1)
    ys, wy = _resize_taps(oh, h, 1.0 / fy)
    xs, wx = _resize_taps(ow, w, 1.0 / fx)
    horiz = src.take(xs[:, 0], axis=1).astype(np.float32)
    horiz *= wx[:, 0, None]
    for j in range(1, 4):
        t = src.take(xs[:, j], axis=1).astype(np.float32)
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
    return out.astype(np.uint8).reshape((oh, ow) + img.shape[2:])


def rotation_matrix_2d(center: Tuple[float, float], degree: float,
                       scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D`` bit for bit: a (2, 3) float64 matrix,
    the angle scaled by pi/180 first and the centre rounded to f32 (it is a
    ``Point2f``)."""
    angle = float(degree) * (math.pi / 180.0)
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    cx, cy = float(np.float32(center[0])), float(np.float32(center[1]))
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv::invertAffineTransform`` (float64)."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]], np.float64)


def warp_affine_cubic(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                      border: Sequence[float]) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags=INTER_CUBIC,
    borderMode=BORDER_CONSTANT, borderValue=border)`` for a u8 (H, W) or
    (H, W, C) image; ``dsize`` is (width, height).  Each output samples the
    source at the inverse map's f32 coordinate; a tap outside the image
    reads the border value, and an output whose 4x4 window misses the image
    is the border value."""
    bw, bh = int(dsize[0]), int(dsize[1])
    inv = _invert_affine(np.asarray(m, np.float64))
    h, w = img.shape[:2]
    src = np.asarray(img, np.uint8).reshape(h, w, -1)
    cn = src.shape[2]
    fill_value = np.asarray(border, np.float32)[:cn]
    pad = 3  # a window that touches the image stays inside the padded copy
    pw = w + 2 * pad
    padded = np.empty((h + 2 * pad, pw, cn), np.float32)
    padded[...] = fill_value
    padded[pad : pad + h, pad : pad + w] = src
    flat = padded.reshape(-1, cn)
    xs = np.arange(bw, dtype=np.float64)[None, :]
    ys = np.arange(bh, dtype=np.float64)[:, None]
    sx = (inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]).astype(np.float32).ravel()
    sy = (inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]).astype(np.float32).ravel()
    x0, y0 = np.floor(sx), np.floor(sy)
    inside = (x0 >= -2) & (x0 <= w) & (y0 >= -2) & (y0 <= h)
    out = np.empty((bh * bw, cn), np.float32)
    out[...] = fill_value
    sx, sy, x0, y0 = sx[inside], sy[inside], x0[inside], y0[inside]
    wx, wy = _cubic_weights(sx - x0), _cubic_weights(sy - y0)
    base = (y0.astype(np.int64) - 1 + pad) * pw + (x0.astype(np.int64) - 1 + pad)
    acc = None
    for i in range(4):
        row = None
        for j in range(4):
            t = flat.take(base + (i * pw + j), axis=0)
            t *= wx[:, j, None]
            row = t if row is None else np.add(row, t, out=row)
        row *= wy[:, i, None]
        acc = row if acc is None else np.add(acc, row, out=acc)
    out[inside] = acc
    np.rint(out, out=out)
    np.clip(out, 0, 255, out=out)
    return out.astype(np.uint8).reshape((bh, bw) + img.shape[2:])


# ------------------------------------------------------- augmentation chain


def augmentation_scale(img, mask_miss, meta: Meta, prm: AugParams, rng) -> Tuple[np.ndarray, np.ndarray, float]:
    # all geometry math in float32, like the reference's `float` locals
    # (augmentation_scale :1431-1447) — the f32 scale feeds cv::resize, and
    # an f64 recomputation changes every interpolated pixel
    dice = np.float32(rng.rand())
    if dice > np.float32(prm.scale_prob):
        mult = np.float32(1.0)
    else:
        dice2 = np.float32(rng.rand())
        mult = ((np.float32(prm.scale_max) - np.float32(prm.scale_min))
                * dice2 + np.float32(prm.scale_min))
    scale = np.float32(
        np.float32(prm.target_dist) / np.float32(meta.scale_self)) * mult
    img = resize_cubic(img, float(scale))
    if mask_miss is not None:
        mask_miss = resize_cubic(mask_miss, float(scale))
    _apply_points(meta.people, lambda pts: pts * scale)
    return img, mask_miss, float(mult)


def _rotated_bounding_rect(center, size, degree):
    """cv::RotatedRect(center, size, degree).boundingRect() — f32 corner
    math (RotatedRect::points) then floor/ceil with the +1 the OpenCV
    integer-rect convention adds."""
    cx, cy = np.float32(center[0]), np.float32(center[1])
    w, h = np.float32(size[0]), np.float32(size[1])
    ang = float(degree) * np.pi / 180.0
    b = np.float32(np.cos(ang) * 0.5)
    a = np.float32(np.sin(ang) * 0.5)
    x0 = cx - a * h - b * w
    y0 = cy + b * h - a * w
    x1 = cx + a * h - b * w
    y1 = cy - b * h - a * w
    xs = np.array([x0, x1, 2 * cx - x0, 2 * cx - x1], np.float32)
    ys = np.array([y0, y1, 2 * cy - y0, 2 * cy - y1], np.float32)
    bx = int(np.floor(xs.min()))
    by = int(np.floor(ys.min()))
    return (bx, by,
            int(np.ceil(xs.max())) - bx + 1, int(np.ceil(ys.max())) - by + 1)


def augmentation_rotate(img, mask_miss, meta: Meta, prm: AugParams, rng):
    # reference (:1577): `degree = (dice - 0.5) * 2 * max_rotate_degree()`
    # — dice is f32, but the 0.5 double literal promotes the whole
    # expression to f64; the result then narrows into the f32 `degree`
    dice = np.float32(rng.rand())
    degree = float(np.float32(
        (float(dice) - 0.5) * 2.0 * float(np.float32(prm.max_rotate_degree))))
    h, w = img.shape[:2]
    center = (w / 2.0, h / 2.0)
    R = rotation_matrix_2d(center, degree, 1.0)
    # expand to the rotated bounding box (reference :1588-1592)
    box = _rotated_bounding_rect(center, (w, h), degree)
    bw, bh = box[2], box[3]
    R[0, 2] += bw / 2.0 - center[0]
    R[1, 2] += bh / 2.0 - center[1]
    img = warp_affine_cubic(img, R, (bw, bh), (128, 128, 128))
    if mask_miss is not None:
        mask_miss = warp_affine_cubic(mask_miss, R, (bw, bh), (255,))

    def rot(pts):
        homo = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
        return (homo @ R.T).astype(np.float32)

    _apply_points(meta.people, rot)
    return img, mask_miss, degree


def augmentation_croppad(img, mask_miss, meta: Meta, prm: AugParams, rng):
    dice_x = np.float32(rng.rand())
    dice_y = np.float32(rng.rand())
    crop_x, crop_y = prm.crop_size_x, prm.crop_size_y
    # reference (:1480): `int((dice_x - 0.5) * 2 * center_perterb_max())`
    # — f32 dice promoted to f64 by the 0.5 double literal; the product is
    # exact in f64 before the C truncation
    cpm = float(np.float32(prm.center_perterb_max))
    x_offset = int((float(dice_x) - 0.5) * 2.0 * cpm)
    y_offset = int((float(dice_y) - 0.5) * 2.0 * cpm)
    center = meta.main.objpos + np.array([x_offset, y_offset], np.float32)
    # Point2f -> Point2i via saturate_cast = cvRound (nearest, ties to even)
    cx, cy = int(np.rint(center[0])), int(np.rint(center[1]))
    offset_left = -(cx - crop_x // 2)
    offset_up = -(cy - crop_y // 2)

    out = np.full((crop_y, crop_x, 3), 128, np.uint8)
    mask_out = np.full((crop_y, crop_x), 255, np.uint8)
    sy0, sy1 = cy - crop_y // 2, cy - crop_y // 2 + crop_y
    sx0, sx1 = cx - crop_x // 2, cx - crop_x // 2 + crop_x
    h, w = img.shape[:2]
    dy0, dx0 = max(0, -sy0), max(0, -sx0)
    cy0, cx0 = max(0, sy0), max(0, sx0)
    cy1, cx1 = min(h, sy1), min(w, sx1)
    if cy1 > cy0 and cx1 > cx0:
        out[dy0 : dy0 + cy1 - cy0, dx0 : dx0 + cx1 - cx0] = img[cy0:cy1, cx0:cx1]
        if mask_miss is not None:
            mask_out[dy0 : dy0 + cy1 - cy0, dx0 : dx0 + cx1 - cx0] = mask_miss[cy0:cy1, cx0:cx1]
    offset = np.array([offset_left, offset_up], np.float32)
    _apply_points(meta.people, lambda pts: pts + offset)
    return out, (mask_out if mask_miss is not None else None), (x_offset, y_offset)


def swap_left_right_56(p: Person) -> None:
    for r, l in zip(SWAP_RIGHT_56, SWAP_LEFT_56):
        ri, li = r - 1, l - 1
        p.joints[[ri, li]] = p.joints[[li, ri]]
        p.visible[[ri, li]] = p.visible[[li, ri]]


def augmentation_flip(img, mask_miss, meta: Meta, prm: AugParams, rng):
    doflip = rng.rand() <= prm.flip_prob
    if doflip:
        img = np.ascontiguousarray(img[:, ::-1])
        if mask_miss is not None:
            mask_miss = np.ascontiguousarray(mask_miss[:, ::-1])
        w = img.shape[1]

        def flip_pts(pts):
            out = pts.copy()
            out[:, 0] = w - 1 - out[:, 0]
            return out

        _apply_points(meta.people, flip_pts)
        if prm.transform_body_joint:
            for p in meta.people:
                swap_left_right(p.joints, p.visible, prm.np)
    return img, mask_miss, doflip


def clahe(img_bgr: np.ndarray, tile_size: int = 8, clip_limit: int = 4) -> np.ndarray:
    """CLAHE on the L channel in Lab space (DataTransformer::clahe,
    data_transformer.cpp:2505-2528): ``cvtColor`` BGR -> Lab, ``CLAHE`` on
    L, Lab -> BGR, in OpenCV's u8 arithmetic without OpenCV
    (``utils/imgproc.py``)."""
    lab = imgproc.bgr2lab_u8(img_bgr)
    lab[..., 0] = imgproc.clahe_u8(lab[..., 0], float(clip_limit), tile_size)
    return imgproc.lab2bgr_u8(lab)


def put_vec_peaks(entry_x: np.ndarray, entry_y: np.ndarray, center_a: np.ndarray,
                  center_b: np.ndarray, thre: int = 4) -> None:
    """Three-blob variant of the PAF writer (putVecPeaks,
    data_transformer.cpp:2022-2060): unit vectors stamped at A, midpoint and
    B within a radius-sqrt(thre) disc; same last-writer overlap behavior."""
    grid_y, grid_x = entry_x.shape
    a = center_a * 0.125
    b = center_b * 0.125
    bc = b - a
    norm = math.sqrt(float(bc[0] * bc[0] + bc[1] * bc[1]))
    if norm == 0:
        return
    u = bc / norm
    for j in range(3):
        center = b * 0.5 * j + a * 0.5 * (2 - j)
        min_x = max(int(math.floor(center[0] - thre)), 0)
        max_x = min(int(math.ceil(center[0] + thre)), grid_x)
        min_y = max(int(math.floor(center[1] - thre)), 0)
        max_y = min(int(math.ceil(center[1] + thre)), grid_y)
        if max_x <= min_x or max_y <= min_y:
            continue
        gx = np.arange(min_x, max_x)
        gy = np.arange(min_y, max_y)
        dist = (gx[None, :] - center[0]) ** 2 + (gy[:, None] - center[1]) ** 2
        sel = dist <= thre
        entry_x[min_y:max_y, min_x:max_x][sel] = u[0]
        entry_y[min_y:max_y, min_x:max_x][sel] = u[1]


def put_gaussian_maps(entry: np.ndarray, center: np.ndarray, stride: int, sigma: float) -> None:
    """Accumulate-and-clamp gaussian (putGaussianMaps :2002-2019)."""
    grid_y, grid_x = entry.shape
    start = stride / 2.0 - 0.5
    xs = start + np.arange(grid_x) * stride
    ys = start + np.arange(grid_y) * stride
    d2 = (xs[None, :] - center[0]) ** 2 + (ys[:, None] - center[1]) ** 2
    expo = d2 / 2.0 / sigma / sigma
    contrib = np.where(expo > 4.6052, 0.0, np.exp(-expo))
    entry += contrib.astype(entry.dtype)
    np.minimum(entry, 1.0, out=entry)


def put_vec_maps(entry_x: np.ndarray, entry_y: np.ndarray, center_a: np.ndarray,
                 center_b: np.ndarray, thre: int = 1) -> None:
    """PAF corridor write (putVecMaps :2063-2114).  Centers are divided by 8
    (hard-coded in the reference); the count matrix never increments on first
    write, so overlap resolves to last-writer — reproduced on purpose."""
    grid_y, grid_x = entry_x.shape
    a = center_a * 0.125
    b = center_b * 0.125
    bc = b - a
    norm = math.sqrt(float(bc[0] * bc[0] + bc[1] * bc[1]))
    if norm == 0:
        return
    u = bc / norm
    # std::round = half away from zero (Python round() is half-to-even);
    # the negative branch only matters pre-clamp so floor(x+0.5) suffices
    def _cround(v):
        return math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5)

    min_x = max(int(_cround(min(a[0], b[0]) - thre)), 0)
    max_x = min(int(_cround(max(a[0], b[0]) + thre)), grid_x)
    min_y = max(int(_cround(min(a[1], b[1]) - thre)), 0)
    max_y = min(int(_cround(max(a[1], b[1]) + thre)), grid_y)
    if max_x <= min_x or max_y <= min_y:
        return
    gx = np.arange(min_x, max_x)
    gy = np.arange(min_y, max_y)
    bax = gx[None, :] - a[0]
    bay = gy[:, None] - a[1]
    dist = np.abs(bax * u[1] - bay * u[0])
    sel = dist <= thre
    entry_x[min_y:max_y, min_x:max_x][sel] = u[0]
    entry_y[min_y:max_y, min_x:max_x][sel] = u[1]


def generate_label_map(meta: Meta, prm: AugParams, mask_miss_grid: Optional[np.ndarray]):
    """Full label tensor (2*(np+1), grid_y, grid_x): generateLabelMap
    (:2117-2305) over the Transform_nv mode-5 mask layout (:1390-1415).

    Three reference branches:
    - np==56 (COCO PAF training): 19 putVecMaps PAF pairs + 18 part
      gaussians + background = max(1-max(parts), 0);
    - np==37 (COCO heatmap-only): 18 part gaussians + 19 limb-interior
      channels with gaussians at 1/4, 1/2, 3/4 along each limb, background
      over all 36 upper channels.  The reference's inner person loop
      shadows the fraction variable ``j`` (:2168-2177) — each OTHER
      person's gaussian uses their PERSON INDEX * 0.25 as the fraction and
      is stamped three times (accumulating pre-clamp) — replicated;
    - default (np==14/27/28/29/33/34/36/43/52/...): one gaussian channel
      per part from the TransformJoints output; generateLabelMap's
      hardcoded ``mode = 6`` skips both the background write (:2287) and
      the clearing of channel 2*np+1 (:2151), so the background channel
      stays at the blob's initial zeros.
    """
    np_ = prm.np
    grid_x = prm.crop_size_x // prm.stride
    grid_y = prm.crop_size_y // prm.stride
    label = np.zeros((2 * (np_ + 1), grid_y, grid_x), np.float32)

    weight = (
        mask_miss_grid.astype(np.float32) / 255.0
        if mask_miss_grid is not None
        else np.ones((grid_y, grid_x), np.float32)
    )
    # per-part loss weights from the main person's visibility; modes that
    # fill fewer slots than np (56/37 fill 18) leave the rest at 0 -> weighted
    vis = np.zeros(np_, np.int32)
    n_filled = min(np_, len(meta.main.visible))
    vis[:n_filled] = meta.main.visible[:n_filled]
    for i in range(np_):
        label[i] = weight if vis[i] != 3 else 0.0
    label[np_] = weight  # mode 5 (:1409-1410)

    if np_ == 56:
        # part gaussians at channels np+39 .. np+56
        for i in range(18):
            for p in meta.people:
                if p.visible[i] <= 1:
                    put_gaussian_maps(label[np_ + 39 + i], p.joints[i], prm.stride, prm.sigma)

        # PAFs at channels np+1+2k, np+2+2k
        for k in range(19):
            a_id, b_id = MID_1[k] - 1, MID_2[k] - 1
            for p in meta.people:
                if p.visible[a_id] <= 1 and p.visible[b_id] <= 1:
                    put_vec_maps(label[np_ + 1 + 2 * k], label[np_ + 2 + 2 * k],
                                 p.joints[a_id], p.joints[b_id], thre=1)

        # background channel (:2259-2264)
        parts = label[np_ + 39 : np_ + 57]
        label[2 * np_ + 1] = np.maximum(1.0 - parts.max(axis=0), 0.0)
    elif np_ == 37:
        for i in range(18):
            for p in meta.people:
                if p.visible[i] <= 1:
                    put_gaussian_maps(label[np_ + 1 + i], p.joints[i], prm.stride, prm.sigma)
        for k in range(19):
            a_id, b_id = MID_1[k] - 1, MID_2[k] - 1
            main = meta.main
            for frac_j in (1, 2, 3):
                if main.visible[a_id] <= 1 and main.visible[b_id] <= 1:
                    c = (main.joints[a_id] * np.float32(1 - frac_j * 0.25)
                         + main.joints[b_id] * np.float32(frac_j * 0.25))
                    put_gaussian_maps(label[np_ + 19 + k], c, prm.stride, prm.sigma)
                # reference :2168-2177: the person loop shadows frac_j, so
                # each other person's center uses their 0-based INDEX as
                # the quarter-fraction, stamped once per outer iteration
                for pj, p in enumerate(meta.others):
                    if p.visible[a_id] <= 1 and p.visible[b_id] <= 1:
                        c = (p.joints[a_id] * np.float32(1 - pj * 0.25)
                             + p.joints[b_id] * np.float32(pj * 0.25))
                        put_gaussian_maps(label[np_ + 19 + k], c, prm.stride, prm.sigma)
        upper = label[np_ + 1 : 2 * np_ + 1]
        label[2 * np_ + 1] = np.maximum(1.0 - upper.max(axis=0), 0.0)
    else:
        for i in range(np_):
            for p in meta.people:
                if i < len(p.visible) and p.visible[i] <= 1:
                    put_gaussian_maps(label[np_ + 1 + i], p.joints[i], prm.stride, prm.sigma)
        # mode == 6 hardcoded upstream: background channel left untouched
    return label


def transform_meta(
    img_bgr: np.ndarray,
    meta: Meta,
    prm: AugParams,
    rng: Optional[np.random.RandomState] = None,
    mask_miss: Optional[np.ndarray] = None,
    train: bool = True,
    aug: Optional[AugSelection] = None,
    normalize: bool = True,
):
    """Augmentation chain only (scale->rotate->croppad->flip,
    Transform_nv :1306-1346): returns (data (3, crop_y, crop_x),
    augmented people, mask_miss grid or None).  Label rasterization is left
    to the caller — either host :func:`generate_label_map` or the on-device
    ``training.labels_device`` path.  ``normalize=False`` returns raw u8
    (the exact (x-128)/256 then runs on device)."""
    rng = rng or np.random.RandomState()
    aug = aug if aug is not None else AugSelection()
    if prm.do_clahe:
        img_bgr = clahe(img_bgr, prm.clahe_tile_size, prm.clahe_clip_limit)
    if train:
        img_bgr, mask_miss, aug.scale = augmentation_scale(img_bgr, mask_miss, meta, prm, rng)
        img_bgr, mask_miss, aug.degree = augmentation_rotate(img_bgr, mask_miss, meta, prm, rng)
        img_bgr, mask_miss, aug.crop = augmentation_croppad(img_bgr, mask_miss, meta, prm, rng)
        img_bgr, mask_miss, aug.flip = augmentation_flip(img_bgr, mask_miss, meta, prm, rng)
    else:
        out = np.full((prm.crop_size_y, prm.crop_size_x, 3), 128, np.uint8)
        h = min(prm.crop_size_y, img_bgr.shape[0])
        w = min(prm.crop_size_x, img_bgr.shape[1])
        out[:h, :w] = img_bgr[:h, :w]
        img_bgr = out
    if mask_miss is not None:
        mask_grid = resize_cubic(mask_miss, 1.0 / prm.stride)
    else:
        mask_grid = None
    if normalize:
        data = (img_bgr.astype(np.float32) - 128.0) / 256.0  # (:1358-1361)
    else:
        data = img_bgr
    data = data.transpose(2, 0, 1)
    return data, meta.people, mask_grid


def transform(
    img_bgr: np.ndarray,
    meta: Meta,
    prm: AugParams,
    rng: Optional[np.random.RandomState] = None,
    mask_miss: Optional[np.ndarray] = None,
    train: bool = True,
) -> Tuple[np.ndarray, np.ndarray, AugSelection]:
    """Full Transform_nv: returns (data (3, crop_y, crop_x), label, aug)."""
    aug = AugSelection()
    data, _, mask_grid = transform_meta(
        img_bgr, meta, prm, rng=rng, mask_miss=mask_miss, train=train, aug=aug)
    label = generate_label_map(meta, prm, mask_grid)
    return data, label, aug
