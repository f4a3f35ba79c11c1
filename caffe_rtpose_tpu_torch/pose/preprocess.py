"""Frame preprocessing helpers the estimator uses: per-scale resize,
center-pad and normalize — byte-for-byte the reference producer semantics
(process_and_pad_image rtpose.cpp:239-269; scale loop rtpose.cpp:508-518) —
and the packed live-region u8 format (``packed_regions``).

A copy of the numpy half of ``caffe_rtpose_tpu/pose/preprocess.py`` (which
cannot be imported without jax).  The resizes need OpenCV; where it is
absent (``cv2 is None``) callers build net-sized canvases themselves and use
``PoseEstimator.estimate_from_net_input``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover - cv2 may be absent on GPU hosts
    cv2 = None


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
    (CV_INTER_AREA per-scale resize + center pad + /256-0.5)."""
    if cv2 is None:
        raise RuntimeError("OpenCV unavailable")
    out = np.zeros((num_scales, 3, net_h, net_w), np.float32)
    for i in range(num_scales):
        scale = start_scale - i * scale_gap
        tw, th = scale_dims(net_w, net_h, scale)
        resized = cv2.resize(img_bgr, (tw, th), interpolation=cv2.INTER_AREA)
        out[i] = pad_and_normalize(resized, net_w, net_h, normalize=True)
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
    if cv2 is None:
        raise RuntimeError("OpenCV unavailable")
    out = np.zeros((num_scales, net_h, net_w, 3), np.uint8)
    for i, (y0, y1, x0, x1) in enumerate(
        region_boxes(net_w, net_h, num_scales, start_scale, scale_gap)
    ):
        resized = cv2.resize(img_bgr, (x1 - x0, y1 - y0), interpolation=cv2.INTER_AREA)
        out[i, y0:y1, x0:x1] = resized
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
    if cv2 is None:
        raise RuntimeError("OpenCV unavailable")
    regs, total = packed_regions(net_w, net_h, num_scales, start_scale, scale_gap)
    out = np.empty(total, np.uint8)
    for th, tw, _, _, off in regs:
        resized = cv2.resize(img_bgr, (tw, th), interpolation=cv2.INTER_AREA)
        out[off : off + th * tw * 3] = resized.reshape(-1)
    return out
