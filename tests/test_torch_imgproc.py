"""The port's OpenCV u8 image operations (``caffe_rtpose_tpu_torch/utils/
imgproc.py``) against ``cv2`` (5.0.0 here), bit for bit:

* BGR <-> Lab over the whole 2^24 cube each way, by the digests pinned in
  ``tests/imgproc_cases.py`` (recomputed with cv2 and with the port);
* CLAHE over sizes that divide the tile grid and sizes that do not, clip
  limits 0, 1, 4 and 40, 1-16 tiles a side, constant, ramp, noise and dark
  images;
* ``cv2.line`` (LINE_8) at thickness 1-5 and more: every octant,
  horizontal, vertical and 45-degree lines, zero-length lines, endpoints off
  every side, 1 and 3 channels, and random segments (hypothesis);
* INTER_LINEAR on u8: up and down on each axis, 1-pixel sources and
  outputs, an exact halving, the tools' 256 <-> 227;
* the refusals.

The port's side runs with cv2 blocked where it is compared with a pin."""

import sys
import types

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import imgproc_cases as C
from caffe_rtpose_tpu_torch.utils import imgproc as ip

CV2_OPS = types.SimpleNamespace(
    bgr2lab_u8=lambda img: cv2.cvtColor(img, cv2.COLOR_BGR2Lab),
    lab2bgr_u8=lambda img: cv2.cvtColor(img, cv2.COLOR_Lab2BGR),
    clahe_u8=lambda gray, clip, tiles: cv2.createCLAHE(clip, (tiles, tiles)).apply(gray),
    line_u8=lambda img, p0, p1, color, t: cv2.line(img, p0, p1, color, t),
    resize_linear_u8=lambda img, h, w: cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR))


def _digest(name, ops, side):
    if name.endswith("_cube"):
        return C.cube_digest(getattr(ops, name[: -len("_cube")] + "_u8"))
    if name == "synthetic":
        if side == "cv2":
            from caffe_rtpose_tpu.training.datasets import SyntheticPoseSource
        else:
            from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource
        return C.synthetic_digest(SyntheticPoseSource)
    if name == "do_clahe":
        if side == "cv2":
            from caffe_rtpose_tpu.training.transformer import clahe
        else:
            from caffe_rtpose_tpu_torch.training.transformer import clahe
        return C.do_clahe_digest(clahe)
    return C.case_digests(ops, (name,))[name]


@pytest.mark.parametrize("name", list(C.DIGESTS))
def test_pins_are_cv2(name):
    """The pinned digests are cv2's (and the JAX package's)."""
    assert _digest(name, CV2_OPS, "cv2") == C.DIGESTS[name]


@pytest.mark.parametrize("name", list(C.DIGESTS))
def test_port_equals_pins(monkeypatch, name):
    """The port, cv2 blocked, gives the pinned digests: over the whole cube
    each way for the Lab conversions."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert _digest(name, ip, "port") == C.DIGESTS[name]


# ------------------------------------------------------------------ Lab


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (240, 320, 3)])
def test_lab_both_ways(shape):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(ip.bgr2lab_u8(img), cv2.cvtColor(img, cv2.COLOR_BGR2Lab))
    np.testing.assert_array_equal(ip.lab2bgr_u8(img), cv2.cvtColor(img, cv2.COLOR_Lab2BGR))


def test_lab_cube_root_entry():
    """OpenCV's softfloat cube root cuts its mantissa: the table entry at
    x = 324/2040 is 17745, where the correctly rounded root gives 17746; the
    grays that index it (L = 119 in cv2) show it."""
    assert ip._lab_tables().cbrt[324] == 17745
    gray = np.arange(256, dtype=np.uint8).repeat(3).reshape(1, 256, 3)
    np.testing.assert_array_equal(ip.bgr2lab_u8(gray), cv2.cvtColor(gray, cv2.COLOR_BGR2Lab))


# ---------------------------------------------------------------- CLAHE


@pytest.mark.parametrize("size", [(368, 368), (480, 640), (333, 517), (97, 131), (1, 50),
                                  (50, 1), (1, 1), (8, 24), (17, 16), (16, 17), (3, 5)])
@pytest.mark.parametrize("kind", C.CLAHE_KINDS)
def test_clahe_against_cv2(size, kind):
    img = C.clahe_image(*size, kind, seed=3)
    for clip in (0.0, 1.0, 2.5, 4.0, 40.0):
        for tiles in (1, 2, 8, 16):
            np.testing.assert_array_equal(ip.clahe_u8(img, clip, tiles),
                                          cv2.createCLAHE(clip, (tiles, tiles)).apply(img),
                                          err_msg=f"clip {clip}, {tiles} tiles")


def test_clahe_residual_zero():
    """A clipped count that is a multiple of 256 leaves no residual."""
    img = np.zeros((16, 16), np.uint8)
    img[:, :8] = 1  # one tile of 256 pixels, 128 of each of two values
    # clip 4.0 on 256 pixels: limit 4, 2 * (128 - 4) = 248 clipped; 6.0: limit 6, 244
    for clip in (4.0, 6.0, 0.5):
        np.testing.assert_array_equal(ip.clahe_u8(img, clip, 1),
                                      cv2.createCLAHE(clip, (1, 1)).apply(img))
    img = np.tile(np.arange(256, dtype=np.uint8), (2, 1))  # 2 of each: 256 clipped at limit 1
    np.testing.assert_array_equal(ip.clahe_u8(img, 1.0, 1), cv2.createCLAHE(1.0, (1, 1)).apply(img))


# ------------------------------------------------------------- cv2.line


def _both_lines(shape, p0, p1, t, seed=0):
    rs = np.random.RandomState(seed)
    ref = rs.randint(0, 256, shape).astype(np.uint8)
    got = ref.copy()
    color = tuple(int(c) for c in rs.randint(0, 256, 3))
    cv2.line(ref, p0, p1, color, t)
    assert ip.line_u8(got, p0, p1, color, t) is got
    return got, ref


@pytest.mark.parametrize("thickness", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", [(41, 57, 3), (30, 22)])
def test_line_octants_and_edges(shape, thickness):
    h, w = shape[:2]
    cx, cy = w // 2, h // 2
    segments = []
    for r in (1, 3, 17, 40):
        for k in range(24):  # every octant and the lines between
            a = 2 * np.pi * k / 24
            segments.append(((cx, cy), (cx + int(round(r * np.cos(a))), cy + int(round(r * np.sin(a))))))
    segments += [((2, cy), (w - 3, cy)), ((cx, 1), (cx, h - 2)), ((1, 1), (18, 18)),
                 ((18, 1), (1, 18)), ((cx, cy), (cx, cy)), ((0, 0), (0, 0)),
                 ((w - 1, h - 1), (w - 1, h - 1))]
    for i, (p0, p1) in enumerate(segments):
        got, ref = _both_lines(shape, p0, p1, thickness, seed=i)
        np.testing.assert_array_equal(got, ref, err_msg=f"{p0} -> {p1}")


@pytest.mark.parametrize("thickness", [1, 2, 3, 4, 5, 9])
def test_line_off_canvas(thickness):
    """Endpoints beyond every side, lines that only their thickness brings
    in, and lines wholly outside."""
    h, w = 35, 47
    segments = [((-20, 10), (60, 20)), ((10, -30), (25, 70)), ((-15, -15), (70, 50)),
                ((60, -8), (-9, 45)), ((-2, 5), (-2, 30)), ((w + 1, 5), (w + 1, 30)),
                ((5, -2), (40, -2)), ((5, h + 1), (40, h + 1)), ((-50, -50), (-10, -60)),
                ((-1000, 17), (1000, 19)), ((23, -1000), (21, 1000)), ((-500, -400), (600, 500)),
                ((w + 3, h + 3), (w + 3, h + 3)), ((-2, -2), (-2, -2))]
    for i, (p0, p1) in enumerate(segments):
        for shape in ((h, w, 3), (h, w)):
            got, ref = _both_lines(shape, p0, p1, thickness, seed=i)
            np.testing.assert_array_equal(got, ref, err_msg=f"{p0} -> {p1}, {shape}")


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 70), w=st.integers(1, 70), t=st.integers(1, 12),
       pts=st.lists(st.integers(-120, 190), min_size=4, max_size=4), seed=st.integers(0, 9))
def test_line_random_segments(h, w, t, pts, seed):
    got, ref = _both_lines((h, w, 3), (pts[0], pts[1]), (pts[2], pts[3]), t, seed)
    np.testing.assert_array_equal(got, ref)


def test_line_colour_saturates():
    """A Scalar's channels round and saturate to u8; a 1-channel image
    takes the first."""
    for color in ((300, -5, 127.6), (12,), 200.4):
        ref = np.zeros((9, 9, 3), np.uint8)
        got = ref.copy()
        cv2.line(ref, (1, 1), (7, 6), color, 2)
        ip.line_u8(got, (1, 1), (7, 6), color, 2)
        np.testing.assert_array_equal(got, ref)
        ref, got = ref[..., 0].copy() * 0, got[..., 0].copy() * 0
        cv2.line(ref, (1, 1), (7, 6), color, 1)
        ip.line_u8(got, (1, 1), (7, 6), color, 1)
        np.testing.assert_array_equal(got, ref)


# -------------------------------------------------------- INTER_LINEAR


@pytest.mark.parametrize("src", [(1, 1), (1, 9), (9, 1), (2, 3), (7, 16), (17, 31),
                                 (97, 131), (256, 256)])
@pytest.mark.parametrize("cn", [0, 1, 3])
def test_resize_linear_against_cv2(src, cn):
    h, w = src
    rs = np.random.RandomState(h * 100 + w)
    img = rs.randint(0, 256, (h, w, max(cn, 1))).astype(np.uint8)
    if cn == 0:
        img = img[..., 0]
    outs = [(2 * h, 2 * w), (max(h // 2, 1), max(w // 2, 1)), (h, 3 * w), (3 * h, w),
            (max(2 * h // 3, 1), 2 * w), (h + 1, max(w - 1, 1)), (1, 1), (227, 227), (5, 9)]
    for oh, ow in outs:
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        got = ip.resize_linear_u8(img, oh, ow)
        assert got.shape == (oh, ow) + img.shape[2:]
        np.testing.assert_array_equal(got, ref.reshape(got.shape), err_msg=f"-> {oh}x{ow}")


def test_resize_linear_halving_is_area():
    """An exact halving of both axes is INTER_AREA's 2x2 average in cv2;
    one axis halved alone stays linear."""
    img = np.random.RandomState(0).randint(0, 256, (30, 44, 3)).astype(np.uint8)
    for oh, ow in ((15, 22), (15, 44), (30, 22)):
        np.testing.assert_array_equal(ip.resize_linear_u8(img, oh, ow),
                                      cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR))
    np.testing.assert_array_equal(ip.resize_linear_u8(img, 15, 22),
                                  cv2.resize(img, (22, 15), interpolation=cv2.INTER_AREA))


# -------------------------------------------------------------- refusals


@pytest.mark.parametrize("call,match", [
    (lambda: ip.bgr2lab_u8(np.zeros((4, 4, 3), np.float32)), "u8"),
    (lambda: ip.bgr2lab_u8(np.zeros((4, 4), np.uint8)), r"\(H, W, 3\)"),
    (lambda: ip.lab2bgr_u8(np.zeros((4, 4, 4), np.uint8)), r"\(H, W, 3\)"),
    (lambda: ip.clahe_u8(np.zeros((4, 4, 1), np.uint8), 4.0, 8), r"\(H, W\)"),
    (lambda: ip.clahe_u8(np.zeros((4, 4), np.uint16), 4.0, 8), "uint16"),
    (lambda: ip.clahe_u8(np.zeros((4, 4), np.uint8), 4.0, 0), "tile"),
    (lambda: ip.line_u8(np.zeros((4, 4, 2), np.uint8), (0, 0), (3, 3), 255, 1), r"\(H, W, 3\)"),
    (lambda: ip.line_u8(np.zeros((4, 4), np.int32), (0, 0), (3, 3), 255, 1), "int32"),
    (lambda: ip.line_u8(np.zeros((4, 4), np.uint8), (0, 0), (3, 3), 255, 0), "thickness"),
    (lambda: ip.resize_linear_u8(np.zeros((4, 4), np.float64), 2, 2), "float64"),
    (lambda: ip.resize_linear_u8(np.zeros((4, 4), np.uint8), 0, 2), "positive"),
])
def test_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call()
