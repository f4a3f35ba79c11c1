"""The port's OpenCV-free preprocess (pose/preprocess.py) against the JAX
package's, which calls OpenCV (cv2 5.0 here), on the same frames.

* ``INTER_AREA`` (every ``make_net_input*``, ``preprocess_frame`` without a
  warp): bit-identical, in all three of OpenCV's code paths (the
  integer-ratio block average and the box-overlap path for downscales, the
  fixed-point linear resize with area coefficients where an axis grows).
* The ``INTER_CUBIC`` display warp: OpenCV 5.0 computes it from exact
  coordinates with f32 weights (not OpenCV 4's 5-bit fixed-point phases),
  and the port lands within one u8 level of it.  Bit-identical where the
  phases are exact (1920x1080 -> 1280x720: offsets 0 and 1/2 only);
  elsewhere at most WARP_ONE_LEVEL_SHARE of the pixels are one level off
  (measured: 0.02-0.3 % on these uniform-noise frames, the worst case for
  rounding) and none more.
"""

import sys

import numpy as np
import pytest

from caffe_rtpose_tpu.pose import preprocess as JP
from caffe_rtpose_tpu_torch.pose import preprocess as TP

cv2 = pytest.importorskip("cv2")

WARP_ONE_LEVEL_SHARE = 0.01


def _frame(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def test_imports_no_cv2():
    assert "cv2" not in vars(TP)
    src = open(TP.__file__).read()
    assert "import cv2" not in src


@pytest.mark.parametrize("src_wh,dst_wh", [
    ((1280, 720), (656, 368)),   # the realtime default, box-overlap path
    ((1280, 720), (464, 272)),   # scale 0.7
    ((1280, 720), (272, 160)),   # scale 0.4
    ((1312, 736), (656, 368)),   # exact 2x: the block average rounded half up
    ((1968, 1104), (656, 368)),  # exact 3x
    ((96, 64), (48, 64)),        # 2x on one axis only
    ((333, 211), (128, 80)),     # odd sizes
    ((101, 77), (64, 48)),
    ((97, 61), (97, 30)),
])
def test_inter_area_bit_identical(src_wh, dst_wh):
    img = _frame(src_wh[1], src_wh[0], sum(src_wh))
    ref = cv2.resize(img, dst_wh, interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(TP.resize_area(img, *dst_wh), ref)


def test_inter_area_upscale_is_refused():
    """Once refused with NotImplementedError; the upscale is ported now, and
    this mixed case (width grows, height shrinks) equals OpenCV."""
    img = _frame(40, 60, 0)
    np.testing.assert_array_equal(TP.resize_area(img, 64, 30),
                                  cv2.resize(img, (64, 30), interpolation=cv2.INTER_AREA))


def _upscale_cases(n=36, seed=0):
    """Seeded (src_hw, dst_wh, channels): both axes up, and one up and one
    down, in 1 and 3 channels."""
    rs = np.random.RandomState(seed)
    cases = []
    for i in range(n):
        sh, sw = (int(v) for v in rs.randint(1, 90, 2))
        grow = [int(v) for v in rs.randint(1, 200, 2)]
        dh, dw = sh + grow[0], sw + grow[1]
        if i % 3 == 1:
            dh = max(1, sh - grow[0] % sh) if sh > 1 else 1
        elif i % 3 == 2:
            dw = max(1, sw - grow[1] % sw) if sw > 1 else 1
        cases.append(((sh, sw), (dw, dh), 1 if i % 2 else 3))
    return cases


@pytest.mark.parametrize("src_hw,dst_wh,cn", _upscale_cases() + [
    ((368, 656), (1280, 720), 3),  # a net-sized frame to a display
    ((240, 320), (656, 368), 3),   # a small frame into the net region
    ((2, 3), (7, 11), 1),
    ((1, 1), (5, 4), 3),
])
def test_inter_area_upscale_bit_identical(src_hw, dst_wh, cn):
    img = _frame(*src_hw, sum(src_hw) + cn)
    if cn == 1:
        img = np.ascontiguousarray(img[..., 0])
    ref = cv2.resize(img, dst_wh, interpolation=cv2.INTER_AREA)
    got = TP.resize_area(img, *dst_wh)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scales", [1, 3])
def test_net_inputs_of_a_small_frame_bit_identical(scales):
    """A frame smaller than the net region, as a small COCO val image in an
    eval run: every scale is an INTER_AREA upscale."""
    img = _frame(150, 212, 17)
    args = (656, 368, scales, 1.0, 0.3)
    np.testing.assert_array_equal(TP.make_net_input_u8(img, *args), JP.make_net_input_u8(img, *args))
    np.testing.assert_array_equal(TP.make_net_input_u8_packed(img, *args),
                                  JP.make_net_input_u8_packed(img, *args))


@pytest.mark.parametrize("src_wh,disp_wh,exact", [
    ((1920, 1080), (1280, 720), True),
    ((333, 211), (256, 160), False),  # odd size, downscale
    ((97, 61), (128, 80), False),     # odd size, upscale
    ((640, 480), (1280, 720), False),  # letterboxed: black border right
])
def test_warp_within_one_level(src_wh, disp_wh, exact):
    img = _frame(src_wh[1], src_wh[0], 7)
    got, s = TP.warp_to_display(img, *disp_wh)
    ref, s_ref = JP.warp_to_display(img, *disp_wh)
    assert s == s_ref and got.shape == ref.shape == (disp_wh[1], disp_wh[0], 3)
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= (0 if exact else 1)
    assert (diff > 0).any(axis=2).mean() <= WARP_ONE_LEVEL_SHARE


def test_identity_warp_returns_the_frame():
    img = _frame(80, 128, 3)
    got, s = TP.warp_to_display(img, 128, 80)
    assert s == 1.0 and got is img


@pytest.mark.parametrize("scales,start,gap", [(1, 1.0, 0.3), (3, 1.0, 0.3), (3, 0.9, 0.1)])
def test_net_inputs_bit_identical(scales, start, gap):
    img = _frame(720, 1280, 11)
    args = (656, 368, scales, start, gap)
    np.testing.assert_array_equal(TP.make_net_input(img, *args), JP.make_net_input(img, *args))
    np.testing.assert_array_equal(TP.make_net_input_u8(img, *args), JP.make_net_input_u8(img, *args))
    np.testing.assert_array_equal(TP.make_net_input_u8_packed(img, *args),
                                  JP.make_net_input_u8_packed(img, *args))
    np.testing.assert_array_equal(TP.make_net_input_u8_base(img, 656, 368, start),
                                  JP.make_net_input_u8_base(img, 656, 368, start))


@pytest.mark.parametrize("u8", [False, True, "packed", "base"])
@pytest.mark.parametrize("frame_hw,disp", [((360, 640), None), ((1080, 1920), (1280, 720))])
def test_preprocess_frame_modes(u8, frame_hw, disp):
    img = _frame(*frame_hw, 13)
    kw = dict(disp_w=disp[0], disp_h=disp[1]) if disp else {}
    got = TP.preprocess_frame(img, 128, 80, num_scales=3, u8=u8, **kw)
    ref = JP.preprocess_frame(img, 128, 80, num_scales=3, u8=u8, **kw)
    np.testing.assert_array_equal(got.net_input, ref.net_input)
    np.testing.assert_array_equal(got.display, ref.display)
    assert (got.scale, got.ori_width, got.ori_height) == (ref.scale, ref.ori_width, ref.ori_height)


@pytest.mark.parametrize("dst,src", [(272, 368), (160, 368), (7, 13)])
def test_area_axis_matrix_is_a_copy(dst, src):
    np.testing.assert_array_equal(TP.area_axis_matrix(dst, src), JP.area_axis_matrix(dst, src))


def test_preprocess_runs_with_cv2_blocked():
    """The module works where no cv2 can be imported (the card's machine)."""
    import subprocess

    code = ("import sys; sys.modules['cv2'] = None\n"
            "import numpy as np\n"
            "from caffe_rtpose_tpu_torch.pose import preprocess as P\n"
            "img = (np.random.RandomState(0).rand(90, 120, 3) * 255).astype(np.uint8)\n"
            "pf = P.preprocess_frame(img, 64, 48, 160, 96, num_scales=2, u8='packed')\n"
            "print(pf.net_input.shape, pf.display.shape)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
