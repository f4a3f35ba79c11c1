"""The port's PoseEstimator with ``batch > 1`` (``fetch_batch``) and with
``pack_u8`` (the packed live-region upload), against the port's own
single-frame and whole-canvas passes and against the JAX PoseEstimator, on
the CPU at 128x80 with a 2-stage COCO deploy net.

Tolerances: a batched pass and single-frame passes, and the packed and the
canvas uploads, run the same arithmetic on the same canvases, so their
packed output rows are compared for equality, bit for bit.  Against JAX,
the f32 tolerances of tests/test_torch_estimator.py (peak and pair counts
exact, peaks within 1e-4, pair scores within one f16 ulp + 1e-5), with
1e-5 relative on the peaks besides: the two f32 CNNs sum in other orders,
which moves refined coordinates ~70 px from the origin by ~3e-6 relative
(seen: 2.2e-4 px at 3 scales on resized frames).  The same shifts put one
of a pair's 10 line samples on the other side of a pixel's rounding
boundary now and then, which moves that pair's score by a tenth of a dot
difference: at most one pair in 10^4 may differ by more than the f16 ulp,
and then by no more than 0.05 (seen: one of 77824 pairs, by 0.0098).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.pose import preprocess as j_pre
from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
from caffe_rtpose_tpu_torch.core.net import params_from_jax
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.pose import preprocess
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

RES = (128, 80)
THR = dict(nms_threshold=-1.0, inter_threshold=-10.0)
SCALES = dict(num_scales=3, start_scale=1.0, scale_gap=0.3)
TOL_ONE_SAMPLE = 0.05


@pytest.fixture(autouse=True, scope="module")
def _torch_native_cpu_conv():
    """As tests/test_torch_estimator.py: torch's own CPU convolution."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def _fan_in(jest, seed):
    rs = np.random.RandomState(seed)
    for name in sorted(jest.net.params):
        w, b = (np.asarray(p) for p in jest.net.params[name])
        kh, kw, cin, _ = w.shape
        jest.net.params[name] = [
            jnp.asarray(rs.randn(*w.shape).astype(np.float32) * np.sqrt(2.0 / (kh * kw * cin))),
            jnp.asarray(rs.randn(*b.shape).astype(np.float32) * 0.05)]
    return params_from_jax(jest.net.params)


def _frames(n, seed):
    """Display-size BGR frames (96x150, so every scale resizes)."""
    rs = np.random.RandomState(seed)
    return [(rs.rand(96, 150, 3) * 255).astype(np.uint8) for _ in range(n)]


def _assert_outputs_match(got, ref):
    (pt, st, ct), (pj, sj, cj) = got, ref
    np.testing.assert_array_equal(pt[:, 0, 0], pj[:, 0, 0])
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(ct, cj)
    ulp = np.spacing(np.maximum(np.abs(st), np.abs(sj)).astype(np.float16)).astype(np.float32)
    bad = np.abs(st - sj) > ulp + 1e-5
    assert bad.sum() <= bad.size // 10000 and (np.abs(st - sj) <= TOL_ONE_SAMPLE).all()


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw,packs", [
    (dict(input_u8=True, num_scales=3), True),
    (dict(input_u8=True, num_scales=1), False),
    (dict(num_scales=3), False),
    (dict(input_u8=True, num_scales=3, keep_heatmap=True), False),
    (dict(input_u8=True, num_scales=3, pack_u8=False), False),
    (dict(input_u8=True, num_scales=1, pack_u8=True), True),
], ids=["u8-3", "u8-1", "f32-3", "heatmap", "off", "on-1"])
def test_pack_u8_default_follows_jax(kw, packs):
    est = PoseEstimator(make_pose_deploy_net("COCO", stages=1), net_resolution=RES,
                        device="cpu", **kw)
    jest = JEstimator(j_make_net("COCO", stages=1), net_resolution=RES, **kw)
    assert est.pack_u8 == jest.pack_u8 == packs
    assert est.input_shape() == jest.input_shape()
    assert est.input_dtype == jest.input_dtype


def test_packed_format_matches_jax():
    for args in ((*RES, 3, 1.0, 0.3), (*RES, 1, 1.0, 0.3), (656, 368, 4, 1.0, 0.25)):
        assert preprocess.packed_regions(*args) == j_pre.packed_regions(*args)
    img = _frames(1, 0)[0]
    packed = preprocess.make_net_input_u8_packed(img, *RES, 3, 1.0, 0.3)
    np.testing.assert_array_equal(packed, j_pre.make_net_input_u8_packed(img, *RES, 3, 1.0, 0.3))
    canv = preprocess.make_net_input_u8(img, *RES, 3, 1.0, 0.3)
    regs, total = preprocess.packed_regions(*RES, 3, 1.0, 0.3)
    assert packed.shape == (total,) and total < canv.size
    for i, (rh, rw, ph, pw, off) in enumerate(regs):  # the live regions, nothing else
        np.testing.assert_array_equal(packed[off : off + rh * rw * 3].reshape(rh, rw, 3),
                                      canv[i, ph : ph + rh, pw : pw + rw])


@pytest.fixture(scope="module")
def weights3():
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=RES, input_u8=True, **SCALES)
    return jest, _fan_in(jest, 6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pack_u8_is_bit_identical_to_the_canvas_upload(weights3, dtype):
    jest, weights = weights3
    proto = make_pose_deploy_net("COCO", stages=2)
    cfg = dict(net_resolution=RES, input_u8=True, weights=weights, dtype=dtype, device="cpu",
               **SCALES)
    packed, canvas = PoseEstimator(proto, **cfg), PoseEstimator(proto, pack_u8=False, **cfg)
    assert packed.pack_u8 and not canvas.pack_u8
    for img in _frames(2, 1):
        xp, xc = packed.make_input(img), canvas.make_input(img)
        assert xp.shape == packed.input_shape() and xc.shape == canvas.input_shape()
        cp = packed._canvases(torch.from_numpy(xp)[None])
        cc = canvas._canvases(torch.from_numpy(xc)[None])
        assert cp.dtype == cc.dtype == dtype and torch.equal(cp, cc)
        rp, rc = packed.run_device(xp, **THR)["packed"], canvas.run_device(xc, **THR)["packed"]
        assert torch.equal(rp, rc)
        if dtype == torch.float32:  # and JAX's packed pass, which is its default here
            assert jest.pack_u8 and jest.input_shape() == xp.shape
            _assert_outputs_match(packed.unpack(rp.numpy()), jest.fetch(jest.run_device(xp, **THR)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batch_matches_single_frame_passes(weights3, dtype):
    _, weights = weights3
    proto = make_pose_deploy_net("COCO", stages=2)
    cfg = dict(net_resolution=RES, input_u8=True, weights=weights, dtype=dtype, device="cpu",
               pair_cap=8, **SCALES)
    single, batched = PoseEstimator(proto, **cfg), PoseEstimator(proto, batch=3, **cfg)
    xs = np.stack([single.make_input(img) for img in _frames(3, 2)])
    out = batched.run_device(xs, **THR)
    assert out["packed"].shape == (3, single.run_device(xs[0])["packed"].numel())
    rows = batched.fetch_batch(out)
    assert len(rows) == 3
    for x, got in zip(xs, rows):
        ref = single.fetch(single.run_device(x, **THR))
        _same(got, ref)
        assert got[0][:, 0, 0].sum() > 0
    # one frame padded to a full batch
    r_b = batched.estimate_from_net_input(xs[1], nms_threshold=THR["nms_threshold"])
    r_s = single.estimate_from_net_input(xs[1], nms_threshold=THR["nms_threshold"])
    np.testing.assert_array_equal(r_b.peaks, r_s.peaks)
    np.testing.assert_array_equal(r_b.joints, r_s.joints)
    assert r_b.num_people == r_s.num_people
    # a batch-1 pass through fetch_batch is a list of one
    _same(single.fetch_batch(single.run_device(xs[0], **THR))[0],
          single.fetch(single.run_device(xs[0], **THR)))


def test_batch_matches_jax_batch(weights3):
    jest1, weights = weights3
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=RES, input_u8=True,
                      batch=3, **SCALES)
    jest.net.params = dict(jest1.net.params)
    est = PoseEstimator(make_pose_deploy_net("COCO", stages=2), net_resolution=RES,
                        input_u8=True, batch=3, weights=weights, device="cpu", **SCALES)
    xs = np.stack([est.make_input(img) for img in _frames(3, 3)])
    got, ref = est.fetch_batch(est.run_device(xs, **THR)), jest.fetch_batch(jest.run_device(xs, **THR))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _assert_outputs_match(g, r)
