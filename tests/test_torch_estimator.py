"""The port's PoseEstimator end to end against the JAX PoseEstimator on the
CPU, on the same weights and inputs (128x80, a 2-stage deploy net).

Weights are drawn with numpy at fan-in scale into the JAX net and handed to
the port through ``params_from_jax``: at that scale activations are O(1),
so f32 summation-order differences stay far below the tolerances (the JAX
nets' own 0.01-std fillers shrink activations to ~1e-13, where the centroid
refinement loses relative precision on both sides).

Tolerances after ``unpack``: peak counts exact; refined x/y/score within
1e-4 abs (NaN where the reference divides 0/0, on both sides); pair counts
exact; pair scores within one f16 ulp (both are rounded to f16 from f32
sums taken in different orders) plus 1e-5 absolute, the f32 error of a
10-sample sum of O(1) dots, which is what remains where that sum cancels to
near zero (seen: 4e-6 on a score of -2e-3); assembled ``num_people`` exact.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
from caffe_rtpose_tpu_torch.core.net import params_from_jax
from caffe_rtpose_tpu_torch.ops import nms_cuda
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pose_seed7_128x80.json")
RES = (128, 80)
THR = dict(nms_threshold=-1.0, inter_threshold=-10.0)


@pytest.fixture(autouse=True)
def _torch_native_cpu_conv():
    """oneDNN's f32 convolutions sum in another order than XLA's, and the
    difference grows through the CNN to ~3e-6 relative at the low-res maps
    (>1e-4 px in a few refined coordinates); torch's own CPU convolution
    stays closer to XLA's (see test_torch_net.py's golden)."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def _fan_in_weights(jest, seed):
    rs = np.random.RandomState(seed)
    for name in sorted(jest.net.params):
        w, b = (np.asarray(p) for p in jest.net.params[name])
        kh, kw, cin, _ = w.shape
        jest.net.params[name] = [
            jnp.asarray(rs.randn(*w.shape).astype(np.float32) * np.sqrt(2.0 / (kh * kw * cin))),
            jnp.asarray(rs.randn(*b.shape).astype(np.float32) * 0.05)]
    return params_from_jax(jest.net.params)


def _relaxed(est):
    return dataclasses.replace(est.params_connect, min_subset_score=-10.0, min_subset_cnt=0,
                               inter_threshold=THR["inter_threshold"])


def _assert_outputs_match(got, ref, cap=None):
    (pt, st, ct), (pj, sj, cj) = got, ref
    m = pt.shape[1] - 1
    if cap is not None:  # the capped pass: first `cap` rows, raw counts in slot 0
        pj, sj, cj = pj[:, : cap + 1], sj[:, :cap, :cap], cj[:, :cap, :cap]
    np.testing.assert_array_equal(pt[:, 0, 0], pj[:, 0, 0])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)  # NaNs compare equal
    np.testing.assert_array_equal(ct, cj)
    ulp = np.spacing(np.maximum(np.abs(st), np.abs(sj)).astype(np.float16)).astype(np.float32)
    assert (np.abs(st - sj) <= ulp + 1e-5).all(), "pair scores differ by more than one f16 ulp"
    assert st.shape == (ct.shape[0], m, m)


@pytest.fixture(scope="module")
def coco():
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=RES, input_u8=True)
    weights = _fan_in_weights(jest, 0)
    rs = np.random.RandomState(1)
    x = (rs.rand(1, RES[1], RES[0], 3) * 255).astype(np.uint8)
    x[:, :, :8] = 0  # a dark band, as letterboxing gives
    ref = jest.fetch(jest.run_device(x, **THR))
    res = jest.estimate_from_net_input(x, nms_threshold=THR["nms_threshold"],
                                       params_connect=_relaxed(jest))
    return weights, x, ref, res.num_people


@pytest.mark.parametrize("pair_cap", [None, 32, 8])
def test_coco_u8_matches_jax(coco, pair_cap):
    weights, x, ref, people = coco
    est = PoseEstimator(make_pose_deploy_net("COCO", stages=2), weights=weights,
                        net_resolution=RES, input_u8=True, pair_cap=pair_cap, device="cpu")
    assert est.input_shape() == x.shape[:0] + (1, RES[1], RES[0], 3)
    got = est.fetch(est.run_device(x, **THR))
    cap = pair_cap if pair_cap and pair_cap < est.max_peaks else None
    _assert_outputs_match(got, ref, cap)
    counts = ref[0][:, 0, 0]
    assert counts.sum() > 0 and counts.max() > 8
    assert est.overflowed(got[0]) == (cap is not None and counts.max() > cap)
    res = est.estimate_from_net_input(x, nms_threshold=THR["nms_threshold"],
                                      params_connect=_relaxed(est))
    assert res.num_people == people > 0
    if pair_cap == 8:  # the uncapped refetch reproduces the uncapped pass
        _assert_outputs_match(est.refetch_full(x, **THR), ref)


def test_mpi_three_scales_f32_matches_jax():
    start, gap = 0.9, 0.1
    jest = JEstimator(j_make_net("MPI", stages=2), net_resolution=RES, num_scales=3,
                      start_scale=start, scale_gap=gap)
    weights = _fan_in_weights(jest, 2)
    est = PoseEstimator(make_pose_deploy_net("MPI", stages=2), weights=weights,
                        net_resolution=RES, num_scales=3, start_scale=start,
                        scale_gap=gap, device="cpu")
    assert est.num_parts == 15 and est.descriptor.name == "MPI_15"
    rs = np.random.RandomState(3)
    x = rs.rand(3, 3, RES[1], RES[0]).astype(np.float32) - 0.5
    ref = jest.fetch(jest.run_device(x, **THR))
    got = est.fetch(est.run_device(x, **THR))
    _assert_outputs_match(got, ref)
    assert ref[0][:, 0, 0].sum() > 0
    pc_j, pc_t = _relaxed(jest), _relaxed(est)
    r_j = jest.estimate_from_net_input(x, nms_threshold=-1.0, params_connect=pc_j)
    r_t = est.estimate_from_net_input(x, nms_threshold=-1.0, params_connect=pc_t)
    assert r_t.num_people == r_j.num_people > 0


def test_pose_golden_seed7():
    """tests/golden/pose_seed7_128x80.json (made with the reference deploy
    prototxt) with the JAX net's seed-7 weights from make_pose_deploy_net,
    whose fillers reproduce it."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    jnet = JNet(j_make_net(), phase="TEST", input_shapes={"image": (1, 3, RES[1], RES[0])}, seed=7)
    est = PoseEstimator(make_pose_deploy_net(), weights=params_from_jax(jnet.params),
                        net_resolution=RES, input_u8=True, device="cpu")
    rs = np.random.RandomState(11)
    x = (rs.rand(1, RES[1], RES[0], 3) * 255).astype(np.uint8)
    peaks, ps, cnt = est.fetch(est.run_device(x, **THR))
    pc = dataclasses.replace(est.params_connect, min_subset_score=-10.0, min_subset_cnt=0)
    from caffe_rtpose_tpu_torch.pose import connect as C

    res = C.assemble_fast(peaks, ps, cnt, est.descriptor, pc, scale_xy=(1.0, 1.0))
    np.testing.assert_array_equal(peaks[:, 0, 0].astype(int), golden["peaks_counts"])
    np.testing.assert_allclose(peaks[:, 1:4], np.asarray(golden["peaks_head"]), atol=2e-3)
    assert res.num_people == golden["num_people"]
    np.testing.assert_allclose(res.joints, np.asarray(golden["joints"]), atol=5e-3)


def test_refuses_options_outside_the_slice():
    """What is still not ported raises NotImplementedError; what JAX refuses
    (the heatmap branch batched, a wrong input) raises ValueError, as there."""
    proto = make_pose_deploy_net("COCO", stages=1)
    for kw in (dict(device_rescale=True), dict(warm_overflow=True), dict(dtype=torch.float16)):
        with pytest.raises(NotImplementedError):
            PoseEstimator(proto, net_resolution=RES, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        PoseEstimator("pose_deploy_linevec.prototxt", net_resolution=RES, device="cpu")
    with pytest.raises(NotImplementedError):
        PoseEstimator(proto, weights="pose_iter_440000.caffemodel", net_resolution=RES,
                      device="cpu")
    for kw in (dict(keep_heatmap=True, batch=2), dict(batch=0)):
        with pytest.raises(ValueError):
            PoseEstimator(proto, net_resolution=RES, device="cpu", **kw)
    est = PoseEstimator(proto, net_resolution=RES, input_u8=True, device="cpu")
    with pytest.raises(ValueError):
        est.run_device(np.zeros((1, 3, RES[1], RES[0]), np.float32))
    batched = PoseEstimator(proto, net_resolution=RES, input_u8=True, batch=2, device="cpu")
    with pytest.raises(ValueError):  # one frame where the pass takes a batch
        batched.run_device(np.zeros((1, RES[1], RES[0], 3), np.uint8))
    out = batched.run_device(np.zeros((2, 1, RES[1], RES[0], 3), np.uint8))
    with pytest.raises(ValueError):  # batched rows go through fetch_batch
        batched.fetch(out)


@pytest.mark.parametrize("net,scales,start,gap", [("COCO", 1, 1.0, 0.3), ("MPI", 3, 0.9, 0.1)])
def test_keep_heatmap_matches_jax_and_packed_branch(net, scales, start, gap):
    """The heatmap branch (full-res upsample of every channel + keys, NMS
    and pair scoring on the full-res maps) against JAX's: peak counts and
    pair counts exact, peaks within 1e-4, the heatmap within
    1e-5 * max(1, |h|) (the CNNs sum in other orders).  Pair scores within
    1e-4 + 1e-4 * |s| over the real peaks: the refined peaks differ by a few
    f32 ulps of coordinates ~100 px (seen: 5e-5 px), which turns a short
    limb's unit vector enough to move its 10-dot sum by ~1e-4 relative
    (seen: 1.6e-4 on a score of -3.07); the padding slots past a part's
    count hold (0, 0) peaks that the assembly never reads, and their
    samples fall on rounding ties (seen: 1e-6 from a .5 boundary).  Then against
    the port's own packed branch on the same frame, with the tolerances of
    tests/test_optimized_path.py for the JAX package's two branches: peaks
    within 1e-3 and, over the real peaks, pair scores within 5e-3 (the
    packed branch stores them as f16) and pair counts equal."""
    cfg = dict(net_resolution=RES, num_scales=scales, start_scale=start, scale_gap=gap)
    jest = JEstimator(j_make_net(net, stages=2), keep_heatmap=True, **cfg)
    weights = _fan_in_weights(jest, 4)
    proto = make_pose_deploy_net(net, stages=2)
    est = PoseEstimator(proto, weights=weights, keep_heatmap=True, input_u8=True,
                        pair_cap=8, device="cpu", **cfg)
    assert not est.input_u8 and est.input_shape() == (scales, 3, RES[1], RES[0])
    rs = np.random.RandomState(5)
    x = rs.rand(scales, 3, RES[1], RES[0]).astype(np.float32) - 0.5

    out_j = jest.run_device(x, **THR)
    before = nms_cuda.upsample_launches
    out_t = est.run_device(x, **THR)
    assert nms_cuda.upsample_launches == before  # the CPU runs the plain version
    assert set(out_t) == {"peaks", "pair_score", "pair_count", "heatmap"}
    (pt, st, ct), (pj, sj, cj) = est.fetch(out_t), jest.fetch(out_j)
    assert pt.shape == (est.num_parts, est.max_peaks + 1, 3)  # pair_cap has no effect
    np.testing.assert_array_equal(pt[:, 0, 0], pj[:, 0, 0])
    assert pt[:, 0, 0].sum() > 0 and not est.overflowed(pt)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ct, cj)
    real = _real_pairs(est.descriptor, pt)
    np.testing.assert_allclose(st[real], sj[real], rtol=1e-4, atol=1e-4)
    hj, ht = np.asarray(out_j["heatmap"]), out_t["heatmap"].numpy()
    assert ht.shape == hj.shape == (57 if net == "COCO" else 44, RES[1], RES[0])
    assert (np.abs(ht - hj) <= 1e-5 * np.maximum(1.0, np.abs(hj))).all()

    r_j = jest.estimate_from_net_input(x, nms_threshold=-1.0, params_connect=_relaxed(jest))
    r_t = est.estimate_from_net_input(x, nms_threshold=-1.0, params_connect=_relaxed(est))
    assert r_t.num_people == r_j.num_people > 0
    np.testing.assert_array_equal(r_t.heatmap, ht)

    packed = PoseEstimator(proto, weights=weights, device="cpu", **cfg)
    p1, s1, c1 = packed.fetch(packed.run_device(x, **THR))
    np.testing.assert_allclose(p1, pt, rtol=0, atol=1e-3)
    np.testing.assert_allclose(s1[real], st[real], rtol=5e-3, atol=5e-3)
    np.testing.assert_array_equal(c1[real], ct[real])


def _real_pairs(desc, peaks):
    """(L, M, M) bool: the pairs of real peaks ([:na, :nb] of each limb)."""
    m = peaks.shape[1] - 1
    n = np.minimum(peaks[:, 0, 0].astype(int), m)
    out = np.zeros((desc.num_limbs, m, m), bool)
    for k in range(desc.num_limbs):
        a, b = desc.limb(k)
        out[k, : n[a], : n[b]] = True
    return out
