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

Those hold on one frame.  Over many frames the CNNs' f32 summation-order
noise shows through in places, and :func:`_assert_outputs_close` states
the rule for them: refined peaks within 1e-4 + ``RTOL_F32_CNN`` * |x| (the
centroid refinement turns the noise into up to ~2e-4 on a coordinate near
32), and pair scores compared only where both sides sample the same
pixels.  An f64 run of the CNN puts the reference's own f32 peaks as far
from the f64 ones (``test_refined_gap_to_jax_is_f32_noise_of_the_cnn``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
from caffe_rtpose_tpu_torch.core.net import params_from_jax
from caffe_rtpose_tpu_torch.ops import nms_cuda
from caffe_rtpose_tpu_torch.parallel.dryrun import real_pairs as _real_pairs
from caffe_rtpose_tpu_torch.parallel.dryrun import (
    sample_pixels_may_differ as _sample_pixels_may_differ)
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pose_seed7_128x80.json")
RES = (128, 80)
THR = dict(nms_threshold=-1.0, inter_threshold=-10.0)
# refined peaks over many frames: |port - jax| <= 1e-4 + RTOL_F32_CNN * |jax|
# (seen: 1.85e-4 on a coordinate near 32, 5.8e-6 relative)
RTOL_F32_CNN = 1e-5
WITNESS_SEEDS = range(8)


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


def _assert_outputs_close(got, ref, desc, cap=None):
    """The rule over many frames, for the CNN's f32 noise: peak counts and
    pair counts exact; refined peaks within 1e-4 + ``RTOL_F32_CNN`` * |x|;
    pair scores within one f16 ulp + 1e-4 + 1e-4 * |s| (a short limb's unit
    vector turns the peaks' noise into ~1e-4 of its sum, as in
    ``test_keep_heatmap_matches_jax_and_packed_branch``), except in the pairs
    where a sample may land on another pixel (:func:`_sample_pixels_may_differ`:
    the sums are then over other pixels), which must stay under 1 % of the
    pairs of real peaks."""
    (pt, st, ct), (pj, sj, cj) = got, ref
    if cap is not None:
        pj, sj, cj = pj[:, : cap + 1], sj[:, :cap, :cap], cj[:, :cap, :cap]
    np.testing.assert_array_equal(pt[:, 0, 0], pj[:, 0, 0])
    np.testing.assert_allclose(pt, pj, rtol=RTOL_F32_CNN, atol=1e-4)  # NaNs compare equal
    np.testing.assert_array_equal(ct, cj)
    moved = _sample_pixels_may_differ(pt, pj, desc)
    real = _real_pairs(desc, pt)
    assert moved[real].mean() < 0.01
    ulp = np.spacing(np.maximum(np.abs(st), np.abs(sj)).astype(np.float16)).astype(np.float32)
    close = np.abs(st - sj) <= ulp + 1e-4 + 1e-4 * np.abs(sj)
    assert (close | moved).all(), "pair scores differ where both sides sample the same pixels"


@pytest.fixture(scope="module")
def coco_jax():
    """The JAX COCO estimator at RES (u8 input) with the fan-in weights of
    seed 0, and those weights in the port's layout: built once for every
    test that compares with it."""
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=RES, input_u8=True)
    return jest, _fan_in_weights(jest, 0)


@pytest.fixture(scope="module")
def coco(coco_jax):
    jest, weights = coco_jax
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


def witness_frame(seed):
    """The estimator tests' frame of ``seed``: u8 noise with a dark band."""
    rs = np.random.RandomState(seed)
    x = (rs.rand(1, RES[1], RES[0], 3) * 255).astype(np.uint8)
    x[:, :, :8] = 0
    return x


def test_refined_gap_to_jax_is_f32_noise_of_the_cnn(coco_jax, monkeypatch):
    """Where the port's outputs differ from JAX's by more than
    :func:`_assert_outputs_match` allows, the CNNs' f32 sums are the cause,
    and neither side is the more exact.  On each frame, the port's and
    JAX's f32 low-res maps are each within 1e-5 of an f64 run of the same
    CNN (the port's net on f64 operands; seen: 2.0e-6 to 2.9e-6 on both
    sides), neither more than twice as far as the other, and the live
    outputs agree by :func:`_assert_outputs_close`.  ``-s`` prints each
    frame's distances of the refined peaks from those the port's post
    segment finds on the f64 map."""
    jest, weights = coco_jax
    est = PoseEstimator(make_pose_deploy_net("COCO", stages=2), weights=weights,
                        net_resolution=RES, input_u8=True, device="cpu")
    jnet, blob = jest.net, jest.lowres_blob
    impls = jnet.prune_for([blob])
    j_low = jax.jit(lambda p, x: jnet._apply(p, {"image": x}, jax.random.PRNGKey(0), None,
                                             False, impls=impls)[blob])
    mask = est._mask.numpy()
    thr = [torch.tensor(THR["nms_threshold"]), torch.tensor(THR["inter_threshold"])]
    ops64 = {k: v.double() for k, v in est.net.operands().items()}
    for seed in WITNESS_SEEDS:
        x = witness_frame(seed)
        low_j = np.asarray(j_low(jnet.params, (x.astype(np.float32) / 256.0 - 0.5) * mask))
        with torch.inference_mode():
            canvases = est._canvases(torch.from_numpy(x)[None])
            low_t = est._lowres(canvases, est.net.operands()).numpy().reshape(low_j.shape)
            with monkeypatch.context() as m:
                m.setattr(est.net, "dtype", torch.float64)
                low_64 = est.net({"image": canvases.double()}, outputs=[blob], layers=est._layers,
                                 operands=ops64)[blob].permute(0, 2, 3, 1)
            p64 = est.unpack(est._post(low_64.float()[None], *thr, est.eff_peaks)[0].numpy())[0]
        d_t, d_j = (float(np.abs(low - low_64.numpy()).max()) for low in (low_t, low_j))
        assert max(d_t, d_j) <= 1e-5 and max(d_t, d_j) <= 2 * min(d_t, d_j), (seed, d_t, d_j)
        ref = jest.fetch(jest.run_device(x, **THR))
        got = est.fetch(est.run_device(x, **THR))
        _assert_outputs_close(got, ref, est.descriptor)
        print(f"seed {seed}: low-res map vs f64: port {d_t:.3g}, jax {d_j:.3g}; refined peaks: "
              f"port-jax {np.nanmax(np.abs(got[0] - ref[0])):.3g}, "
              f"port-f64 {np.nanmax(np.abs(got[0] - p64)):.3g}, "
              f"jax-f64 {np.nanmax(np.abs(ref[0] - p64)):.3g}")


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
    (the heatmap branch batched, device_rescale without u8 input, a wrong
    input) raises ValueError, as there, and a missing model file
    FileNotFoundError; graphs need a CUDA device."""
    proto = make_pose_deploy_net("COCO", stages=1)
    with pytest.raises(NotImplementedError):
        PoseEstimator(proto, net_resolution=RES, device="cpu", dtype=torch.float16)
    for kw in (dict(device_rescale=True), dict(device_rescale=True, input_u8=True,
                                                keep_heatmap=True), dict(cuda_graph=True)):
        with pytest.raises(ValueError):
            PoseEstimator(proto, net_resolution=RES, device="cpu", **kw)
    # accepted: without graphs there is nothing to capture ahead
    assert PoseEstimator(proto, net_resolution=RES, input_u8=True, pair_cap=8,
                         warm_overflow=True, device="cpu")._warm_thread is None
    # model files are read as JAX reads them: a path that does not exist raises there
    with pytest.raises(FileNotFoundError):
        PoseEstimator("pose_deploy_linevec.prototxt", net_resolution=RES, device="cpu")
    with pytest.raises(FileNotFoundError):
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


def test_device_rescale_matches_jax(coco):
    """device_rescale: one uploaded live region, the smaller scales made on
    the device by the INTER_AREA matrices.  The canvases are einsums summed
    in other orders on the two sides (f32 rounding, ~1e-7 of a pixel), so
    the outputs are held to _assert_outputs_match's tolerances."""
    weights = coco[0]
    cfg = dict(net_resolution=RES, num_scales=3, start_scale=1.0, scale_gap=0.3, input_u8=True,
               device_rescale=True)
    jest = JEstimator(j_make_net("COCO", stages=2), **cfg)
    jest.net.params = {k: [jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b)]
                       for k, (w, b) in weights.items()}
    est = PoseEstimator(make_pose_deploy_net("COCO", stages=2), weights=weights, device="cpu",
                        **cfg)
    assert est.input_shape() == jest.input_shape() == (RES[0] * RES[1] * 3,)
    assert not est.pack_u8
    img = (np.random.RandomState(8).rand(120, 200, 3) * 255).astype(np.uint8)
    x = est.make_input(img)
    np.testing.assert_array_equal(x, jest.make_input(img))
    _assert_outputs_match(est.fetch(est.run_device(x, **THR)),
                          jest.fetch(jest.run_device(x, **THR)))


def test_estimate_matches_jax(coco_jax):
    """estimate(): preprocess (the display warp and INTER_AREA) -> device ->
    assembly, against JAX's estimate() on the same BGR frame."""
    jest, weights = coco_jax
    est = PoseEstimator(make_pose_deploy_net("COCO", stages=2), weights=weights,
                        net_resolution=RES, input_u8=True, device="cpu")
    frame = (np.random.RandomState(9).rand(180, 288, 3) * 255).astype(np.uint8)
    for disp in (None, (192, 120)):
        kw = dict(disp_w=disp[0], disp_h=disp[1]) if disp else {}
        r_t, pf_t = est.estimate(frame, nms_threshold=-1.0, params_connect=_relaxed(est), **kw)
        r_j, pf_j = jest.estimate(frame, nms_threshold=-1.0, params_connect=_relaxed(jest), **kw)
        np.testing.assert_array_equal(pf_t.net_input, pf_j.net_input)
        assert r_t.num_people == r_j.num_people > 0
        np.testing.assert_allclose(r_t.peaks, r_j.peaks, rtol=0, atol=1e-4)
        np.testing.assert_allclose(r_t.joints[..., :2], r_j.joints[..., :2], rtol=0, atol=1e-3)
        np.testing.assert_allclose(r_t.joints[..., 2], r_j.joints[..., 2], rtol=0, atol=1e-3)


def test_tensor_threshold_equals_float():
    """K1 and K3 (their plain versions on the CPU) take the threshold as a
    0-d f32 tensor, as a graph passes it, with the float's result; a tensor
    of another shape, type or device is refused."""
    rs = np.random.RandomState(12)
    low = torch.from_numpy(rs.rand(1, 10, 14, 5).astype(np.float32) * 2 - 1)
    args = (low, (80, 112), 1.0, 0.3)
    t = torch.tensor(0.3, dtype=torch.float32)
    assert torch.equal(nms_cuda.peak_mask_fused(*args, t), nms_cuda.peak_mask_fused(*args, 0.3))
    heat_t, keys_t = nms_cuda.upsample_peak_keys(*args, t, key_channels=3)
    heat_f, keys_f = nms_cuda.upsample_peak_keys(*args, 0.3, key_channels=3)
    assert torch.equal(heat_t, heat_f) and torch.equal(keys_t, keys_f) and int((keys_f > 0).sum())
    for bad in (torch.tensor([0.3]), torch.tensor(0.3, dtype=torch.float64)):
        with pytest.raises(ValueError):
            nms_cuda.threshold_scalar(bad, torch.device("cpu"))
    assert nms_cuda.threshold_scalar(t, torch.device("cpu")) is t



def _without_resize(proto, low):
    """A deploy graph whose Nms reads the low-res concat: no ImResize."""
    proto = dict(proto, layer=[dict(l) for l in proto["layer"] if l["name"] != "resize"])
    for l in proto["layer"]:
        if l["name"] == "nms":
            l["bottom"] = [low]
    return proto


def test_net_without_resize_matches_jax():
    """ROADMAP A.3: a deploy net without a ``resize`` layer runs the net's
    own Nms on the low-res maps and scores pairs there (JAX
    estimator.py:331-345), unpacked at batch 1; peaks and counts as
    ``_assert_outputs_match`` holds them, pair scores within 1e-4."""
    jest = JEstimator(_without_resize(j_make_net("COCO", stages=2), "concat_stage3"),
                      net_resolution=RES)
    weights = _fan_in_weights(jest, 0)
    est = PoseEstimator(_without_resize(make_pose_deploy_net("COCO", stages=2), "concat_stage3"),
                        weights=weights, net_resolution=RES, device="cpu")
    assert est.lowres_blob is None and not est._packed
    assert est._program_key(est.eff_peaks, 1) == ("direct",)  # the key a graph is kept by
    x = np.random.RandomState(0).rand(1, 3, RES[1], RES[0]).astype(np.float32) - 0.5
    kw = dict(nms_threshold=0.0, inter_threshold=-10.0)
    got, ref = est.fetch(est.run_device(x, **kw)), jest.fetch(jest.run_device(x, **kw))
    assert got[0].shape == ref[0].shape == (18, 65, 3)
    np.testing.assert_array_equal(got[0][:, 0, 0], ref[0][:, 0, 0])
    assert got[0][:, 0, 0].sum() > 0
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2], ref[2])
    assert est.estimate_from_net_input(x).num_people == jest.estimate_from_net_input(
        x).num_people
    with pytest.raises(ValueError, match="packed"):
        PoseEstimator(_without_resize(make_pose_deploy_net("COCO", stages=2), "concat_stage3"),
                      net_resolution=RES, batch=2, device="cpu")
