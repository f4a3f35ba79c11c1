"""The port's PoseEstimator in bf16 against the JAX PoseEstimator in bf16 on
the CPU, on the same weights and frames (a 2-stage COCO deploy net at
128x80): u8 input at 1 scale, 3 scales with ``pack_u8``, and the heatmap
branch (f32 input).

1. After the CNN both sides are f32.  Given the JAX CNN's own bf16 low-res
   maps, the port's post segment reproduces the JAX estimator's outputs at
   the f32 tolerances of tests/test_torch_estimator.py: peak and pair
   counts exact, peaks within 1e-4, pair scores within one f16 ulp (the
   heatmap branch: within 1e-4 relative, its heat within 1e-5 relative).

2. End to end.  The two bf16 CNNs round every activation to bf16 and differ
   in summation order and bias rounding (tests/test_torch_bf16_net.py), so
   their low-res maps differ by a measured eps = max |low_port - low_jax|,
   about 1% of the maps' range.  The full-res maps are a linear map of the
   low-res ones, U = M low (bicubic upsample and scale average; M is built
   here from impulses).  So at a full-res pixel p the sides differ by at
   most |M[p]|_1 eps, and the step from p to a neighbour q by at most
   |M[p] - M[q]|_1 eps.  A peak that clears the threshold and each of its 8
   neighbours by more than these bounds (plus 1e-5 for the two f32
   upsamples) is a peak of the other side too.  The test asserts that for
   every such peak of either side, that there are at least MIN_ROBUST of
   them (so that the check is not vacuous: 7 of 80 peaks clear it at 1
   scale, 10 of 91 in the heatmap branch; the 3-scale average is smoother
   and 1 of 63 does, so there the post-segment test above carries the
   weight), and that per part the peak counts differ by no more than the
   peaks that fall short of the margin, and not at all where none does.
   Those peaks' scores (the full-res map at the peak) within
   max_p |M[p]|_1 eps + 1e-5, refined coordinates within 0.05 px
   (measured: 0.015); the heatmap within |M[p]|_1 eps + 1e-5 at each
   pixel.

   Random fan-in weights give smooth maps whose maxima clear their
   neighbours by ~1e-3, below that noise, so the part head is set to give
   sharper maps: the heatmap branch's last 1x1 conv passes part k through
   from one feature channel, whose bias is lowered so that only its top 30%
   of pixels stay above zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
from caffe_rtpose_tpu_torch.core.net import params_from_jax
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.ops import nms_cuda
from caffe_rtpose_tpu_torch.ops.imresize import imresize_average
from caffe_rtpose_tpu_torch.pose import preprocess
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

RES = (128, 80)
BF16 = torch.bfloat16
F32_SLACK = 1e-5
TOL_XY = 0.05
SPIKE_QUANTILE = 0.7
HEAD = ("Mconv6_stage2_L2", "Mconv7_stage2_L2")  # the 2-stage net's part head
INTER = -10.0
MODES = {"1-scale": 7, "3-scale pack_u8": 15, "heatmap": 2}  # mode: seed
MIN_ROBUST = {"1-scale": 5, "3-scale pack_u8": 1, "heatmap": 5}


@pytest.fixture(autouse=True, scope="module")
def _torch_native_cpu_conv():
    """As tests/test_torch_estimator.py: torch's own CPU convolution, for
    the module-scoped passes too."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def _fan_in(jest, seed):
    rs = np.random.RandomState(seed)
    out = {}
    for name in sorted(jest.net.params):
        w, b = (np.asarray(p) for p in jest.net.params[name])
        kh, kw, cin, _ = w.shape
        out[name] = [rs.randn(*w.shape).astype(np.float32) * np.sqrt(2.0 / (kh * kw * cin)),
                     rs.randn(*b.shape).astype(np.float32) * 0.05]
    return params_from_jax(out)


def _spiky_head(weights, net, x):
    """Sharpen the part maps on the canvases ``x`` (module docstring), from
    the port's f32 net."""
    feat, last = HEAD
    net.load_weights(weights)
    with torch.inference_mode():
        g = net({"image": torch.from_numpy(x)}, outputs=[feat])[feat]
    P = weights[last][0].shape[0] - 1
    g = g[:, :P].permute(1, 0, 2, 3).reshape(P, -1)
    cut = torch.quantile(g, SPIKE_QUANTILE, dim=1).numpy()
    w6, b6 = (a.copy() for a in weights[feat])
    b6[:P] -= np.maximum(cut, 0.0)
    w7, b7 = np.zeros_like(weights[last][0]), np.zeros_like(weights[last][1])
    w7[np.arange(P), np.arange(P)] = 1.0
    return {**weights, feat: [w6, b6], last: [w7, b7]}


def _u8_canvases(scales, seed):
    """Random u8 content in each scale's live region, zero padding."""
    rs = np.random.RandomState(seed)
    x = np.zeros((scales, RES[1], RES[0], 3), np.uint8)
    for i, (y0, y1, x0, x1) in enumerate(preprocess.region_boxes(*RES, scales, 1.0, 0.3)):
        x[i, y0:y1, x0:x1] = (rs.rand(y1 - y0, x1 - x0, 3) * 255).astype(np.uint8)
    return x


def _normalized(canv):
    """What the u8 path computes on the device, as (S, 3, H, W) f32:
    u8/256 - 0.5 in the live region, 0 in the padding."""
    mask = np.zeros(canv.shape[:3] + (1,), np.float32)
    for i, (y0, y1, x0, x1) in enumerate(preprocess.region_boxes(*RES, canv.shape[0], 1.0, 0.3)):
        mask[i, y0:y1, x0:x1] = 1.0
    x = (canv.astype(np.float32) / 256.0 - 0.5) * mask
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def _pack(canv, regions):
    return np.concatenate([canv[i, ph : ph + rh, pw : pw + rw].reshape(-1)
                           for i, (rh, rw, ph, pw, _) in enumerate(regions)])


@pytest.fixture(scope="module", params=list(MODES))
def case(request):
    mode = request.param
    scales = 3 if mode.startswith("3") else 1
    cfg = dict(net_resolution=RES, num_scales=scales)
    kw = dict(keep_heatmap=True) if mode == "heatmap" else dict(input_u8=True)
    jest = JEstimator(j_make_net("COCO", stages=2), dtype=jnp.bfloat16, **cfg, **kw)
    proto = make_pose_deploy_net("COCO", stages=2)
    canv = _u8_canvases(scales, 20 + MODES[mode])
    norm = _normalized(canv)
    f32 = PoseEstimator(proto, device="cpu", **cfg)
    weights = _spiky_head(_fan_in(jest, MODES[mode]), f32.net, norm)
    for name, (w, b) in weights.items():
        jest.net.params[name] = [jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b)]
    est = PoseEstimator(proto, weights=weights, dtype=BF16, device="cpu", **cfg, **kw)
    assert est.pack_u8 == jest.pack_u8 == (mode == "3-scale pack_u8")
    assert est.input_shape() == jest.input_shape()
    x = norm if mode == "heatmap" else _pack(canv, est._regions) if est.pack_u8 else canv

    with torch.inference_mode():
        low_t = est._lowres(est._canvases(torch.from_numpy(x)[None]))[0]
    blob = jest.lowres_blob
    low_j = np.asarray(jest.net.forward({"image": norm}, outputs=[blob])[blob], np.float32)
    low_j = torch.from_numpy(low_j).permute(0, 2, 3, 1)  # (S, h, w, C) f32 of bf16 values
    assert low_t.dtype == torch.float32 and low_t.shape == low_j.shape
    assert torch.equal(low_t, low_t.to(BF16).float())  # the bf16 CNN's output, cast once
    thr = 0.25 * float(imresize_average(low_j[..., : est.num_parts], *est.target_hw,
                                        est.start_scale, est.scale_gap).max())
    ref = jest.run_device(x, nms_threshold=thr, inter_threshold=INTER)
    return dict(mode=mode, jest=jest, est=est, x=x, low_t=low_t, low_j=low_j, thr=thr, ref=ref)


def _assert_outputs_match(got, ref):
    """tests/test_torch_estimator.py's f32 tolerances."""
    (pt, st, ct), (pj, sj, cj) = got, ref
    np.testing.assert_array_equal(pt[:, 0, 0], pj[:, 0, 0])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ct, cj)
    ulp = np.spacing(np.maximum(np.abs(st), np.abs(sj)).astype(np.float16)).astype(np.float32)
    assert (np.abs(st - sj) <= ulp + 1e-5).all()


def test_post_segment_on_the_jax_maps_matches_jax(case):
    est, jest, thr = case["est"], case["jest"], case["thr"]
    ref = jest.fetch(case["ref"])
    assert ref[0][:, 0, 0].sum() >= MIN_ROBUST[case["mode"]]
    with torch.inference_mode():
        if case["mode"] == "heatmap":
            out = est._heatmap_post(case["low_j"], thr, INTER)
            got = est.fetch(out)
            np.testing.assert_array_equal(got[0][:, 0, 0], ref[0][:, 0, 0])
            np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-4)
            np.testing.assert_array_equal(got[2], ref[2])
            np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-4)
            hj = np.asarray(case["ref"]["heatmap"], np.float32)
            ht = out["heatmap"].numpy()
            assert (np.abs(ht - hj) <= 1e-5 * np.maximum(1.0, np.abs(hj))).all()
        else:
            row = est._post(case["low_j"], thr, INTER, est.eff_peaks)
            _assert_outputs_match(est.unpack(row.numpy()), ref)


def _operator(est):
    """The (th*tw, S*h*w) matrix of the upsample + scale average."""
    S = est.num_scales
    _, _, h, w = est.net.blob_shapes[est.lowres_blob]
    k = S * h * w
    eye = torch.eye(k).reshape(k, S, h, w).permute(1, 2, 3, 0).contiguous()
    th, tw = est.target_hw
    return imresize_average(eye, th, tw, est.start_scale, est.scale_gap)[0].reshape(th * tw, k)


def _margins(est, low, M, eps, thr):
    """{(part, y, x): margin / noise bound} for every peak of U = M low."""
    P, (th, tw) = est.num_parts, est.target_hw
    u = (M @ low[..., :P].reshape(-1, P)).T.reshape(P, th, tw)
    mask = nms_cuda.peak_mask_fused_reference(low[..., :P], (th, tw), est.start_scale,
                                              est.scale_gap, thr)
    out = {}
    for c, y, x in torch.nonzero(mask).tolist():
        p = y * tw + x
        r = (float(u[c, y, x]) - thr) / (float(M[p].abs().sum()) * eps + F32_SLACK)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    q = (y + dy) * tw + x + dx
                    bound = float((M[p] - M[q]).abs().sum()) * eps + F32_SLACK
                    r = min(r, float(u[c, y, x] - u[c, y + dy, x + dx]) / bound)
        out[(c, y, x)] = r
    return out


def test_bf16_matches_jax_bf16_within_the_bf16_noise(case):
    est, thr = case["est"], case["thr"]
    low_t, low_j = case["low_t"], case["low_j"]
    P = est.num_parts
    eps = float((low_t[..., :P] - low_j[..., :P]).abs().max())
    assert 0 < eps < 0.05 * float(low_j[..., :P].abs().max())
    M = _operator(est)
    m_j, m_t = _margins(est, low_j, M, eps, thr), _margins(est, low_t, M, eps, thr)
    robust_j = {k for k, r in m_j.items() if r > 1}
    robust_t = {k for k, r in m_t.items() if r > 1}
    assert robust_j <= set(m_t) and robust_t <= set(m_j)
    assert len(robust_j) >= MIN_ROBUST[case["mode"]]

    out = case["est"].run_device(case["x"], nms_threshold=thr, inter_threshold=INTER)
    pt, pj = est.fetch(out)[0], case["jest"].fetch(case["ref"])[0]
    n_t, n_j = pt[:, 0, 0].astype(int), pj[:, 0, 0].astype(int)
    weak = np.zeros(P, int)
    for c, _, _ in [k for m in (m_j, m_t) for k, r in m.items() if r <= 1]:
        weak[c] += 1
    np.testing.assert_array_equal(n_j, [sum(k[0] == c for k in m_j) for c in range(P)])
    np.testing.assert_array_equal(n_t, [sum(k[0] == c for k in m_t) for c in range(P)])
    assert (np.abs(n_t - n_j) <= weak).all()
    for c in range(P):
        if weak[c] == 0:
            assert n_t[c] == n_j[c]
    # the robust peaks' output rows: their raster rank on each side
    rank = lambda m, k: sorted(q for q in m if q[0] == k[0]).index(k) + 1  # noqa: E731
    score_tol = float(M.abs().sum(1).max()) * eps + F32_SLACK
    for k in robust_j:
        a, b = pt[k[0], rank(m_t, k)], pj[k[0], rank(m_j, k)]
        np.testing.assert_allclose(a[:2], b[:2], rtol=0, atol=TOL_XY)
        assert abs(a[2] - b[2]) <= score_tol
    if case["mode"] == "heatmap":
        ht, hj = out["heatmap"].numpy(), np.asarray(case["ref"]["heatmap"], np.float32)
        eps_all = float((low_t - low_j).abs().max())
        bound = M.abs().sum(1).reshape(est.target_hw).numpy() * eps_all + F32_SLACK
        assert (np.abs(ht - hj) <= bound).all()
