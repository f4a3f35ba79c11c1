"""The post segment over a batch (the port of the JAX estimator's
``jax.vmap`` over frames): one mask, compaction, refinement and pair scoring
for all F frames of a pass.

On the CPU at 128x80 with a 2-stage COCO deploy net, f32, batch 3, against
the same functions run frame by frame and against the JAX estimator at
batch 3.  Tolerances: tests/test_torch_batch_pack.py's ``_assert_outputs_match``
(peak and pair counts exact, peaks within 1e-4 abs + 1e-5 rel, pair scores
within one f16 ulp + 1e-5, at most one pair in 10^4 beyond that and by no
more than 0.05).  The refinement's frame trap is held at the ops level: a
window below the last part channel of frame 0 must read frame 0's next
channel, as the reference's flat per-frame buffer does, and never frame 1's
first channel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.ops import nms as j_nms
from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.ops import nms
from caffe_rtpose_tpu_torch.pose import connect as C
from caffe_rtpose_tpu_torch.core.net import params_from_jax
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

RES = (128, 80)
THR = dict(nms_threshold=-1.0, inter_threshold=-10.0)
BATCH = 3
TOL_ONE_SAMPLE = 0.05


def _fan_in(jest, seed):
    """tests/test_torch_batch_pack.py's fan-in weights, set in the JAX net."""
    rs = np.random.RandomState(seed)
    for name in sorted(jest.net.params):
        w, b = (np.asarray(p) for p in jest.net.params[name])
        kh, kw, cin, _ = w.shape
        jest.net.params[name] = [
            jnp.asarray(rs.randn(*w.shape).astype(np.float32) * np.sqrt(2.0 / (kh * kw * cin))),
            jnp.asarray(rs.randn(*b.shape).astype(np.float32) * 0.05)]
    return params_from_jax(jest.net.params)


def _frames(n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.rand(96, 150, 3) * 255).astype(np.uint8) for _ in range(n)]


def _assert_outputs_match(got, ref):
    """tests/test_torch_batch_pack.py's tolerances (module docstring)."""
    (pt, st, ct), (pj, sj, cj) = got, ref
    np.testing.assert_array_equal(pt[:, 0, 0], pj[:, 0, 0])
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(ct, cj)
    ulp = np.spacing(np.maximum(np.abs(st), np.abs(sj)).astype(np.float16)).astype(np.float32)
    bad = np.abs(st - sj) > ulp + 1e-5
    assert bad.sum() <= bad.size // 10000 and (np.abs(st - sj) <= TOL_ONE_SAMPLE).all()


@pytest.fixture(autouse=True, scope="module")
def _torch_native_cpu_conv():
    """As tests/test_torch_estimator.py: torch's own CPU convolution."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


@pytest.fixture(scope="module")
def pair():
    """The JAX estimator at batch 3 (jax.vmap over frames) and the port's,
    1 scale, pair_cap=8, on the same fan-in weights, and 3 frames."""
    cfg = dict(net_resolution=RES, input_u8=True, pair_cap=8, batch=BATCH)
    jest = JEstimator(j_make_net("COCO", stages=2), **cfg)
    weights = _fan_in(jest, 8)
    est = PoseEstimator(make_pose_deploy_net("COCO", stages=2), weights=weights, device="cpu",
                        **cfg)
    xs = np.stack([est.make_input(img) for img in _frames(BATCH, 4)])
    return jest, est, xs


def test_batched_post_equals_the_frame_loop(pair):
    _, est, xs = pair
    with torch.inference_mode():
        low = est._lowres(est._canvases(torch.from_numpy(xs)))
        assert low.shape[:2] == (BATCH, 1)
        rows = est._post(low, THR["nms_threshold"], THR["inter_threshold"], est.eff_peaks)
        loop = [est._post(low[f : f + 1], THR["nms_threshold"], THR["inter_threshold"],
                          est.eff_peaks)[0] for f in range(BATCH)]
    assert rows.shape == (BATCH, loop[0].numel()) and rows.dtype == torch.uint8
    for f in range(BATCH):
        got, ref = est.unpack(rows[f].numpy()), est.unpack(loop[f].numpy())
        _assert_outputs_match(got, ref)
        assert got[0][:, 0, 0].sum() > 0
    # and the packed pass is that batched post segment
    assert torch.equal(est.run_device(xs, **THR)["packed"], rows)


def test_batched_post_on_the_jax_maps_matches_jax_vmap(pair):
    """The port's post segment over the JAX CNN's low-res maps of the batch
    against the JAX estimator's vmapped pass: the post segments alone, at
    every local maximum (threshold -1)."""
    jest, est, xs = pair
    norm = (xs.astype(np.float32) / 256.0 - 0.5) * est._mask.numpy()  # (F, 1, H, W, 3)
    blob = jest.lowres_blob
    low = np.stack([np.asarray(jest.net.forward({"image": n.transpose(0, 3, 1, 2)},
                                                outputs=[blob])[blob]) for n in norm])
    with torch.inference_mode():
        rows = est._post(torch.from_numpy(low).permute(0, 1, 3, 4, 2), THR["nms_threshold"],
                         THR["inter_threshold"], est.eff_peaks)
    ref = jest.fetch_batch(jest.run_device(xs, **THR))
    for f in range(BATCH):
        _assert_outputs_match(est.unpack(rows[f].numpy()), ref[f])


def test_batched_estimator_matches_jax_vmap(pair):
    """The whole batched pass, CNN included, against JAX's at batch 3.  At
    threshold 0.01: a peak whose score lies within the two CNNs' f32
    noise of zero (seen at threshold -1: 7.8e-4, 1.3e-3 relative apart,
    its centroid 1.5e-3 px apart) is no peak the comparison can hold."""
    jest, est, xs = pair
    thr = dict(nms_threshold=0.01, inter_threshold=THR["inter_threshold"])
    got = est.fetch_batch(est.run_device(xs, **thr))
    ref = jest.fetch_batch(jest.run_device(xs, **thr))
    assert len(got) == len(ref) == BATCH
    for g, r in zip(got, ref):
        _assert_outputs_match(g, r)
        assert g[0][:, 0, 0].sum() > 0
        assert est.overflowed(g[0]) == jest.overflowed(r[0])


def test_block_keys_and_compaction_take_a_frame_axis():
    rs = np.random.RandomState(3)
    mask = torch.from_numpy(rs.rand(BATCH, 4, 24, 33) > 0.97)
    kb = nms.block_keys(mask, 24, 33)
    assert kb.shape == (BATCH, 4, 24 * 16)
    pos, valid, counts = nms.compact_keys(kb, 24 * 33, 5)
    for f in range(BATCH):
        assert torch.equal(kb[f], nms.block_keys(mask[f], 24, 33))
        for a, b in zip((pos[f], valid[f], counts[f]), nms.compact_keys(kb[f], 24 * 33, 5)):
            assert torch.equal(a, b)
        jpos, jvalid, jcounts = j_nms.compact_keys(jnp.asarray(kb[f].numpy()), 24 * 33, 5)
        np.testing.assert_array_equal(pos[f].numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(counts[f].numpy(), np.asarray(jcounts))


def test_refinement_below_the_last_part_stays_in_its_frame():
    """A peak 2 rows above the bottom of the last part channel (a wide map,
    so its 7x7 window passes the bottom edge and reads the next channel at
    rows 0-1): with a frame axis, the read lands in the same frame's extra
    channel, as jax.vmap of the JAX refinement has it; reading frame 1's
    channel 0 instead would change the refined peak."""
    P, h, w, th, tw = 4, 10, 16, 80, 128
    rs = np.random.RandomState(12)
    low = (rs.rand(2, 1, h, w, P + 1).astype(np.float32) + 0.1)
    low[1, ..., 0] += 5.0  # frame 1's first channel: what a flattened read would meet
    pos = np.zeros((2, P, 2), np.int32)
    pos[:, P - 1, 0] = (th - 2) * tw + 60
    pos[:, 0, 0], pos[:, 0, 1] = 5 * tw + 7, 40 * tw + 90
    counts = np.array([[2, 0, 0, 1]] * 2, np.int32)
    valid = np.arange(2)[None, None, :] < counts[..., None]
    args = ((th, tw), 2, 1.0, 0.3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = nms.refine_from_low(t(low), t(pos), t(valid), t(counts), *args)
    assert got.shape == (2, P, 3, 3)
    ref = jax.vmap(lambda l, p, v, c: j_nms.refine_from_low(l, p, v, c, *args))(
        *(jnp.asarray(a) for a in (low, pos, valid, counts)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    for f in range(2):
        one = nms.refine_from_low(t(low[f : f + 1]), t(pos[f : f + 1]), t(valid[f : f + 1]),
                                  t(counts[f : f + 1]), *args)
        assert torch.equal(got[f], one[0])
    # the window does reach past the bottom: frame 1's channel 0 in place of
    # frame 0's extra channel moves the refined peak
    crossed = low[:1].copy()
    crossed[..., P] = low[1, ..., 0]
    wrong = nms.refine_from_low(t(crossed), t(pos[:1]), t(valid[:1]), t(counts[:1]), *args)[0]
    assert not torch.allclose(wrong[P - 1, 1], got[0, P - 1, 1], atol=1e-3)
    assert torch.equal(wrong[: P - 1], got[0, : P - 1])


def test_pair_scoring_takes_a_frame_axis(pair):
    _, est, xs = pair
    with torch.inference_mode():
        low = est._lowres(est._canvases(torch.from_numpy(xs)))
    rs = np.random.RandomState(5)
    th, tw = est.target_hw
    peaks = np.zeros((BATCH, est.num_parts, 5, 3), np.float32)
    peaks[..., 0, 0] = rs.randint(0, 5, (BATCH, est.num_parts))
    peaks[..., 1:, 0] = rs.rand(BATCH, est.num_parts, 4) * (tw - 1)
    peaks[..., 1:, 1] = rs.rand(BATCH, est.num_parts, 4) * (th - 1)
    peaks = torch.from_numpy(peaks)
    args = (est.descriptor, (th, tw), est.start_scale, est.scale_gap, -0.5)
    score, count = C.score_pairs_lowres(low, peaks, *args)
    assert score.shape == count.shape == (BATCH, est.descriptor.num_limbs, 4, 4)
    for f in range(BATCH):
        s1, c1 = C.score_pairs_lowres(low[f : f + 1], peaks[f : f + 1], *args)
        torch.testing.assert_close(score[f], s1[0], rtol=0, atol=1e-5)
        assert torch.equal(count[f], c1[0])
