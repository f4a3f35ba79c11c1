"""The estimator's CUDA graphs against the same programs run eagerly, on a
CUDA card (skipped without one).  Imports no jax, so that it runs on the
card's machine: ``python3 -m pytest --noconftest -m cuda
tests/test_torch_cuda_graph.py``."""

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.ops import nms_cuda
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

RES = (128, 80)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(input_u8=True, pair_cap=8),
                                dict(input_u8=True, pair_cap=8, batch=2, dtype=torch.bfloat16),
                                dict(keep_heatmap=True)])
def test_graph_equals_eager(cuda_device, kw):
    """On the card: each captured program against the same program run
    eagerly, at two thresholds set between replays; the uncapped refetch
    through its own graph."""
    net = make_pose_deploy_net("COCO", stages=2)
    est = PoseEstimator(net, net_resolution=RES, warm_overflow=True, device=cuda_device, **kw)
    rs = np.random.RandomState(13)
    shape = est.input_shape() if est.batch == 1 else (est.batch, *est.input_shape())
    x = (rs.rand(*shape) * 255).astype(est.input_dtype) if est.input_u8 else \
        rs.rand(*shape).astype(np.float32) - 0.5
    assert est.cuda_graph
    for thr in (0.0, -1.0):
        est.cuda_graph = True
        got = est.run_device(x, nms_threshold=thr)
        est.cuda_graph = False
        ref = est.run_device(x, nms_threshold=thr)
        est.cuda_graph = True
        for k in ref:  # bit for bit, NaN where both hold NaN (threshold -1)
            torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, equal_nan=True,
                                       msg=f"threshold {thr}, {k}")
    if not est.keep_heatmap:
        one = x if est.batch == 1 else x[0]
        peaks, _, _ = est.refetch_full(one, nms_threshold=-1.0)
        assert peaks.shape == (est.num_parts, est.max_peaks + 1, 3)


@pytest.mark.cuda
def test_kernels_take_a_device_threshold(cuda_device):
    """K1 and K3 read the threshold from a device scalar: a 0-d tensor gives
    the float's result bit for bit, and so does a graph that replays them
    after the scalar changed."""
    rs = np.random.RandomState(14)
    low = torch.from_numpy(rs.rand(1, 46, 82, 18).astype(np.float32) * 2 - 1).to(cuda_device)
    args = (low, (368, 656), 1.0, 0.3)
    thr = torch.zeros((), dtype=torch.float32, device=cuda_device)
    for v in (0.05, 0.3):
        thr.fill_(v)
        assert torch.equal(nms_cuda.peak_mask_fused(*args, thr), nms_cuda.peak_mask_fused(*args, v))
        h_t, k_t = nms_cuda.upsample_peak_keys(*args, thr)
        h_f, k_f = nms_cuda.upsample_peak_keys(*args, v)
        assert torch.equal(h_t, h_f) and torch.equal(k_t, k_f)
    nms_cuda.peak_mask_fused(*args, thr)  # warm: the tables are uploaded outside the capture
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        mask = nms_cuda.peak_mask_fused(*args, thr)
    for v in (0.05, 0.3):
        thr.fill_(v)
        g.replay()
        assert torch.equal(mask, nms_cuda.peak_mask_fused(*args, v))


@pytest.mark.cuda
def test_replays_count_their_kernels(cuda_device):
    """A replay makes no wrapper call: ``replayed_launches`` counts each
    program's replays times the hand-kernel nodes its capture recorded: one
    conv1 block and one peak mask a pass, the post segment running over the
    batch."""
    net = make_pose_deploy_net("COCO", stages=2)
    est = PoseEstimator(net, net_resolution=RES, input_u8=True, pair_cap=8, batch=2,
                        dtype=torch.bfloat16, device=cuda_device)
    x = np.zeros((est.batch, *est.input_shape()), np.uint8)
    for _ in range(3):
        est.fetch_batch(est.run_device(x))
    assert est.replayed_launches() == {"peak_mask_kernel": 3, "upsample_peak_keys_kernel": 0,
                                       "conv1_block_kernel": 3}
