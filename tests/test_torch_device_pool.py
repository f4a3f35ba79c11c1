"""The port's device pool (caffe_rtpose_tpu_torch/parallel/inference.py) on
the CPU: replicas made on the CPU stand in for the cards, so round-robin
dispatch can be held against the single estimator frame by frame (every
packed byte equal) and against the JAX estimator on the same weights and
frames (test_torch_estimator.py's rule for many frames); the pipeline's
``num_devices > 1`` path runs through it.  The multi-card path itself runs
only where there are cards."""

import types

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
from caffe_rtpose_tpu_torch.core.net import Net
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.parallel.inference import DevicePool
from caffe_rtpose_tpu_torch.pipeline.runner import PipelineConfig, RtPosePipeline
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

from test_torch_estimator import (THR, WITNESS_SEEDS, _assert_outputs_close, _fan_in_weights,
                                  witness_frame)

RES = (128, 80)


@pytest.fixture(scope="module")
def est():
    proto = make_pose_deploy_net("COCO", stages=2)
    net = Net(proto, device="cpu")
    rs = np.random.RandomState(3)
    weights = {k: [rs.randn(*c.weight.shape).astype(np.float32) * 0.1,
                   rs.randn(c.cout).astype(np.float32) * 0.1] for k, c in net.convs.items()}
    return PoseEstimator(proto, weights=weights, net_resolution=RES, input_u8=True, pair_cap=8,
                         batch=2, device="cpu")


def _frames(n):
    rs = np.random.RandomState(2)
    return (rs.rand(n, 2, 1, RES[1], RES[0], 3) * 255).astype(np.uint8)


def test_round_robin_equals_the_single_estimator(est):
    pool = DevicePool(est, num_devices=3)
    assert pool.replicas[0] is est and len(pool.replicas) == 3
    assert all(r is not est and r._weights is not None for r in pool.replicas[1:])
    x = _frames(6)
    outs = [pool.run_device(f, nms_threshold=0.0) for f in x]
    for f, out in zip(x, outs):
        ref = est.run_device(f, nms_threshold=0.0)
        assert torch.equal(out["packed"], ref["packed"])
        for a, b in zip(pool.fetch_batch(out), est.fetch_batch(ref)):
            assert all(np.array_equal(u, v, equal_nan=True) for u, v in zip(a, b))
    # explicit placement, and the round-robin order went 0, 1, 2, 0, ...
    assert torch.equal(pool.run_device(x[1], nms_threshold=0.0, device_index=2)["packed"],
                       outs[1]["packed"])
    assert [r._graphs == {} for r in pool.replicas] == [True] * 3  # no graphs on the CPU


def test_round_robin_matches_jax():
    """Three replicas over the f64 witness's frames in passes of two, on
    the JAX estimator's fan-in weights: each pass equals the single port
    estimator byte for byte, and JAX's batched estimator by
    ``_assert_outputs_close``, whichever replica ran it.  oneDNN off, as in
    test_torch_estimator.py: its convolutions sum further from XLA's."""
    cfg = dict(net_resolution=RES, input_u8=True, pair_cap=8, batch=2)
    jest = JEstimator(j_make_net("COCO", stages=2), **cfg)
    port = PoseEstimator(make_pose_deploy_net("COCO", stages=2),
                         weights=_fan_in_weights(jest, 0), device="cpu", **cfg)
    pool = DevicePool(port, num_devices=3)
    frames = np.stack([witness_frame(s) for s in WITNESS_SEEDS[:6]]).reshape(3, 2, 1, RES[1],
                                                                             RES[0], 3)
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        outs = [pool.run_device(x, **THR) for x in frames]  # replicas 0, 1, 2
        for x, out in zip(frames, outs):
            assert torch.equal(out["packed"], port.run_device(x, **THR)["packed"])
            for got, ref in zip(pool.fetch_batch(out),
                                jest.fetch_batch(jest.run_device(x, **THR))):
                _assert_outputs_close(got, ref, port.descriptor)
    finally:
        torch.backends.mkldnn.enabled = prev


def test_replica_shares_the_host_state_and_copies_the_operands(est):
    rep = est.replicate("cpu")
    assert rep.net is est.net and rep.descriptor is est.descriptor
    ops = est.net.operands()
    assert rep._weights.keys() == ops.keys()
    assert all(torch.equal(rep._weights[k], v) for k, v in ops.items())
    assert rep._graphs is not est._graphs and rep._graph_lock is not est._graph_lock


def test_missing_cards_raise_value_error():
    """A CUDA estimator asks for cards; this machine has none."""
    fake = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="need devices"):
        DevicePool(fake, num_devices=2)


def test_pipeline_over_the_pool_equals_one_device(est, tmp_path):
    """``num_devices > 1`` (rtpose ``--num_gpu``): the pipeline dispatches
    through the pool, warms one pass a device, and writes the JSON one
    device writes."""
    import os

    rs = np.random.RandomState(4)
    frames = [(rs.rand(96, 160, 3) * 255).astype(np.uint8) for _ in range(5)]
    for n in (1, 3):
        cfg = PipelineConfig(net_resolution=RES, resolution=(160, 96), num_devices=n,
                             no_display=True, no_frame_drops=True, nms_threshold=0.0,
                             write_json=str(tmp_path / str(n)))
        pipe = RtPosePipeline(est, cfg)
        assert isinstance(pipe.pool, DevicePool) == (n > 1)
        pipe.frame_iter = iter((i, f, None) for i, f in enumerate(frames))
        assert pipe.run() == len(frames)
    names = sorted(os.listdir(tmp_path / "1"))
    assert names == sorted(os.listdir(tmp_path / "3")) and len(names) == len(frames)
    people = 0
    for name in names:
        a, b = (open(tmp_path / d / name).read() for d in ("1", "3"))
        assert a == b
        people += a.count('"joints"')
    assert people > 0
