"""ROADMAP C2: an f32 ``Net.backward`` outside the TRAIN phase ran cuDNN's
f32 data-gradient path on the card (C1 measured it 0.41-0.45 relative L2
from f64).  The switch (``core/layers.f32_training``) now keys on whether a
gradient will be taken through the layer: true in a TRAIN forward and in
any forward under grad mode whose input or operands require a gradient,
false under ``no_grad``/``inference_mode``, where every deploy and TEST
forward keeps cuDNN, unchanged.

On the CPU the switch is held directly and through the calls that reach
it (the flag each convolution gets), and ``Net.backward`` of a deploy net
against an f64 run of the same call that takes the f32 forward's ReLU
decisions (``chip_smoke.backward_f64_gaps``: without them a pre-activation
within rounding of 0 moves a deep net's gradients by ~1e-2 whatever the
engine), 2e-3 relative L2 a blob, the bound the card is held to.  The card-only test holds pycaffe's
``api.Net.backward`` of the COCO deploy net at 656x368 to f64 there."""

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu_torch import api
from caffe_rtpose_tpu_torch.core import layers as L
from caffe_rtpose_tpu_torch.core.net import Net
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.ops import nn as nn_ops
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
from chip_smoke import backward_f64_gaps

TOL_F64 = 2e-3  # relative L2 a blob, against the f64 run
RES = (128, 80)


def test_switch_keys_on_gradients():
    x = torch.zeros(1, 3, 4, 4)
    w = torch.zeros(2, 3, 3, 3, requires_grad=True)
    test, train = L.RunCtx(training=False), L.RunCtx(training=True)
    with torch.enable_grad():
        assert L.f32_training(test, x, w, None)
        assert L.f32_training(test, x.clone().requires_grad_(True), w.detach())
        assert not L.f32_training(test, x, w.detach(), None)  # nothing to differentiate
        assert not L.f32_training(test, x.bfloat16(), w)  # bf16 runs cuDNN's bf16 engines
        assert L.f32_training(train, x)
    with torch.no_grad():
        assert not L.f32_training(test, x, w)
        assert L.f32_training(train, x)  # a TRAIN forward as before C2
    with torch.inference_mode():
        assert not L.f32_training(test, x, w)


@pytest.fixture
def cudnn_flags(monkeypatch):
    """The ``cudnn`` flag of every convolution call."""
    seen = []
    real = nn_ops.conv2d

    def record(*a, cudnn=True, **kw):
        seen.append(cudnn)
        return real(*a, cudnn=cudnn, **kw)

    monkeypatch.setattr(nn_ops, "conv2d", record)
    return seen


def _deploy_net():
    net = Net(make_pose_deploy_net("COCO", stages=2, input_dim=(1, 3, 64, 64)), device="cpu",
              seed=1)
    rs = np.random.RandomState(0)
    net.load_weights({k: [(rs.randn(*c.weight.shape) * np.sqrt(2.0 / np.prod(
        c.weight.shape[1:]))).astype(np.float32), (rs.randn(c.cout) * 0.1).astype(np.float32)]
        for k, c in net.convs.items()})
    x = torch.from_numpy(rs.rand(1, 3, 64, 64).astype(np.float32) - 0.5)
    top = net.output_names()[0]  # the low-res concat the estimator reads
    return net, x, {top: rs.randn(*net.blob_shapes[top]).astype(np.float32)}


def test_backward_leaves_cudnn_and_forwards_keep_it(cudnn_flags):
    net, x, diffs = _deploy_net()
    n_convs = len(net.convs)
    net.backward({"image": x}, diffs)
    assert cudnn_flags == [False] * n_convs
    cudnn_flags.clear()
    with torch.no_grad():
        a = net.forward({"image": x})
    b = net.forward({"image": x})  # grad mode, nothing requires a gradient
    assert cudnn_flags == [True] * (2 * n_convs)
    assert all(torch.equal(a[k], b[k]) for k in diffs)
    cudnn_flags.clear()
    est = PoseEstimator(make_pose_deploy_net("COCO", stages=2), net_resolution=RES,
                        input_u8=True, device="cpu")
    est.run_device(np.zeros(est.input_shape(), np.uint8))
    assert cudnn_flags and all(cudnn_flags)


def test_deploy_backward_matches_f64():
    net, x, diffs = _deploy_net()
    gaps, _ = backward_f64_gaps(net, {"image": x}, diffs)
    assert len(gaps) == 1 + 2 * len(net.convs)
    assert max(gaps.values()) <= TOL_F64, max(gaps.items(), key=lambda kv: kv[1])


@pytest.mark.cuda
def test_api_backward_on_the_card_matches_f64():
    """pycaffe's ``Net.backward`` of the COCO deploy net at 656x368 on the
    card: every blob within 2e-3 relative L2 of the f64 run (cuDNN's f32
    backward put the trunk 0.41-0.45 away, C1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    api.set_mode_gpu()
    proto = make_pose_deploy_net("COCO", input_dim=(1, 3, 368, 656))
    net = api.Net(proto, phase=api.TEST)
    core = net._net
    rs = np.random.RandomState(0)
    core.load_weights({k: [(rs.randn(*c.weight.shape) * np.sqrt(2.0 / np.prod(
        c.weight.shape[1:]))).astype(np.float32), (rs.randn(c.cout) * 0.1).astype(np.float32)]
        for k, c in core.convs.items()})
    x = rs.rand(1, 3, 368, 656).astype(np.float32) - 0.5
    top = core.output_names()[0]
    diffs = {top: rs.randn(*core.blob_shapes[top]).astype(np.float32)}
    net.forward(image=x)
    got = net.backward(**diffs)
    assert got["image"].shape == x.shape
    gaps, _ = backward_f64_gaps(core, {"image": torch.from_numpy(x)}, diffs)
    assert max(gaps.values()) <= TOL_F64, max(gaps.items(), key=lambda kv: kv[1])
