"""bf16 mixed-precision training and ``remat`` on the port's Net against the
JAX package's: the 2-stage CPM train net (``make_pose_train_net(batch=2,
crop=64, stages=2)``) with the same fan-in weights in both.

bf16 against JAX bf16, per parameter blob: the port's convolutions round the
f32 sum to bf16 before the f32 bias is added (cuDNN's bf16 engines return
bf16), where JAX rounds once after the bias (``ops/nn.py::_mixed``), so the
two bf16 runs are two draws of the same rounding noise.  A blob passes when
its port-to-JAX relative L2 is at most 1.5 times JAX's own bf16-to-f32
relative L2 on that blob, or under 1e-2.

``remat="convs"`` recomputes what a convolution saves, so its gradients
equal ``remat="none"``'s bit for bit on the CPU, in f32 and in bf16 (at
crop 32, as the 3-step bf16 solver case).
An f32 TRAIN net's convolutions on the card run outside cuDNN
(``ops/nn.py::_OutsideCudnn``); its forward and backward equal autograd of
the plain ops on the CPU.  oneDNN is off in this module, as in the other
tests that hold CPU convolutions against XLA's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu.models.cpm import make_pose_train_net as jmake_train
from caffe_rtpose_tpu.ops import layout
from caffe_rtpose_tpu_torch.core.net import Net, params_from_jax, params_to_jax
from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
from caffe_rtpose_tpu_torch.training.solver import Solver

B, CROP, STAGES = 2, 64, 2
SMALL = 32  # the crop of the remat and solver cases
RATIO = 1.5  # port-to-JAX distance against JAX's bf16-to-f32 distance
FLOOR = 1e-2  # a distance under this passes whatever JAX's own is
SOLVER = "base_lr: 2e-5 lr_policy: 'fixed' momentum: 0.9 weight_decay: 5e-4"
CONVS = [l["name"] for l in make_pose_train_net(batch=B, crop=CROP, stages=STAGES)["layer"]
         if l["type"] == "Convolution"]


@pytest.fixture(scope="module", autouse=True)
def _no_onednn():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = prev


def proto(crop=CROP):
    return make_pose_train_net(batch=B, crop=crop, stages=STAGES)


def fan_in(net: Net, seed: int):
    rs = np.random.RandomState(seed)
    out = {}
    for name, conv in net.convs.items():
        w = tuple(conv.weight.shape)
        out[name] = [(rs.randn(*w) * np.sqrt(2.0 / np.prod(w[1:]))).astype(np.float32),
                     (rs.randn(w[0]) * 0.1).astype(np.float32)]
    return out


def inputs(seed=1, crop=CROP):
    rs = np.random.RandomState(seed)
    return {"data": (rs.rand(B, 3, crop, crop) - 0.5).astype(np.float32),
            "label": (rs.rand(B, 114, crop // 8, crop // 8) > 0.7).astype(np.float32)}


def port_grads(weights, feed, dtype, remat="none"):
    crop = feed["data"].shape[-1]
    net = Net(proto(crop), phase="TRAIN", device="cpu", dtype=dtype, remat=remat)
    net.load_weights(weights)
    loss, _ = net.loss({k: torch.from_numpy(v) for k, v in feed.items()})
    loss.backward()
    return float(loss.detach()), {n: [p.grad for p in ps] for n, ps in net.layer_blobs().items()}


def jax_grads(weights, feed, dtype):
    """JAX's gradients, as scripts/train_breakdown.py runs the step: inputs
    and labels cast to the net's dtype, parameters f32."""
    jnet = JNet(jmake_train(batch=B, crop=CROP, stages=STAGES), phase="TRAIN", seed=0,
                dtype=dtype)
    params = {k: [jnp.asarray(a) for a in v] for k, v in params_to_jax(weights).items()}
    phys = {k: layout.to_physical(jnp.asarray(v)).astype(dtype) for k, v in feed.items()}
    fn = jax.jit(jax.value_and_grad(jnet.make_loss_fn()))
    loss, g = fn(params, phys, jax.random.PRNGKey(0))
    return float(loss), params_from_jax(g)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def grads():
    weights = fan_in(Net(proto(), phase="TRAIN", device="cpu"), 0)
    feed = inputs()
    return dict(j32=jax_grads(weights, feed, jnp.float32),
                j16=jax_grads(weights, feed, jnp.bfloat16),
                p16=port_grads(weights, feed, torch.bfloat16))


def test_bf16_loss_close_to_jax(grads):
    (lj, _), (lp, _) = grads["j16"], grads["p16"]
    assert np.isfinite(lp)
    np.testing.assert_allclose(lp, lj, rtol=1e-2)


@pytest.mark.parametrize("layer", CONVS)
def test_bf16_gradients_match_jax_bf16(grads, layer):
    """Each of the layer's blobs: port bf16 against JAX bf16 within 1.5x
    JAX's bf16-to-f32 distance, or under 1e-2; the gradients are f32."""
    ref32, ref16, got = grads["j32"][1][layer], grads["j16"][1][layer], grads["p16"][1][layer]
    for i, (a, b, g) in enumerate(zip(ref32, ref16, got)):
        assert g.dtype == torch.float32
        g = g.numpy()
        assert np.isfinite(g).all()
        d_port, d_jax = rel(g, b), rel(b, a)
        assert d_port <= RATIO * d_jax or d_port < FLOOR, (layer, i, d_port, d_jax)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_convs_gradients_bit_identical(dtype):
    weights = fan_in(Net(proto(SMALL), phase="TRAIN", device="cpu"), 2)
    feed = inputs(3, SMALL)
    l0, g0 = port_grads(weights, feed, dtype, "none")
    l1, g1 = port_grads(weights, feed, dtype, "convs")
    assert l0 == l1
    for name in g0:
        for a, b in zip(g0[name], g1[name]):
            assert torch.equal(a, b), name


def test_remat_only_known_policies():
    with pytest.raises(ValueError, match="remat"):
        Net(proto(), phase="TRAIN", device="cpu", remat="all")


def test_bf16_train_refuses_conv1_kernel():
    """The conv1 kernel has no backward: a TRAIN net asked for it raises, and
    by default a TRAIN net never takes it."""
    with pytest.raises(ValueError, match="conv1"):
        Net(proto(), phase="TRAIN", device="cpu", dtype=torch.bfloat16, conv1_kernel=True)
    assert not Net(proto(), phase="TRAIN", device="cpu", dtype=torch.bfloat16).conv1_kernel


def test_bf16_solver_keeps_f32_state():
    """Three bf16 SGD steps: the parameters, their gradients and the momentum
    stay f32, the parameters move, the losses are finite, and a forward after
    the update reads the updated parameters (no stale bf16 copy)."""
    net = Net(proto(SMALL), phase="TRAIN", device="cpu", dtype=torch.bfloat16)
    net.load_weights(fan_in(net, 4))
    before = {n: [p.detach().clone() for p in ps] for n, ps in net.layer_blobs().items()}
    feed = inputs(5, SMALL)
    solver = Solver(SOLVER, net, lambda it: feed)
    losses = [solver.step(1) for _ in range(3)]
    assert np.isfinite(losses).all()
    for name, ps in net.layer_blobs().items():
        for p, h, b in zip(ps, solver.history["h0"][name], before[name]):
            assert p.dtype == h.dtype == p.grad.dtype == torch.float32
            assert not torch.equal(p.detach(), b), name
    with torch.no_grad():
        conv = net.mods["conv1_1"]
        x = torch.from_numpy(feed["data"]).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        got = net.forward({"data": torch.from_numpy(feed["data"]),
                           "label": torch.from_numpy(feed["label"])},
                          outputs=["conv1_1"])["conv1_1"]
        w = conv.weight.to(torch.bfloat16)
        ref = torch.relu((torch.nn.functional.conv2d(x, w, None, padding=1).float()
                          + conv.bias.reshape(1, -1, 1, 1)).to(torch.bfloat16))
    assert torch.equal(got, ref)  # relu1_1 runs in place on conv1_1's top


@pytest.mark.parametrize("transposed,groups,stride,dilation", [
    (False, 1, (1, 1), (1, 1)), (False, 2, (2, 1), (1, 2)),
    (True, 1, (2, 2), (1, 1)), (True, 2, (1, 2), (2, 1))])
def test_convolution_outside_cudnn_matches_autograd(transposed, groups, stride, dilation):
    """An f32 TRAIN net's convolutions on the card run ``_OutsideCudnn``
    (forward and ``convolution_backward`` with cuDNN off); on the CPU it
    equals autograd of the plain op bit for bit."""
    import torch.nn.functional as F

    from caffe_rtpose_tpu_torch.ops.nn import _OutsideCudnn

    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 4, 9, 8, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn((4, 6 // groups, 3, 3) if transposed else (6, 4 // groups, 3, 3),
                    generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(6, generator=g, dtype=torch.float64, requires_grad=True)
    y = _OutsideCudnn.apply(x, w, b, stride, (1, 1), dilation, groups, transposed)
    op = F.conv_transpose2d if transposed else F.conv2d
    ref = op(x, w, b, stride=stride, padding=(1, 1), dilation=dilation, groups=groups)
    assert torch.equal(y, ref)
    gy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    for a, r in zip(torch.autograd.grad(y, (x, w, b), gy), torch.autograd.grad(ref, (x, w, b), gy)):
        assert torch.equal(a, r)
