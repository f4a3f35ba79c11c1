"""The port's Net in the TRAIN phase against the JAX package's: the 2-stage
CPM train net (``models/cpm.make_pose_train_net``, crop 64, batch 2, fan-in
weights loaded into both) and small nets for Slice, Eltwise (PROD, SUM with
coefficients, MAX), EuclideanLoss with loss weights, EuclideanmaskLoss and
Silence.

Each loss top and the total against JAX's ``make_loss_fn``: relative 1e-5.
Each gradient (autograd against ``jax.grad``): within 1e-4 of the blob's
largest magnitude (f32 sums of the backward convolutions in other orders;
measured ~1e-6).  oneDNN is off in this module, as in the other tests that
hold CPU convolutions against XLA's."""

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

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, CROP, STAGES = 2, 64, 2


@pytest.fixture(scope="module", autouse=True)
def _no_onednn():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = prev


def fan_in(net: Net, seed: int):
    rs = np.random.RandomState(seed)
    out = {}
    for name, conv in net.convs.items():
        w = tuple(conv.weight.shape)
        out[name] = [(rs.randn(*w) * np.sqrt(2.0 / np.prod(w[1:]))).astype(np.float32),
                     (rs.randn(w[0]) * 0.1).astype(np.float32)]
    return out


def jax_loss(jnet, params, inputs):
    """(total, {output: caffe-layout numpy}, grads {layer: [HWIO, bias]},
    input grads in Caffe layout) of the JAX net."""
    phys = {k: layout.to_physical(jnp.asarray(v)) if v.ndim == 4 else jnp.asarray(v)
            for k, v in inputs.items()}
    fn = jax.value_and_grad(jnet.make_loss_fn(with_outputs=True), argnums=(0, 1), has_aux=True)
    (total, (_, outs)), (gp, gi) = fn(params, phys, jax.random.PRNGKey(0))
    gi = {k: np.asarray(layout.to_caffe(v) if v.ndim == 4 else v) for k, v in gi.items()}
    return float(total), {k: np.asarray(v) for k, v in outs.items()}, gp, gi


def port_loss(net, inputs, grad_inputs=()):
    feed = {k: torch.from_numpy(v).requires_grad_(k in grad_inputs) for k, v in inputs.items()}
    total, outs = net.loss(feed)
    total.backward()
    return float(total.detach()), outs, {k: feed[k].grad.numpy() for k in grad_inputs}


def assert_blobs_close(got, ref, tol=GRAD_TOL):
    for k in ref:
        for g, r in zip(got[k], ref[k]):
            scale = max(float(np.abs(r).max()), 1e-30)
            assert float(np.abs(np.asarray(g) - r).max()) <= tol * scale, k


@pytest.fixture(scope="module")
def cpm():
    jnet = JNet(jmake_train(batch=B, crop=CROP, stages=STAGES), phase="TRAIN", seed=0)
    net = Net(make_pose_train_net(batch=B, crop=CROP, stages=STAGES), phase="TRAIN", device="cpu")
    weights = fan_in(net, 0)
    net.load_weights(weights)
    jparams = {k: [jnp.asarray(a) for a in v] for k, v in params_to_jax(weights).items()}
    rs = np.random.RandomState(1)
    inputs = {"data": (rs.rand(B, 3, CROP, CROP) - 0.5).astype(np.float32),
              "label": rs.rand(B, 114, CROP // 8, CROP // 8).astype(np.float32)}
    ref = jax_loss(jnet, jparams, inputs)
    got = port_loss(net, inputs)
    return net, jnet, ref, got


def test_train_net_structure(cpm):
    net, jnet, _, _ = cpm
    assert net.loss_tops() == jnet.loss_tops()
    assert net.output_names() == [t for t, _ in jnet.loss_tops()]
    # train and deploy share layer names: the convolutions of both builders
    assert list(net.convs) == [i.name for i in jnet.impls if i.params]
    for name, _, prm, lr, dm in net.learnable():
        ji = jnet.layer_by_name[name]
        assert (lr, dm) in [(p.lr_mult, p.decay_mult) for p in ji.params]
        assert prm.requires_grad


def test_train_net_losses(cpm):
    _, jnet, (jtotal, jouts, _, _), (total, outs, _) = cpm
    np.testing.assert_allclose(total, jtotal, rtol=LOSS_RTOL)
    assert set(outs) == set(jouts) and len(outs) == 2 * STAGES
    for k in jouts:
        np.testing.assert_allclose(float(outs[k].detach()), float(jouts[k]), rtol=LOSS_RTOL)


def test_train_net_gradients(cpm):
    net, _, (_, _, jgrads, _), _ = cpm
    ref = params_from_jax(jgrads)
    got = {name: [conv.weight.grad.numpy(), conv.bias.grad.numpy()]
           for name, conv in net.convs.items()}
    assert set(got) == set(ref)
    assert_blobs_close(got, ref)


def _small(layers, inputs):
    return {"name": "small", "input": list(inputs),
            "input_shape": [{"dim": list(s)} for s in inputs.values()], "layer": layers}


SLICE_ELTWISE = _small([
    {"name": "sa", "type": "Slice", "bottom": ["a"], "top": ["a0", "a1", "a2"],
     "slice_param": {"axis": 1, "slice_point": [2, 4]}},
    {"name": "prod", "type": "Eltwise", "bottom": ["a0", "a1"], "top": ["p"],
     "eltwise_param": {"operation": 0}},
    {"name": "sum", "type": "Eltwise", "bottom": ["a0", "a1", "a2"], "top": ["s"],
     "eltwise_param": {"operation": 1, "coeff": [0.5, -2.0, 1.5]}},
    {"name": "max", "type": "Eltwise", "bottom": ["a2", "c"], "top": ["m"],
     "eltwise_param": {"operation": 2}},
    {"name": "sb", "type": "Slice", "bottom": ["b"], "top": ["b0", "b1", "b2"],
     "slice_param": {"axis": 1}},
    {"name": "sw", "type": "Slice", "bottom": ["c"], "top": ["c0", "c1"],
     "slice_param": {"axis": 3, "slice_point": [2]}},
    {"name": "l1", "type": "EuclideanLoss", "bottom": ["p", "b0"], "top": ["l1"],
     "loss_weight": [0.7]},
    {"name": "l2", "type": "EuclideanLoss", "bottom": ["s", "b1"], "top": ["l2"]},
    {"name": "l3", "type": "EuclideanLoss", "bottom": ["m", "b2"], "top": ["l3"],
     "loss_weight": [2.0]},
    {"name": "l4", "type": "EuclideanLoss", "bottom": ["c0", "c0"], "top": ["l4"],
     "loss_weight": [0.0]},
    {"name": "quiet", "type": "Silence", "bottom": ["c1"]},
], {"a": (2, 6, 4, 5), "b": (2, 6, 4, 5), "c": (2, 2, 4, 5)})

MASKED = _small([
    {"name": "conv", "type": "Convolution", "bottom": ["x"], "top": ["y"],
     "param": [{"lr_mult": 1.0, "decay_mult": 1.0}, {"lr_mult": 0.0, "decay_mult": 0.0}],
     "convolution_param": {"num_output": 4, "kernel_size": [3], "pad": [1],
                           "weight_filler": {"type": "gaussian", "std": 0.1}}},
    {"name": "loss", "type": "EuclideanmaskLoss", "bottom": ["y", "t", "mask"], "top": ["loss"],
     "loss_weight": [1.5]},
], {"x": (2, 3, 6, 6), "t": (2, 4, 6, 6), "mask": (2, 4)})


@pytest.mark.parametrize("proto,grad_inputs", [(SLICE_ELTWISE, ("a", "b", "c")),
                                               (MASKED, ("x", "t"))], ids=["slice_eltwise",
                                                                           "masked"])
def test_small_nets(proto, grad_inputs):
    rs = np.random.RandomState(2)
    inputs = {k: rs.randn(*s["dim"]).astype(np.float32)
              for k, s in zip(proto["input"], proto["input_shape"])}
    if "mask" in inputs:
        inputs["mask"] = (rs.rand(2, 4) > 0.5).astype(np.float32)
    jnet = JNet(proto, phase="TRAIN", seed=0)
    net = Net(proto, phase="TRAIN", device="cpu")
    weights = fan_in(net, 3)
    net.load_weights(weights)
    jparams = {k: [jnp.asarray(a) for a in v] for k, v in params_to_jax(weights).items()}
    jtotal, jouts, jgp, jgi = jax_loss(jnet, jparams, inputs)
    total, outs, gi = port_loss(net, inputs, grad_inputs)
    assert net.loss_tops() == jnet.loss_tops()
    assert set(outs) == set(jouts)
    np.testing.assert_allclose(total, jtotal, rtol=LOSS_RTOL)
    for k in jouts:
        np.testing.assert_allclose(outs[k].detach().numpy(), jouts[k], rtol=LOSS_RTOL, atol=1e-6)
    assert_blobs_close({k: [v] for k, v in gi.items()}, {k: [jgi[k]] for k in gi})
    if net.convs:
        conv = net.convs["conv"]
        assert conv.lr_mult == [1.0, 0.0] and conv.decay_mult == [1.0, 0.0]
        assert conv.weight.requires_grad and not conv.bias.requires_grad
        assert conv.bias.grad is None  # Caffe computes no diff for lr_mult 0
        assert_blobs_close({"conv": [conv.weight.grad.numpy()]},
                           {"conv": [params_from_jax(jgp)["conv"][0]]})


def test_deploy_phase_params_need_no_gradient():
    """Outside TRAIN the parameters take no gradient (the estimator's
    programs run without autograd)."""
    net = Net(make_pose_train_net(batch=1, crop=16, stages=1), phase="TEST", device="cpu")
    assert not any(p.requires_grad for p in net.parameters())


@pytest.mark.parametrize("phase,dtype,fmt", [
    ("TRAIN", torch.float32, torch.contiguous_format),
    ("TEST", torch.float32, torch.channels_last),
    ("TRAIN", torch.bfloat16, torch.channels_last)])
def test_memory_format(phase, dtype, fmt):
    """f32 training runs NCHW (cuDNN's f32 NHWC engines are its slow ones);
    the deploy nets and bf16 stay channels_last."""
    net = Net(make_pose_train_net(batch=1, crop=16, stages=1), phase=phase, device="cpu",
              dtype=dtype)
    assert net.memory_format == fmt
    w = net.convs["conv1_2"].weight
    assert w.is_contiguous(memory_format=fmt)
    out = net.forward({"data": torch.rand(1, 3, 16, 16), "label": torch.rand(1, 114, 2, 2)},
                      outputs=["conv4_4_CPM"])["conv4_4_CPM"]
    assert out.is_contiguous(memory_format=fmt)


def test_eltwise_coefficient_count_is_checked():
    bad = _small([{"name": "e", "type": "Eltwise", "bottom": ["a", "a"], "top": ["e"],
                   "eltwise_param": {"operation": 1, "coeff": [1.0]}}], {"a": (1, 2, 3, 3)})
    with pytest.raises(ValueError, match="one coefficient per bottom"):
        Net(bad, phase="TRAIN", device="cpu")
