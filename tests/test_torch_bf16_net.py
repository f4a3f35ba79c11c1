"""The port's graph runtime in bf16 (core/net.py): against the JAX ``Net``
in bf16 on the same weights, and the conv1 block's fused path (K4,
ops/conv1_cuda.py) taken by structure and only where it is exact to take.

Tolerance.  Both sides round every activation to bf16, with f32 sums;
they differ in summation order and in where the bias is rounded
(ops/nn.py::conv2d), so a few elements of each layer round the other way
and the differences grow through the net, as they do between the JAX
package's own bf16 and f32 passes.  The bound is therefore taken from that
distance, measured on the same inputs: the port's bf16 output is within
1.5x the JAX bf16-vs-f32 relative L2 distance of the JAX bf16 output
(measured: 0.0104 against 0.0110 for the 2-stage deploy net at 128x80),
and within 1.5x of it from the JAX f32 output as well.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu_torch.core import net as net_mod
from caffe_rtpose_tpu_torch.core.net import Net, params_from_jax
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.ops import conv1_cuda

BF16 = torch.bfloat16
RATIO = 1.5


@pytest.fixture(autouse=True)
def _torch_native_cpu_conv():
    """As tests/test_torch_estimator.py: torch's own CPU convolution."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _fan_in(jnet, seed):
    rs = np.random.RandomState(seed)
    for name in sorted(jnet.params):
        w, b = (np.asarray(p) for p in jnet.params[name])
        kh, kw, cin, _ = w.shape
        jnet.params[name] = [
            jnp.asarray(rs.randn(*w.shape).astype(np.float32) * np.sqrt(2.0 / (kh * kw * cin))),
            jnp.asarray(rs.randn(*b.shape).astype(np.float32) * 0.05)]
    return params_from_jax(jnet.params)


class _Spy:
    """Stands in for conv1_cuda.conv1_block and counts its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x, cw):
        self.calls += 1
        return conv1_cuda.conv1_block_reference(x, cw)


@pytest.fixture
def spy(monkeypatch):
    s = _Spy()
    monkeypatch.setattr(net_mod.conv1_cuda, "conv1_block", s)
    return s


@pytest.fixture(scope="module")
def deploy():
    """The 2-stage COCO deploy net at 128x80: JAX bf16 and f32 outputs on
    fan-in weights, and the weights for the port."""
    shape = (1, 3, 80, 128)
    jb = JNet(j_make_net("COCO", stages=2), phase="TEST", input_shapes={"image": shape},
              dtype=jnp.bfloat16)
    weights = _fan_in(jb, 0)
    jf = JNet(j_make_net("COCO", stages=2), phase="TEST", input_shapes={"image": shape})
    jf.params = dict(jb.params)
    x = (np.random.RandomState(1).rand(*shape) * 255).astype(np.uint8)
    x = x.astype(np.float32) / 256.0 - 0.5
    blob = "concat_stage3"
    ref_b = np.asarray(jb.forward({"image": x}, outputs=[blob])[blob], np.float32)
    ref_f = np.asarray(jf.forward({"image": x}, outputs=[blob])[blob], np.float32)
    return weights, x, blob, ref_b, ref_f


@pytest.mark.parametrize("conv1_kernel", [False, True])
def test_deploy_net_bf16_matches_jax_bf16(deploy, spy, conv1_kernel):
    weights, x, blob, ref_b, ref_f = deploy
    net = Net(make_pose_deploy_net("COCO", stages=2), input_shapes={"image": x.shape},
              device="cpu", dtype=BF16, conv1_kernel=conv1_kernel)
    assert net.load_weights(weights) == len(weights)
    assert list(net.conv1_blocks) == ["conv1_1"]  # found by structure
    with torch.inference_mode():
        out = net({"image": torch.from_numpy(x)}, outputs=[blob])[blob]
    assert spy.calls == int(conv1_kernel)
    assert out.dtype == BF16 and out.is_contiguous(memory_format=torch.channels_last)
    got = out.float().numpy()
    assert got.shape == ref_b.shape and np.isfinite(got).all()
    jax_own = _rel(ref_b, ref_f)  # the JAX package's bf16-vs-f32 distance
    assert 1e-3 < jax_own < 0.05
    assert _rel(got, ref_b) <= RATIO * jax_own
    assert _rel(got, ref_f) <= RATIO * jax_own


def test_bf16_compute_weights_are_made_at_load_not_per_call(deploy):
    weights, x, _, _, _ = deploy
    net = Net(make_pose_deploy_net("COCO", stages=2), input_shapes={"image": x.shape},
              device="cpu", dtype=BF16)
    conv = net.convs["conv2_1"]
    net.load_weights(weights)
    w_bf, b_bf = conv._operands
    assert w_bf.dtype == b_bf.dtype == BF16 and conv.weight.dtype == torch.float32
    np.testing.assert_array_equal(conv.weight.numpy(), weights["conv2_1"][0])  # f32 as loaded
    assert torch.equal(w_bf, conv.weight.to(BF16))
    with torch.inference_mode():
        net({"image": torch.from_numpy(x)}, outputs=["pool2_stage1"])
    assert conv._operands[0] is w_bf  # no per-call copy
    net.load_weights({"conv2_1": [np.zeros_like(weights["conv2_1"][0]), weights["conv2_1"][1]]})
    assert not conv._operands[0].any()  # a new load refreshes them
    blk = net.conv1_blocks["conv1_1"]
    assert torch.equal(blk.weights.w1, net.convs["conv1_1"].weight)


# --------------------------------------------- a narrow net with the block

def _conv(name, bottom, n, k=3, pad=1, top=None, **kw):
    p = {"num_output": n, "kernel_size": [k], "pad": [pad],
         "weight_filler": {"type": "gaussian", "std": 0.3}, **kw}
    return {"name": name, "type": "Convolution", "bottom": [bottom], "top": [top or name],
            "convolution_param": p}


def _relu(name, blob, slope=0.0):
    return {"name": name, "type": "ReLU", "bottom": [blob], "top": [blob],
            "relu_param": {"negative_slope": slope}}


def _pool(name, bottom, k=2, s=2):
    return {"name": name, "type": "Pooling", "bottom": [bottom], "top": [name],
            "pooling_param": {"pool": 0, "kernel_size": k, "stride": s}}


def _narrow(h=24, w=36, **change):
    """A first block under other names (so it is found by structure), then
    narrow layers; ``change`` alters one thing of the block."""
    block = [_conv("a", "image", 64), _relu("ra", "a", change.get("slope", 0.0)),
             _conv("b", "a", change.get("cout", 64), pad=change.get("pad", 1)),
             _relu("rb", "b"), _pool("p", "b", k=change.get("k", 2))]
    layers = block + [_conv("c", "p", 8), _relu("rc", "c"), _pool("q", "c"),
                      _conv("d", "q", 5, k=1, pad=0)]
    if change.get("reader"):  # a second reader of the block's inner blob
        layers.append({"name": "cat", "type": "Concat", "bottom": ["a", "a"], "top": ["cat"],
                       "concat_param": {"axis": 1}})
    return {"input": ["image"], "input_dim": [2, 3, h, w], "layer": layers}


def test_narrow_net_bf16_matches_jax_bf16(spy):
    proto = _narrow()
    jb = JNet(proto, phase="TEST", seed=3, dtype=jnp.bfloat16)
    weights = _fan_in(jb, 4)
    jf = JNet(proto, phase="TEST", seed=3)
    jf.params = dict(jb.params)
    x = np.random.RandomState(5).rand(2, 3, 24, 36).astype(np.float32) - 0.5
    outs = ["p", "d"]
    ref_b, ref_f = (jb.forward({"image": x}, outputs=outs), jf.forward({"image": x}, outputs=outs))
    net = Net(proto, device="cpu", dtype=BF16, conv1_kernel=True)
    net.load_weights(weights)
    assert list(net.conv1_blocks) == ["a"]
    with torch.inference_mode():
        got = net({"image": torch.from_numpy(x)}, outputs=outs)
    assert spy.calls == 1
    for k in outs:
        g = got[k].float().numpy()
        jax_own = _rel(ref_b[k], ref_f[k])
        assert g.shape == ref_b[k].shape and jax_own > 0
        assert _rel(g, ref_b[k]) <= RATIO * jax_own, k
    # the block's output alone: the fused kernel's plain version against the
    # JAX chain, within K4's two bf16 ulps (tests/test_torch_conv1.py)
    a, b = got["p"].float().numpy(), np.asarray(ref_b["p"], np.float32)
    assert (np.abs(a - b) <= np.maximum(np.maximum(np.abs(a), np.abs(b)) * 2 ** -7, 2 ** -13)).all()


@pytest.mark.parametrize("change", [dict(cout=32), dict(pad=0), dict(k=3), dict(slope=0.1),
                                    dict(reader=True)], ids=lambda c: next(iter(c)))
def test_graph_without_the_exact_block_is_not_fused(spy, change):
    net = Net(_narrow(**change), device="cpu", dtype=BF16, conv1_kernel=True)
    assert net.conv1_blocks == {}
    x = torch.from_numpy(np.random.RandomState(6).rand(2, 3, 24, 36).astype(np.float32))
    with torch.inference_mode():
        out = net({"image": x})
    assert spy.calls == 0 and all(v.dtype == BF16 for v in out.values())


@pytest.mark.parametrize("case", ["f32", "switch_off", "inner_output", "odd_input"])
def test_fused_path_taken_only_where_exact(spy, case):
    h, w = (25, 36) if case == "odd_input" else (24, 36)
    dtype = torch.float32 if case == "f32" else BF16
    net = Net(_narrow(h, w), device="cpu", dtype=dtype, conv1_kernel=case != "switch_off")
    assert list(net.conv1_blocks) == ["a"]  # found; whether it runs is per call
    x = torch.from_numpy(np.random.RandomState(7).rand(2, 3, h, w).astype(np.float32) - 0.5)
    outs = ["a", "b", "d"] if case == "inner_output" else ["d"]
    with torch.inference_mode():
        got = net({"image": x}, outputs=outs)
        ref = Net(_narrow(h, w), device="cpu", dtype=dtype, conv1_kernel=False)(
            {"image": x}, outputs=outs)
    assert spy.calls == 0
    for k in outs:  # the same layer-by-layer computation
        assert torch.equal(got[k], ref[k]), k
    assert net.conv1_kernel == (dtype == BF16 and case != "switch_off")
