"""The port's graph runtime (core/net.py): the whole deploy CNN reproduces
the recorded concat_stage7 golden without jax, and a narrow net of the same
layer types matches the JAX Net given the same weights."""

import os

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu_torch.core.net import Net, params_from_jax
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "concat_stage7_seed42.npz")


def test_cnn_reproduces_concat_stage7_golden():
    """tests/test_golden_pose.py's whole-CNN golden (trunk + 6 stages at
    80x128): weights drawn as it draws them — RandomState(42), layers in
    sorted name order, draws in the JAX HWIO shapes — then turned to OIHW."""
    blob = np.load(GOLDEN)
    net = Net(make_pose_deploy_net(), input_shapes={"image": (1, 3, 80, 128)}, device="cpu")
    rs = np.random.RandomState(42)
    weights = {}
    for name in sorted(net.convs.keys()):
        conv = net.convs[name]
        cout, cin, kh, kw = conv.weight.shape
        w_hwio = rs.randn(kh, kw, cin, cout).astype(np.float32) * 0.05
        b = rs.randn(cout).astype(np.float32) * 0.05
        weights[name] = [w_hwio.transpose(3, 2, 0, 1), b]
    assert net.load_weights(weights) == len(weights) == 92
    x = rs.rand(1, 3, 80, 128).astype(np.float32) - 0.5
    np.testing.assert_allclose(x, blob["x"], atol=0)  # rng stream stable
    # oneDNN's f32 convolutions sum in an order whose cancellation noise on
    # these activations (max ~7.5e7) reaches ~430 here; torch's own CPU
    # convolution stays within ~160 of the golden, as XLA's does (~140)
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        with torch.inference_mode():
            out = net({"image": torch.from_numpy(x)})
    finally:
        torch.backends.mkldnn.enabled = prev
    assert list(out) == ["concat_stage7"]
    y = out["concat_stage7"].numpy()
    assert y.shape == blob["y"].shape == (1, 57, 10, 16)
    # as test_golden_pose: atol covers cancellation noise on near-zero
    # elements of the deliberately large activations (scale ~1e7)
    np.testing.assert_allclose(y, blob["y"], rtol=2e-4, atol=200)


def _narrow_net():
    def conv(name, bottom, n, k, pad, **kw):
        p = {"num_output": n, "kernel_size": [k], "pad": [pad],
             "weight_filler": {"type": "gaussian", "std": 0.3}, **kw}
        return {"name": name, "type": "Convolution", "bottom": [bottom], "top": [name],
                "convolution_param": p}

    def relu(name, blob, slope=0.0):
        return {"name": name, "type": "ReLU", "bottom": [blob], "top": [blob],
                "relu_param": {"negative_slope": slope}}

    layers = [
        conv("c1", "image", 8, 3, 1), relu("r1", "c1"),
        {"name": "p1", "type": "Pooling", "bottom": ["c1"], "top": ["p1"],
         "pooling_param": {"pool": 0, "kernel_size": 2, "stride": 2}},
        conv("c2", "p1", 8, 3, 1, stride=[1]), relu("r2", "c2", 0.1),
        # ceil-and-clip pooling with pad: 11x16 -> 6x9
        {"name": "p2", "type": "Pooling", "bottom": ["c2"], "top": ["p2"],
         "pooling_param": {"pool": 0, "kernel_size": 3, "stride": 2, "pad": 1}},
    ]
    prev = {"L1": "p2", "L2": "p2"}
    for t in (1, 2):  # two dual-branch stages
        for br, n in (("L1", 4), ("L2", 3)):
            name = f"s{t}_{br}"
            layers += [conv(f"{name}_a", prev[br], 6, 7 if t == 2 else 3, 3 if t == 2 else 1),
                       relu(f"{name}_ra", f"{name}_a"),
                       conv(f"{name}_b", f"{name}_a", n, 1, 0, bias_term=(br == "L1"))]
            prev[br] = f"{name}_b"
        layers.append({"name": f"cat{t}", "type": "Concat",
                       "bottom": [prev["L2"], prev["L1"], "p2"], "top": [f"cat{t}"],
                       "concat_param": {"axis": 1}})
        prev = {"L1": f"cat{t}", "L2": f"cat{t}"}
    return {"input": ["image"], "input_dim": [2, 3, 22, 31], "layer": layers}


def test_narrow_net_matches_jax_net():
    import jax.numpy as jnp

    from caffe_rtpose_tpu.core.net import Net as JNet

    proto = _narrow_net()
    jnet = JNet(proto, phase="TEST", seed=1)
    rs = np.random.RandomState(9)
    for name in jnet.params:  # larger biases than the fillers give
        jnet.params[name] = [jnp.asarray(np.asarray(p) + (0.1 * rs.randn(*p.shape) if p.ndim == 1 else 0),
                                         jnp.float32) for p in jnet.params[name]]
    x = rs.rand(2, 3, 22, 31).astype(np.float32) - 0.5
    ref = jnet.forward({"image": x}, outputs=["cat1", "cat2", "p2"])

    tnet = Net(proto, device="cpu")
    assert tnet.load_weights(params_from_jax(jnet.params)) == 10
    assert tnet.blob_shapes["p2"] == (2, 8, 6, 9) == ref["p2"].shape
    assert tnet.output_names() == ["cat2"]
    with torch.inference_mode():
        got = tnet({"image": torch.from_numpy(x)}, outputs=["cat1", "cat2", "p2"])
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape == tnet.blob_shapes[k]
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-4, atol=1e-4)
    # prune_for keeps only what a blob needs
    assert [l.name for l in tnet.prune_for(["p1"])] == ["c1", "r1", "p1"]


def test_net_refuses_what_it_does_not_port():
    proto = _narrow_net()
    net = Net(proto, device="cpu")
    with pytest.raises(ValueError):
        net.load_weights({"c1": [np.zeros((8, 3, 3, 2), np.float32), np.zeros(8, np.float32)]})
    with pytest.raises(ValueError):
        net.load_weights({"c1": [np.zeros((8, 3, 3, 3), np.float32)]})
    assert net.load_weights({"no_such_layer": [np.zeros(1)]}) == 0
    bad = dict(proto, layer=proto["layer"] + [
        {"name": "d", "type": "NoSuchLayer", "bottom": ["cat2"], "top": ["cat2"]}])
    with pytest.raises(NotImplementedError):  # a type the registry lacks
        Net(bad, device="cpu")
    with pytest.raises(FileNotFoundError):  # a prototxt path is read, as in JAX
        Net("pose_deploy_linevec.prototxt", device="cpu")
    with pytest.raises(NotImplementedError):  # float32 and bfloat16 only
        Net(proto, device="cpu", dtype=torch.float16)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Net(_narrow_net())
