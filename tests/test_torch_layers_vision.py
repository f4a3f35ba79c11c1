"""The vision layer types of the port's registry against JAX
(``torch_zoo.run_case``: forward within 1e-5·max(1,|y|), gradients of
inputs and parameters within 1e-4 of each blob's largest), one small net a
case on the CPU: convolution (grouped, strided, dilated), deconvolution,
pooling (MAX, AVE with Caffe's border divisor, STOCHASTIC's test form,
global), inner product, LRN, BatchNorm, MVN, Im2col, SPP, Embed, Crop and
the CPM layers ImResize, Nms and Maximum."""

import numpy as np
import pytest
import torch

from torch_zoo import Case, rnd, run_case

X = rnd(2, 4, 7, 6, seed=1)


def one(t, key, param, x=X, top_count=1, **kw):
    tops = ["y"] if top_count == 1 else [f"y{i}" for i in range(top_count)]
    layer = {"name": "l", "type": t, "bottom": ["x"], "top": tops, key: param}
    return Case(f"{t}-{sorted(param.items())}", [layer], {"x": x}, **kw)


def conv(**p):
    return one("Convolution", "convolution_param", {"num_output": 6, "kernel_size": [3], **p})


def pool(**p):
    return one("Pooling", "pooling_param", p)


CASES = [
    conv(),
    conv(group=2, stride=[2], pad=[1]),
    conv(dilation=[2], bias_term=False),
    conv(kernel_h=3, kernel_w=2, stride_h=1, stride_w=2, pad_h=1, pad_w=0),
    one("Deconvolution", "convolution_param", {"num_output": 6, "kernel_size": [3],
                                               "stride": [2], "pad": [1], "group": 2}),
    one("Deconvolution", "convolution_param", {"num_output": 3, "kernel_size": [2],
                                               "bias_term": False}),
    pool(pool=0, kernel_size=3, stride=2),
    pool(pool=0, kernel_size=3, stride=2, pad=1),
    pool(pool=1, kernel_size=3, stride=2, pad=1),
    pool(pool=1, kernel_size=2, stride=2),
    pool(pool=2, kernel_size=3, stride=2),  # STOCHASTIC in TEST: the weighted average
    pool(pool=1, global_pooling=True),
    pool(pool=0, global_pooling=True),
    one("InnerProduct", "inner_product_param", {"num_output": 5}),
    one("InnerProduct", "inner_product_param", {"num_output": 5, "transpose": True}),
    one("InnerProduct", "inner_product_param", {"num_output": 3, "axis": 2}),
    one("LRN", "lrn_param", {"local_size": 3, "alpha": 0.5, "beta": 0.75, "k": 2.0}),
    one("LRN", "lrn_param", {"local_size": 5, "alpha": 1e-4, "beta": 0.75}),
    one("LRN", "lrn_param", {"local_size": 3, "alpha": 0.5, "norm_region": 1}),
    one("BatchNorm", "batch_norm_param", {"eps": 1e-3}, weights={
        "l": [np.abs(rnd(4, seed=2)) + 0.5, np.abs(rnd(4, seed=3)) + 0.5,
              np.array([2.0], np.float32)]}),
    one("BatchNorm", "batch_norm_param", {"eps": 1e-5}, phase="TRAIN"),
    one("MVN", "mvn_param", {}),
    one("MVN", "mvn_param", {"across_channels": True, "normalize_variance": False}),
    one("Im2col", "convolution_param", {"kernel_size": [3], "stride": [2], "pad": [1]}),
    one("SPP", "spp_param", {"pyramid_height": 3, "pool": 0}),
    one("SPP", "spp_param", {"pyramid_height": 2, "pool": 1}),
    Case("Embed", [{"name": "l", "type": "Embed", "bottom": ["i"], "top": ["y"],
                    "embed_param": {"num_output": 4, "input_dim": 7}}],
         {"i": np.array([[0, 3, 6], [2, 2, 5]], np.float32)}, no_grad=["i"]),
    Case("Crop", [{"name": "l", "type": "Crop", "bottom": ["x", "ref"], "top": ["y"],
                   "crop_param": {"axis": 2, "offset": [1, 2]}}],
         {"x": X, "ref": rnd(2, 4, 4, 3, seed=5)}),
    Case("ImResize", [{"name": "l", "type": "ImResize", "bottom": ["x"], "top": ["y"],
                       "imresize_param": {"factor": 2.0, "start_scale": 1.0,
                                          "scale_gap": 0.3}}],
         {"x": rnd(3, 4, 6, 5, seed=6)}),
    Case("Nms", [{"name": "l", "type": "Nms", "bottom": ["x"], "top": ["y"],
                  "nms_param": {"threshold": 0.5, "max_peaks": 4, "num_parts": 3}}],
         {"x": np.abs(rnd(1, 4, 12, 10, seed=7))}, grads=False),
    Case("Maximum", [{"name": "l", "type": "Maximum", "bottom": ["x"], "top": ["y"]}],
         {"x": X}, grads=False),
]


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_vision_layer_matches_jax(case):
    run_case(case)


def test_ave_pool_divides_by_the_padded_window_at_the_border():
    """Caffe's AVE divisor is the window clipped to the padded bounds, so
    the last row of a 3x3/2 pad-1 pool over 6x7 divides by 6 (the window
    hangs past the pad) and the last column by 9 (it ends inside the pad):
    checked by hand on ones, last row and column included."""
    from caffe_rtpose_tpu_torch.ops.nn import avg_pool2d

    x = torch.ones(1, 1, 6, 7)
    y = avg_pool2d(x, (3, 3), (2, 2), (1, 1))
    assert tuple(y.shape) == (1, 1, 4, 4)
    # windows start -1, 1, 3, 5 and end at min(start + 3, size + pad): rows
    # divide by 3, 3, 3, 2 (7 bounds the last), columns by 3 (8 bounds none);
    # the ones inside the input are 2, 3, 3, 1 a row and 2, 3, 3, 2 a column
    rows = np.array([3, 3, 3, 2.0])
    cols = np.array([3, 3, 3, 3.0])
    sums = np.outer([2, 3, 3, 1], [2, 3, 3, 2]).astype(np.float64)
    np.testing.assert_allclose(y[0, 0].numpy(), sums / np.outer(rows, cols), rtol=1e-6)


def test_stochastic_pool_train_samples_a_window_element():
    """STOCHASTIC in TRAIN: each output is an element of its window (ceil
    mode, no pad), drawn from the net's generator (the same seed draws the
    same), and the gradient goes to the sampled element alone."""
    from caffe_rtpose_tpu_torch.core.net import Net

    proto = {"input": ["x"], "input_shape": [{"dim": [2, 3, 7, 6]}],
             "layer": [{"name": "p", "type": "Pooling", "bottom": ["x"], "top": ["y"],
                        "pooling_param": {"pool": 2, "kernel_size": 3, "stride": 2}}]}
    x = torch.from_numpy(np.abs(rnd(2, 3, 7, 6, seed=8)) + 0.1)
    y = Net(proto, phase="TRAIN", device="cpu", seed=4).forward({"x": x})["y"]
    assert tuple(y.shape) == (2, 3, 3, 3)
    for i in range(3):
        for j in range(3):
            win = x[:, :, 2 * i: 2 * i + 3, 2 * j: 2 * j + 3].reshape(2, 3, -1)
            assert bool(((win == y[:, :, i, j, None]).any(-1)).all())
    net = Net(proto, phase="TRAIN", device="cpu", seed=4)
    assert torch.equal(net.forward({"x": x})["y"], y)
    din, _ = Net(proto, phase="TRAIN", device="cpu", seed=4).backward(
        {"x": x}, {"y": np.ones((2, 3, 3, 3), np.float32)})
    assert float(din["x"].sum()) == 54.0 and bool(((din["x"] == 0) | (din["x"] >= 1)).all())


def test_set_imresize_and_update_bn_stats_match_jax():
    """Net.set_imresize retargets the ImResize layers (the port's knob for
    SetStartScale/SetScaleGap/setTargetDimenions): equal to JAX's layer
    built with those parameters; update_bn_stats writes JAX's statistics."""
    from caffe_rtpose_tpu.core.net import Net as JNet

    from caffe_rtpose_tpu_torch.core.net import Net

    x = rnd(3, 4, 6, 5, seed=6)

    def proto(**p):
        return {"input": ["x"], "input_shape": [{"dim": [3, 4, 6, 5]}],
                "layer": [{"name": "r", "type": "ImResize", "bottom": ["x"], "top": ["y"],
                           "imresize_param": {"factor": 2.0, **p}}]}

    net = Net(proto(), device="cpu")
    net.set_imresize(start_scale=0.8, scale_gap=0.2, target=(9, 7))
    assert net.blob_shapes["y"] == (1, 4, 9, 7)
    got = net.forward({"x": torch.from_numpy(x)}, outputs=["y"])["y"].numpy()
    ref = JNet(proto(factor=0.0, target_spatial_height=9, target_spatial_width=7,
                     start_scale=0.8, scale_gap=0.2)).forward({"x": x}, outputs=["y"])["y"]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    bn = {"input": ["x"], "input_shape": [{"dim": [2, 4, 7, 6]}],
          "layer": [{"name": "bn", "type": "BatchNorm", "bottom": ["x"], "top": ["y"]}]}
    batches = [{"x": rnd(2, 4, 7, 6, seed=10 + i, scale=2.0, offset=1.0)} for i in range(3)]
    net, jnet = Net(bn, device="cpu"), JNet(bn)
    assert net.update_bn_stats(lambda i: batches[i], 3) == jnet.update_bn_stats(
        lambda i: batches[i], 3) == 1
    for a, b in zip(net.export_weights()["bn"], jnet.export_weights()["bn"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
