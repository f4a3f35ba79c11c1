"""The neuron and per-channel layer types of the port's registry against
JAX (``torch_zoo.run_case``: forward within 1e-5·max(1,|y|), gradients of
inputs and parameters within 1e-4 of each blob's largest), one small net a
case on the CPU; Dropout's TRAIN draw by its kept share and scale."""

import numpy as np
import pytest
import torch

from torch_zoo import Case, rnd, run_case

X = rnd(2, 3, 5, 4, seed=1)
POS = np.abs(rnd(2, 3, 5, 4, seed=2)) + 0.1


def one(t, param=None, key=None, x=X, **kw):
    layer = {"name": "l", "type": t, "bottom": ["x"], "top": ["y"]}
    if param is not None:
        layer[key] = param
    return Case(f"{t}-{key}-{param}" if param else t, [layer], {"x": x}, **kw)


CASES = [
    one("ReLU"),
    one("ReLU", {"negative_slope": 0.1}, "relu_param"),
    one("Sigmoid"),
    one("TanH"),
    one("AbsVal"),
    one("BNLL"),
    one("ELU", {"alpha": 0.7}, "elu_param"),
    one("Power", {"power": 2.0, "scale": 0.5, "shift": 1.0}, "power_param"),
    one("Power", {"power": 1.0, "scale": -2.0, "shift": 0.5}, "power_param"),
    one("Exp", {"base": -1.0, "scale": 0.5, "shift": 0.1}, "exp_param"),
    one("Exp", {"base": 2.0, "scale": 0.5}, "exp_param"),
    one("Log", {"base": -1.0, "scale": 2.0, "shift": 0.5}, "log_param", x=POS),
    one("Log", {"base": 10.0}, "log_param", x=POS),
    one("Threshold", {"threshold": 0.2}, "threshold_param", grads=False),
    one("PReLU"),
    one("PReLU", {"channel_shared": True}, "prelu_param"),
    one("Dropout", {"dropout_ratio": 0.3}, "dropout_param"),  # TEST: the identity
    one("Scale", {"axis": 1, "num_axes": 1, "bias_term": True}, "scale_param"),
    Case("Scale-two-bottoms",
         [{"name": "l", "type": "Scale", "bottom": ["x", "g"], "top": ["y"],
           "scale_param": {"axis": 1}}], {"x": X, "g": rnd(3, 5, seed=3)}),
    one("Bias", {"axis": 1, "num_axes": 2}, "bias_param"),
    Case("Bias-two-bottoms",
         [{"name": "l", "type": "Bias", "bottom": ["x", "b"], "top": ["y"]}],
         {"x": X, "b": rnd(3, seed=4)}),
]


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_neuron_layer_matches_jax(case):
    run_case(case)


@pytest.mark.parametrize("ratio", [0.5, 0.3])
def test_dropout_train_keeps_its_share_scaled(ratio):
    """In TRAIN each element is kept with probability 1 - ratio, from the
    net's generator, and scaled by 1/(1 - ratio): over 1e5 elements the kept
    share within 0.01 of 1 - ratio, every kept value exactly x/(1 - ratio);
    the same seed draws the same mask; the gradient is the mask's scale."""
    from caffe_rtpose_tpu_torch.core.net import Net

    proto = {"input": ["x"], "input_shape": [{"dim": [10, 10, 10, 100]}],
             "layer": [{"name": "d", "type": "Dropout", "bottom": ["x"], "top": ["y"],
                        "dropout_param": {"dropout_ratio": ratio}}]}
    x = torch.from_numpy(np.abs(rnd(10, 10, 10, 100, seed=6)) + 1.0)
    y = Net(proto, phase="TRAIN", device="cpu", seed=3).forward({"x": x})["y"]
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - ratio)) < 0.01
    assert torch.equal(y[kept], (x / (1 - ratio))[kept])
    y2 = Net(proto, phase="TRAIN", device="cpu", seed=3).forward({"x": x})["y"]
    assert torch.equal(y, y2)
    net = Net(proto, phase="TRAIN", device="cpu", seed=3)
    din, _ = net.backward({"x": x}, {"y": np.ones(x.shape, np.float32)})
    assert torch.equal(din["x"] != 0, kept)
    assert torch.allclose(din["x"][kept], torch.tensor(1 / (1 - ratio)))
