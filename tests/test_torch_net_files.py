"""The port's Net and PoseEstimator built from model files: a prototxt path,
prototxt text or a dict give the same graph; include/exclude rules over
phase, stage and level keep the layers the JAX Net keeps; weights read from
a caffemodel file are the weights that were written, so what the net and
the estimator compute does not change (compared bit for bit), and the
concat_stage7 golden is reproduced through a file round trip (the
tolerances of tests/test_torch_net.py's golden test)."""

import os

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu_torch.core.net import Net
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
from caffe_rtpose_tpu_torch.proto import prototxt

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "concat_stage7_seed42.npz")
RES = (128, 80)

RULES = """
name: "rules"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
layer { name: "train" type: "ReLU" bottom: "data" top: "data" include { phase: TRAIN } }
layer { name: "test" type: "ReLU" bottom: "data" top: "data" include { phase: TEST } }
layer { name: "not_test" type: "ReLU" bottom: "data" top: "data" exclude { phase: TEST } }
layer { name: "deploy" type: "ReLU" bottom: "data" top: "data" include { stage: "deploy" } }
layer { name: "no_deploy" type: "ReLU" bottom: "data" top: "data"
        include { not_stage: "deploy" } }
layer { name: "level1" type: "ReLU" bottom: "data" top: "data" include { min_level: 1 } }
layer { name: "level0" type: "ReLU" bottom: "data" top: "data" include { max_level: 0 } }
layer { name: "not_xy" type: "ReLU" bottom: "data" top: "data"
        exclude { stage: "x" stage: "y" } }
layer { name: "test_x_or_2" type: "ReLU" bottom: "data" top: "data"
        include { phase: TEST stage: "x" } include { min_level: 2 } }
layer { name: "not_neg" type: "ReLU" bottom: "data" top: "data" exclude { max_level: -1 } }
layer { name: "pool" type: "Pooling" bottom: "data" top: "pool"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
"""

STATE = 'state { stage: "x" level: 1 }\n'

CASES = [  # (phase, stages, level)
    ("TEST", (), None), ("TRAIN", (), None), ("TEST", ("deploy",), None),
    ("TEST", ("x",), None), ("TEST", ("x", "y"), None), ("TRAIN", ("x",), 0),
    ("TEST", (), 1), ("TEST", (), 2), ("TEST", (), -1), ("TRAIN", ("y", "deploy"), 3),
    ("TEST", (), 0),
]


@pytest.fixture(autouse=True)
def _torch_native_cpu_conv():
    """As tests/test_torch_net.py's golden: torch's own CPU convolution."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def _layers(net):
    return [(l.name, l.type, l.bottoms, l.tops, l.param) for l in net.layers]


def test_net_from_path_text_and_dict(tmp_path):
    proto = make_pose_deploy_net("COCO", stages=2)
    path = str(tmp_path / "deploy.prototxt")
    prototxt.dump_file(proto, path)
    with open(path) as f:
        text = f.read()
    nets = [Net(p, input_shapes={"image": (1, 3, *RES[::-1])}, device="cpu")
            for p in (proto, text, path)]
    for net in nets[1:]:
        assert _layers(net) == _layers(nets[0])
        assert net.blob_shapes == nets[0].blob_shapes
        assert {k: (l.type, l.bottoms, l.param) for k, l in net.post_layers.items()} == \
            {k: (l.type, l.bottoms, l.param) for k, l in nets[0].post_layers.items()}
        assert net.name == nets[0].name
    # a field the file leaves out takes the schema's default
    trimmed = text.replace("    max_peaks: 64\n", "").replace("    factor: 8.0\n", "")
    assert trimmed != text
    est = PoseEstimator(trimmed, net_resolution=RES, device="cpu")
    assert est.max_peaks == 20 and est.target_hw == (368, 368)


@pytest.mark.parametrize("with_state", [False, True], ids=["no_state", "file_state"])
@pytest.mark.parametrize("phase,stages,level", CASES)
def test_phase_stage_level_rules_follow_jax(with_state, phase, stages, level):
    text = (STATE if with_state else "") + RULES
    jnet = JNet(text, phase=phase, stages=stages, level=level)
    want = [lv.name for lv in jnet.layer_views]
    net = Net(text, phase=phase, stages=stages, level=level, device="cpu")
    assert [l.name for l in net.layers] == want
    assert net.blob_shapes["pool"] == (1, 3, 4, 4)


def test_rules_keep_a_layer_the_port_cannot_build():
    """Filtering runs first: a layer type the port lacks raises only when
    the rules keep it."""
    text = RULES + ('layer { name: "drop" type: "NoSuchLayer" bottom: "pool" top: "pool" '
                    'include { phase: TRAIN } }\n')
    assert [l.name for l in Net(text, device="cpu").layers][-1] == "pool"
    with pytest.raises(NotImplementedError):
        Net(text, phase="TRAIN", device="cpu")


def _golden_weights(net):
    """tests/test_torch_net.py's draws: RandomState(42), sorted layer names,
    JAX HWIO shapes, turned to OIHW; then the input."""
    rs = np.random.RandomState(42)
    weights = {}
    for name in sorted(net.convs.keys()):
        cout, cin, kh, kw = net.convs[name].weight.shape
        w_hwio = rs.randn(kh, kw, cin, cout).astype(np.float32) * 0.05
        weights[name] = [w_hwio.transpose(3, 2, 0, 1), rs.randn(cout).astype(np.float32) * 0.05]
    return weights, rs.rand(1, 3, 80, 128).astype(np.float32) - 0.5


def test_concat_stage7_golden_through_files(tmp_path):
    blob = np.load(GOLDEN)
    shapes = {"image": (1, 3, 80, 128)}
    by_dict = Net(make_pose_deploy_net(), input_shapes=shapes, device="cpu")
    weights, x = _golden_weights(by_dict)
    np.testing.assert_allclose(x, blob["x"], atol=0)
    assert by_dict.load_weights(weights) == 92
    proto_path, model_path = str(tmp_path / "deploy.prototxt"), str(tmp_path / "w.caffemodel")
    prototxt.dump_file(make_pose_deploy_net(), proto_path)
    by_dict.save_caffemodel(model_path)
    by_file = Net(proto_path, input_shapes=shapes, device="cpu")
    assert by_file.load_weights(model_path) == 92
    with torch.inference_mode():
        a = by_dict({"image": torch.from_numpy(x)})["concat_stage7"]
        b = by_file({"image": torch.from_numpy(x)})["concat_stage7"]
    assert torch.equal(a, b)
    np.testing.assert_allclose(b.numpy(), blob["y"], rtol=2e-4, atol=200)


@pytest.mark.parametrize("kw", [dict(), dict(batch=2, pair_cap=8, dtype=torch.bfloat16)],
                         ids=["f32", "bf16_batch2"])
def test_estimator_from_files_equals_estimator_from_dicts(tmp_path, kw):
    proto = make_pose_deploy_net("COCO", stages=2)
    rs = np.random.RandomState(11)
    ref_net = Net(proto, device="cpu")
    weights = {name: [rs.randn(*c.weight.shape).astype(np.float32)
                      * np.sqrt(2.0 / np.prod(c.weight.shape[1:])),
                      rs.randn(c.cout).astype(np.float32) * 0.05]
               for name, c in ref_net.convs.items()}
    ref_net.load_weights(weights)
    proto_path, model_path = str(tmp_path / "deploy.prototxt"), str(tmp_path / "w.caffemodel")
    prototxt.dump_file(proto, proto_path)
    ref_net.save_caffemodel(model_path)
    cfg = dict(net_resolution=RES, input_u8=True, device="cpu", **kw)
    by_dict = PoseEstimator(proto, weights=weights, **cfg)
    by_file = PoseEstimator(proto_path, weights=model_path, **cfg)
    shape = by_dict.input_shape() if by_dict.batch == 1 else (by_dict.batch, *by_dict.input_shape())
    x = (rs.rand(*shape) * 255).astype(np.uint8)
    a = by_dict.run_device(x, nms_threshold=-1.0)["packed"]
    b = by_file.run_device(x, nms_threshold=-1.0)["packed"]
    assert torch.equal(a, b)
    rows = by_file.fetch_batch({"packed": b})
    assert sum(int(r[0][:, 0, 0].sum()) for r in rows) > 0
