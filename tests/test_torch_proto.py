"""The port's model-file codec (caffe_rtpose_tpu_torch/proto: prototxt text,
the protobuf wire format, caffemodel files and the legacy V0/V1 upgrade
chain) against the JAX package's on the same inputs.

Tolerances: none.  The codecs are copies of one another, so text and bytes
must be identical, parsed and upgraded messages equal, and weights read
back bit for bit.
"""

import numpy as np
import pytest

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.proto import caffe_pb as j_pb
from caffe_rtpose_tpu.proto import caffemodel as j_caffemodel
from caffe_rtpose_tpu.proto import prototxt as j_prototxt
from caffe_rtpose_tpu.proto import upgrade as j_upgrade
from caffe_rtpose_tpu.proto import wire as j_wire
from caffe_rtpose_tpu_torch.core.net import Net, params_from_jax
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.proto import caffe_pb, caffemodel, prototxt, upgrade, wire

SMALL = {"image": (1, 3, 80, 128)}

# tests/test_upgrade_v0.py's V0 net: a padding layer, V0 type names and fields
V0_PROTOTXT = """
name: "v0_net"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 16 input_dim: 16
layers {
  layer { name: "pad1" type: "padding" pad: 2 }
  bottom: "data" top: "pad1"
}
layers {
  layer {
    name: "conv1" type: "conv" num_output: 4 kernelsize: 5 stride: 1
    group: 1 biasterm: true
    weight_filler { type: "gaussian" std: 0.1 }
    blobs_lr: 1.0 blobs_lr: 2.0 weight_decay: 1.0 weight_decay: 0.0
  }
  bottom: "pad1" top: "conv1"
}
layers { layer { name: "relu1" type: "relu" } bottom: "conv1" top: "conv1" }
layers {
  layer { name: "pool1" type: "pool" pool: AVE kernelsize: 2 stride: 2 }
  bottom: "conv1" top: "pool1"
}
layers {
  layer { name: "norm1" type: "lrn" local_size: 3 alpha: 2.0 beta: 0.5 }
  bottom: "pool1" top: "norm1"
}
layers {
  layer { name: "drop1" type: "dropout" dropout_ratio: 0.3 }
  bottom: "norm1" top: "norm1"
}
layers {
  layer { name: "fc1" type: "innerproduct" num_output: 7 biasterm: false
          weight_filler { type: "constant" value: 0.01 } }
  bottom: "norm1" top: "fc1"
}
layers { layer { name: "prob" type: "softmax" } bottom: "fc1" top: "prob" }
"""

V1_PROTOTXT = """
name: "v1_net"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 16 input_dim: 16
layers {
  name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  blobs_lr: 1.0 blobs_lr: 2.0 weight_decay: 1.0 weight_decay: 0.0
  convolution_param { num_output: 4 kernel_size: 3 pad: 1
                      weight_filler { type: "gaussian" std: 0.1 } }
}
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers {
  name: "pool1" type: POOLING bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 }
  include { phase: TEST }
}
layers { name: "d" type: DATA top: "x" data_param { source: "db" batch_size: 4 scale: 0.5 } }
"""


def assert_msgs_equal(a, b):
    """Two decoded messages equal: dicts and lists by structure, packed
    arrays (numpy views of the payload) by value and type."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            assert_msgs_equal(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_msgs_equal(x, y)
    else:
        assert type(a) is type(b) and a == b


def test_schema_is_a_copy():
    assert caffe_pb.SCHEMA.keys() == j_pb.SCHEMA.keys()
    for name, fields in j_pb.SCHEMA.items():
        assert {n: vars(f) for n, f in caffe_pb.SCHEMA[name].items()} == \
            {n: vars(f) for n, f in fields.items()}, name
    assert caffe_pb.PHASE == j_pb.PHASE and caffe_pb.V1_TO_V2_TYPE == j_pb.V1_TO_V2_TYPE


@pytest.mark.parametrize("model", ["COCO", "MPI"])
def test_deploy_prototxt_text_is_byte_identical(model, tmp_path):
    """dumps of the deploy graph is the JAX dumps, byte for byte, and both
    parsers read it to equal dicts; a file written by either reads back."""
    text = prototxt.dumps(make_pose_deploy_net(model))
    assert text == j_prototxt.dumps(j_make_net(model))
    assert_msgs_equal(prototxt.parse(text), j_prototxt.parse(text))
    path = str(tmp_path / "deploy.prototxt")
    prototxt.dump_file(make_pose_deploy_net(model), path)
    with open(path) as f:
        assert f.read() == text
    assert_msgs_equal(j_prototxt.parse_file(path), prototxt.parse_file(path))


def _net_with_blobs(seed):
    rs = np.random.RandomState(seed)
    layers = []
    for i, shape in enumerate([(4, 3, 3, 3), (7, 4, 1, 1)]):
        w = rs.randn(*shape).astype(np.float32)
        b = rs.randn(shape[0]).astype(np.float32)
        layers.append({"name": f"conv{i}", "type": "Convolution", "bottom": ["x"], "top": ["y"],
                       "convolution_param": {"num_output": shape[0], "kernel_size": [shape[2]]},
                       "blobs": [j_caffemodel.array_to_blob(w), j_caffemodel.array_to_blob(b)]})
    return {"name": "blobs", "input": ["x"], "input_dim": [1, 3, 8, 8], "layer": layers}


def test_wire_encode_is_byte_identical():
    msg = _net_with_blobs(0)
    raw = wire.encode(msg, caffe_pb.SCHEMA, "NetParameter")
    assert raw == j_wire.encode(msg, j_pb.SCHEMA, "NetParameter")
    got = wire.decode(raw, caffe_pb.SCHEMA, "NetParameter")
    assert_msgs_equal(got, j_wire.decode(raw, j_pb.SCHEMA, "NetParameter"))
    # packed floats decode as read-only views of the buffer
    data = got["layer"][0]["blobs"][0]["data"]
    assert isinstance(data, np.ndarray) and not data.flags.writeable


def test_unknown_fields_are_skipped():
    """A field number the schema lacks is skipped by both decoders (as
    protobuf keeps unknown fields out of the message), and an unknown
    prototxt scalar likewise."""
    raw = wire.encode(_net_with_blobs(1), caffe_pb.SCHEMA, "NetParameter")
    unknown = (wire._encode_varint((999 << 3) | 0) + wire._encode_varint(42)
               + wire._encode_varint((998 << 3) | 2) + wire._encode_varint(3) + b"abc")
    got = wire.decode(unknown + raw + unknown, caffe_pb.SCHEMA, "NetParameter")
    assert_msgs_equal(got, wire.decode(raw, caffe_pb.SCHEMA, "NetParameter"))
    assert_msgs_equal(got, j_wire.decode(unknown + raw + unknown, j_pb.SCHEMA, "NetParameter"))
    text = 'name: "t" not_a_field: 3\nlayer { name: "c" type: "ReLU" bogus: 1.5 }\n'
    assert_msgs_equal(prototxt.parse(text), j_prototxt.parse(text))
    assert prototxt.parse(text) == {"name": "t", "layer": [{"name": "c", "type": "ReLU"}]}


def _jax_net(model="COCO", stages=1, seed=3):
    jnet = JNet(j_make_net(model, stages=stages), input_shapes=SMALL)
    rs = np.random.RandomState(seed)
    jnet.params = {k: [np.asarray(rs.randn(*np.shape(p)), np.float32) for p in v]
                   for k, v in jnet.params.items()}
    return jnet


def test_jax_caffemodel_loads_into_the_port(tmp_path):
    jnet = _jax_net()
    path = str(tmp_path / "jax.caffemodel")
    jnet.save_caffemodel(path)
    want = jnet.export_weights()
    read = caffemodel.load_weights(path)
    assert read.keys() == want.keys()
    for k in want:
        for a, b in zip(read[k], want[k]):
            assert a.dtype == np.float32 and np.array_equal(a, b)
    net = Net(make_pose_deploy_net("COCO", stages=1), input_shapes=SMALL, device="cpu")
    assert net.load_weights(path) == len(want)
    got = net.export_weights()
    assert list(got) == list(want)
    for k in want:
        assert all(np.array_equal(a, b) for a, b in zip(got[k], want[k]))


def test_port_caffemodel_loads_into_jax(tmp_path):
    """The reverse, and the two files are the same bytes."""
    jnet = _jax_net(seed=4)
    net = Net(make_pose_deploy_net("COCO", stages=1), input_shapes=SMALL, device="cpu")
    net.load_weights(params_from_jax(jnet.params))
    mine, theirs = str(tmp_path / "port.caffemodel"), str(tmp_path / "jax.caffemodel")
    net.save_caffemodel(mine)
    jnet.save_caffemodel(theirs)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    fresh = JNet(j_make_net("COCO", stages=1), input_shapes=SMALL)
    assert fresh.load_weights(mine) == len(net.convs)
    want = net.export_weights()
    for k, blobs in fresh.export_weights().items():
        assert all(np.array_equal(a, b) for a, b in zip(blobs, want[k]))


@pytest.mark.parametrize("upgrade_input", [False, True])
def test_v0_net_upgrades_as_in_jax(upgrade_input):
    text = V0_PROTOTXT
    mine = upgrade.upgrade_net_as_needed(prototxt.parse(text), upgrade_input=upgrade_input)
    theirs = j_upgrade.upgrade_net_as_needed(j_prototxt.parse(text), upgrade_input=upgrade_input)
    assert "layers" not in mine and len(mine["layer"]) >= 7
    assert_msgs_equal(mine, theirs)


def test_v1_net_upgrades_as_in_jax(tmp_path):
    """Text V1 (enum layer types, blobs_lr, a data layer's transform fields)
    and a binary V1 caffemodel with blobs."""
    mine = upgrade.upgrade_net_as_needed(prototxt.parse(V1_PROTOTXT))
    theirs = j_upgrade.upgrade_net_as_needed(j_prototxt.parse(V1_PROTOTXT))
    assert [l["type"] for l in mine["layer"]] == ["Convolution", "ReLU", "Pooling", "Data"]
    assert_msgs_equal(mine, theirs)
    w = np.random.RandomState(2).randn(4, 3, 3, 3).astype(np.float32)
    old = {"name": "old", "layers": [
        {"name": "conv1", "type": caffe_pb.V1_LAYER_TYPE["CONVOLUTION"],
         "blobs": [caffemodel.array_to_blob(w), caffemodel.array_to_blob(w[:, 0, 0, 0])],
         "blobs_lr": [1.0, 2.0]}]}
    path = str(tmp_path / "v1.caffemodel")
    with open(path, "wb") as f:
        f.write(wire.encode(old, caffe_pb.SCHEMA, "NetParameter"))
    assert_msgs_equal(caffemodel.load_net_parameter(path), j_caffemodel.load_net_parameter(path))
    got = caffemodel.load_weights(path)
    assert np.array_equal(got["conv1"][0], w) and got["conv1"][1].shape == (4,)


def test_legacy_net_builds_in_the_port():
    """Net runs the upgrade chain on a copy of a legacy net: the V1 net (its
    Data layer excluded by nothing, so the net opens its source, which does
    not exist here) and the same net without it."""
    msg = prototxt.parse(V1_PROTOTXT)
    with pytest.raises(OSError, match="does not exist"):
        Net(msg, device="cpu")
    msg["layers"] = msg["layers"][:3]
    before = prototxt.dumps(msg)
    net = Net(msg, device="cpu")
    assert prototxt.dumps(msg) == before  # the caller's dict is untouched
    assert [l.name for l in net.layers] == ["conv1", "relu1", "pool1"]
    assert net.blob_shapes["pool1"] == (1, 4, 8, 8)


def test_upgrade_tool(tmp_path):
    """``upgrade net_text`` and ``net_binary`` write what the JAX tool
    writes."""
    from caffe_rtpose_tpu.tools.upgrade_proto import main as j_main
    from caffe_rtpose_tpu_torch.__main__ import main

    src = tmp_path / "v0.prototxt"
    src.write_text(V0_PROTOTXT)
    assert main(["upgrade", "net_text", str(src), str(tmp_path / "a.prototxt")]) == 0
    assert j_main(["net_text", str(src), str(tmp_path / "b.prototxt")]) == 0
    assert (tmp_path / "a.prototxt").read_text() == (tmp_path / "b.prototxt").read_text()
    binary = tmp_path / "v0.caffemodel"
    binary.write_bytes(wire.encode(prototxt.parse(V0_PROTOTXT), caffe_pb.SCHEMA, "NetParameter"))
    assert main(["upgrade", "net_binary", str(binary), str(tmp_path / "a.caffemodel")]) == 0
    assert j_main(["net_binary", str(binary), str(tmp_path / "b.caffemodel")]) == 0
    assert (tmp_path / "a.caffemodel").read_bytes() == (tmp_path / "b.caffemodel").read_bytes()
    solver = tmp_path / "solver.prototxt"
    solver.write_text('net: "n.prototxt"\nbase_lr: 0.01\nsolver_type: NESTEROV\n')
    assert main(["upgrade", "solver_text", str(solver), str(tmp_path / "s.prototxt")]) == 0
    assert 'type: "Nesterov"' in (tmp_path / "s.prototxt").read_text()
