"""The port's net tooling against JAX's: ``core/net_spec.py`` (NetSpec, L,
params), ``coord_map.py`` (coord_map_from_to, crop_params on the COCO
trunk and a small FCN-style net), ``proto/gen_proto.py`` and
``proto/caffe_pb2.py`` (the same generated schema; protoc messages that
read the port's prototxt), ``core/insert_splits.py`` and
``ops/cpm_legacy.py`` (the crops and gaussian, within 1e-6)."""

import shutil

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu_torch.core.net_spec import L, NetSpec, params


def build_spec(L_, NetSpec_, P):
    n = NetSpec_("spec")
    n.data = L_.Input(shape=dict(dim=[1, 3, 20, 24]))
    n.conv1 = L_.Convolution(n.data, num_output=4, kernel_size=3, pad=1)
    n.relu1 = L_.ReLU(n.conv1, in_place=True)
    n.pool1 = L_.Pooling(n.relu1, pool=P.Pooling.MAX, kernel_size=2, stride=2)
    n.a, n.b = L_.Slice(n.pool1, ntop=2, slice_point=[2])
    n.sum = L_.Eltwise(n.a, n.b, operation=P.Eltwise.SUM, coeff=[1.0, -1.0])
    n.fc = L_.InnerProduct(n.sum, num_output=3)
    n.silence = L_.Silence(n.fc, ntop=0)
    return n


def test_net_spec_matches_jax():
    from caffe_rtpose_tpu.core import net_spec as J

    from caffe_rtpose_tpu_torch.core.net import Net

    ours, theirs = build_spec(L, NetSpec, params), build_spec(J.L, J.NetSpec, J.params)
    assert ours.to_proto() == theirs.to_proto()
    assert ours.to_prototxt() == theirs.to_prototxt()
    net = Net(ours.to_prototxt(), device="cpu")
    assert net.blob_shapes["sum"] == (1, 2, 10, 12) and net.blob_shapes["fc"] == (1, 3)
    assert params.Pooling.AVE == 1 and params.Eltwise.MAX == 2


def _jax_views(proto):
    """What JAX's coord_map reads of a net (its layer views), without
    building the JAX net."""
    from types import SimpleNamespace

    from caffe_rtpose_tpu.proto import caffe_pb as jpb

    return SimpleNamespace(layer_views=[jpb.view(l, "LayerParameter") for l in proto["layer"]])


def test_coord_map_matches_jax():
    from caffe_rtpose_tpu import coord_map as jcm

    from caffe_rtpose_tpu_torch import coord_map as cm
    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net

    proto = make_pose_deploy_net("COCO", stages=1)
    proto["input_dim"] = [1, 3, 64, 64]
    names = [l["name"] for l in proto["layer"]]  # the VGG trunk alone
    proto["layer"] = proto["layer"][: names.index("relu4_4_CPM") + 1]
    got = cm.coord_map_from_to(Net(proto, device="cpu"), "conv4_4_CPM", "image")
    assert got == jcm.coord_map_from_to(_jax_views(proto), "conv4_4_CPM", "image")
    fcn = {"input": ["x"], "input_dim": [1, 3, 32, 32], "layer": [
        {"name": "c", "type": "Convolution", "bottom": ["x"], "top": ["c"],
         "convolution_param": {"num_output": 2, "kernel_size": [3], "pad": [1]}},
        {"name": "p", "type": "Pooling", "bottom": ["c"], "top": ["p"],
         "pooling_param": {"kernel_size": 2, "stride": 2}},
        {"name": "d", "type": "Deconvolution", "bottom": ["p"], "top": ["d"],
         "convolution_param": {"num_output": 2, "kernel_size": [4], "stride": [2], "pad": [1]}},
        {"name": "r", "type": "ReLU", "bottom": ["d"], "top": ["d"]}]}
    ours, theirs = Net(fcn, device="cpu"), _jax_views(fcn)
    assert cm.coord_map_from_to(ours, "d", "x") == jcm.coord_map_from_to(theirs, "d", "x")
    assert cm.crop_params(ours, "d", "x") == jcm.crop_params(theirs, "d", "x")
    with pytest.raises(RuntimeError):
        cm.coord_map_from_to(ours, "d", "nowhere")


def test_gen_proto_matches_jax():
    from caffe_rtpose_tpu.proto import gen_proto as J

    from caffe_rtpose_tpu_torch.proto import gen_proto

    assert gen_proto.generate_proto() == J.generate_proto()
    assert gen_proto.schema_digest() == J.schema_digest()


@pytest.mark.skipif(shutil.which("protoc") is None, reason="caffe_pb2 needs protoc on PATH")
def test_caffe_pb2_reads_the_ports_prototxt():
    from google.protobuf import text_format

    from caffe_rtpose_tpu_torch.proto import caffe_pb2

    msg = caffe_pb2.NetParameter()
    text_format.Merge(build_spec(L, NetSpec, params).to_prototxt(), msg)
    assert [l.type for l in msg.layer][:3] == ["Input", "Convolution", "ReLU"]
    assert msg.layer[5].eltwise_param.coeff[1] == -1.0


def test_insert_splits_matches_jax():
    from caffe_rtpose_tpu.core.insert_splits import insert_splits as J

    from caffe_rtpose_tpu_torch.core.insert_splits import insert_splits
    from caffe_rtpose_tpu_torch.core.net import Net

    proto = build_spec(L, NetSpec, params).to_proto()
    proto["layer"].append({"name": "fc2", "type": "InnerProduct", "bottom": ["sum"],
                           "top": ["fc2"], "inner_product_param": {"num_output": 2}})
    out = insert_splits(proto)
    assert out == J(proto)
    assert any(l["type"] == "Split" for l in out["layer"])
    Net(out, device="cpu")  # the rewritten net builds


def test_cpm_legacy_matches_jax():
    import jax.numpy as jnp

    from caffe_rtpose_tpu.ops import cpm_legacy as J

    from caffe_rtpose_tpu_torch.ops import cpm_legacy

    img = np.random.RandomState(1).rand(3, 30, 40).astype(np.float32)
    centers = np.array([[5.4, 3.6], [20.0, 15.5], [39.7, 29.2]], np.float32)
    got = cpm_legacy.fill_pose_net(torch.from_numpy(img), torch.from_numpy(centers), 16).numpy()
    ref = np.asarray(J.fill_pose_net(jnp.asarray(img), jnp.asarray(centers), 16))
    assert got.shape == ref.shape == (3, 4, 16, 16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cpm_legacy.fill_image(torch.from_numpy(img), centers[1], 9).numpy(),
                               np.asarray(J.fill_image(jnp.asarray(img), jnp.asarray(centers[1]),
                                                       9)), atol=0)
