"""The port's pycaffe facade (``caffe_rtpose_tpu_torch/api.py``) against the
JAX facade on the CPU: the layer type list, a narrow CaffeNet-shaped net's
forward, blobs, parameters and backward (forward within 1e-5·max(1,|y|),
diffs within 1e-4 of each blob's largest), the net surface (layers, names,
copy_from/save, share_with, reshape, forward_all), the io helpers
(Transformer, oversample, load_image, blobproto and datum), draw, the
Classifier and ``classify`` CLI on PNGs, and SGDSolver with a test net."""

import os
import subprocess
import sys

import numpy as np
import pytest

from caffe_rtpose_tpu_torch import api
from caffe_rtpose_tpu_torch.pipeline.image_io import encode_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def cpu_mode():
    api.set_mode_cpu()
    yield
    api.set_mode_gpu()


def narrow_caffenet(batch=2, crop=35, classes=7):
    """CaffeNet's layer types at small widths (the deploy form)."""
    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet_deploy

    net = make_caffenet_deploy(batch=batch, crop=crop, num_classes=classes)
    widths = {"conv1": 8, "conv2": 8, "conv3": 12, "conv4": 12, "conv5": 8, "fc6": 16, "fc7": 16}
    for l in net["layer"]:
        p = l.get("convolution_param") or l.get("inner_product_param")
        if l["name"] in widths:
            p["num_output"] = widths[l["name"]]
        if l["name"] == "conv1":
            p["kernel_size"], p["stride"] = [5], [2]
    return net


def weights_for(jnet, seed=3):
    rs = np.random.RandomState(seed)
    return {impl.name: [(rs.randn(*pi.caffe_shape) * (0.3 if len(pi.caffe_shape) > 1 else 0.1))
                        .astype(np.float32) for pi in impl.params]
            for impl in jnet._net.impls if impl.params}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    from caffe_rtpose_tpu import api as japi

    work = tmp_path_factory.mktemp("api")
    proto = narrow_caffenet()
    jnet = japi.Net(proto, japi.TEST)
    w = weights_for(jnet)
    jnet._net.load_weights(w)
    jnet._refresh_params()
    jnet.save(str(work / "w.caffemodel"))
    net = api.Net(proto, str(work / "w.caffemodel"), api.TEST)
    return work, proto, jnet, net


def close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= tol(b)), float(np.abs(a - b).max())


def fwd(b):  # forward: 1e-5 * max(1, |y|)
    return 1e-5 * np.maximum(1.0, np.abs(b))


def grad(b):  # diffs: 1e-4 of the blob's largest
    return 1e-4 * max(float(np.abs(b).max()), 1e-6)


def test_layer_type_list_equals_jax():
    from caffe_rtpose_tpu import api as japi

    assert api.layer_type_list() == japi.layer_type_list()
    assert len(api.layer_type_list()) == 65


def test_every_registered_type_has_a_case():
    """Each of the 65 types has a case against JAX: the 59 layer types in
    the five test_torch_layers_* files, the 6 data layers in
    test_torch_data_layers.py."""
    import test_torch_data_layers as data
    import test_torch_layers_loss as loss
    import test_torch_layers_neuron as neuron
    import test_torch_layers_recurrent as recurrent
    import test_torch_layers_shape as shape
    import test_torch_layers_vision as vision

    from caffe_rtpose_tpu_torch.core.data_layers import DATA_LAYER_TYPES

    covered = {l["type"] for m in (neuron, vision, loss, shape, recurrent) for c in m.CASES
               for l in c.layers}
    if hasattr(shape, "test_hdf5_output_appends_like_jax"):  # a file output, its own test
        covered.add("HDF5Output")
    tested = {n[len("test_"):].split("_")[0] for n in dir(data) if n.startswith("test_")}
    assert {"data", "image", "memory", "hdf5", "window", "cpm"} <= tested
    assert covered | set(DATA_LAYER_TYPES) == set(api.layer_type_list())


def test_facade_starts_in_gpu_mode():
    code = "from caffe_rtpose_tpu_torch import api; print(api.device())"
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.stdout.strip() == "cuda:0", res.stderr


def test_forward_blobs_params_backward_match_jax(pair):
    _, _, jnet, net = pair
    x = np.random.RandomState(4).rand(2, 3, 35, 35).astype(np.float32)
    assert net.inputs == jnet.inputs and net.outputs == jnet.outputs == ["prob"]
    got, ref = net.forward(data=x), jnet.forward(data=x)
    close(got["prob"], ref["prob"], fwd)
    for name in ("conv1", "norm1", "pool2", "conv5", "fc6", "fc8"):
        close(net.blobs[name].data, jnet.blobs[name].data, fwd)
    for name, blobs in jnet.params.items():
        for a, b in zip(net.params[name], blobs):
            np.testing.assert_array_equal(a.data, b.data)
    d = np.random.RandomState(5).randn(2, 7).astype(np.float32)
    gi, gj = net.backward(prob=d), jnet.backward(prob=d)
    close(gi["data"], gj["data"], grad)
    for name, blobs in jnet.params.items():
        for a, b in zip(net.params[name], blobs):
            close(a.diff, b.diff, grad)
    assert [l.type for l in net.layers] == [l.type for l in jnet.layers]
    assert net.top_names == jnet.top_names and net.bottom_names == jnet.bottom_names
    assert net._layer_names == jnet._layer_names and list(net.layer_dict) == list(jnet.layer_dict)


def test_pose_graph_outputs_and_forward_match_jax(tmp_path):
    """A pose deploy graph (the VGG trunk, one stage, ImResize and Nms) at
    32x48: the facade's outputs are the Nms top, as JAX's, and forward()
    runs the ImResize and Nms layers: the peak counts exact, the peaks'
    coordinates and scores and the low-res maps within 1e-5·max(1,|y|)."""
    from caffe_rtpose_tpu import api as japi
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net

    proto = make_pose_deploy_net("COCO", stages=1, input_dim=(1, 3, 32, 48))
    jnet = japi.Net(proto, japi.TEST)
    rs = np.random.RandomState(8)
    w = {impl.name: [(rs.randn(*pi.caffe_shape) / np.sqrt(np.prod(pi.caffe_shape[1:]))
                      if len(pi.caffe_shape) > 1 else 0.1 * rs.randn(*pi.caffe_shape))
                     .astype(np.float32) for pi in impl.params]
         for impl in jnet._net.impls if impl.params}
    jnet._net.load_weights(w)
    jnet._refresh_params()
    jnet.save(str(tmp_path / "pose.caffemodel"))
    net = api.Net(proto, str(tmp_path / "pose.caffemodel"), api.TEST)
    assert net.outputs == jnet.outputs == ["joints"]
    x = rs.rand(1, 3, 32, 48).astype(np.float32) - 0.5
    got, ref = net.forward(blobs=["concat_stage2"], image=x), jnet.forward(
        blobs=["concat_stage2"], image=x)
    assert list(got) == list(ref) == ["joints", "concat_stage2"]
    close(got["concat_stage2"], ref["concat_stage2"], fwd)
    counts = ref["joints"][0, :, 0, 0]
    assert counts.sum() > 0
    np.testing.assert_array_equal(got["joints"][0, :, 0, 0], counts)
    close(got["joints"], ref["joints"], fwd)


def test_param_edits_write_through_and_save(pair, tmp_path):
    _, proto, _, net = pair
    x = np.random.RandomState(6).rand(2, 3, 35, 35).astype(np.float32)
    before = net.forward(data=x)["prob"].copy()
    net.params["fc8"][1].data[...] += 1.0  # a bias shift leaves the softmax alone
    np.testing.assert_allclose(net.forward(data=x)["prob"], before, atol=1e-6)
    net.params["fc8"][1].data[0] += 5.0
    assert not np.allclose(net.forward(data=x)["prob"], before)
    net.save(str(tmp_path / "edited.caffemodel"))
    other = api.Net(proto, str(tmp_path / "edited.caffemodel"), api.TEST)
    np.testing.assert_array_equal(other.forward(data=x)["prob"], net.forward(data=x)["prob"])
    fresh = api.Net(proto, api.TEST)
    fresh.share_with(net)
    np.testing.assert_array_equal(fresh.forward(data=x)["prob"], net.forward(data=x)["prob"])
    net.params["fc8"][1].data[...] -= 1.0
    net.params["fc8"][1].data[0] -= 5.0
    net.clear_param_diffs()
    assert not net.params["fc8"][0].diff.any()


def test_reshape_and_forward_all(pair):
    _, proto, jnet, net = pair
    x = np.random.RandomState(7).rand(5, 3, 35, 35).astype(np.float32)
    got, ref = net.forward_all(data=x), jnet.forward_all(data=x)
    close(got["prob"], ref["prob"], fwd)
    net.blobs["data"].reshape(3, 3, 35, 35)
    net.reshape()
    assert net.blobs["prob"].shape == (3, 7)
    close(net.forward(data=x[:3])["prob"], ref["prob"][:3], fwd)
    net.blobs["data"].reshape(2, 3, 35, 35)
    net.reshape()


def test_io_helpers_match_jax(tmp_path):
    from caffe_rtpose_tpu import api as japi

    rs = np.random.RandomState(8)
    img = rs.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    (tmp_path / "a.png").write_bytes(encode_png(img))
    np.testing.assert_array_equal(api.load_image(str(tmp_path / "a.png")),
                                  japi.load_image(str(tmp_path / "a.png")))
    ims = [rs.rand(8, 9, 3).astype(np.float32) for _ in range(2)]
    np.testing.assert_array_equal(api.oversample(ims, (5, 6)), japi.oversample(ims, (5, 6)))
    tf, jtf = api.Transformer({"data": (1, 3, 6, 7)}), japi.Transformer({"data": (1, 3, 6, 7)})
    for t in (tf, jtf):
        t.set_transpose("data", (2, 0, 1))
        t.set_channel_swap("data", (2, 1, 0))
        t.set_raw_scale("data", 255.0)
        t.set_mean("data", np.array([100.0, 110.0, 120.0]))
        t.set_input_scale("data", 0.5)
    a, b = tf.preprocess("data", ims[0]), jtf.preprocess("data", ims[0])
    np.testing.assert_allclose(a, b, atol=1e-4)
    np.testing.assert_allclose(tf.deprocess("data", a), jtf.deprocess("data", b), atol=1e-4)
    arrs = [rs.rand(2, 3).astype(np.float32), rs.rand(4).astype(np.float32)]
    s = api.arraylist_to_blobprotovector_str(arrs)
    assert s == japi.arraylist_to_blobprotovector_str(arrs)
    for x, y in zip(api.blobprotovector_str_to_arraylist(s), arrs):
        np.testing.assert_allclose(x, y, rtol=1e-7)
    bp = api.array_to_blobproto(arrs[0], diff=arrs[0] * 2)
    assert bp == japi.array_to_blobproto(arrs[0], diff=arrs[0] * 2)
    np.testing.assert_allclose(api.blobproto_to_array(bp, return_diff=True), arrs[0] * 2,
                               rtol=1e-6)
    u8 = rs.randint(0, 256, (3, 4, 5)).astype(np.uint8)
    assert api.array_to_datum(u8, 3) == japi.array_to_datum(u8, 3)
    np.testing.assert_array_equal(api.datum_to_array(api.array_to_datum(u8, 3)), u8)


def test_load_image_jpeg_matches_jax(tmp_path):
    """caffe.io.load_image of JPEG files (4:2:0 colour, a gray file), in
    colour and gray: the port's codec against JAX's cv2.imread."""
    import cv2
    from caffe_rtpose_tpu import api as japi

    rs = np.random.RandomState(9)
    img = rs.randint(0, 256, (19, 23, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "c.jpg"), img)
    cv2.imwrite(str(tmp_path / "g.jpeg"), img[:, :, 1])
    for name in ("c.jpg", "g.jpeg"):
        for color in (True, False):
            a = api.load_image(str(tmp_path / name), color)
            b = japi.load_image(str(tmp_path / name), color)
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_draw_matches_jax():
    from caffe_rtpose_tpu import api as japi

    proto = narrow_caffenet()
    assert api.draw_net_text(proto) == japi.draw_net_text(proto)
    assert api.draw_net_dot(proto) == japi.draw_net_dot(proto)


def write_images(tmp_path, n=4):
    rs = np.random.RandomState(9)
    for i in range(n):
        (tmp_path / f"im{i}.png").write_bytes(
            encode_png(rs.randint(0, 256, (40, 44, 3)).astype(np.uint8)))


def test_classifier_and_classify_cli_match_jax(pair, tmp_path):
    """Classifier with 10-crop oversampling against JAX's, and ``python -m
    caffe_rtpose_tpu_torch classify --device cpu`` on 4 PNGs: prob rows that
    sum to 1 and equal the Classifier's."""
    from caffe_rtpose_tpu import api as japi

    from caffe_rtpose_tpu.proto import prototxt as jproto
    from caffe_rtpose_tpu_torch.__main__ import main

    work, proto, _, _ = pair
    write_images(tmp_path)
    deploy = str(tmp_path / "deploy.prototxt")
    jproto.dump_file(proto, deploy)
    kw = dict(image_dims=(40, 40), mean=np.array([104.0, 117.0, 123.0]), raw_scale=255.0,
              channel_swap=(2, 1, 0))
    clf = api.Classifier(deploy, str(work / "w.caffemodel"), **kw)
    jclf = japi.Classifier(deploy, str(work / "w.caffemodel"), **kw)
    ims = [api.load_image(str(tmp_path / f"im{i}.png")) for i in range(4)]
    got, ref = clf.predict(ims), jclf.predict(ims)
    close(got, ref, fwd)
    np.save(tmp_path / "mean.npy", np.array([104.0, 117.0, 123.0], np.float32))
    assert main(["classify", str(tmp_path), str(tmp_path / "out.npy"), "--model_def", deploy,
                 "--pretrained_model", str(work / "w.caffemodel"), "--images_dim", "40,40",
                 "--mean_file", str(tmp_path / "mean.npy"), "--device", "cpu"]) == 0
    out = np.load(tmp_path / "out.npy")
    assert out.shape == (4, 7)
    np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-5)
    close(out, got, fwd)


def test_classify_gpu_flag_means_the_card(monkeypatch):
    """``classify --gpu`` is accepted as JAX's is and runs on the card, even
    with ``--device cpu`` (detect's rule)."""
    from caffe_rtpose_tpu.tools import classify as jclassify
    from caffe_rtpose_tpu_torch.tools import classify

    argv = ["in.png", "out.npy", "--model_def", "deploy.prototxt", "--gpu"]
    assert jclassify.build_parser().parse_args(argv).gpu
    assert classify.build_parser().parse_args(argv).gpu

    class Card(Exception):
        pass

    def to_card():
        raise Card

    monkeypatch.setattr(api, "set_mode_gpu", to_card)
    with pytest.raises(Card):
        classify.main(argv + ["--device", "cpu"])


def test_sgd_solver_with_a_test_net(tmp_path):
    """SGDSolver on a net fed by MemoryData-free inputs: a TRAIN/TEST net
    (inner products, softmax loss, accuracy in TEST), 3 steps against the
    JAX solver from the same weights (losses within 1e-5 relative), the test
    net's output from the shared weights, and the facade's read-after-step."""
    from caffe_rtpose_tpu import api as japi

    from caffe_rtpose_tpu.proto import prototxt as jproto

    net = {"input": ["x", "label"], "input_shape": [{"dim": [6, 5]}, {"dim": [6]}],
           "layer": [
               {"name": "ip1", "type": "InnerProduct", "bottom": ["x"], "top": ["h"],
                "inner_product_param": {"num_output": 4}},
               {"name": "sig", "type": "Sigmoid", "bottom": ["h"], "top": ["h"]},
               {"name": "ip2", "type": "InnerProduct", "bottom": ["h"], "top": ["s"],
                "inner_product_param": {"num_output": 3}},
               {"name": "loss", "type": "SoftmaxWithLoss", "bottom": ["s", "label"],
                "top": ["loss"]},
               {"name": "acc", "type": "Accuracy", "bottom": ["s", "label"], "top": ["acc"],
                "include": [{"phase": 1}]}]}
    jproto.dump_file(net, str(tmp_path / "net.prototxt"))
    (tmp_path / "solver.prototxt").write_text(
        f'net: "{tmp_path}/net.prototxt"\nbase_lr: 0.5\nmomentum: 0.9\nweight_decay: 1e-3\n'
        'lr_policy: "fixed"\ntest_interval: 2\ntest_iter: 1\ntest_initialization: false\n')
    rs = np.random.RandomState(10)
    feed = {"x": rs.randn(6, 5).astype(np.float32),
            "label": rs.randint(0, 3, 6).astype(np.float32)}
    s = api.SGDSolver(str(tmp_path / "solver.prototxt"), lambda it: feed, lambda it: feed)
    js = japi.SGDSolver(str(tmp_path / "solver.prototxt"), lambda it: feed, lambda it: feed)
    w = weights_for(japi.Net(net, japi.TRAIN), seed=11)
    s._solver.net.load_weights(w)
    js._solver.net.load_weights(w)
    losses = [s.step(1) for _ in range(3)]
    jlosses = [js.step(1) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert s.iter == 3 and len(s.test_nets) == 1
    np.testing.assert_allclose(s.net.blobs["loss"].data, js.net.blobs["loss"].data, rtol=1e-5)
    for name in ("ip1", "ip2"):
        for a, b in zip(s.net.params[name], js.net.params[name]):
            np.testing.assert_allclose(a.data, b.data, rtol=1e-4, atol=1e-5)
    scores = s._solver.test(0)
    jscores = js._solver.test(0)
    assert set(scores) >= {"loss", "acc"}
    np.testing.assert_allclose([scores["loss"], scores["acc"]],
                               [jscores["loss"], jscores["acc"]], rtol=1e-5)


def test_hdf5_weights_and_detector_match_jax(pair, tmp_path):
    """save_hdf5/load_hdf5 (the port's codec) write and read what JAX's do
    (through h5py), and Detector.detect_windows classifies PNG windows as
    JAX's does."""
    from caffe_rtpose_tpu import api as japi

    from caffe_rtpose_tpu.proto import prototxt as jproto

    work, proto, jnet, net = pair
    net.save_hdf5(str(tmp_path / "port.h5"))
    pytest.importorskip("h5py")  # JAX's side
    fresh = japi.Net(proto, japi.TEST)
    fresh.load_hdf5(str(tmp_path / "port.h5"))
    other = api.Net(proto, api.TEST)
    jnet.save_hdf5(str(tmp_path / "jax.h5"))
    other.load_hdf5(str(tmp_path / "jax.h5"))
    for name, blobs in jnet.params.items():
        for a, b in zip(other.params[name], blobs):
            np.testing.assert_array_equal(a.data, b.data)
        for a, c in zip(net.params[name], fresh.params[name]):
            np.testing.assert_array_equal(c.data, a.data)
    write_images(tmp_path, n=2)
    deploy = str(tmp_path / "deploy.prototxt")
    jproto.dump_file(proto, deploy)
    windows = [(str(tmp_path / "im0.png"), [(0, 0, 30, 30), (5, 8, 40, 44)]),
               (str(tmp_path / "im1.png"), [(2, 3, 20, 25)])]
    kw = dict(mean=np.array([104.0, 117.0, 123.0]), raw_scale=255.0, channel_swap=(2, 1, 0))
    got = api.Detector(deploy, str(work / "w.caffemodel"), **kw).detect_windows(windows)
    ref = japi.Detector(deploy, str(work / "w.caffemodel"), **kw).detect_windows(windows)
    assert [(d["filename"], tuple(d["window"])) for d in got] == \
        [(d["filename"], tuple(d["window"])) for d in ref]
    for a, b in zip(got, ref):
        close(a["prediction"], b["prediction"], fwd)
