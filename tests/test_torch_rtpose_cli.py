"""The port's rtpose CLI (tools/rtpose.py, ``python -m caffe_rtpose_tpu_torch
rtpose``): the JAX tool's flags and defaults plus ``--device``; an image
directory end to end on the CPU; serving bundles and ``--num_gpu`` on the
CPU; what the JAX tool refuses is refused."""

import os
import subprocess
import sys

import numpy as np
import pytest

from caffe_rtpose_tpu.tools import rtpose as jax_rtpose
from caffe_rtpose_tpu_torch.pipeline.image_io import read_image
from caffe_rtpose_tpu_torch.tools import rtpose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_flags_and_defaults_match_jax():
    """Every JAX flag with its default, plus --device; --caffeproto's default
    is the reference checkout's relative path (as --caffemodel's is), not
    the JAX tool's absolute one; both fall back to the built-in graph when
    the file is missing."""
    port, ref = _flags(rtpose.build_parser()), _flags(jax_rtpose.build_parser())
    extra = port.pop("device")
    assert extra[1] == "cuda" and set(extra[2]) == {"cuda", "cpu"}
    assert port.keys() == ref.keys()
    assert port["caffeproto"][1] == "model/coco/pose_deploy_linevec.prototxt"
    assert ref["caffeproto"][1].endswith("/" + port["caffeproto"][1])
    for k in ref:
        if k == "caffeproto":
            continue
        assert port[k][:3] == ref[k][:3], k
        assert (port[k][3] is None) == (ref[k][3] is None), k
    assert port["dtype"][1] == "bfloat16"


def _png_dir(path, n, wh=(160, 96)):
    import struct
    import zlib

    os.makedirs(path)
    rs = np.random.RandomState(0)
    for i in range(n):
        rgb = (rs.rand(wh[1], wh[0], 3) * 255).astype(np.uint8)
        raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(wh[1]))

        def chunk(kind, body):
            return struct.pack(">I", len(body)) + kind + body + struct.pack(
                ">I", zlib.crc32(kind + body))

        with open(os.path.join(path, f"f{i}.png"), "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n"
                    + chunk(b"IHDR", struct.pack(">IIBBBBB", wh[0], wh[1], 8, 2, 0, 0, 0))
                    + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
        assert read_image(os.path.join(path, f"f{i}.png")).shape == (wh[1], wh[0], 3)


def test_image_dir_end_to_end_on_cpu(tmp_path, capsys):
    img, out = str(tmp_path / "img"), str(tmp_path / "json")
    _png_dir(img, 3)
    rc = rtpose.main(["--device", "cpu", "--no_weights", "--image_dir", img, "--write_json", out,
                      "--frame_limit", "2", "--net_resolution", "128x80", "--no_display",
                      "--no_frame_drops", "--caffeproto", str(tmp_path / "missing.prototxt")])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["f0.json", "f1.json"]
    assert "overflow refetches" in capsys.readouterr().out


def test_model_files_end_to_end_on_cpu(tmp_path, capsys):
    """--caffeproto and --caffemodel files that exist are read: no fallback
    warning, and every JSON equals estimate() of an estimator built from the
    same graph and weights as dicts, in the CLI's configuration."""
    import torch

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.pipeline.runner import write_json_file
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.proto import prototxt

    proto = make_pose_deploy_net("COCO", stages=2)
    net = Net(proto, device="cpu")
    rs = np.random.RandomState(3)
    weights = {k: [rs.randn(*c.weight.shape).astype(np.float32) * 0.1,
                   rs.randn(c.cout).astype(np.float32) * 0.1] for k, c in net.convs.items()}
    net.load_weights(weights)
    proto_path, model_path = str(tmp_path / "deploy.prototxt"), str(tmp_path / "w.caffemodel")
    prototxt.dump_file(proto, proto_path)
    net.save_caffemodel(model_path)
    img, out = str(tmp_path / "img"), str(tmp_path / "json")
    _png_dir(img, 2)
    rc = rtpose.main(["--device", "cpu", "--caffeproto", proto_path, "--caffemodel", model_path,
                      "--image_dir", img, "--write_json", out, "--net_resolution", "128x80",
                      "--resolution", "160x96", "--no_display", "--no_frame_drops",
                      "--nms_threshold", "0.0"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "not found" not in err
    est = PoseEstimator(proto, weights=weights, net_resolution=(128, 80), input_u8=True,
                        pair_cap=32, dtype=torch.bfloat16, device="cpu")
    for name in ("f0", "f1"):
        res, pf = est.estimate(read_image(os.path.join(img, f"{name}.png")), 160, 96,
                               nms_threshold=0.0)
        assert res.peaks[:, 0, 0].sum() > 0  # the loaded weights make peaks
        ref = str(tmp_path / f"{name}_ref.json")
        write_json_file(ref, res.joints, res.num_people, float(np.float32(pf.scale)),
                        est.num_parts)
        with open(os.path.join(out, f"{name}.json")) as a, open(ref) as b:
            assert a.read() == b.read()


def test_module_entry_point(tmp_path):
    img, out = str(tmp_path / "img"), str(tmp_path / "json")
    _png_dir(img, 1, wh=(64, 48))
    res = subprocess.run([sys.executable, "-m", "caffe_rtpose_tpu_torch", "rtpose", "--device",
                          "cpu", "--no_weights", "--image_dir", img, "--write_json", out,
                          "--net_resolution", "64x48", "--resolution", "64x48", "--no_display",
                          "--no_frame_drops", "--dtype", "float32"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert os.listdir(out) == ["f0.json"]
    assert "built-in COCO" in res.stderr


def test_jpeg_paths_without_cv2(tmp_path):
    """With cv2 blocked: rtpose over a JPEG directory with --write_frames
    --no_text --write_json, an ImageData net over a JPEG list, and eval
    run-list over the JPEGs, all run, and none imports cv2."""
    import cv2

    rs = np.random.RandomState(12)
    img = tmp_path / "img"
    img.mkdir()
    for i in range(2):
        cv2.imwrite(str(img / f"f{i}.jpg"), (rs.rand(48, 64, 3) * 255).astype(np.uint8))
    (tmp_path / "list.txt").write_text("f0.jpg 0\nf1.jpg 1\n")
    (tmp_path / "coco.txt").write_text("0 1 f0.jpg 48 64\n1 2 f1.jpg 48 64\n")
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.proto import prototxt

    proto = str(tmp_path / "deploy.prototxt")  # 2 stages: the run is about the images
    prototxt.dump_file(make_pose_deploy_net("COCO", stages=2), proto)
    code = f"""
import os, sys
sys.modules["cv2"] = None
from caffe_rtpose_tpu_torch.core.net import Net
from caffe_rtpose_tpu_torch.tools import eval_pose, rtpose
d, img, proto = {str(tmp_path)!r}, {str(img)!r}, {proto!r}
assert rtpose.main(["--device", "cpu", "--caffeproto", proto, "--no_weights", "--image_dir", img,
                    "--write_json", d + "/json", "--write_frames", d + "/frames", "--no_text",
                    "--net_resolution", "64x48", "--resolution", "64x48", "--no_display",
                    "--no_frame_drops", "--dtype", "float32"]) == 0
assert sorted(os.listdir(d + "/json")) == ["f0.json", "f1.json"]
assert sorted(os.listdir(d + "/frames")) == ["f0.jpg", "f1.jpg"]
net = Net({{"layer": [{{"name": "data", "type": "ImageData", "top": ["data", "label"],
                       "image_data_param": {{"source": d + "/list.txt", "batch_size": 2,
                                             "root_folder": img + "/"}}}}]}}, device="cpu")
out = net.forward({{}}, outputs=["data", "label"])
assert tuple(out["data"].shape) == (2, 3, 48, 64)
assert eval_pose.main(["run-list", "--list", d + "/coco.txt", "--image_root", img, "--out",
                       d + "/eval", "--caffeproto", proto, "--net_resolution", "64x48",
                       "--display", "64x48", "--dtype", "float32", "--device", "cpu"]) == 0
assert sorted(os.listdir(d + "/eval")) == ["f0.json", "f1.json"]
print("ok", sys.modules["cv2"] is not None)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.split()[-2:] == ["ok", "False"], res.stderr
    for i in range(2):  # the frames written are JPEGs of the 64x48 canvas
        assert cv2.imread(str(tmp_path / "frames" / f"f{i}.jpg")).shape == (48, 64, 3)


def test_refuses_what_is_not_ported(tmp_path):
    """Model files that exist are read, and what they hold is refused as
    the JAX tool refuses it: a graph without an Nms layer, bytes that are no
    NetParameter.  ``--bundle`` and the device pool are ported now: a bundle
    refuses the heatmap views as the JAX tool does, a missing bundle
    raises, and ``--num_gpu 2`` runs (on the CPU, over two CPU replicas)."""
    proto, model = tmp_path / "deploy.prototxt", tmp_path / "w.caffemodel"
    proto.write_text("name: 'x'\n")
    model.write_bytes(b"\0")
    assert rtpose.main(["--device", "cpu", "--bundle", "b", "--part_to_show", "1"]) == 2
    with pytest.raises(FileNotFoundError):
        rtpose.main(["--device", "cpu", "--bundle", str(tmp_path / "missing_bundle")])
    small = ["--device", "cpu", "--net_resolution", "64x48"]
    with pytest.raises(ValueError, match="no 'nms' layer"):
        rtpose.main([*small, "--caffeproto", str(proto), "--no_weights"])
    from caffe_rtpose_tpu.proto import caffemodel as j_caffemodel

    with pytest.raises(Exception) as jax_error:
        j_caffemodel.load_weights(str(model))
    with pytest.raises(type(jax_error.value)):
        rtpose.main([*small, "--caffeproto", str(tmp_path / "missing.prototxt"),
                     "--caffemodel", str(model)])
    missing = ["--caffeproto", str(tmp_path / "missing.prototxt")]
    assert rtpose.main(["--device", "cpu", "--no_weights", "--num_gpu", "2", *missing,
                        "--net_resolution", "64x48", "--image_dir", str(tmp_path)]) == 0
    assert rtpose.main(["--device", "cpu", "--net_resolution", "100x48", *missing]) == 2


def test_bundle_and_num_gpu_end_to_end_on_cpu(tmp_path, capsys):
    """``--bundle`` (one device and ``--num_gpu 2``) writes the JSON the live
    CLI writes from the same graph and weights (f32: on the CPU the live
    estimator runs the plain peak mask, which is the operator's CPU
    implementation the bundle records)."""
    import torch

    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
    from caffe_rtpose_tpu_torch.proto import prototxt
    from caffe_rtpose_tpu_torch.serving import export_estimator

    proto = make_pose_deploy_net("COCO", stages=2)
    net = Net(proto, device="cpu")
    rs = np.random.RandomState(3)
    weights = {k: [rs.randn(*c.weight.shape).astype(np.float32) * 0.1,
                   rs.randn(c.cout).astype(np.float32) * 0.1] for k, c in net.convs.items()}
    net.load_weights(weights)
    proto_path, model_path = str(tmp_path / "deploy.prototxt"), str(tmp_path / "w.caffemodel")
    prototxt.dump_file(proto, proto_path)
    net.save_caffemodel(model_path)
    bundle = str(tmp_path / "bundle")
    export_estimator(PoseEstimator(proto, weights=weights, net_resolution=(128, 80),
                                   input_u8=True, pair_cap=32, dtype=torch.float32,
                                   device="cpu", peak_kernel=True), bundle)
    img = str(tmp_path / "img")
    _png_dir(img, 3)
    common = ["--device", "cpu", "--image_dir", img, "--resolution", "160x96", "--no_display",
              "--no_frame_drops", "--nms_threshold", "0.0"]
    runs = {"live": ["--caffeproto", proto_path, "--caffemodel", model_path, "--dtype",
                     "float32", "--net_resolution", "128x80"],
            "bundle": ["--bundle", bundle],
            "bundle2": ["--bundle", bundle, "--num_gpu", "2"]}
    for name, flags in runs.items():
        assert rtpose.main([*common, *flags, "--write_json", str(tmp_path / name)]) == 0
    capsys.readouterr()
    files = sorted(os.listdir(tmp_path / "live"))
    assert files == ["f0.json", "f1.json", "f2.json"]
    people = 0
    for f in files:
        live = (tmp_path / "live" / f).read_text()
        people += live.count('"joints"')
        for name in ("bundle", "bundle2"):
            assert (tmp_path / name / f).read_text() == live, (name, f)
    assert people > 0
