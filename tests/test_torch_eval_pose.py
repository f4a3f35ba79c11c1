"""The port's eval tool (caffe_rtpose_tpu_torch/tools/eval_pose.py) on the
CPU: the OKS/AP math, the image list and the parity tool against the JAX
tool's on the same seeded inputs (equal, bit for bit: the same numpy code);
``coco_keypoint_ap`` against the independent COCOeval oracle
(tests/coco_eval_oracle.py, within 1e-6 as tests/test_coco_ap_fixtures.py
holds the JAX scorer); ``run-list`` over PNG files against ``estimate()``
per image (the JSON text equal)."""

import contextlib
import io
import os

import cv2
import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.tools import eval_pose as jax_eval
from caffe_rtpose_tpu_torch import __main__ as dispatcher
from caffe_rtpose_tpu_torch.core.net import Net
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.pipeline.image_io import read_image
from caffe_rtpose_tpu_torch.pipeline.runner import write_json_file
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
from caffe_rtpose_tpu_torch.proto import prototxt
from caffe_rtpose_tpu_torch.tools import eval_pose

from coco_eval_oracle import evaluate as oracle_evaluate
from test_coco_ap_fixtures import _ORACLE_FIXTURES, _random_scene


def _kp(rs, n_vis):
    kp = np.zeros((17, 3), np.float32)
    kp[:, :2] = rs.uniform(0, 500, (17, 2))
    kp[rs.choice(17, n_vis, replace=False), 2] = 2
    return kp


def test_constants_equal_jax():
    np.testing.assert_array_equal(eval_pose.COCO_SIGMAS, jax_eval.COCO_SIGMAS)
    assert eval_pose.OURS_TO_COCO == jax_eval.OURS_TO_COCO
    assert eval_pose.AREA_RANGES == jax_eval.AREA_RANGES


def test_oks_and_dt_area_equal_jax():
    rs = np.random.RandomState(0)
    for i in range(40):
        gt, dt = _kp(rs, i % 18), _kp(rs, 17)
        area = float(rs.uniform(100, 1e5))
        bbox = [float(v) for v in rs.uniform(0, 300, 4)] if i % 3 else None
        assert eval_pose.oks(gt, dt, area, bbox=bbox) == jax_eval.oks(gt, dt, area, bbox=bbox)
        assert eval_pose._dt_area(dt) == jax_eval._dt_area(dt)


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_keypoint_ap_equals_jax_and_the_oracle(seed):
    gts, dts = _random_scene(seed)
    ours = eval_pose.coco_keypoint_ap(gts, dts)
    assert ours == jax_eval.coco_keypoint_ap(gts, dts)
    assert 0.05 < ours["AP"] < 0.999
    ref = oracle_evaluate(gts, dts)
    for k in ("AP", "AP50", "AP75", "AP_medium", "AP_large"):
        assert ours[k] == pytest.approx(ref[k], abs=1e-6), k


@pytest.mark.parametrize("name", sorted(_ORACLE_FIXTURES))
def test_coco_keypoint_ap_on_the_fixtures(name):
    gts, dts, kw = _ORACLE_FIXTURES[name]()
    ours = eval_pose.coco_keypoint_ap(gts, dts, **kw)
    assert ours == jax_eval.coco_keypoint_ap(gts, dts, **kw)
    ref = oracle_evaluate(gts, dts, **kw)
    for k in ("AP", "AP50", "AP75", "AP_medium", "AP_large"):
        if k not in ours and k not in ref:
            continue
        if ref.get(k) == -1.0:  # COCOeval's sentinel: no non-ignored GT in range
            assert ours.get(k, 0.0) == 0.0, k
        else:
            assert ours[k] == pytest.approx(ref[k], abs=1e-6), k


def test_parse_image_list_equals_jax(tmp_path):
    path = tmp_path / "list.txt"
    path.write_text("0 397133 a/000000397133.jpg 427 640\n"
                    "short line\n\n"
                    "1 37777 000000037777.png 230 352 extra\n"
                    "2 252219 x.bmp 428 640\n")
    ours = eval_pose.parse_image_list(str(path))
    assert ours == jax_eval.parse_image_list(str(path))
    assert ours[1] == (37777, "000000037777.png", 230, 352)


def _json_dirs(root, seed):
    """Two directories of rtpose JSON: B is A with small joint offsets, one
    file with a person fewer, and one file that only A has."""
    rs = np.random.RandomState(seed)
    a, b = root / "a", root / "b"
    a.mkdir()
    b.mkdir()
    for i in range(6):
        n = rs.randint(0, 4)
        joints = rs.uniform(0, 600, (n, 18, 3)).astype(np.float32)
        joints[..., 2] = rs.uniform(0, 1, (n, 18)) * (rs.rand(n, 18) > 0.2)
        write_json_file(str(a / f"{i:012d}.json"), joints, n, 1.0, 18)
        jb = joints.copy()
        jb[..., :2] += rs.normal(0, 0.3, jb[..., :2].shape)
        jb[..., 2] += rs.normal(0, 0.003, jb[..., 2].shape) * (jb[..., 2] > 0)
        nb = n - 1 if i == 4 and n else n
        write_json_file(str(b / f"{i:012d}.json"), jb[:nb], nb, 1.0, 18)
    write_json_file(str(a / "only_a.json"), np.zeros((0, 18, 3), np.float32), 0, 1.0, 18)
    return str(a), str(b)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("tol", [[], ["--px_tol", "5", "--conf_tol", "0.5"]])
def test_joint_diff_equals_jax(tmp_path, tol):
    a, b = _json_dirs(tmp_path, 0)
    for pair in ((a, b), (a, a)):
        got = _run(dispatcher.main, ["eval", "joint-diff", *pair, *tol])
        assert got == _run(jax_eval.main, ["joint-diff", *pair, *tol])
    assert "PARITY OK" in _run(eval_pose.main, ["joint-diff", a, a])[1]


def test_coco_ap_command_equals_jax(tmp_path):
    import json

    gts, dts = _random_scene(2, n_images=6)
    ann, images = [], []
    for img, gl in gts.items():
        images.append({"id": img})
        for g in gl:
            ann.append({"image_id": img, "keypoints": g["keypoints"].reshape(-1).tolist(),
                        "area": g["area"], "bbox": g.get("bbox"),
                        "iscrowd": int(g.get("iscrowd", False)),
                        "num_keypoints": int((g["keypoints"][:, 2] > 0).sum())})
    gt_path = tmp_path / "gt.json"
    gt_path.write_text(json.dumps({"images": images, "annotations": ann}))
    pred = tmp_path / "pred"
    pred.mkdir()
    coco_to_ours = {c17: c18 for c17, c18 in enumerate(eval_pose.OURS_TO_COCO)}
    for img, dl in dts.items():
        joints = np.zeros((len(dl), 18, 3), np.float32)
        for p, d in enumerate(dl):
            for c17, c18 in coco_to_ours.items():
                joints[p, c18, :2] = d["keypoints"][c17, :2]
                joints[p, c18, 2] = d["score"]
        write_json_file(str(pred / f"{img:012d}.json"), joints, len(dl), 1.0, 18)
    argv = ["coco-ap", "--gt", str(gt_path), "--pred", str(pred)]
    got = _run(eval_pose.main, argv)
    assert got == _run(jax_eval.main, argv) and got[0] == 0
    assert set(json.loads(got[1])) >= {"AP", "AP50", "AP75"}


def test_run_list_equals_estimate_per_image(tmp_path):
    """``eval run-list`` over PNG files (one smaller than the net region at
    the display size, so the INTER_AREA upscale runs) writes, per image, the
    JSON that estimate() of the same estimator gives."""
    _run_list_case(tmp_path, "png")


def test_run_list_over_jpegs(tmp_path):
    """The same over JPEG files (COCO's format), read by the port's codec:
    each image's JSON is estimate() on what JAX's run-list reads,
    cv2.imread."""
    _run_list_case(tmp_path, "jpg")


def _run_list_case(tmp_path, ext):
    proto = make_pose_deploy_net("COCO", stages=2)
    net = Net(proto, device="cpu")
    rs = np.random.RandomState(3)
    weights = {k: [rs.randn(*c.weight.shape).astype(np.float32) * 0.1,
                   rs.randn(c.cout).astype(np.float32) * 0.1] for k, c in net.convs.items()}
    net.load_weights(weights)
    proto_path, model_path = str(tmp_path / "deploy.prototxt"), str(tmp_path / "w.caffemodel")
    prototxt.dump_file(proto, proto_path)
    net.save_caffemodel(model_path)
    root = tmp_path / "img"
    root.mkdir()
    lines = []
    for i, (h, w) in enumerate([(96, 160), (40, 52), (120, 90)]):
        name = f"{1000 + i:012d}.{ext}"
        cv2.imwrite(str(root / name), (rs.rand(h, w, 3) * 255).astype(np.uint8))
        lines.append(f"{i} {1000 + i} {name} {h} {w}")
    lines.append("3 1003 missing.png 10 10")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    out = tmp_path / "json"
    rc, text = _run(dispatcher.main, [
        "eval", "run-list", "--list", str(tmp_path / "list.txt"), "--image_root", str(root),
        "--out", str(out), "--caffeproto", proto_path, "--caffemodel", model_path,
        "--net_resolution", "128x80", "--display", "96x64", "--device", "cpu"])
    assert rc == 0 and "Wrote 3 JSON files" in text
    est = PoseEstimator(proto, weights=weights, net_resolution=(128, 80), input_u8=True,
                        dtype=torch.float32, device="cpu")
    people = 0
    for i in range(3):
        name = f"{1000 + i:012d}"
        img = read_image(str(root / f"{name}.{ext}"))
        np.testing.assert_array_equal(img, cv2.imread(str(root / f"{name}.{ext}")))
        res, pf = est.estimate(img, 96, 64)
        people += res.num_people
        ref = str(tmp_path / f"{name}_ref.json")
        write_json_file(ref, res.joints, res.num_people, pf.scale, est.num_parts)
        with open(out / f"{name}.json") as a, open(ref) as b:
            assert a.read() == b.read()
    assert people > 0
