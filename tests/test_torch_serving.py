"""The port's serving bundles (caffe_rtpose_tpu_torch/serving.py) on the CPU:
exported with torch.export, reloaded cold, against the live port
estimator (bit for bit) and against the JAX package's bundle on the same
weights (2-stage COCO deploy net at 128x80, fan-in weights from numpy).

Tolerances against JAX are test_torch_estimator.py's: peak counts and pair
counts exact, refined peaks within 1e-4, pair scores within one f16 ulp
plus 1e-5.  Between the port's bundle and its live estimator: every packed
byte equal (the loaded program runs the same operators on the same
operands)."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.serving import ExportedPose as JExportedPose
from caffe_rtpose_tpu.serving import export_estimator as j_export
from caffe_rtpose_tpu_torch import __main__ as dispatcher
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
from caffe_rtpose_tpu_torch.proto import prototxt
from caffe_rtpose_tpu_torch.serving import ExportedPose, export_estimator
from caffe_rtpose_tpu_torch.utils import device as device_mod

from test_torch_estimator import (WITNESS_SEEDS, _assert_outputs_close, _assert_outputs_match,
                                  _fan_in_weights, witness_frame)

RES = (128, 80)
CAP = 8
THR = dict(nms_threshold=-1.0, inter_threshold=-10.0)


@pytest.fixture(scope="module", autouse=True)
def _torch_native_cpu_conv():
    """As test_torch_estimator.py: torch's own CPU convolution sums closer
    to XLA's than oneDNN's."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = prev


def _port(weights, **kw):
    cfg = dict(net_resolution=RES, input_u8=True, pair_cap=CAP, device="cpu", peak_kernel=True)
    cfg.update(kw)
    return PoseEstimator(make_pose_deploy_net("COCO", stages=2), weights=weights, **cfg)


def _frames(seed, n):
    rs = np.random.RandomState(seed)
    x = (rs.rand(n, 1, RES[1], RES[0], 3) * 255).astype(np.uint8)
    x[:, :, :, :8] = 0  # a dark band, as letterboxing gives
    return x


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The JAX bundle and the port's batch-1 and batch-4 bundles, all on
    the same weights, each beside the estimator it came from."""
    root = tmp_path_factory.mktemp("bundles")
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=RES, input_u8=True,
                      pair_cap=CAP)
    weights = _fan_in_weights(jest, 0)
    j_export(jest, str(root / "jax"))
    out = {"jax": (jest, str(root / "jax")), "weights": weights}
    for name, batch in (("b1", 1), ("b4", 4)):
        est = _port(weights, batch=batch)
        export_estimator(est, str(root / name))
        out[name] = (est, str(root / name))
    return out


def test_bundle_files_and_no_weights_in_the_program(bundles):
    est, path = bundles["b1"]
    assert set(os.listdir(path)) == {"meta.json", "weights.npz", "program.pt2",
                                     "program_nocap.pt2"}
    weights = os.path.getsize(os.path.join(path, "weights.npz"))
    for name in ("program.pt2", "program_nocap.pt2"):
        ep = torch.export.load(os.path.join(path, name))
        assert not ep.state_dict  # weights are inputs, not parameters
        biggest = max(v.numel() * v.element_size() for v in ep.constants.values())
        assert biggest < RES[0] * RES[1] * 4 + 1  # the canvas mask; no weight tensor
        assert os.path.getsize(os.path.join(path, name)) < weights / 20
        targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
        assert targets.count("crt.peak_mask_fused.default") == 1
        assert not any("lift_fresh" in t for t in targets)  # constants lifted, not copied
    # no fake tensor from the trace entered the constant cache
    assert not any(isinstance(v, torch._subclasses.fake_tensor.FakeTensor)
                   for v in device_mod._consts.values())


@pytest.mark.parametrize("name", ["b1", "b4"])
def test_bundle_equals_live_estimator_bit_for_bit(bundles, name):
    est, path = bundles[name]
    pose = ExportedPose(path, device="cpu")
    assert pose.input_shape() == est.input_shape() and pose.input_dtype == est.input_dtype
    x = _frames(3, 4)
    if est.batch == 1:
        for f in x[:2]:
            for thr in (THR, {}):  # the thresholds are the program's inputs
                a = est.run_device(f, **thr)["packed"]
                assert torch.equal(a, pose.run_device(f, **thr)["packed"])
    else:
        a, b = est.run_device(x, **THR), pose.run_device(x, **THR)
        assert torch.equal(a["packed"], b["packed"]) and a["packed"].shape[0] == 4
        for (p1, s1, c1), (p2, s2, c2) in zip(est.fetch_batch(a), pose.fetch_batch(b)):
            assert np.array_equal(p1, p2, equal_nan=True) and np.array_equal(s1, s2)
            assert np.array_equal(c1, c2)
    # pair_cap overflow: the bundle's single-frame program_nocap
    peaks = est.fetch_batch(est.run_device(x if est.batch > 1 else x[0], **THR))[0][0]
    assert est.overflowed(peaks)
    for u, v in zip(est.refetch_full(x[0], **THR), pose.refetch_full(x[0], **THR)):
        assert np.array_equal(u, v, equal_nan=True)
    ra, _ = est.estimate(np.ascontiguousarray(x[1, 0]), nms_threshold=0.0)
    rb, _ = pose.estimate(np.ascontiguousarray(x[1, 0]), nms_threshold=0.0)
    assert ra.num_people == rb.num_people
    assert np.array_equal(ra.joints, rb.joints) and np.array_equal(ra.peaks, rb.peaks,
                                                                   equal_nan=True)


def test_bundle_matches_the_jax_bundle(bundles):
    jest, jpath = bundles["jax"]
    jpose = JExportedPose(jpath)
    pose = ExportedPose(bundles["b1"][1], device="cpu")
    # test_torch_estimator.py's frame, at the single-frame tolerances; over
    # many frames the CNNs' f32 noise shows (test_bundles_agree_with_jax_over_frames)
    x = witness_frame(1)
    got, ref = pose.fetch(pose.run_device(x, **THR)), jpose.fetch(jpose.run_device(x, **THR))
    _assert_outputs_match(got, ref)
    assert pose.overflowed(got[0]) and jpose.overflowed(ref[0])
    _assert_outputs_match(pose.refetch_full(x, **THR), jpose.refetch_full(x, **THR))


def test_bundles_agree_with_jax_over_frames(bundles):
    """The port's batch-4 bundle against the JAX bundle on the frames of
    test_torch_estimator.py's f64 witness (two passes of four), by the rule
    that witness states for many frames (``_assert_outputs_close``): counts
    exact, refined peaks within 1e-4 + 1e-5 * |x|, pair scores where both
    sides sample the same pixels."""
    jest, jpath = bundles["jax"]
    jpose = JExportedPose(jpath)
    pose = ExportedPose(bundles["b4"][1], device="cpu")
    frames = np.stack([witness_frame(s) for s in WITNESS_SEEDS])
    got = []
    for i in range(0, len(frames), 4):
        got += pose.fetch_batch(pose.run_device(frames[i : i + 4], **THR))
    for x, g in zip(frames, got):
        _assert_outputs_close(g, jpose.fetch(jpose.run_device(x, **THR)), pose.descriptor)


def test_weights_npz_is_the_jax_layout(bundles):
    with np.load(os.path.join(bundles["jax"][1], "weights.npz")) as zj, \
            np.load(os.path.join(bundles["b1"][1], "weights.npz")) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype == np.float32
            assert zj[k].shape == zt[k].shape, k
            np.testing.assert_array_equal(zj[k], zt[k])


def test_meta_has_the_jax_keys(bundles):
    with open(os.path.join(bundles["jax"][1], "meta.json")) as f:
        mj = json.load(f)
    with open(os.path.join(bundles["b1"][1], "meta.json")) as f:
        mt = json.load(f)
    assert set(mj) <= set(mt)
    assert mt["format_version"] != mj["format_version"]  # each package reads its own
    for k in set(mj) - {"format_version"}:
        assert mt[k] == mj[k], k
    assert mt["platforms"] == ["cpu"]


def test_operands_are_derived_as_the_net_derives_them(bundles):
    """ExportedPose makes the operands from weights.npz with the code Net
    uses: the same values, dtypes and strides as the live net's."""
    for name in ("b1",):
        est, path = bundles[name]
        live, loaded = est.net.operands(), ExportedPose(path, device="cpu")._weights
        assert live.keys() == loaded.keys()
        for k, v in live.items():
            assert torch.equal(v, loaded[k]) and v.stride() == loaded[k].stride(), k


def test_bf16_bundle_runs_k4_and_equals_live(bundles, tmp_path):
    est = _port(bundles["weights"], dtype=torch.bfloat16, conv1_kernel=True, batch=2)
    export_estimator(est, str(tmp_path))
    ep = torch.export.load(str(tmp_path / "program.pt2"))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("crt.conv1_block.default") == 1
    with open(tmp_path / "meta.json") as f:
        assert json.load(f)["conv1_blocks"] == {"conv1_1": ["conv1_1", "conv1_2"]}
    pose = ExportedPose(str(tmp_path), device="cpu")
    x = _frames(7, 2)
    assert torch.equal(est.run_device(x)["packed"], pose.run_device(x)["packed"])


def test_missing_program_raises_not_implemented(bundles, tmp_path):
    est, path = bundles["b1"]
    pose = ExportedPose(path, device="cpu")
    with pytest.raises(NotImplementedError, match="no program for 2 frame"):
        pose._run(_frames(1, 2), None, None)
    # a bundle without its overflow program cannot refetch
    cut = tmp_path / "cut"
    shutil.copytree(path, cut)
    os.remove(cut / "program_nocap.pt2")
    with open(cut / "meta.json") as f:
        meta = json.load(f)
    del meta["programs"]["program_nocap.pt2"]
    with open(cut / "meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(NotImplementedError, match="pair capacity"):
        ExportedPose(str(cut), device="cpu").refetch_full(_frames(1, 1)[0])


def test_export_refuses_heatmap_and_kernels_off(bundles, tmp_path):
    w = bundles["weights"]
    with pytest.raises(ValueError, match="keep_heatmap"):
        export_estimator(_port(w, keep_heatmap=True, pair_cap=None), str(tmp_path))
    with pytest.raises(ValueError, match="operators"):
        export_estimator(_port(w, peak_kernel=False), str(tmp_path))


def test_export_tool_build_and_check(tmp_path):
    """``python -m caffe_rtpose_tpu_torch export build|check``, through the
    dispatcher's ``main`` in this process."""
    proto = tmp_path / "deploy.prototxt"
    prototxt.dump_file(make_pose_deploy_net("COCO", stages=2), str(proto))
    out = tmp_path / "bundle"

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = dispatcher.main(["export", *argv])
        return rc, buf.getvalue()

    rc, text = run("build", "--caffeproto", str(proto), "--out", str(out), "--net_resolution",
                   "128x80", "--input_u8", "--device", "cpu")
    assert rc == 0 and "program.pt2" in text and "program_nocap.pt2" in text
    rc, text = run("check", str(out), "--device", "cpu")
    assert rc == 0 and "smoke ok" in text and '"platforms": [\n  "cpu"' in text
