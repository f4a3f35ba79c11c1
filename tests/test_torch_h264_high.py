"""The port's H.264 decoder on High profile streams (the 8x8 transform,
Intra8x8, scaling matrices, a chroma QP offset for each of Cb and Cr)
against the JAX package's reader, ``cv2.VideoCapture`` with its default
backend (FFMPEG) inside ``caffe_rtpose_tpu.pipeline.runner.frame_source``,
on the streams of tests/h264_cases.HIGH and the committed clip
tests/data/h264_high_720p.mp4:

(a) the writer codes every syntax element and context of High profile the
    decoder takes, and resolves the scaling lists as the standard's
    fall-back rules say;
(b) every case's frame count, fps, frames (sha256), start_frame and ui
    seeks (h264_cases.seeks: for the 720p clip, seeks inside its 8 frames,
    each of which decodes on from the IDR picture) equal the JAX reader's,
    pinned in h264_cases.PINNED, and the port gives the pins with cv2
    blocked; each CABAC case decodes as its CAVLC twin in both readers;
(c) what High profile allows beyond what is decoded raises UnsupportedVideo
    naming it;
(d) rtpose --video on a small High profile MP4 writes the JSONs the JAX
    pipeline writes for that file.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import avi_cases as A
import h264_cases as H
from caffe_rtpose_tpu.pipeline import runner as JR
from caffe_rtpose_tpu_torch.pipeline import bmff, runner, video
from test_torch_h264 import _read_all, _zero_params

cv2 = pytest.importorskip("cv2")

NAMES = [*H.HIGH, "h264_high_720p"]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("h264_high")
    out = {"h264_high_720p": H.CLIP_HIGH_720P}
    for name in [*H.HIGH, *H.HIGH_REFUSED]:
        p = d / f"{name}{H.suffix(name)}"
        p.write_bytes(H.build(name))
        out[name] = str(p)
    return out


# --------------------------------------------------------- (a) syntax

def test_high_cases_write_every_element_the_decoder_takes():
    """Across HIGH the writer codes transform_size_8x8_flag 0 and 1 in I_NxN
    and inter macroblocks, all 9 Intra8x8 modes, 8x8 blocks of intra and
    inter macroblocks at QPs 0-51, every CABAC context of ctxIdx 399-435
    (the flag, ctxBlockCat 5's significance maps and levels, with the level
    suffix), SPS lists explicit, use-default and absent, an SPS whose flag
    has no list, PPS lists under rule B (the SPS has lists) and rule A (it
    has none), a list ending in repeats, and two chroma QP offsets apart,
    in MP4, QuickTime and AVI."""
    seen = set()
    for name in H.HIGH:
        H.stream(name)
        seen |= H.SEEN[name]

    def values(key):
        return {k[1:] for k in seen if k[0] == key}

    assert values("transform_size_8x8_flag") == {(i, f) for i in (False, True)
                                                 for f in (False, True)}
    assert values("Intra8x8") == {(m,) for m in range(9)}
    assert values("8x8 block") == {(False,), (True,)}
    assert values("ctx") == {(c,) for c in range(399, 436)}
    assert (5,) in values("cabac level suffix")
    assert values("qp") == {(q,) for q in range(52)}
    sps = {k[1] for k in values("scaling") if k[0] == "sps"}
    assert (None,) * 8 in sps
    assert {"explicit", "default", None} <= {c for spec in sps for c in spec}
    assert {k[2] for k in values("scaling") if k[0] == "pps"} == {False, True}
    assert ("repeat",) in values("scaling")
    params = [dict(H._defaults(), **kw) for kw in H.HIGH.values()]
    assert any(p.get("chroma_offset2", p["chroma_offset"]) != p["chroma_offset"] and
               p["qp"] == (0, 51) for p in params)
    assert {p["container"] for p in params} == {"mp4", "mov", "avi"}
    assert any(p["bframes"] and p["pyramid"] and p["direct8x8"] for p in params)


@pytest.mark.parametrize("case", ["flat", "rule_a", "rule_b", "pps_rule_a", "pps_keeps_8x8"])
def test_scaling_lists_follow_the_fallback_rules(case):
    """scaling_matrices (the lists the writer dequantises with) against the
    standard's Table 7-2: without the flag an SPS is Flat_16 and a PPS its
    SPS's; an absent list 0, 3, 6 or 7 is Default_* (rule A) or the SPS's
    (rule B), the others the list before; use-default gives Default_*; a
    PPS without the 8x8 transform keeps the SPS's 8x8 lists."""
    ex4, ex8 = tuple(range(1, 17)), tuple(range(101, 165))
    raster4 = tuple(ex4[H.ZIGZAG.index(r)] for r in range(16))
    raster8 = tuple(ex8[H.ZIGZAG8.index(r)] for r in range(64))
    seq = H.scaling_matrices([ex4, None, "default", None, None, None, ex8, None])
    if case == "flat":
        assert H.scaling_matrices(None) == [H.FLAT4] * 6 + [H.FLAT8] * 2
        assert H.scaling_matrices(None, (seq, True)) == seq
    elif case == "rule_a":
        assert seq == [raster4, raster4, H.DEFAULT4[0], H.DEFAULT4[1], H.DEFAULT4[1],
                       H.DEFAULT4[1], raster8, H.DEFAULT8[1]]
        assert H.scaling_matrices([None] * 8) == [H.DEFAULT4[0]] * 3 + [H.DEFAULT4[1]] * 3 + \
            list(H.DEFAULT8)
    elif case == "rule_b":
        got = H.scaling_matrices([None, None, ex4, "default", None, None, None, "default"],
                                 (seq, True))
        assert got == [raster4, raster4, raster4, H.DEFAULT4[1], H.DEFAULT4[1], H.DEFAULT4[1],
                       raster8, H.DEFAULT8[1]]
    elif case == "pps_rule_a":
        flat = H.scaling_matrices(None)
        got = H.scaling_matrices([None, ex4, None, None, None, None, None, ex8], (flat, False))
        assert got == [H.DEFAULT4[0], raster4, raster4, H.DEFAULT4[1], H.DEFAULT4[1],
                       H.DEFAULT4[1], H.DEFAULT8[0], raster8]
    else:
        got = H.scaling_matrices([ex4] * 6, (seq, True))
        assert got == [raster4] * 6 + seq[6:]


# ----------------------------------------------------------- (b) pins

@pytest.mark.parametrize("name", NAMES)
def test_jax_reader_gives_the_pins(paths, name):
    path, pin = paths[name], H.PINNED[name]
    cap = cv2.VideoCapture(path)
    assert (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)) == (
        pin["count"], pin["fps"])
    frames = _read_all(cap)
    assert A.sha256(frames) == pin["sha256"]
    assert A.observe(JR, path, frames, H.seeks(name), exact=True) == {
        k: pin[k] for k in ("order", "start", "ui")}


@pytest.mark.parametrize("name", NAMES)
def test_port_gives_the_pins_without_cv2(paths, name, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    path, pin = paths[name], H.PINNED[name]
    reader = video.open_reader(path)
    assert (reader.codec, reader.frame_count, reader.fps) == ("h264", pin["count"], pin["fps"])
    frames = _read_all(reader)
    reader.release()
    assert A.sha256(frames) == pin["sha256"]
    assert A.observe(runner, path, frames, H.seeks(name), exact=True) == {
        k: pin[k] for k in ("order", "start", "ui")}


@pytest.mark.parametrize("name", H.HIGH_CABAC)
def test_cabac_case_decodes_as_its_cavlc_twin(tmp_path, name, monkeypatch):
    """The CAVLC stream of the same seed gives the CABAC case's pinned
    frames in the JAX reader and in the port with cv2 blocked."""
    path = str(tmp_path / f"{name}_cavlc{H.suffix(name)}")
    with open(path, "wb") as f:
        f.write(H.build_twin(name))
    cap = cv2.VideoCapture(path)
    assert A.sha256(_read_all(cap)) == H.PINNED[name]["sha256"]
    monkeypatch.setitem(sys.modules, "cv2", None)
    reader = video.open_reader(path)
    assert A.sha256(_read_all(reader)) == H.PINNED[name]["sha256"]
    reader.release()


def test_high_clip_is_x264s_default_layout():
    """tests/data/h264_high_720p.mp4 (encode_clip with high) codes the 8
    frames as I P B B P B B P in CABAC under High profile: the 8x8 transform
    on, flat matrices (no scaling lists, x264's --cqm flat), the I picture's
    macroblocks below the first row Intra8x8, with composition offsets, in
    1.5 MB or less."""
    with open(H.CLIP_HIGH_720P, "rb") as f:
        track = bmff.parse(f, os.path.getsize(H.CLIP_HIGH_720P))
    wr = H._ClipWriter(720, 1280, 26, cabac=True, bframes=True, high=True).wr
    assert wr.transform8 and wr.sps_spec is None and wr.pps_spec is None
    assert track.extra == H.avcc(wr.sps(), wr.pps())
    assert track.extra[1] == 100 and track.nal_length == 4
    assert [s.pts // 512 for s in track.samples] == [0, 3, 1, 2, 6, 4, 5, 7]
    assert (track.start_pts, track.video_delay) == (0, 1)
    assert os.path.getsize(H.CLIP_HIGH_720P) <= 1_500_000


# ------------------------------------------------------- (c) refusals

@pytest.mark.parametrize("name", list(H.HIGH_REFUSED))
def test_refused_high_features_are_named(paths, name, monkeypatch):
    path, (_, word) = paths[name], H.HIGH_REFUSED[name]
    with pytest.raises(video.UnsupportedVideo) as e:
        video.open_reader(path)
    for w in (path, "ISO BMFF", "avc1", word, "H.264", "OpenCV"):
        assert w in str(e.value), (w, str(e.value))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="--video") as e:
        list(runner.frame_source(runner.PipelineConfig(video=path)))
    for w in (path, word, "OpenCV"):
        assert w in str(e.value)


# --------------------------------------------------- (d) rtpose --video

def test_rtpose_video_h264_high_matches_jax_pipeline(tmp_path, monkeypatch):
    """A High profile MP4 (CABAC, I P B with the 8x8 transform) of 3 random
    96x72 frames through both pipelines (64x48 net input, a 2-stage COCO net
    with fan-in weights, relaxed thresholds): the same bodies within 1 px
    and 0.01 confidence, as test_torch_h264 holds for Main profile."""
    import jax.numpy as jnp

    from caffe_rtpose_tpu.core.net import Net as JNet
    from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
    from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
    from caffe_rtpose_tpu_torch.core.net import params_from_jax
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.pipeline.runner import RtPosePipeline
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

    res, disp = (64, 48), (96, 72)
    rs = np.random.RandomState(1)
    path = tmp_path / "clip.mp4"
    path.write_bytes(H.encode_clip([(rs.rand(disp[1], disp[0], 3) * 255).astype(np.uint8)
                                    for _ in range(3)], 26, cabac=True, bframes=True, high=True))
    assert video.open_reader(str(path))._extra[1] == 100
    monkeypatch.setattr(JNet, "init_params", _zero_params)
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=res, input_u8=True)
    for name in sorted(jest.net.params):
        w, b = (np.asarray(p) for p in jest.net.params[name])
        kh, kw, cin, _ = w.shape
        jest.net.params[name] = [
            jnp.asarray(rs.randn(*w.shape).astype(np.float32) * np.sqrt(2.0 / (kh * kw * cin))),
            jnp.asarray(rs.randn(*b.shape).astype(np.float32) * 0.05)]
    est = PoseEstimator(make_pose_deploy_net("COCO", stages=2), weights=params_from_jax(
        jest.net.params), net_resolution=res, input_u8=True, device="cpu")
    for e in (jest, est):
        e.params_connect = dataclasses.replace(e.params_connect, inter_threshold=-10.0,
                                               min_subset_score=-10.0, min_subset_cnt=0)
    outs = {}
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False  # torch's own CPU convolution sums closer to XLA's
    try:
        for tag, mod, e in (("jax", JR, jest), ("port", runner, est)):
            out = tmp_path / tag
            cfg = mod.PipelineConfig(video=str(path), resolution=disp, net_resolution=res,
                                     write_json=str(out), no_display=True, no_frame_drops=True,
                                     nms_threshold=-1.0)
            assert (mod.RtPosePipeline if mod is JR else RtPosePipeline)(e, cfg).run() == 3
            outs[tag] = out
    finally:
        torch.backends.mkldnn.enabled = prev
    names = [f"frame{i:06d}.json" for i in range(3)]
    assert sorted(os.listdir(outs["jax"])) == sorted(os.listdir(outs["port"])) == names
    people = 0
    for name in names:
        bj = json.load(open(outs["jax"] / name))["bodies"]
        bt = json.load(open(outs["port"] / name))["bodies"]
        assert len(bt) == len(bj)
        people += len(bj)
        for a, b in zip(bt, bj):
            a, b = np.asarray(a["joints"]).reshape(-1, 3), np.asarray(b["joints"]).reshape(-1, 3)
            np.testing.assert_allclose(a[:, :2], b[:, :2], rtol=0, atol=1.0)
            np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=0, atol=0.01)
    assert people > 0
