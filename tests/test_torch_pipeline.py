"""The port's realtime pipeline (pipeline/queues.py, pipeline/runner.py):
the cases of tests/test_pipeline.py on the port's pipeline (reorder
buffer, keyboard UI, video source, drop policies, partial batches), built
on the built-in graph instead of the reference prototxt; and parity with
the JAX pipeline over the same image directory.

Parity budget: the same JSON file names and people counts; joints within
1 px and 0.01 confidence (the project's joint budget); write_json_file
byte-identical to JAX's on the same array.
"""

import dataclasses
import json
import os
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.pipeline import runner as JR
from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
from caffe_rtpose_tpu_torch.core.net import params_from_jax
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.pipeline.queues import OrderedBuffer
from caffe_rtpose_tpu_torch.pipeline.runner import (PipelineConfig, RtPosePipeline, UIState,
                                                    frame_source, handle_key, write_json_file)
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

cv2 = pytest.importorskip("cv2")

RES = (96, 64)


@pytest.fixture(scope="module")
def est():
    return PoseEstimator(make_pose_deploy_net("COCO", stages=2), net_resolution=RES,
                         input_u8=True, device="cpu")


def _frames(seed, n):
    rs = np.random.RandomState(seed)
    return [(rs.rand(RES[1], RES[0], 3) * 255).astype(np.uint8) for _ in range(n)]


# ------------------------------------------------------------ reorder buffer

def test_ordered_buffer_inorder():
    ob = OrderedBuffer()
    assert ob.push(1, "a") == ["a"]
    assert ob.push(2, "b") == ["b"]
    assert ob.push(4, "d") == []
    assert ob.push(3, "c") == ["c", "d"]


def test_ordered_buffer_dropped():
    ob = OrderedBuffer()
    ob.push_dropped(1)
    assert ob.push(2, "b") == ["b"]
    ob.push_dropped(3)
    ob.push_dropped(4)
    assert ob.push(5, "e") == ["e"]


def test_ordered_buffer_overflow_flush():
    ob = OrderedBuffer(buffer_size=2)
    assert ob.push(3, "c") == []
    assert ob.push(4, "d") == []
    assert ob.push(5, "e") == ["c", "d", "e"]


def test_overflow_never_regresses_next():
    b = OrderedBuffer(buffer_size=2)
    assert b.push(1, "f1") == ["f1"]
    assert b.push(3, "f3") == []
    assert b.push(4, "f4") == []
    assert b.push(5, "f5") == ["f3", "f4", "f5"]
    assert b.push(6, "f6") == ["f6"]
    assert b.push(2, "f2") == ["f2"]
    assert b.push(7, "f7") == ["f7"]


def test_stale_dropped_entries_do_not_block():
    b = OrderedBuffer(buffer_size=2)
    b.push_dropped(2)
    assert b.push(1, "f1") == ["f1"]
    assert b.push(4, "f4") == []
    assert b.push(5, "f5") == []
    assert b.push(6, "f6") == ["f4", "f5", "f6"]
    b.push_dropped(7)
    out = b.push(8, "f8")
    assert out and out[-1] == "f8"


# --------------------------------------------------------------- keyboard UI

def _ui():
    return UIState(nms_threshold=0.05, inter_threshold=0.05, min_subset_score=0.4,
                   min_subset_cnt=3, inter_min_above_threshold=9)


def test_quit_and_toggles():
    ui = _ui()
    assert handle_key(ui, ord("g"), False) and ui.googly_eyes
    assert handle_key(ui, ord("f"), False) and ui.fullscreen
    assert handle_key(ui, ord(" "), False) and ui.paused
    assert not handle_key(ui, 27, False) and ui.quit


def test_threshold_tuning():
    ui = _ui()
    handle_key(ui, ord("="), False)
    assert abs(ui.nms_threshold - 0.055) < 1e-9
    handle_key(ui, ord("-"), False)
    assert abs(ui.nms_threshold - 0.05) < 1e-9
    handle_key(ui, ord("+"), False)
    assert abs(ui.min_subset_score - 0.405) < 1e-9
    handle_key(ui, ord("]"), False)
    assert abs(ui.inter_threshold - 0.055) < 1e-9
    handle_key(ui, ord("}"), False)
    assert ui.inter_min_above_threshold == 10
    handle_key(ui, ord("'"), False)
    assert ui.min_subset_cnt == 4


def test_part_select_and_seek():
    ui = _ui()
    handle_key(ui, ord("3"), False)
    assert ui.part_to_show == 3
    handle_key(ui, ord("q"), False)
    assert ui.part_to_show == 10
    handle_key(ui, ord(","), False)
    assert ui.part_to_show == 9
    ui.current_frame = 100
    handle_key(ui, ord("l"), True)
    assert ui.seek_to_frame and ui.current_frame == 130
    ui.seek_to_frame = False
    handle_key(ui, ord("k"), True)
    assert ui.current_frame == 100


@pytest.mark.parametrize("key", [*"0123456789qwertyuiopas", *"-=_+[]{};',.gfl k", "A", "Q"])
def test_handle_key_matches_jax(key):
    ui, jui = _ui(), JR.UIState(**dataclasses.asdict(_ui()))
    ui.current_frame = jui.current_frame = 50
    assert handle_key(ui, ord(key), True) == JR.handle_key(jui, ord(key), True)
    assert dataclasses.asdict(ui) == dataclasses.asdict(jui)


# -------------------------------------------------------------- video source

def _clip(tmp_path, n=30, fps=10, size=(64, 48)):
    path = str(tmp_path / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, size)
    for i in range(n):
        w.write(np.full((size[1], size[0], 3), i * 8 % 255, np.uint8))
    w.release()
    return path


def test_seek_applies_and_is_not_clobbered(tmp_path):
    src = frame_source(PipelineConfig(video=_clip(tmp_path), no_display=True), ui := UIState())
    for _ in range(3):
        next(src)
    ui.current_frame += 10
    ui.seek_to_frame = True
    assert next(src)[0] == 12


def test_quit_stops_source(tmp_path):
    ui = UIState()
    src = frame_source(PipelineConfig(video=_clip(tmp_path), no_display=True), ui)
    next(src)
    ui.quit = True
    assert list(src) == []


def test_video_paces_to_native_fps(tmp_path):
    path = _clip(tmp_path, n=10, fps=20, size=(32, 24))
    t0 = time.time()
    assert sum(1 for _ in frame_source(PipelineConfig(video=path, no_display=True))) == 10
    paced = time.time() - t0
    assert paced >= 0.35
    t0 = time.time()
    offline = PipelineConfig(video=path, no_display=True, no_frame_drops=True)
    assert sum(1 for _ in frame_source(offline)) == 10
    assert time.time() - t0 < paced


# ------------------------------------------------------- pipeline behaviour

def test_json_schema(tmp_path):
    joints = np.array([[[10.0, 20.0, 0.5], [30.0, 40.0, 0.25]]], np.float32)
    p = str(tmp_path / "f.json")
    write_json_file(p, joints, 1, scale=0.5, num_parts=2)
    raw = open(p).read()
    assert raw.startswith('{\n"version":0.1,\n"bodies":[\n')
    assert json.loads(raw)["bodies"][0]["joints"] == [20, 40, 0.5, 60, 80, 0.25]


@pytest.mark.parametrize("people,scale", [(0, 1.0), (1, 0.5), (3, float(np.float32(0.6667)))])
def test_write_json_file_byte_identical_to_jax(tmp_path, people, scale):
    joints = (np.random.RandomState(people).rand(people, 18, 3) * 500).astype(np.float32)
    a, b = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    write_json_file(a, joints, people, scale, 18)
    JR.write_json_file(b, joints, people, scale, 18)
    assert open(a, "rb").read() == open(b, "rb").read()


def _slow(pipe, est, seconds):
    """A device whose every pass takes ``seconds`` and returns at once after
    (the first pass's outputs, computed once): dispatch on the card is
    asynchronous, where a CPU pass would block the dispatcher."""
    outs = []

    class SlowPool:
        def run_device(self, x, **kw):
            time.sleep(seconds)
            if not outs:
                outs.append(est.run_device(x, **kw))
            return outs[0]

    pipe.pool = SlowPool()


def test_partial_batch_dispatch_wait(tmp_path):
    """A batch=4 estimator fed slower than the batch fills still emits every
    frame promptly with batch_wait_ms (partial batches are padded)."""
    est4 = PoseEstimator(make_pose_deploy_net("COCO", stages=2), net_resolution=RES,
                         input_u8=True, batch=4, device="cpu")
    frames = _frames(1, 3)

    def slow_source():
        for i in range(3):
            time.sleep(0.08)
            yield i, frames[i], None

    out = tmp_path / "json"
    cfg = PipelineConfig(resolution=RES, net_resolution=RES, no_display=True, no_frame_drops=True,
                         write_json=str(out), frame_limit=3, fetchers=2, queue_depth=2,
                         batch_wait_ms=25.0)
    pipe = RtPosePipeline(est4, cfg)
    pipe.frame_iter = slow_source()
    assert pipe.run() == 3
    assert len(os.listdir(out)) == 3
    assert all(s["e2e"] < 10.0 for s in pipe.stats)


def test_drop_policy_counts_dropped_frames(est):
    frames = _frames(2, 2)
    cfg = PipelineConfig(resolution=RES, net_resolution=RES, no_display=True,
                         no_frame_drops=False, frame_limit=10, fetchers=1, dispatchers=1,
                         queue_depth=1)
    pipe = RtPosePipeline(est, cfg)
    _slow(pipe, est, 0.15)
    pipe.frame_iter = ((i, frames[i % 2], None) for i in range(10))
    n = pipe.run()
    assert pipe.dropped > 0
    assert n + pipe.dropped == 10


def test_predictive_shed_policy(est):
    frames = _frames(3, 2)
    cfg = PipelineConfig(resolution=RES, net_resolution=RES, no_display=True,
                         no_frame_drops=False, frame_limit=12, fetchers=1, dispatchers=1,
                         queue_depth=1, drop_policy="predictive")
    pipe = RtPosePipeline(est, cfg)
    _slow(pipe, est, 0.15)

    def paced():
        for i in range(12):
            time.sleep(0.04)
            yield i, frames[i % 2], None

    pipe.frame_iter = paced()
    n = pipe.run()
    assert n + pipe.dropped == 12
    assert pipe.dropped > 0
    assert n >= 2
    assert pipe._service_ema is not None and pipe._service_ema > 0.1


def test_predictive_shed_never_drops_final_frame(est, monkeypatch):
    frames = _frames(4, 2)
    cfg = PipelineConfig(resolution=RES, net_resolution=RES, no_display=True,
                         no_frame_drops=False, fetchers=1, dispatchers=1, queue_depth=1,
                         drop_policy="predictive")
    pipe = RtPosePipeline(est, cfg)
    _slow(pipe, est, 0.11)
    pipe._service_ema = 0.12
    dropped = []
    orig = OrderedBuffer.push_dropped
    monkeypatch.setattr(OrderedBuffer, "push_dropped",
                        lambda self, index: (dropped.append(index), orig(self, index))[1])

    def paced():
        yield 0, frames[0], None
        time.sleep(0.035)
        yield 1, frames[1], None
        time.sleep(0.035)
        yield 2, frames[0], None

    pipe.frame_iter = paced()
    n = pipe.run()
    assert n + pipe.dropped == 3
    assert 3 not in dropped
    assert pipe._service_ema is not None and pipe._service_ema > 0.1


def test_many_frames_ordered_no_drops(tmp_path, est):
    """120 PNG frames through the full pipeline, drops off: every frame
    written, in order."""
    d = tmp_path / "imgs"
    d.mkdir()
    base = _frames(0, 1)[0]
    for i in range(120):
        img = base.copy()
        cv2.putText(img, str(i), (5, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
        cv2.imwrite(str(d / f"f{i:04d}.png"), img)
    out = tmp_path / "out"
    cfg = PipelineConfig(image_dir=str(d), resolution=RES, net_resolution=RES, no_display=True,
                         write_json=str(out), no_frame_drops=True, fetchers=4)
    assert RtPosePipeline(est, cfg).run() == 120
    files = sorted(os.listdir(out))
    assert files == [f"f{i:04d}.json" for i in range(120)]


def test_options_that_need_what_is_not_ported_or_cv2(est, tmp_path, monkeypatch):
    """num_devices > 1 once raised NotImplementedError; it builds the device
    pool now (two replicas on the CPU for a CPU estimator). The options that
    need OpenCV still stop at once without it and name the option. The text
    overlay on --write_frames needs no cv2: frames with text are written
    with cv2 blocked, each file the bytes encode_jpeg gives at quality 98
    for the JAX runner's overlay on the same rendered canvas (its fps label
    fixed by fixing _emit_times in both runners).  A Motion-JPEG AVI runs
    end to end without cv2 (each JSON equal to estimate() on the frame
    CAP_OPENCV_MJPEG reads, libjpeg's pixels), and so does an mp4v MP4 (each
    JSON equal to estimate() on cv2's frame, which the port's MPEG-4 decoder
    gives bit for bit); a video the port refuses (FFV1) still stops at
    construction naming --video."""
    from caffe_rtpose_tpu_torch.parallel.inference import DevicePool
    from caffe_rtpose_tpu_torch.pipeline import runner

    pool = RtPosePipeline(est, PipelineConfig(num_devices=2)).pool
    assert isinstance(pool, DevicePool) and len(pool.replicas) == 2
    import sys

    d = tmp_path / "jpgs"
    d.mkdir()
    for i, img in enumerate(_frames(0, 2)):
        cv2.imwrite(str(d / f"f{i}.jpg"), img)
    clip, other = str(tmp_path / "clip.avi"), str(tmp_path / "clip_ffv1.avi")
    mp4 = str(tmp_path / "clip.mp4")
    for path, api, fourcc in ((clip, cv2.CAP_OPENCV_MJPEG, "MJPG"),
                              (other, cv2.CAP_FFMPEG, "FFV1"), (mp4, cv2.CAP_FFMPEG, "mp4v")):
        w = cv2.VideoWriter(path, api, cv2.VideoWriter_fourcc(*fourcc), 10, RES)
        for img in _frames(1, 2):
            w.write(img)
        w.release()
    cap = cv2.VideoCapture(clip, cv2.CAP_OPENCV_MJPEG)
    clip_frames = [cap.read()[1] for _ in range(2)]
    cap = cv2.VideoCapture(mp4)
    mp4_frames = [cap.read()[1] for _ in range(2)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    for kw, name in ((dict(video=other), "--video"),
                     (dict(no_display=False), "display")):
        with pytest.raises(RuntimeError, match=name):
            RtPosePipeline(est, PipelineConfig(**kw))
    for video, frames in ((clip, clip_frames), (mp4, mp4_frames)):
        out = tmp_path / f"video_json_{os.path.basename(video)}"
        cfg = PipelineConfig(video=video, resolution=RES, net_resolution=RES, no_display=True,
                             write_json=str(out), no_frame_drops=True)
        assert RtPosePipeline(est, cfg).run() == 2
        assert sorted(os.listdir(out)) == ["frame000000.json", "frame000001.json"]
        for i, frame in enumerate(frames):
            res, pf = est.estimate(frame, *RES)
            write_json_file(str(tmp_path / "ref.json"), res.joints, res.num_people,
                            float(np.float32(pf.scale)), est.num_parts)
            assert (out / f"frame{i:06d}.json").read_text() == (tmp_path / "ref.json").read_text()
    RtPosePipeline(est, PipelineConfig(write_frames=str(tmp_path / "w")))  # text: no cv2
    with pytest.raises(RuntimeError, match="--camera"):
        RtPosePipeline(est, PipelineConfig()).run()
    # a JPEG directory, frames written without and with the text overlay and
    # JSON, all without cv2
    emit_times = [100.0, 100.25, 100.5]
    canvases = []  # (rendered canvas, frame) of each frame the overlay draws on
    overlay = runner.RtPosePipeline._overlay_text

    def fixed_overlay(self, canvas, f):
        self._emit_times[:] = emit_times
        canvases.append((np.array(canvas), f.num_people))
        return overlay(self, canvas, f)

    monkeypatch.setattr(runner.RtPosePipeline, "_overlay_text", fixed_overlay)
    for text in (False, True):
        out, frames = tmp_path / f"json{text}", tmp_path / f"frames{text}"
        cfg = PipelineConfig(image_dir=str(d), resolution=RES, net_resolution=RES,
                             no_display=True, write_json=str(out), write_frames=str(frames),
                             no_text=not text, no_frame_drops=True, part_to_show=3)
        assert RtPosePipeline(est, cfg).run() == 2
        assert sorted(os.listdir(out)) == ["f0.json", "f1.json"]
        assert sorted(os.listdir(frames)) == ["f0.jpg", "f1.jpg"]
    assert len(canvases) == 2
    jax = JR.RtPosePipeline.__new__(JR.RtPosePipeline)
    jax.cfg = JR.PipelineConfig(write_frames=str(frames))
    jax.ui = JR.UIState(part_to_show=3)
    jax.est = types.SimpleNamespace(descriptor=est.descriptor)
    jax._emit_times = list(emit_times)
    for (canvas, people), name in zip(canvases, ("f0.jpg", "f1.jpg")):
        frame = types.SimpleNamespace(num_people=people)
        want = runner.encode_jpeg(jax._overlay_text(canvas, frame), 98)
        assert (frames / name).read_bytes() == want


# ------------------------------------------------------------ JAX parity

def test_pipeline_matches_jax_pipeline(tmp_path, parity_estimators):
    """The same PNG directory through both pipelines, display = frame size
    (identity warp), 192x120 frames -> 128x80 net input (INTER_AREA), a
    2-stage COCO net with the JAX net's fan-in weights, relaxed thresholds
    so people are found."""
    _pipeline_parity(tmp_path, parity_estimators, "png")


def test_pipeline_jpeg_matches_jax_pipeline(tmp_path, monkeypatch, parity_estimators):
    """The same over a JPEG directory (JAX reads it with cv2.imread, the port
    with its codec), the port also writing frames (--write_frames,
    --no_text): each file holds the bytes cv2.imencode gives at quality 98
    for the canvas the port rendered, which is what JAX's cv2.imwrite
    (runner.py:554) writes for a canvas."""
    from caffe_rtpose_tpu_torch.pipeline import runner

    canvases = []

    def recording(canvas, quality):
        canvases.append((np.array(canvas), quality))
        return encode(canvas, quality)

    encode = runner.encode_jpeg
    monkeypatch.setattr(runner, "encode_jpeg", recording)
    frames = _pipeline_parity(tmp_path, parity_estimators, "jpg",
                              write_frames=str(tmp_path / "frames"))
    names = sorted(os.listdir(frames))
    assert names == ["im0.jpg", "im1.jpg", "im2.jpg"] and len(canvases) == 3
    for name, (canvas, quality) in zip(names, canvases):
        assert quality == 98
        ok, ref = cv2.imencode(".jpg", canvas, [int(cv2.IMWRITE_JPEG_QUALITY), 98])
        assert ok and (frames / name).read_bytes() == ref.tobytes()


@pytest.fixture(scope="module")
def parity_estimators():
    """The JAX and port COCO 2-stage estimators the parity tests compare
    (128x80 u8 input, the JAX net's fan-in weights, relaxed thresholds),
    built once, and the random state the weights left, which draws the
    frames."""
    res = (128, 80)
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=res, input_u8=True)
    rs = np.random.RandomState(0)
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
    return jest, est, rs.get_state()


def _pipeline_parity(tmp_path, estimators, ext, write_frames=""):
    res, disp = (128, 80), (192, 120)
    jest, est, state = estimators
    rs = np.random.RandomState()
    rs.set_state(state)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(3):
        cv2.imwrite(str(img_dir / f"im{i}.{ext}"),
                    (rs.rand(disp[1], disp[0], 3) * 255).astype(np.uint8))
    outs = {}
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False  # torch's own CPU convolution sums closer to XLA's
    try:
        for tag, mod, e in (("jax", JR, jest), ("port", None, est)):
            out = tmp_path / tag
            kw = dict(image_dir=str(img_dir), resolution=disp, net_resolution=res,
                      write_json=str(out), no_display=True, no_frame_drops=True, fetchers=2,
                      nms_threshold=-1.0)
            pipe = (mod.RtPosePipeline(e, mod.PipelineConfig(**kw)) if mod
                    else RtPosePipeline(e, PipelineConfig(**kw, write_frames=write_frames,
                                                          no_text=True)))
            assert pipe.run() == 3
            outs[tag] = out
    finally:
        torch.backends.mkldnn.enabled = prev
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"])) == ["im0.json", "im1.json", "im2.json"]
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
    return tmp_path / "frames"
