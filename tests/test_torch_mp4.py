"""The port's MP4/QuickTime reader (caffe_rtpose_tpu_torch/pipeline/bmff.py
behind video.Mp4Reader) and its AVI reader on MPEG-4 Part 2, against the
JAX package's reader, ``cv2.VideoCapture`` with its default backend (FFMPEG)
inside ``caffe_rtpose_tpu.pipeline.runner.frame_source``:

(a) every packet the port hands its decoder equals the packet cv2 gives in
    raw mode (``CAP_PROP_FORMAT`` -1), in order: the clips cv2's writers
    wrote (tests/data) and the crafted layouts of tests/mp4_cases.py;
(b) frame indices, count, order, fps, ``start_frame`` and ui seeks (past
    the end, to P-frames and into the second and third GOP) equal the JAX
    frame_source's, pinned in mp4_cases.PINNED, and the port gives the pins
    with cv2 blocked;
(d) layouts the reader refuses raise naming the refusal, the file, the
    container and the fourcc; with cv2 they go to OpenCV.
"""

import io
import sys

import numpy as np
import pytest

import avi_cases as A
import mp4_cases as M
from caffe_rtpose_tpu.pipeline import runner as JR
from caffe_rtpose_tpu_torch.pipeline import bmff, runner, video
from caffe_rtpose_tpu_torch.pipeline.runner import PipelineConfig, frame_source

cv2 = pytest.importorskip("cv2")

FILES = [n for n in M.CLIPS if n != "mp4v_720p"] + list(M.CASES)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp4")
    out = {n: M.clip_path(n) for n in M.CLIPS}
    for name in [*M.CASES, *M.REFUSED_CASES]:
        p = d / f"{name}.mp4"
        p.write_bytes(M.build(name))
        out[name] = str(p)
    return out


def _sources(name):
    return M.sources(name) if name in M.CLIPS else M.case_sources(name)


def _raw_packets(path):
    cap = cv2.VideoCapture(path)
    assert cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, pk = cap.read()
        if not ok:
            return out
        out.append(pk.reshape(-1).tobytes())


def _read_all(reader):
    out = []
    while True:
        ok, img = reader.read()
        if not ok:
            return out
        out.append(img)


# ------------------------------------------------------------- (a) packets

@pytest.mark.parametrize("name", [*M.CLIPS, *M.CASES])
def test_packets_equal_cv2_raw_packets(paths, name):
    reader = video.open_reader(paths[name])
    got = [reader.packet(i) for i in range(len(reader.frames))]
    reader.release()
    want = _raw_packets(paths[name])
    # every sample, but those an edit list drops (elst_short: those after
    # the key frame at 24, past the edit's 20 frames)
    assert len(got) == len(want) == M.PINNED[name]["count"] - (name == "elst_short")
    assert all(a == b for a, b in zip(got, want))


def test_readers_and_codecs(paths):
    kinds = {n: video.open_reader(paths[n]) for n in M.CLIPS}
    assert {n: (type(r).__name__, r.codec, r.fourcc) for n, r in kinds.items()} == {
        "mp4v_mp4": ("Mp4Reader", "mpeg4", "mp4v"), "mp4v_mov": ("Mp4Reader", "mpeg4", "mp4v"),
        "xvid_avi": ("AviReader", "mpeg4", "XVID"), "divx_avi": ("AviReader", "mpeg4", "DIVX"),
        "mjpeg_mov": ("Mp4Reader", "mjpeg", "jpeg"),
        "motion_mp4": ("Mp4Reader", "mpeg4", "mp4v"),
        "mp4v_720p": ("Mp4Reader", "mpeg4", "mp4v")}
    keys = [f.key for f in kinds["mp4v_mp4"].frames]
    assert [i for i, k in enumerate(keys) if k] == [0, 12, 24]  # stss, as the I-VOPs
    assert [f.key for f in kinds["xvid_avi"].frames] == keys  # idx1's AVIIF_KEYFRAME
    for r in kinds.values():
        r.release()


# ---------------------------------------------------------------- (b) pins

@pytest.mark.parametrize("name", FILES)
def test_jax_reader_gives_the_pins(paths, name):
    path, pin = paths[name], M.PINNED[name]
    cap = cv2.VideoCapture(path)
    assert (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)) == (
        pin["count"], pin["fps"])
    assert A.observe(JR, path, _sources(name), M.SEEKS) == {
        k: pin[k] for k in ("order", "start", "ui")}


@pytest.mark.parametrize("name", [*FILES, "mp4v_720p"])
def test_port_gives_the_pins_without_cv2(paths, name, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    path, pin = paths[name], M.PINNED[name]
    reader = video.open_reader(path)
    assert (reader.frame_count, reader.fps) == (pin["count"], pin["fps"])
    assert A.sha256(_read_all(reader)) == pin["sha256"]
    reader.release()
    if "order" in pin:
        assert A.observe(runner, path, _sources(name), M.SEEKS) == {
            k: pin[k] for k in ("order", "start", "ui")}


def test_edit_list_and_timescale(paths):
    """elst media_time 2 frames: the 2 frames before are decoded, not
    shown, and timestamps start at 0; 30000/1001: fps 29.97..."""
    with open(paths["elst_skip2"], "rb") as f:
        track = bmff.parse(f, len(M.build("elst_skip2")))
    assert [s.discard for s in track.samples[:3]] == [True, True, False]
    assert [s.pts for s in track.samples[:3]] == [-1024, -512, 0]
    with open(paths["ntsc"], "rb") as f:
        track = bmff.parse(f, len(M.build("ntsc")))
    assert (track.timescale, track.fps, track.samples[1].pts) == (30000, 30000 / 1001, 1001)


@pytest.mark.parametrize("version,elst", [(0, True), (0, False), (1, True), (1, False)])
def test_h264_composition_offsets(version, elst):
    """ctts on an avc1 track, as libavformat's mov demuxer reads it: B
    pictures in decode order 0 2 1 4 3 5 (offsets of version 0 shifted to
    stay >= 0, with an elst whose media_time is that shift; version 1
    signed).  Each sample's pts is its dts plus its offset, less the edit's
    media_time; seeks compare decode times; the stream starts at the first
    sample's pts; the reordering gives a video delay of 1."""
    order, delta = [0, 2, 1, 4, 3, 5], 512
    shift = 0 if version else 1
    data = M.write_mp4([bytes(8)] * 6, 100, 74, fourcc=b"avc1",
                       ctts=[(v - d + shift) * delta for d, v in enumerate(order)],
                       ctts_version=version, elst=elst, edit_frames=6, media_time=shift)
    track = bmff.parse(io.BytesIO(data), len(data))
    pts = [(v + (0 if elst else shift)) * delta for v in order]
    assert [s.pts for s in track.samples] == pts
    assert [s.dts for s in track.samples] == [d * delta for d in range(6)]
    assert not any(s.discard for s in track.samples)
    assert (track.start_pts, track.video_delay) == (pts[0], 1)


# ----------------------------------------------------------- (d) refusals

@pytest.mark.parametrize("name,why", [("fragmented", "fragmented MP4"),
                                      ("ctts", "composition offsets"),
                                      ("mpeg2_esds", "object type 97")])
def test_refused_layouts_name_the_refusal(paths, name, why, monkeypatch):
    path = paths[name]
    with pytest.raises(video.UnsupportedVideo) as e:
        video.open_reader(path)
    for word in (path, "ISO BMFF", "mp4v", why, "OpenCV"):
        assert word in str(e.value)
    cap = runner.open_video(path)  # with cv2, OpenCV reads them
    assert isinstance(cap, runner._Cv2Capture)
    cap.release()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="--video") as e:
        list(frame_source(PipelineConfig(video=path)))
    for word in ("ISO BMFF", "mp4v", why, "OpenCV"):
        assert word in str(e.value)


def test_other_sample_entries_name_their_fourcc(tmp_path, monkeypatch):
    path = tmp_path / "avc1.mp4"
    path.write_bytes(A.write_mp4(b"avc1"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="--video") as e:
        runner.open_video(str(path))
    for word in (str(path), "ISO BMFF", "avc1", "OpenCV"):
        assert word in str(e.value)


def test_port_reads_go_through_the_port_with_cv2(paths):
    for name in ("mp4v_mp4", "xvid_avi", "mjpeg_mov"):
        cap = runner.open_video(paths[name])
        assert isinstance(cap, video._Reader)
        cap.release()
    got = [img for _, img, _ in frame_source(PipelineConfig(video=paths["mp4v_mov"],
                                                            no_frame_drops=True))]
    assert A.sha256(got) == M.PINNED["mp4v_mov"]["sha256"]
    assert np.asarray(got).shape == (26, 74, 100, 3)
