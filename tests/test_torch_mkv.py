"""The port's Matroska reader (caffe_rtpose_tpu_torch/pipeline/matroska.py
behind video.MkvReader) against the JAX package's reader,
``cv2.VideoCapture`` with its default backend (FFMPEG) inside
``caffe_rtpose_tpu.pipeline.runner.frame_source``, on the files of
tests/mkv_cases.py (EBML written around the repo's MPEG-4 Part 2,
Motion-JPEG and H.264 packets, and two files cv2's writer wrote):

(a) every packet the port hands its decoder equals the packet cv2 gives in
    raw mode (``CAP_PROP_FORMAT`` -1), in order: lacing, header stripping
    and zlib undone (H.264 in V_MPEG4/ISO/AVC: the same NAL units, as cv2
    converts its packets to Annex B); each frame's timestamp equals cv2's
    ``CAP_PROP_POS_MSEC``;
(b) frame count, fps, order, frames (sha256), ``start_frame`` and ui seeks
    equal the JAX reader's, pinned in mkv_cases.PINNED, and the port gives
    the pins with cv2 blocked; the rates without DefaultDuration
    (mkv_cases.RATES); tests/data/h264_high_720p.mp4 remuxed reads as the MP4;
(c) each refused file raises naming the file, the container, the CodecID
    and the feature; with cv2 it goes to OpenCV, and a file the port takes
    never does.
"""

import sys

import numpy as np
import pytest

import avi_cases as A
import h264_cases as H
import mkv_cases as K
import mp4_cases as M
from caffe_rtpose_tpu.pipeline import runner as JR
from caffe_rtpose_tpu_torch.pipeline import h264, matroska, mpeg4, runner, video
from caffe_rtpose_tpu_torch.pipeline.runner import PipelineConfig, frame_source

cv2 = pytest.importorskip("cv2")

FILES = [*K.CASES, *K.CLIPS]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mkv")
    out = {n: K.clip_path(n) for n in K.CLIPS}
    for name in [*K.CASES, *K.REFUSED]:
        p = d / f"{name}.{'webm' if name == 'vp8' else 'mkv'}"
        p.write_bytes(K.build(name))
        out[name] = str(p)
    return out


def _read_all(reader):
    out = []
    while True:
        ok, img = reader.read()
        if not ok:
            return out
        out.append(img)


def _sources(name, frames):
    return frames if K.exact(name) else M.sources("mp4v_mp4")


@pytest.fixture(scope="module")
def jax_reads(paths):
    """What the JAX reader gives for every file, read once: (count, fps,
    the frames a read from the start gives, the observed reads)."""
    out = {}
    for name in FILES:
        cap = cv2.VideoCapture(paths[name])
        head = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS))
        frames = _read_all(cap)
        cap.release()
        out[name] = head, frames, A.observe(JR, paths[name], _sources(name, frames), K.SEEKS,
                                            exact=K.exact(name))
    return out


def _nal_units(packet, annexb):
    """The NAL units of an H.264 packet but its parameter sets (cv2's raw
    mode inserts them before IDR pictures)."""
    units = []
    if annexb:
        at = [i for i in range(len(packet) - 2) if packet[i:i + 3] == b"\x00\x00\x01"]
        for a, b in zip(at, at[1:] + [len(packet) + 3]):
            units.append(packet[a + 3:b - 1 if packet[b - 1:b] == b"\x00" else b].rstrip(b"\x00"))
    else:
        pos = 0
        while pos < len(packet):
            n = int.from_bytes(packet[pos:pos + 4], "big")
            units.append(packet[pos + 4:pos + 4 + n])
            pos += 4 + n
    return [u for u in units if u[0] & 31 not in (7, 8)]


# ---------------------------------------------------------- (a) packets

@pytest.mark.parametrize("name", FILES)
def test_packets_and_timestamps_equal_cv2s(paths, name):
    reader = video.open_reader(paths[name])
    got = [reader.packet(i) for i in range(len(reader.frames))]
    pts = [(f.pts - reader._start_time) * reader._time_base * 1000 for f in reader.frames]
    avc = reader._nal_length
    reader.release()
    cap = cv2.VideoCapture(paths[name])
    assert cap.set(cv2.CAP_PROP_FORMAT, -1)
    want, msec = [], []
    while True:
        ok, pk = cap.read()
        if not ok:
            break
        want.append(pk.reshape(-1).tobytes())
        msec.append(cap.get(cv2.CAP_PROP_POS_MSEC))
    assert len(got) == len(want)
    if avc:
        assert [_nal_units(p, False) for p in got] == [_nal_units(p, True) for p in want]
    else:
        assert got == want
    # raw mode numbers each packet by its own timestamp (pts, or dts in V_MS/VFW/FOURCC)
    assert np.allclose(pts, msec, rtol=0, atol=1e-9)


def test_readers_and_codecs(paths):
    kinds = {}
    for name in ("mp4v_simple", "xvid_vfw", "mjpeg_simple", "mjpeg_vfw", "h264_cavlc", "h264_vfw",
                 "mp4v_webm", *K.CLIPS):
        r = video.open_reader(paths[name])
        kinds[name] = (type(r).__name__, r.codec, r.fourcc, r._number_by_trigger)
        r.release()
    assert kinds == {
        "mp4v_simple": ("MkvReader", "mpeg4", "V_MPEG4/ISO/ASP", False),
        "xvid_vfw": ("MkvReader", "mpeg4", "XVID", True),
        "mjpeg_simple": ("MkvReader", "mjpeg", "V_MJPEG", False),
        "mjpeg_vfw": ("MkvReader", "mjpeg", "MJPG", True),
        "h264_cavlc": ("MkvReader", "h264", "V_MPEG4/ISO/AVC", False),
        "h264_vfw": ("MkvReader", "h264", "H264", True),
        "mp4v_webm": ("MkvReader", "mpeg4", "V_MPEG4/ISO/ASP", False),
        "mjpeg_mkv": ("MkvReader", "mjpeg", "V_MJPEG", False),
        "mp4v_mkv": ("MkvReader", "mpeg4", "V_MPEG4/ISO/ASP", False)}


def test_laces_and_seek_index(paths):
    """Xiph lacing of 3 at DefaultDuration 33366667 ns: the block lasts 100
    ticks, its laces follow at 33, 33 and 34, and only the first is a key
    frame; the seek index holds each key frame at its Cluster's first
    frame, and the Cues' entries (every other key frame, before the
    clusters) at theirs."""
    with open(paths["mp4v_xiph"], "rb") as f:
        track = matroska.parse(f, len(K.build("mp4v_xiph")))
    assert [s.pts for s in track.samples[:4]] == [0, 33, 66, 100]
    assert [i for i, s in enumerate(track.samples) if s.key] == [0, 12, 24]
    assert track.durations[:3] == [33, 33, 34]
    assert track.seek_index == [(0, 0), (400, 12), (801, 24)]
    with open(paths["mp4v_cues_first"], "rb") as f:
        track = matroska.parse(f, len(K.build("mp4v_cues_first")))
    assert track.seek_index == [(0, 0), (480, 12), (960, 24)]


# ---------------------------------------------------------------- (b) pins

@pytest.mark.parametrize("name", FILES)
def test_jax_reader_gives_the_pins(jax_reads, name):
    (count, fps), frames, reads = jax_reads[name]
    pin = K.PINNED[name]
    assert (count, fps, A.sha256(frames)) == (pin["count"], pin["fps"], pin["sha256"])
    assert reads == {k: pin[k] for k in ("order", "start", "ui")}


@pytest.mark.parametrize("name", FILES)
def test_port_gives_the_pins_without_cv2(paths, jax_reads, name, monkeypatch):
    path, pin = paths[name], K.PINNED[name]
    cap = runner.open_video(path)
    assert isinstance(cap, video.MkvReader)  # never cv2's
    cap.release()
    monkeypatch.setitem(sys.modules, "cv2", None)
    reader = video.open_reader(path)
    assert (reader.frame_count, reader.fps) == (pin["count"], pin["fps"])
    assert A.sha256(_read_all(reader)) == pin["sha256"]
    reader.release()
    assert A.observe(runner, path, _sources(name, jax_reads[name][1]), K.SEEKS,
                     exact=K.exact(name)) == {k: pin[k] for k in ("order", "start", "ui")}


@pytest.mark.parametrize("name", list(K.RATES))
def test_rates_without_default_duration(tmp_path, name, monkeypatch):
    path = str(tmp_path / f"{name}.mkv")
    with open(path, "wb") as f:
        f.write(K.build_rate(name))
    _, _, count, fps = K.RATES[name]
    cap = cv2.VideoCapture(path)
    assert (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)) == (count, fps)
    monkeypatch.setitem(sys.modules, "cv2", None)
    reader = video.open_reader(path)
    assert (reader.frame_count, reader.fps) == (count, fps)
    reader.release()


def test_720p_high_profile_remux_reads_as_the_mp4(tmp_path, monkeypatch):
    """tests/data/h264_high_720p.mp4 remuxed (I P B B, blocks at their
    presentation times): cv2 and the port give the MP4's frames."""
    path = str(tmp_path / "high.mkv")
    with open(path, "wb") as f:
        f.write(K.remux_mp4(H.CLIP_HIGH_720P))
    pin = H.PINNED["h264_high_720p"]
    cap = cv2.VideoCapture(path)
    assert (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)) == (8, 25.0)
    assert A.sha256(_read_all(cap)) == pin["sha256"]
    monkeypatch.setitem(sys.modules, "cv2", None)
    reader = video.open_reader(path)
    assert (reader.frame_count, reader.fps) == (8, 25.0)
    assert A.sha256(_read_all(reader)) == pin["sha256"]
    reader.release()


def test_rate_helpers():
    """av_reduce, and the codec rates libavformat falls back on: the VOL's
    (25, 1) in mp4v.mp4, an SPS's VUI timing (time_scale 50, one tick: 25
    fps), none without timing."""
    assert matroska.reduce(10**9, 33366667, 30000) == (30000, 1001)
    assert matroska.reduce(10**9, 41708333, 30000) == (24000, 1001)
    assert matroska.reduce(10**9, 12345678, 30000) == (81, 1)
    assert matroska.reduce(10**9, 40_000_000, 30000) == (25, 1)
    assert matroska.reduce(-6, 4, 100) == (-3, 2)
    assert mpeg4.vol_frame_rate(K.mp4v_sources()[1]) == (25, 1)
    for name, rate in (("full_range", (25, 1)), ("pcm_skip", None)):
        sps = H.stream(name)[2]
        assert h264.sps_frame_rate(sps) == rate


# ----------------------------------------------------------- (c) refusals

@pytest.mark.parametrize("name", list(K.REFUSED))
def test_refused_files_name_the_refusal(paths, name, monkeypatch):
    path, (_, kw, why) = paths[name], K.REFUSED[name]
    codec_id = K.codec_id(name)
    with pytest.raises(video.UnsupportedVideo) as e:
        video.open_reader(path)
    container = "WebM" if kw.get("doc_type") == "webm" else "Matroska"
    for word in (path, container, codec_id, why, "OpenCV"):
        assert word in str(e.value)
    if cv2.VideoCapture(path).isOpened():  # with cv2, OpenCV reads them
        cap = runner.open_video(path)
        assert isinstance(cap, runner._Cv2Capture)
        cap.release()
    else:
        with pytest.raises(RuntimeError, match="Couldn't open video"):
            runner.open_video(path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="--video") as e:
        list(frame_source(PipelineConfig(video=path)))
    for word in (container, codec_id, why, "OpenCV"):
        assert word in str(e.value)


def test_vp8_webm_cv2_wrote_goes_to_opencv(tmp_path):
    path = str(tmp_path / "vp8.webm")
    frames = M.sources("mp4v_mp4")[:6]
    wr = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"VP80"), 25, (100, 74))
    for f in frames:
        wr.write(f)
    wr.release()
    with pytest.raises(video.UnsupportedVideo) as e:
        video.open_reader(path)
    for word in (path, "WebM", "V_VP8", "OpenCV"):
        assert word in str(e.value)
    got = [img for _, img, _ in frame_source(PipelineConfig(video=path, no_frame_drops=True))]
    assert len(got) == 6 and got[0].shape == (74, 100, 3)
