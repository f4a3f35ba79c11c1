"""The port's Motion-JPEG AVI reader (caffe_rtpose_tpu_torch/pipeline/video.py)
against the JAX package's reader, ``cv2.VideoCapture`` with its default
backend (FFMPEG) inside ``caffe_rtpose_tpu.pipeline.runner.frame_source``:

(a) every frame the port reads equals ``cv2.VideoCapture(path,
    CAP_FFMPEG)``'s bit for bit, and the port's ``decode_jpeg`` of each
    chunk equals ``cv2.imdecode`` of it and ``CAP_OPENCV_MJPEG``'s frame
    wherever that backend reads the file: the crafted layouts of
    tests/avi_cases.py and clips from both of cv2's writers;
(b) frame indices, count, order, fps, ``start_frame`` and ui seeks (past
    the end too) equal the JAX frame_source's, each frame identified by
    equality: pinned in avi_cases.PINNED for the crafted layouts (with the
    digest of the JAX reader's frames), live for the writers' clips;
(c) ROADMAP C9, repaired: FFMPEG's pixels equal the port's on 4:2:0,
    4:2:2, 4:4:4, gray and cut frames; the layouts left on libjpeg's
    arithmetic (C9's remainder) keep it and stay within their bounds;
(d) without cv2 an MJPEG AVI reads, and videos the port's readers refuse
    raise naming the container, the fourcc and OpenCV (with cv2 they go to
    OpenCV).
"""

import itertools
import sys

import numpy as np
import pytest

import avi_cases as A
import jpeg_frames
from caffe_rtpose_tpu.pipeline import runner as JR
from caffe_rtpose_tpu_torch.pipeline import runner, video
from caffe_rtpose_tpu_torch.pipeline.jpeg import MjpegDecoder, decode_jpeg
from caffe_rtpose_tpu_torch.pipeline.runner import PipelineConfig, frame_source

cv2 = pytest.importorskip("cv2")

# C9: the largest difference of FFMPEG's frames from the port's, in levels
C9_BOUND = {"flat": 0, "smooth": 0, "noisy": 0, "422": 0, "444": 0, "gray": 0, "cut": 0,
            "cut_restarts": 0, "itu601": 0}
# C9's remainder: layouts FFMPEG converts with swscale's scaler, which the
# port decodes with libjpeg's arithmetic (cv2.imread's); the largest
# difference from FFMPEG's frames on the noisy frames, in levels
C9_REMAINDER_BOUND = {"411": 55, "440": 77, "odd_height": 126}


def _encode(img, quality):
    return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("avi")
    out = {}
    for name in A.CASES:
        data, imgs = A.build(name, _encode)
        path = str(d / f"{name}.avi")
        with open(path, "wb") as f:
            f.write(data)
        out[name] = (path, imgs)
    return out


def _read_all(reader):
    out = []
    while True:
        ok, img = reader.read()
        if not ok:
            return out
        out.append(img)


_chunks = A.chunks


def _refs(path):
    """Each source frame as FFMPEG decodes its chunk (the port's decoder; the
    tests hold the JAX reader to equality with these)."""
    with open(path, "rb") as f:
        return A.decoded(f.read(), MjpegDecoder(path).decode)


def _ffmpeg(path):
    """cv2.VideoCapture(path, CAP_FFMPEG)'s frames."""
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    out = []
    while True:
        ok, img = cap.read()
        if not ok:
            return out
        out.append(img)


def _imdecode(chunk, tmp_path):
    img = cv2.imdecode(np.frombuffer(chunk, np.uint8), cv2.IMREAD_COLOR)
    if img is None and chunk[:2] == b"\xff\xd8":  # cut short: read as imread reads a cut file
        p = str(tmp_path / "cut.jpg")
        with open(p, "wb") as f:
            f.write(chunk)
        img = cv2.imread(p, cv2.IMREAD_COLOR)
    return img


def _opencv_mjpeg(path):
    """CAP_OPENCV_MJPEG's frames, a zero-length chunk's repeat dropped; None
    where that backend does not open the file."""
    cap = cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)
    if not cap.isOpened():
        return None
    out = []
    while True:
        ok, img = cap.read()
        if not ok:
            return out
        if not out or not np.array_equal(out[-1], img):
            out.append(img)


# ------------------------------------------------------ (b) the pinned cases

@pytest.mark.parametrize("name", list(A.CASES))
def test_jax_reader_gives_the_pins(cases, name):
    path, sources = cases[name]
    cap = cv2.VideoCapture(path)
    pin = A.PINNED[name]
    assert (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)) == (
        pin["count"], pin["fps"])
    jax = [img for _, img, _ in JR.frame_source(JR.PipelineConfig(video=path,
                                                                  no_frame_drops=True))]
    assert A.sha256(jax) == pin["sha256"]
    assert A.observe(JR, path, _refs(path), A.seeks(name), exact=True) == {
        k: pin[k] for k in ("order", "start", "ui")}


@pytest.mark.parametrize("name", list(A.CASES))
def test_port_gives_the_pins(cases, name):
    path, sources = cases[name]
    pin = A.PINNED[name]
    reader = video.AviReader(path)
    assert (reader.frame_count, reader.fps) == (pin["count"], pin["fps"])
    assert A.sha256(_read_all(reader)) == pin["sha256"]
    assert A.observe(runner, path, _refs(path), A.seeks(name), exact=True) == {
        k: pin[k] for k in ("order", "start", "ui")}


# --------------------------------------------------------------- (a) pixels

@pytest.mark.parametrize("name", list(A.CASES))
def test_frames_equal_imdecode_and_opencv_mjpeg(cases, name, tmp_path):
    path, _ = cases[name]
    with open(path, "rb") as f:
        chunks = _chunks(f.read())
    got = _read_all(video.AviReader(path))
    want = _ffmpeg(path)
    assert len(got) == len(want) == len(A.PINNED[name]["order"])
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    # libjpeg's pixels: decode_jpeg of each chunk (read as imread reads a
    # cut file) against imdecode, and against CAP_OPENCV_MJPEG, which opens
    # no file without idx1, reads nothing of idx1_absolute and only the first
    # RIFF of odml
    libjpeg = list(itertools.takewhile(lambda x: x is not None,
                                       (_imdecode(c, tmp_path) for c in chunks)))
    assert len(libjpeg) == len(got)
    for c, b in zip(chunks, libjpeg):
        assert np.array_equal(decode_jpeg(c, truncated_ok=True), b)
    mj = _opencv_mjpeg(path)
    if mj:
        assert len(mj) <= len(got)
        for a, b in zip(libjpeg, mj):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("backend", ["CAP_OPENCV_MJPEG", "CAP_FFMPEG"])
def test_opencv_writers(backend, tmp_path, monkeypatch):
    """A clip from each of cv2's MJPG writers: (a) frames against
    CAP_FFMPEG's, decode_jpeg of the chunks against imdecode and
    CAP_OPENCV_MJPEG, (b) the JAX frame_source live, and with its
    VideoCapture sent to CAP_OPENCV_MJPEG, libjpeg's pixels."""
    sources = A.frames(10, (64, 96), seed=3)
    path = str(tmp_path / "clip.avi")
    w = cv2.VideoWriter(path, getattr(cv2, backend), cv2.VideoWriter_fourcc(*"MJPG"), 20,
                        (96, 64))
    for f in sources:
        w.write(f)
    w.release()
    with open(path, "rb") as f:
        chunks = _chunks(f.read())
    reader = video.AviReader(path)
    cap = cv2.VideoCapture(path)
    assert (reader.frame_count, reader.fps) == (
        int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)) == (10, 20.0)
    got = _read_all(reader)
    assert len(got) == len(chunks) == 10
    for a, b in zip(got, _ffmpeg(path)):
        assert np.array_equal(a, b)
    libjpeg = [decode_jpeg(c) for c in chunks]
    for a, c, b in zip(libjpeg, chunks, _opencv_mjpeg(path)):
        assert np.array_equal(a, cv2.imdecode(np.frombuffer(c, np.uint8), cv2.IMREAD_COLOR))
        assert np.array_equal(a, b)
    seeks = (0, 1, 3, 9, 10, 11, 40)
    assert A.observe(runner, path, sources, seeks) == A.observe(JR, path, sources, seeks)
    real = cv2.VideoCapture
    monkeypatch.setattr(JR.cv2, "VideoCapture",
                        lambda src: real(src, cv2.CAP_OPENCV_MJPEG))
    jax = [img for _, img, _ in JR.frame_source(JR.PipelineConfig(video=path,
                                                                  no_frame_drops=True))]
    assert len(jax) == 10 and all(np.array_equal(a, b) for a, b in zip(libjpeg, jax))


@pytest.mark.parametrize("name", ["cv2", "ffmpeg", "odd_chunk", "ntsc", "corrupt"])
def test_jax_reader_on_opencv_mjpeg_gives_equal_pixels(cases, name, monkeypatch):
    """The JAX frame_source with cv2.VideoCapture sent to CAP_OPENCV_MJPEG
    (libjpeg's pixels) on layouts that backend reads as FFMPEG does: the
    same frames as the port's, in libjpeg's arithmetic (decode_jpeg of
    their chunks); with its default backend, the port's pixels."""
    path, _ = cases[name]
    with open(path, "rb") as f:
        chunks = _chunks(f.read())
    port = [img for _, img, _ in frame_source(PipelineConfig(video=path, no_frame_drops=True))]
    ffmpeg = [img for _, img, _ in JR.frame_source(JR.PipelineConfig(video=path,
                                                                     no_frame_drops=True))]
    real = cv2.VideoCapture
    monkeypatch.setattr(JR.cv2, "VideoCapture",
                        lambda src: real(src, cv2.CAP_OPENCV_MJPEG))
    jax = [img for _, img, _ in JR.frame_source(JR.PipelineConfig(video=path,
                                                                  no_frame_drops=True))]
    libjpeg = [decode_jpeg(c) for c in chunks if c[:2] == b"\xff\xd8"]
    assert len(port) == len(jax) == len(ffmpeg) == len(A.PINNED[name]["order"])
    assert all(np.array_equal(a, b) for a, b in zip(libjpeg, jax))
    assert all(np.array_equal(a, b) for a, b in zip(port, ffmpeg))


# ------------------------------------------------------------------ (c) C9

def _smooth(h, w, i):
    y, x = np.mgrid[:h, :w].astype(np.float64)
    return np.clip(np.stack([128 + 100 * np.sin(x / 97 + i), 128 + 100 * np.cos(y / 61 - i),
                             128 + 90 * np.sin((x + y) / 143)], -1), 0, 255).astype(np.uint8)


_SAMPLING = {"422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _c9_clip(kind, tmp_path):
    """(the JAX frame_source's frames, the port's, the port's arithmetic a
    frame) for an AVI of kind ``kind``: q95 frames, 4:2:0 unless the kind
    names another sampling; ``cut`` is three noisy frames, the last cut a
    third of the way from its end (the blocks it does not reach keep the
    frame before's pixels), ``cut_restarts`` the same with a restart
    interval of 1 (each interval past the end decodes from zero bits);
    ``itu601`` carries the comment "CS=ITU601", with which FFmpeg decodes to
    limited-range YUV."""
    frames = {"flat": lambda i: np.full((48, 64, 3), i * 8 % 255, np.uint8),
              "smooth": lambda i: _smooth(720, 1280, i),
              "odd_height": lambda i: jpeg_frames.frame(359, 640, i),
              "gray": lambda i: jpeg_frames.frame(360, 640, i)[..., 1]}.get(
        kind, lambda i: jpeg_frames.frame(360, 640, i))
    params = [cv2.IMWRITE_JPEG_QUALITY, 95]
    if kind in _SAMPLING:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[kind]]
    if kind == "cut_restarts":
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 1]
    cut = kind.startswith("cut")
    imgs = [frames(i) for i in range(3 if cut else 2)]
    jpegs = [cv2.imencode(".jpg", x, params)[1].tobytes() for x in imgs]
    if kind == "itu601":
        jpegs = [j[:2] + b"\xff\xfe\x00\x0bCS=ITU601" + j[2:] for j in jpegs]
    path = str(tmp_path / "c9.avi")
    with open(path, "wb") as f:
        f.write(A.write_avi(jpegs, imgs[0].shape[1], imgs[0].shape[0],
                            **(dict(idx1=None, cut=len(jpegs[-1]) // 3) if cut else {})))
    jax = [img for _, img, _ in JR.frame_source(JR.PipelineConfig(video=path,
                                                                  no_frame_drops=True))]
    port = [img for _, img, _ in frame_source(PipelineConfig(video=path, no_frame_drops=True))]
    dec = MjpegDecoder()
    arith = []
    for c in _chunks(open(path, "rb").read()):
        dec.decode(c)
        arith.append(dec.arithmetic)
    assert len(jax) == len(port) == len(imgs)
    return jax, port, arith


def _gap(kind, jax, port, capsys):
    gap = np.stack([np.abs(a.astype(np.int32) - b).max(-1) for a, b in zip(jax, port)])
    with capsys.disabled():
        print(f"\nC9 {kind}: max {gap.max()} levels, {(gap > 0).mean():.4%} of pixels differ, "
              f"{(gap > 1).mean():.4%} by more than 1")
    return gap.max()


@pytest.mark.parametrize("kind", list(C9_BOUND))
def test_c9_ffmpeg_pixel_gap(kind, tmp_path, capsys):
    """ROADMAP C9: the JAX frame_source's FFMPEG frames against the port's,
    q95: flat 64x48 frames (tests/test_pipeline.py's clip), smooth 1280x720
    sines, 640x360 ramps with sparse noise (4:2:0, 4:2:2, 4:4:4 and gray,
    and 4:2:0 marked limited range), and a clip whose last frame the end of
    the file cuts."""
    jax, port, arith = _c9_clip(kind, tmp_path)
    assert arith == ["ffmpeg"] * len(arith)
    assert _gap(kind, jax, port, capsys) <= C9_BOUND[kind]


@pytest.mark.parametrize("kind", list(C9_REMAINDER_BOUND))
def test_c9_remainder_layouts_keep_libjpeg(kind, tmp_path, capsys):
    """C9's remainder: 4:1:1, 4:4:0 and a 4:2:0 frame of odd height go
    through swscale's scaler in FFMPEG; the port reads them as cv2.imread
    (decode_jpeg), within their bound of FFMPEG's frames."""
    jax, port, arith = _c9_clip(kind, tmp_path)
    assert arith == ["libjpeg"] * len(arith)
    chunks = _chunks(open(str(tmp_path / "c9.avi"), "rb").read())
    assert all(np.array_equal(p, decode_jpeg(c)) for p, c in zip(port, chunks))
    assert 0 < _gap(kind, jax, port, capsys) <= C9_REMAINDER_BOUND[kind]


# ------------------------------------------------- (d) without cv2, refusals

def test_mjpeg_avi_reads_without_cv2(cases, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    path, _ = cases["odml"]
    got = [img for _, img, _ in frame_source(PipelineConfig(video=path, no_frame_drops=True))]
    assert A.sha256(got) == A.PINNED["odml"]["sha256"]


@pytest.mark.parametrize("kind", ["h264_avi", "avc1_mp4", "ffv1_avi", "ffv1_mkv"])
def test_other_videos_name_container_and_fourcc(kind, tmp_path, monkeypatch):
    path = str(tmp_path / {"h264_avi": "a.avi", "ffv1_avi": "b.avi",
                           "ffv1_mkv": "a.mkv"}.get(kind, "a.mp4"))
    if kind == "h264_avi":
        with open(path, "wb") as f:
            f.write(A.write_avi([b"\x00\x00\x00\x01\x67" + bytes(40)] * 3, 64, 48,
                                fourcc=b"H264"))
    elif kind == "avc1_mp4":
        with open(path, "wb") as f:
            f.write(A.write_mp4(b"avc1"))
    else:
        w = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"FFV1"), 25, (64, 48))
        for i in range(3):
            w.write(np.full((48, 64, 3), 60 * i, np.uint8))
        w.release()
    container, fourcc = {"h264_avi": ("RIFF AVI", "H264"), "avc1_mp4": ("ISO BMFF", "avc1"),
                         "ffv1_avi": ("RIFF AVI", "FFV1"),
                         "ffv1_mkv": ("Matroska", "V_FFV1")}[kind]
    with pytest.raises(video.UnsupportedVideo) as e:
        video.open_reader(path)
    for word in (path, container, fourcc, "OpenCV"):
        assert word in str(e.value)
    if kind in ("ffv1_avi", "ffv1_mkv"):  # with cv2, OpenCV reads them
        cap = runner.open_video(path)
        assert isinstance(cap, runner._Cv2Capture) and cap.fps == 25.0
        got = [img for _, img, _ in frame_source(PipelineConfig(video=path, no_frame_drops=True),
                                                 video=cap)]
        assert len(got) == 3
    monkeypatch.setitem(sys.modules, "cv2", None)
    for call in (lambda: runner.open_video(path),
                 lambda: list(frame_source(PipelineConfig(video=path)))):
        with pytest.raises(RuntimeError, match="--video") as e:
            call()
        for word in (container, fourcc, "OpenCV"):
            assert word in str(e.value)


def test_missing_video(tmp_path):
    with pytest.raises(RuntimeError, match="Couldn't open video"):
        runner.open_video(str(tmp_path / "none.avi"))
