"""The port's printf image sequence reader (pipeline/video.py
``SequenceReader``) against the JAX package's reader, ``cv2.VideoCapture``
with its default backend (FFMPEG's image2 demuxer) inside
``caffe_rtpose_tpu.pipeline.runner.frame_source``:

(a) on the cases of tests/sequence_cases.py (PNG, JPEG, BMP, PPM and PGM
    files; first numbers 0 to 4; ``%d``, ``%0Nd`` and ``%%``; a gap; 40
    frames; one image), the JAX reader gives the pins: frame count and fps
    as cv2 reports them, reads, ``start_frame`` and ui seeks, each frame
    equal to one source's decode, and the digest of the frames;
(b) the port gives the same pins with cv2 blocked;
(c) printf patterns as libavutil reads them;
(d) refusals: what the port does not decode goes to OpenCV where it is
    installed and raises naming the file and the reason without it;
(e) ``rtpose --video`` on a sequence, cv2 blocked.
"""

import os
import sys

import numpy as np
import pytest

import avi_cases as A
import sequence_cases as S
from caffe_rtpose_tpu.pipeline import runner as JR
from caffe_rtpose_tpu_torch.pipeline import runner, video
from caffe_rtpose_tpu_torch.pipeline.runner import PipelineConfig, frame_source

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("name", list(S.CASES))
def test_jax_reader_gives_the_pins(tmp_path, name):
    path, _, files = S.write(name, str(tmp_path))
    cap = cv2.VideoCapture(path)
    pin = S.PINNED[name]
    assert (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)) == (
        pin["count"], pin["fps"])
    jax = [img for _, img, _ in JR.frame_source(JR.PipelineConfig(video=path,
                                                                  no_frame_drops=True))]
    assert A.sha256(jax) == pin["sha256"]
    got = S.observe(JR, name, path, files)
    assert got == {k: pin[k] for k in got}


@pytest.mark.parametrize("name", list(S.CASES))
def test_port_gives_the_pins_without_cv2(tmp_path, name, monkeypatch):
    path, _, files = S.write(name, str(tmp_path))
    pin = S.PINNED[name]
    monkeypatch.setitem(sys.modules, "cv2", None)
    reader = runner.open_video(path)
    assert isinstance(reader, video.SequenceReader)
    assert (reader.frame_count, reader.fps) == (pin["count"], pin["fps"])
    reader.release()
    got = [img for _, img, _ in frame_source(PipelineConfig(video=path, no_frame_drops=True))]
    assert all(img.dtype == np.uint8 and img.shape == S.SIZE + (3,) for img in got)
    assert A.sha256(got) == pin["sha256"]
    obs = S.observe(runner, name, path, files)
    assert obs == {k: pin[k] for k in obs}


@pytest.mark.parametrize("pattern,number,want", [
    ("f_%03d.png", 7, "f_007.png"), ("f_%d.png", 12, "f_12.png"), ("f_%3d.png", 7, "f_007.png"),
    ("a%%b_%02d.png", 3, "a%b_03.png"), ("d%d/x.png", 1, "d1/x.png"), ("f.png", 1, None),
    ("f_%d_%d.png", 1, None), ("f_%s.png", 1, None), ("f_%03.png", 1, None), ("f_%", 1, None),
    ("f_%%.png", 1, None)])
def test_printf_patterns(pattern, number, want):
    """av_get_frame_filename2's rules: one %d (zero-padded to its width, %3d
    too), %% a literal %, anything else no pattern."""
    assert video.sequence_filename(pattern, number) == want


def test_refused_sequences_go_to_opencv_or_name_the_reason(tmp_path, monkeypatch):
    """A TIFF sequence and a 16-bit PPM one: with cv2 they open through it
    (the JAX reader's frames), without it --video raises naming the file and
    the reason; a pattern with no file numbered 0-4 cannot be opened."""
    rs = np.random.RandomState(5)
    for ext, img in ((".tiff", rs.randint(0, 256, (16, 24, 3)).astype(np.uint8)),
                     (".ppm", rs.randint(0, 65536, (16, 24, 3)).astype(np.uint16))):
        d = tmp_path / ext[1:]
        d.mkdir()
        for i in range(3):
            assert cv2.imwrite(str(d / f"f_{i:02d}{ext}"), img)
        path = str(d / f"f_%02d{ext}")
        with pytest.raises(video.UnsupportedVideo) as e:
            video.open_reader(path)
        for word in (path, "f_00" + ext, "OpenCV"):
            assert word in str(e.value)
        cap = runner.open_video(path)
        assert isinstance(cap, runner._Cv2Capture)
        got = [im for _, im, _ in frame_source(PipelineConfig(video=path, no_frame_drops=True),
                                               video=cap)]
        assert len(got) == 3
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "cv2", None)
            with pytest.raises(RuntimeError, match="--video") as e:
                runner.open_video(path)
            assert "f_00" + ext in str(e.value)
    with pytest.raises(RuntimeError, match="Couldn't open video"):
        runner.open_video(str(tmp_path / "none_%03d.png"))
    assert not cv2.VideoCapture(str(tmp_path / "none_%03d.png")).isOpened()


def test_rtpose_video_on_a_sequence_without_cv2(tmp_path, monkeypatch, capsys):
    """rtpose --video f_%03d.jpg --start_frame 3 on the CPU (2-stage net,
    64x48), cv2 blocked: a JSON a frame from the fourth on."""
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.proto import prototxt
    from caffe_rtpose_tpu_torch.tools import rtpose

    path, _, _ = S.write("jpeg", str(tmp_path / "seq"))
    proto = str(tmp_path / "deploy.prototxt")
    prototxt.dump_file(make_pose_deploy_net("COCO", stages=2), proto)
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = str(tmp_path / "json")
    assert rtpose.main(["--device", "cpu", "--caffeproto", proto, "--no_weights", "--video",
                        path, "--write_json", out, "--start_frame", "3", "--net_resolution",
                        "64x48", "--resolution", "64x48", "--no_display", "--no_frame_drops",
                        "--dtype", "float32"]) == 0
    assert sorted(os.listdir(out)) == [f"frame{i:06d}.json" for i in range(3, 8)]
