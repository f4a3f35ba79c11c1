"""The port's MPEG-4 Part 2 decoder (caffe_rtpose_tpu_torch/csrc/
mpeg4_video.cpp behind pipeline/mpeg4.py) against the JAX package's
reader, ``cv2.VideoCapture`` (FFMPEG's ``mpeg4`` decoder and swscale):

(c) every frame the port decodes equals cv2's bit for bit: the I- and
    P-VOPs of the clips cv2's writers wrote (mp4v in .mp4/.mov, XVID and
    DIVX in .avi, sizes not a multiple of 16, large motion with f_code 3 and 4 and
    vectors out of the frame, the 1280x720 clip), frames after seeks to
    P-frames and into later GOPs, and P-frames decoded after a seek that
    lands on a frame that is not a key frame (predicted from mid-grey, as in
    FFmpeg); each frame is also no farther from the frame that was written
    (PSNR) than cv2's is; every AVI fourcc sent to the decoder is one cv2
    decodes as MPEG-4 to the same frames, and the XVID clip in avi_cases'
    layouts (no idx1, absolute idx1, libavformat's, OpenDML) reads and
    seeks as the JAX reader does;
(d) every refused feature raises naming it: VOL flags rebuilt into the
    XVID clip's in-band VOL, B- and S-VOP types patched into its VOP
    headers, an inter4v macroblock, Xvid's user data, a short video header.
"""

import sys

import numpy as np
import pytest

import avi_cases as A
import mp4_cases as M
from caffe_rtpose_tpu.pipeline import runner as JR
from caffe_rtpose_tpu_torch.pipeline import mpeg4, runner, video
from caffe_rtpose_tpu_torch.pipeline.runner import PipelineConfig, frame_source

cv2 = pytest.importorskip("cv2")

MPEG4_CLIPS = [n for n in M.CLIPS if n != "mjpeg_mov"]
VOP = b"\x00\x00\x01\xb6"


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, img = cap.read()
        if not ok:
            return out
        out.append(img)


def _read_all(reader):
    out = []
    while True:
        ok, img = reader.read()
        if not ok:
            return out
        out.append(img)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# -------------------------------------------------------------- (c) pixels

@pytest.mark.parametrize("name", MPEG4_CLIPS)
def test_frames_equal_cv2(name):
    path = M.clip_path(name)
    reader = video.open_reader(path)
    types = []
    got = []
    while True:
        ok, img = reader.read()
        if not ok:
            break
        got.append(img)
        types.append(reader._decoder.vop_type)
    want = _cv2_frames(path)
    assert len(got) == len(want) == M.PINNED[name]["count"]
    assert 0 in types and 1 in types  # I- and P-VOPs
    for a, b, src in zip(got, want, M.sources(name)):
        assert a.dtype == np.uint8 and a.shape == src.shape and np.array_equal(a, b)
        assert abs(_psnr(a, src) - _psnr(b, src)) <= 0.1


@pytest.mark.parametrize("name", ["mp4v_mp4", "divx_avi", "no_stss", "elst_skip2"])
def test_frames_after_seeks_equal_cv2(name, tmp_path):
    """start_frame into a GOP (P-frames), into the next GOPs and past the
    end; no_stss seeks land on P-frames, which FFmpeg decodes from grey."""
    if name in M.CLIPS:
        path = M.clip_path(name)
    else:
        path = str(tmp_path / f"{name}.mp4")
        with open(path, "wb") as f:
            f.write(M.build(name))
    for k in (3, 11, 13, 20, 25, 30):
        cfg = dict(video=path, start_frame=k, no_frame_drops=True)
        jax = [img for _, img, _ in JR.frame_source(JR.PipelineConfig(**cfg))][:4]
        port = [img for _, img, _ in frame_source(PipelineConfig(**cfg))][:4]
        assert len(port) == len(jax)
        assert all(np.array_equal(a, b) for a, b in zip(port, jax)), (name, k)


@pytest.mark.parametrize("fourcc", video.MPEG4_FOURCCS + ("xvid", "mp4v"))
def test_avi_fourccs_ffmpeg_maps_to_mpeg4(fourcc, tmp_path):
    """Every AVI fourcc the reader sends to the MPEG-4 decoder is one cv2
    (FFMPEG) decodes as MPEG-4 too, to the same frames."""
    chunks = _xvid_chunks()[:14]
    path = str(tmp_path / "clip.avi")
    with open(path, "wb") as f:
        f.write(A.write_avi(chunks, 100, 74, fourcc=fourcc.encode()))
    reader = video.open_reader(path)
    assert reader.codec == "mpeg4"
    got, want = _read_all(reader), _cv2_frames(path)
    assert len(got) == len(want) == 14
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("layout", [dict(idx1=None), dict(idx1="absolute"),
                                    dict(layout="ffmpeg"), dict(odml=12)],
                         ids=["no_idx1", "idx1_absolute", "ffmpeg", "odml"])
def test_mpeg4_avi_layouts_equal_cv2(layout, tmp_path):
    """The XVID clip's chunks in avi_cases' layouts (every indexed chunk
    flagged a key frame; without idx1 the scan takes the VOP type): reads,
    seeks and the frames after them equal the JAX reader's."""
    path = str(tmp_path / "clip.avi")
    with open(path, "wb") as f:
        f.write(A.write_avi(_xvid_chunks(), 100, 74, fourcc=b"XVID", **layout))
    sources = M.sources("xvid_avi")
    assert A.observe(runner, path, sources, M.SEEKS) == A.observe(JR, path, sources, M.SEEKS)
    for k in (3, 13, 20):
        cfg = dict(video=path, start_frame=k, no_frame_drops=True)
        jax = [img for _, img, _ in JR.frame_source(JR.PipelineConfig(**cfg))][:3]
        port = [img for _, img, _ in frame_source(PipelineConfig(**cfg))][:3]
        assert len(port) == len(jax) == 3
        assert all(np.array_equal(a, b) for a, b in zip(port, jax))


def test_decoder_api():
    reader = video.open_reader(M.clip_path("xvid_avi"))
    dec = mpeg4.Mpeg4Decoder(tag="XVID")
    first = reader.packet(0)
    head = first[:first.find(VOP)]
    assert dec.decode(head) is None  # headers only: no picture
    want = _cv2_frames(M.clip_path("xvid_avi"))
    assert np.array_equal(dec.decode(first), want[0]) and dec.vop_type == 0
    assert np.array_equal(dec.decode(reader.packet(1)), want[1]) and dec.vop_type == 1
    dec.flush()  # the reference forgotten: a P-VOP predicts from grey
    grey = dec.decode(reader.packet(2))
    assert not np.array_equal(grey, want[2])
    assert abs(float(grey.mean()) - 128) < abs(float(want[2].mean()) - 128) + 20
    dec.close()
    reader.release()


def test_not_coded_vop_gives_no_frame(tmp_path):
    """A VOP with vop_coded 0: FFMPEG outputs no picture for it and reads
    on; its chunk still takes a frame period."""
    reader = video.open_reader(M.clip_path("divx_avi"))
    chunks = [reader.packet(i) for i in range(12)]
    reader.release()
    bits = "01" + "0" + "1" + "00100" + "1" + "0"  # P, modulo 0, increment, not coded
    bits += "0" + "1" * (-(len(bits) + 1) % 8)
    nvop = VOP + int(bits, 2).to_bytes(len(bits) // 8, "big")
    path = str(tmp_path / "nvop.avi")
    with open(path, "wb") as f:
        f.write(A.write_avi(chunks[:4] + [nvop] + chunks[4:], 100, 74, fourcc=b"DIVX"))
    want = _cv2_frames(path)
    got = _read_all(video.open_reader(path))
    assert len(got) == len(want) == 12
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------ (d) refusals

class _Bits:
    def __init__(self):
        self.s = ""

    def put(self, v, n):
        self.s += format(v, f"0{n}b") if n else ""
        return self

    def bytes(self):
        s = self.s + "0" + "1" * (-(len(self.s) + 1) % 8)  # stuffing
        return int(s, 2).to_bytes(len(s) // 8, "big")


def _vol(verid=1, shape=0, interlaced=0, sprite=0, bits_per_pixel=None, quant_type=0,
         qpel=0, cplx=0, resync=0, partitioned=0, newpred=0, reduced=0, scalable=0,
         low_delay=1, w=100, h=74):
    """A VOL header (start code 0x120 on) with the XVID clip's fields, one
    of them changed."""
    b = _Bits().put(0, 1).put(1, 8).put(1, 1).put(verid, 4).put(1, 3).put(1, 4)
    b.put(1, 1).put(1, 2).put(low_delay, 1).put(0, 1)  # vol_control: 4:2:0, no vbv
    b.put(shape, 2).put(1, 1).put(25, 16).put(1, 1).put(0, 1)
    b.put(1, 1).put(w, 13).put(1, 1).put(h, 13).put(1, 1)
    b.put(interlaced, 1).put(1, 1).put(sprite, 1 if verid == 1 else 2)
    if bits_per_pixel is None:
        b.put(0, 1)
    else:
        b.put(1, 1).put(5, 4).put(bits_per_pixel, 4)
    b.put(quant_type, 1)
    if verid != 1:
        b.put(qpel, 1)
    b.put(1 - cplx, 1).put(1 - resync, 1).put(partitioned, 1)
    if partitioned:
        b.put(0, 1)
    if verid != 1:
        b.put(newpred, 1).put(reduced, 1)
    b.put(scalable, 1)
    return b"\x00\x00\x01\x20" + b.bytes()


def _xvid_chunks():
    reader = video.open_reader(M.clip_path("xvid_avi"))
    chunks = [reader.packet(i) for i in range(len(reader.frames))]
    reader.release()
    return chunks


def _with_vol(first: bytes, vol: bytes) -> bytes:
    a = first.find(b"\x00\x00\x01\x20")
    b = first.find(b"\x00\x00\x01", a + 4)
    return first[:a] + vol + first[b:]


REFUSALS = {
    "interlaced": (dict(interlaced=1), "interlaced"),
    "sprite": (dict(sprite=1), "sprites"),
    "gmc_v2": (dict(verid=2, sprite=2), "global motion compensation"),
    "bit_depth": (dict(bits_per_pixel=10), "bit depth"),
    "quant_type": (dict(quant_type=1), "quant_type 1"),
    "qpel": (dict(verid=2, qpel=1), "quarter-pel"),
    "complexity": (dict(cplx=1), "complexity estimation"),
    "resync": (dict(resync=1), "resync markers"),
    "partitioned": (dict(partitioned=1), "data partitioning"),
    "newpred": (dict(verid=2, newpred=1), "newpred"),
    "reduced": (dict(verid=2, reduced=1), "reduced resolution"),
    "scalable": (dict(scalable=1), "scalability"),
    "shape": (dict(shape=1), "shape"),
    "low_delay": (dict(low_delay=0), "B-VOP reordering"),
}


def _refused(path, words, monkeypatch, at_open=True):
    """The refusal names ``words`` and the file, container and fourcc, from
    the reader (when it opens, or else when the frame is read) and, without
    cv2, from frame_source."""
    def check(msg):
        for word in (*words, "RIFF AVI", "XVID", "OpenCV"):
            assert word in msg, (word, msg)

    if at_open:
        with pytest.raises(video.UnsupportedVideo) as e:
            video.open_reader(path)
    else:
        reader = video.open_reader(path)
        with pytest.raises(video.UnsupportedVideo) as e:
            _read_all(reader)
    check(str(e.value))
    assert path in str(e.value)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError) as e:
        list(frame_source(PipelineConfig(video=path, no_frame_drops=True)))
    check(str(e.value))


@pytest.mark.parametrize("name", list(REFUSALS))
def test_vol_features_are_refused_by_name(name, tmp_path, monkeypatch):
    chunks = _xvid_chunks()
    kw, word = REFUSALS[name]
    assert _with_vol(chunks[0], _vol()) == chunks[0]  # the builder gives the clip's VOL
    chunks[0] = _with_vol(chunks[0], _vol(**kw))
    path = str(tmp_path / f"{name}.avi")
    with open(path, "wb") as f:
        f.write(A.write_avi(chunks, 100, 74, fourcc=b"XVID"))
    _refused(path, (word,), monkeypatch)


@pytest.mark.parametrize("vop_type,word", [(2, "B-VOPs"), (3, "S-VOPs")])
def test_b_and_s_vops_are_refused_by_name(vop_type, word, tmp_path, monkeypatch):
    chunks = _xvid_chunks()
    at = chunks[5].find(VOP) + 4
    chunks[5] = chunks[5][:at] + bytes([chunks[5][at] & 0x3F | vop_type << 6]) + chunks[5][at + 1:]
    path = str(tmp_path / "b.avi")
    with open(path, "wb") as f:
        f.write(A.write_avi(chunks, 100, 74, fourcc=b"XVID"))
    _refused(path, (word,), monkeypatch)


def test_inter4v_is_refused_when_its_frame_decodes(tmp_path, monkeypatch):
    """A P-VOP whose first macroblock is inter4v (MCBPC 16, '010'): found
    only when that frame decodes, so the read raises there."""
    chunks = _xvid_chunks()
    b = _Bits().put(1, 2).put(0, 1).put(1, 1).put(5, 5).put(1, 1).put(1, 1)  # P, coded
    b.put(0, 1).put(0, 3).put(3, 5).put(1, 3)  # rounding, intra_dc_vlc_thr, quant, f_code
    b.put(0, 1).put(0b010, 3).put(0b11, 2)  # coded MB, MCBPC inter4v, CBPY
    chunks[1] = VOP + b.bytes() + bytes(8)
    path = str(tmp_path / "inter4v.avi")
    with open(path, "wb") as f:
        f.write(A.write_avi(chunks, 100, 74, fourcc=b"XVID"))
    _refused(path, ("inter4v",), monkeypatch, at_open=False)


def test_xvid_user_data_and_short_header_are_refused(tmp_path, monkeypatch):
    chunks = _xvid_chunks()
    first = chunks[0].replace(b"Lavc62.28.101", b"XviD0050\0\0\0\0\0")
    path = str(tmp_path / "xvid_ud.avi")
    with open(path, "wb") as f:
        f.write(A.write_avi([first] + chunks[1:], 100, 74, fourcc=b"XVID"))
    _refused(path, ("written by XviD",), monkeypatch)
    monkeypatch.undo()
    first = chunks[0].replace(b"Lavc62.28.101", b"Lavf62.28.101")  # no libavcodec user data
    with open(path, "wb") as f:
        f.write(A.write_avi([first] + chunks[1:], 100, 74, fourcc=b"XVID"))
    _refused(path, ("Xvid or DivX IDCT",), monkeypatch)
    monkeypatch.undo()
    with open(path, "wb") as f:  # H.263 baseline in an MPEG-4 tag
        f.write(A.write_avi([b"\x00\x00\x80\x02" + bytes(60)] * 3, 100, 74, fourcc=b"XVID"))
    _refused(path, ("short video header",), monkeypatch)
