"""The port's H.264 decoder (caffe_rtpose_tpu_torch/csrc/h264_video.cpp
behind pipeline/h264.py and video.open_reader) against the JAX package's
reader, ``cv2.VideoCapture`` with its default backend (FFMPEG) inside
``caffe_rtpose_tpu.pipeline.runner.frame_source``, on the Constrained
Baseline and Main profile (CABAC, weighted P) streams tests/h264_cases.py
writes from seeds:

(a) the writer's tables are prefix codes and its avcC record is what the
    port's MP4 demuxer hands the decoder;
(b) every case's frame count, fps, frames (sha256 of every frame, so bit
    for bit), start_frame and ui seeks equal the JAX reader's, pinned in
    h264_cases.PINNED, and the port gives the pins with cv2 blocked: MP4,
    QuickTime and AVI, POC types 0 and 2, both ranges, cropped sizes, CABAC
    and CAVLC, streams that start on a non-IDR picture (fault C10); each
    CABAC case decodes as its CAVLC twin in both readers;
(c) each refused feature raises UnsupportedVideo naming it when the file
    opens, and without cv2 frame_source raises naming --video;
(d) rtpose --video on a small H.264 MP4 writes the JSONs the JAX pipeline
    writes for that file.
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
from caffe_rtpose_tpu_torch.pipeline import bmff, h264, runner, video
from caffe_rtpose_tpu_torch.pipeline.runner import PipelineConfig, frame_source

cv2 = pytest.importorskip("cv2")

NAMES = list(H.CASES)


CLIPS = {"h264_720p": H.CLIP_720P, "h264_cabac_720p": H.CLIP_CABAC_720P,
         "h264_b_720p": H.CLIP_B_720P}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("h264")
    out = dict(CLIPS)
    for name in [*H.CASES, *H.REFUSED]:
        p = d / f"{name}{H.suffix(name)}"
        p.write_bytes(H.build(name))
        out[name] = str(p)
    return out


def _read_all(reader):
    out = []
    while True:
        ok, img = reader.read()
        if not ok:
            return out
        out.append(img)


# --------------------------------------------------------- (a) syntax

@pytest.mark.parametrize("table", ["coeff_token", "total_zeros", "run_before"])
def test_writer_tables_are_complete_prefix_codes(table):
    """Each VLC table the writer and the decoder share is prefix-free and
    fills its code space (Kraft sum 1, or 1 less the one unused code)."""
    if table == "coeff_token":
        codes = [[(ln, b) for i, (ln, b) in enumerate(zip(H.COEFF_TOKEN_LEN[k],
                                                          H.COEFF_TOKEN_BITS[k]))
                  if ln and (i & 3) <= (i >> 2)] for k in range(4)]
        codes.append([(ln, b) for i, (ln, b) in enumerate(zip(H.CHROMA_DC_COEFF_TOKEN_LEN,
                                                              H.CHROMA_DC_COEFF_TOKEN_BITS))
                      if ln and (i & 3) <= (i >> 2)])
    elif table == "total_zeros":
        codes = [list(zip(ln, b)) for ln, b in zip(H.TOTAL_ZEROS_LEN, H.TOTAL_ZEROS_BITS)]
        codes += [list(zip(ln, b)) for ln, b in zip(H.CHROMA_DC_TOTAL_ZEROS_LEN,
                                                     H.CHROMA_DC_TOTAL_ZEROS_BITS)]
    else:
        codes = [list(zip(ln, b)) for ln, b in zip(H.RUN_LEN, H.RUN_BITS)]
    for code in codes:
        words = [format(b, f"0{ln}b") for ln, b in code]
        assert len(set(words)) == len(words)
        assert not any(a != b and b.startswith(a) for a in words for b in words)
        kraft = sum(2.0 ** -len(w) for w in words)
        assert kraft <= 1.0 and 2.0 ** -16 <= kraft, (table, kraft)


def test_cases_write_every_element_the_decoder_takes():
    """Across CASES the writer emits every I and P mb_type and sub_mb_type,
    all 9 + 4 + 4 intra modes, every coeff_token table with both level
    escapes, QP 0-51, deblocking idc 0, 1 and 2 with offsets -6 and +6, up
    to 4 references, list modification, MMCO 1 and several slices a
    picture."""
    seen = set()
    for name in H.CASES:
        H.stream(name)
        seen |= H.SEEN[name]

    def values(key):
        return {k[1:] for k in seen if k[0] == key}

    assert values("mb_type I") == {(t,) for t in range(26)}
    assert values("mb_type P") == {(t,) for t in range(5)}
    assert values("sub_mb_type") == {(t,) for t in range(4)}
    assert values("Intra4x4") == {(m,) for m in range(9)}
    assert values("Intra16x16") == values("chroma") == {(m,) for m in range(4)}
    assert values("coeff_token") == {(k,) for k in (-1, 0, 1, 2, 3)}
    assert values("level_prefix") == {(14,), (15,)}
    assert values("qp") == {(q,) for q in range(52)}
    deblock = values("deblock")
    assert {d[0] for d in deblock} == {0, 1, 2}
    assert {-6, 6} <= {d[1] for d in deblock if len(d) == 3}
    assert {-6, 6} <= {d[2] for d in deblock if len(d) == 3}
    assert max(values("references")) == (4,)
    assert values("ref_pic_list_modification") and values("mmco")
    assert max(values("slices"))[0] > 1


def test_cabac_cases_write_every_element_the_decoder_takes():
    """Across the CABAC cases the writer codes every I and P mb_type (I ones
    in P slices too), sub_mb_type, intra mode and QP, I_PCM in I and P
    slices, the Exp-Golomb suffixes of coeff_abs_level_minus1 and mvd_l0,
    the I slices' contexts and cabac_init_idc 0-2, several slices a
    picture, 4 references, and weights of luma and chroma."""
    seen = set()
    for name in H.CABAC:
        H.stream(name)
        seen |= H.SEEN[name]

    def values(key):
        return {k[1:] for k in seen if k[0] == key}

    assert values("mb_type I") == {(t,) for t in range(26)}
    assert values("mb_type P") == {(t,) for t in range(5)}
    assert values("sub_mb_type") == {(t,) for t in range(4)}
    assert values("Intra4x4") == {(m,) for m in range(9)}
    assert values("Intra16x16") == values("chroma") == {(m,) for m in range(4)}
    assert values("qp") == {(q,) for q in range(52)}
    assert values("cabac_init_idc") == {(0,), (1,), (2,), ("I",)}
    assert values("cabac I_PCM") == {(False,), (True,)}
    assert values("cabac level suffix") and values("cabac mvd suffix")
    assert values("weights") == {("luma",), ("chroma",)}
    assert max(values("references")) == (4,) and max(values("slices"))[0] > 1


def test_b_cases_write_every_element_the_decoder_takes():
    """Across the B-slice cases (CABAC, and CAVLC in their twins) the writer
    codes every B mb_type and sub_mb_type, B_Skip, intra macroblocks in B
    slices, spatial and temporal direct with direct_8x8_inference 0 and 1,
    weighted_bipred_idc 0, 1 (luma and chroma weights) and 2, 1 to 4
    references in a list, modification of both lists, reference B pictures
    under MMCO 1, and streams with and without bitstream restriction, in
    MP4 (ctts versions 0 and 1, with and without elst), QuickTime and AVI."""
    names = [n for n, kw in H.CASES.items() if kw.get("bframes")]
    seen = set()
    for name in names:
        H.stream(name)
        seen |= H.SEEN[name]

    def values(key):
        return {k[1] for k in seen if k[0] == key}

    assert values("mb_type B") == set(range(23)) and values("sub_mb_type B") == set(range(13))
    assert values("B macroblock") == {"skip", "direct", "b16", "b2", "b8x8", "intra"}
    assert values("direct") == {"spatial", "temporal"}
    assert values("references B") == {1, 2, 3, 4}
    assert values("list modification B") == {0, 1} and values("mmco B") == {1}
    assert values("weights B") == {"luma", "chroma"}
    params = [dict(H._defaults(), **H.CASES[n]) for n in names]
    assert {p["direct8x8"] for p in params} == {0, 1}
    assert {p["bipred"] for p in params} == {0, 1, 2}
    assert {p["pyramid"] for p in params} == {False, True}
    assert {p["reorder"] for p in params} >= {None, 1, 2}
    assert {(p["container"], p["ctts"], p["elst"]) for p in params} >= {
        ("mp4", "v0", True), ("mp4", "v0", False), ("mov", "v1", True), ("avi", "v0", True)}
    assert all(n in H.CABAC for n in names if n not in ("b_slices", "b_avi_open_gop"))


@pytest.mark.parametrize("name,length", [("pcm_skip", 4), ("nal_length2", 2),
                                         ("nal_length1", 1), ("avc3", 4)])
def test_avcc_is_what_the_writer_put_in(paths, name, length):
    p, _, sps, pps = H.stream(name)
    with open(paths[name], "rb") as f:
        track = bmff.parse(f, os.path.getsize(paths[name]))
    record = H.avcc(sps, pps, length)
    assert track.fourcc == ("avc3" if name == "avc3" else "avc1")
    assert track.nal_length == length
    assert track.extra == (record[:5] + b"\xe0\x00" if name == "avc3" else record)
    reader = video.open_reader(paths[name])
    assert (reader.codec, reader._nal_length, reader._extra) == ("h264", length, track.extra)
    assert [f.key for f in reader.frames] == [i in p["idr"] for i in range(H.CLIP_FRAMES)]
    reader.release()


def test_avi_fourccs_and_key_flags(paths):
    got = {}
    for name in ("avi", "avi_x264", "avi_strf"):
        reader = video.open_reader(paths[name])
        got[name] = (type(reader).__name__, reader.codec, reader.fourcc, len(reader._extra))
        assert [i for i, f in enumerate(reader.frames) if f.key] == [0, 12, 24]  # idx1
        reader.release()
    _, _, sps, pps = H.stream("avi_strf")
    assert got == {"avi": ("AviReader", "h264", "H264", 0),
                   "avi_x264": ("AviReader", "h264", "X264", 0),
                   "avi_strf": ("AviReader", "h264", "avc1", len(H.annexb([sps, pps])))}


# ----------------------------------------------------------- (b) pins

@pytest.mark.parametrize("name", NAMES + list(CLIPS))
def test_jax_reader_gives_the_pins(paths, name):
    path, pin = paths[name], H.PINNED[name]
    cap = cv2.VideoCapture(path)
    assert (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)) == (
        pin["count"], pin["fps"])
    frames = _read_all(cap)
    assert A.sha256(frames) == pin["sha256"]
    if "order" in pin:
        assert A.observe(JR, path, frames, H.SEEKS, exact=True) == {
            k: pin[k] for k in ("order", "start", "ui")}


@pytest.mark.parametrize("name", NAMES + list(CLIPS))
def test_port_gives_the_pins_without_cv2(paths, name, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    path, pin = paths[name], H.PINNED[name]
    reader = video.open_reader(path)
    assert (reader.codec, reader.frame_count, reader.fps) == ("h264", pin["count"], pin["fps"])
    frames = _read_all(reader)
    reader.release()
    assert A.sha256(frames) == pin["sha256"]
    if "order" in pin:
        assert A.observe(runner, path, frames, H.SEEKS, exact=True) == {
            k: pin[k] for k in ("order", "start", "ui")}


@pytest.mark.parametrize("name", H.CABAC)
def test_cabac_case_decodes_as_its_cavlc_twin(tmp_path, name, monkeypatch):
    """The CAVLC stream of the same seed (the same macroblocks, each element
    coded with CAVLC) gives the CABAC case's pinned frames in the JAX
    reader and in the port with cv2 blocked."""
    path = str(tmp_path / f"{name}_cavlc{H.suffix(name)}")
    with open(path, "wb") as f:
        f.write(H.build_twin(name))
    cap = cv2.VideoCapture(path)
    assert A.sha256(_read_all(cap)) == H.PINNED[name]["sha256"]
    monkeypatch.setitem(sys.modules, "cv2", None)
    reader = video.open_reader(path)
    assert A.sha256(_read_all(reader)) == H.PINNED[name]["sha256"]
    reader.release()


def test_cabac_clip_is_the_cavlc_clip_smaller():
    """tests/data/h264_cabac_720p.mp4 codes the CAVLC clip's macroblocks
    with CABAC (Main profile) in fewer bytes; both decode to the pinned
    frames (test_*_gives_the_pins)."""
    reader = video.open_reader(H.CLIP_CABAC_720P)
    assert reader._extra[1] == 77  # avcC's AVCProfileIndication: Main
    reader.release()
    assert os.path.getsize(H.CLIP_CABAC_720P) < os.path.getsize(H.CLIP_720P)


def test_b_clip_is_i_p_b_b_with_composition_offsets():
    """tests/data/h264_b_720p.mp4 (encode_clip with bframes) codes the 8
    frames as I P B B P B B P in CABAC (Main profile, implicit weights),
    with composition offsets whose edit list starts the stream at 0, a video
    delay of 1 and num_reorder_frames 1: the decoder holds the first picture
    back one packet."""
    with open(H.CLIP_B_720P, "rb") as f:
        track = bmff.parse(f, os.path.getsize(H.CLIP_B_720P))
    assert track.extra[1] == 77 and track.nal_length == 4
    assert [s.pts // 512 for s in track.samples] == [0, 3, 1, 2, 6, 4, 5, 7]
    assert [s.key for s in track.samples] == [True] + [False] * 7
    assert (track.start_pts, track.video_delay) == (0, 1)
    assert os.path.getsize(H.CLIP_B_720P) < 1_500_000
    dec = h264.H264Decoder(track.extra, track.nal_length, "h264_b_720p")
    with open(H.CLIP_B_720P, "rb") as f:
        f.seek(track.samples[0].pos)
        assert not dec.advance(f.read(track.samples[0].size), 0) and dec.delay == 1
    dec.close()


def test_avi_pictures_take_the_pts_of_the_packet_that_gave_them(paths, monkeypatch):
    """AVI packets carry no pts, so OpenCV numbers each picture by the dts
    of the packet whose decode gave it (CAP_PROP_POS_MSEC): with B pictures
    and the delay of 1 avformat_find_stream_info's decode reached, picture
    k comes out with packet k + 1, and the last one, drained at the end,
    has none (0).  The port's reader numbers its pictures the same way."""
    path = paths["b_avi_open_gop"]
    cap = cv2.VideoCapture(path)
    jax = []
    while cap.read()[0]:
        jax.append(round(cap.get(cv2.CAP_PROP_POS_MSEC) * cap.get(cv2.CAP_PROP_FPS) / 1000))
    assert jax == [*range(1, 26), 0]
    monkeypatch.setitem(sys.modules, "cv2", None)
    reader = video.open_reader(path)
    port = []
    while reader.read()[0]:
        port.append(reader._last_pts if reader._last_pts != video._NOPTS else 0)
    reader.release()
    assert port == jax


def test_decoder_api_and_output_delay(paths):
    """Packets in, pictures out: with num_reorder_frames 1 each picture
    comes out one packet late, tagged with its own packet, and the last at
    drain(); flush() drops what is held, and a P picture after it gives
    nothing (it predicts from grey pictures and is not recovered) until
    the next IDR picture."""
    p, units, sps, pps = H.stream("reorder1")
    dec = h264.H264Decoder(H.avcc(sps, pps), 4, "reorder1")
    tags = []
    for i, u in enumerate(units[:13]):
        if dec.advance(H.prefixed(u, 4), i):
            tags.append(dec.tag)
    assert tags == list(range(12))
    assert dec.picture().shape == (74, 100, 3)
    dec.flush()
    assert not dec.drain()
    assert not dec.advance(H.prefixed(units[13], 4), 13)  # a P picture: nothing before an IDR
    got = [dec.advance(H.prefixed(units[i], 4), i) for i in (24, 25)]
    assert got == [False, True] and dec.tag == 24
    assert dec.drain() and dec.tag == 25 and not dec.drain()
    with pytest.raises(ValueError, match="does not decode|NAL|slice|PPS"):
        dec.advance(b"\x00\x00\x00\x05\x65\x88\x80\x10\x00", 26)
    dec.close()


# ------------------------------------------------------- (c) refusals

@pytest.mark.parametrize("name", list(H.REFUSED))
def test_refused_features_are_named(paths, name, monkeypatch):
    path, (_, word) = paths[name], H.REFUSED[name]
    with pytest.raises(video.UnsupportedVideo) as e:
        video.open_reader(path)
    for w in (path, "ISO BMFF", "avc1", word, "H.264", "OpenCV"):
        assert w in str(e.value), (w, str(e.value))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="--video") as e:
        list(frame_source(PipelineConfig(video=path)))
    for w in (path, word, "OpenCV"):
        assert w in str(e.value)


def test_refused_files_go_to_opencv_with_cv2(paths):
    cap = runner.open_video(paths["b_long_term_l1"])
    assert isinstance(cap, runner._Cv2Capture)
    cap.release()
    cap = runner.open_video(paths["intra"])  # what the port reads, it reads itself
    assert isinstance(cap, video._Reader) and cap.codec == "h264"
    cap.release()


# --------------------------------------------------- (d) rtpose --video

def _zero_params(net, seed=0):
    """Net.init_params without its random fillers (84 XLA compiles on the
    CPU): every parameter is replaced before use."""
    return {impl.name: [pi.import_caffe(np.zeros(pi.caffe_shape, np.float32))
                        for pi in impl.params] for impl in net.impls if impl.params}


def test_rtpose_video_h264_matches_jax_pipeline(tmp_path, monkeypatch):
    """An H.264 MP4 of 3 random 96x72 frames (coded 96x80) through both
    pipelines (display = frame size, 64x48 net input, a 2-stage COCO net with the JAX
    net's fan-in weights, relaxed thresholds so people are found): the same
    bodies within 1 px and 0.01 confidence, as test_torch_pipeline holds
    for image directories."""
    import jax.numpy as jnp

    from caffe_rtpose_tpu.core.net import Net as JNet
    from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
    from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
    from caffe_rtpose_tpu_torch.core.net import params_from_jax
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
    from caffe_rtpose_tpu_torch.pipeline.runner import RtPosePipeline
    from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

    res, disp = (64, 48), (96, 72)
    rs = np.random.RandomState(0)
    path = tmp_path / "clip.mp4"
    path.write_bytes(H.encode_clip([(rs.rand(disp[1], disp[0], 3) * 255).astype(np.uint8)
                                    for _ in range(3)]))
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
