"""The port's Caffe tools against the JAX package's on the CPU, on the same
files: parse_log's rows and CSVs (a ``caffe train`` log of the port and a
glog-stamped one), plot_training_log's series, summarize's table (and
``--shapes``), draw_net's ``.dot``, the shims' delegation and warning,
convert_imageset's DB (keys, labels, shapes and pixels: equal, with and
without a resize; within a u8 level with ``--gray``, two resized),
compute_image_mean (bit for bit, and its
``.binaryproto`` bytes), extract_features' ``.npz`` (within 1e-5 of each
blob's largest) and detect's CSV (within 1e-5), and encoded-PNG Datums
written and read with OpenCV blocked."""

import contextlib
import csv
import io
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from caffe_rtpose_tpu_torch import api
from caffe_rtpose_tpu_torch.pipeline.image_io import encode_png
from caffe_rtpose_tpu_torch.proto import prototxt
from caffe_rtpose_tpu_torch.tools import (aux_tools, detect, draw_net, parse_log,
                                          plot_training_log, shims, summarize)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5

_LSQ_NET = """
name: "t"
layer { name: "data" type: "DummyData" top: "x" top: "t"
  dummy_data_param { shape { dim: 4 dim: 3 } shape { dim: 4 dim: 1 }
    data_filler { type: "gaussian" std: 1.0 }
    data_filler { type: "constant" value: 0.5 } } }
layer { name: "ip" type: "InnerProduct" bottom: "x" top: "p"
  inner_product_param { num_output: 1
    weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "l" type: "EuclideanLoss" bottom: "p" bottom: "t" top: "l" }
"""

_GLOG_LOG = """\
I0523 14:00:00.000000  1234 solver.cpp:242] Iteration 0, loss = 2.5
I0523 14:00:00.100000  1234 solver.cpp:258]     Train net output #0: l = 2.5 (* 1 = 2.5 loss)
I0523 14:00:00.200000  1234 sgd_solver.cpp:112] Iteration 0, lr = 0.1
I0523 14:00:10.000000  1234 solver.cpp:242] Iteration 20, loss = 1.25
I0523 14:00:10.100000  1234 solver.cpp:258]     Train net output #0: l = 1.25 (* 1 = 1.25 loss)
I0523 14:00:10.200000  1234 sgd_solver.cpp:112] Iteration 20, lr = 0.05
I0523 14:00:15.000000  1234 solver.cpp:330] Iteration 40, Testing net (#0)
I0523 14:00:15.500000  1234 solver.cpp:397]     Test net output #0: accuracy = 0.75
I0523 14:00:15.500000  1234 solver.cpp:397]     Test net output #1: l = 1.0
"""

_SUMMARY_NET = """
name: "t"
input: "x" input_shape { dim: 2 dim: 3 dim: 8 dim: 8 }
layer { name: "c" type: "Convolution" bottom: "x" top: "c"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  convolution_param { num_output: 4 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.01 } } }
layer { name: "r" type: "ReLU" bottom: "c" top: "c" }
layer { name: "p" type: "Pooling" bottom: "c" top: "p"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "drop" type: "Dropout" bottom: "p" top: "p" include { phase: TRAIN } }
layer { name: "ip" type: "InnerProduct" bottom: "p" top: "ip"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
"""


@pytest.fixture(autouse=True, scope="module")
def cpu_mode():
    api.set_mode_cpu()
    yield
    api.set_mode_gpu()


@pytest.fixture(scope="module")
def train_log(tmp_path_factory):
    """A ``caffe train`` log of the port (CPU), with a test net."""
    from caffe_rtpose_tpu_torch.tools import caffe_tool

    d = tmp_path_factory.mktemp("log")
    net = d / "n.prototxt"
    net.write_text(_LSQ_NET)
    sol = d / "s.prototxt"
    sol.write_text(f'net: "{net}"\nbase_lr: 0.05\nlr_policy: "step"\nstepsize: 2\ngamma: 0.5\n'
                   'max_iter: 6\ndisplay: 2\ntest_interval: 3\ntest_iter: 1\n')
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert caffe_tool.main(["train", "--solver", str(sol), "--device", "cpu"]) == 0
    log = d / "caffe.log"
    log.write_text(buf.getvalue())
    glog = d / "glog.log"
    glog.write_text(_GLOG_LOG)
    return str(log), str(glog)


def test_parse_log_matches_jax(train_log, tmp_path):
    from caffe_rtpose_tpu.tools import parse_log as jparse

    for log in train_log:
        got, ref = parse_log.parse_log(log), jparse.parse_log(log)
        assert got == ref and got[0]
        (tmp_path / "port").mkdir(exist_ok=True)
        (tmp_path / "jax").mkdir(exist_ok=True)
        assert parse_log.main([log, str(tmp_path / "port")]) == 0
        assert jparse.main([log, str(tmp_path / "jax")]) == 0
        for ext in (".train", ".test"):
            name = os.path.basename(log) + ext
            assert ((tmp_path / "port" / name).read_bytes()
                    == (tmp_path / "jax" / name).read_bytes())
    train, test = parse_log.parse_log(train_log[0])
    assert len(train) >= 3 and test and all("l" in r for r in train + test)


@pytest.mark.parametrize("chart", range(8))
def test_plot_series_match_jax(train_log, chart):
    from caffe_rtpose_tpu.tools import plot_training_log as jplot

    for log in train_log:
        try:
            ref = jplot.extract_series(log, chart)
        except ValueError:
            with pytest.raises(ValueError):
                plot_training_log.extract_series(log, chart)
            continue
        assert plot_training_log.extract_series(log, chart) == ref


def test_plot_without_matplotlib_exits_with_a_message(train_log, tmp_path):
    code = ("import sys\nsys.modules['matplotlib'] = None\n"
            "from caffe_rtpose_tpu_torch.tools import plot_training_log as p\n"
            f"sys.exit(p.main(['6', {str(tmp_path / 'o.png')!r}, {train_log[0]!r}]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 2 and "matplotlib is not available" in res.stderr
    assert not (tmp_path / "o.png").exists()


def test_plot_png(train_log, tmp_path):
    out = tmp_path / "loss.png"
    assert plot_training_log.main(["6", str(out), train_log[0]]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("color", [False, True])
def test_summarize_table_matches_jax(tmp_path, color):
    from caffe_rtpose_tpu.tools import summarize as jsum

    p = tmp_path / "n.prototxt"
    p.write_text(_SUMMARY_NET + 'layer { name: "bad" type: "ReLU" bottom: "ghost" top: "g" }\n')
    assert summarize.summarize(str(p), color=color) == jsum.summarize(str(p), color=color)


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_summarize_shapes_match_jax(tmp_path, capsys, phase):
    from caffe_rtpose_tpu.tools import summarize as jsum

    p = tmp_path / "n.prototxt"
    p.write_text(_SUMMARY_NET)
    assert summarize.main(["-s", "--no-color", "-p", phase, "--device", "cpu", str(p)]) == 0
    got = capsys.readouterr().out
    assert jsum.main(["-s", "--no-color", "-p", phase, str(p)]) == 0
    assert got == capsys.readouterr().out
    assert "c 2x4x8x8" in got and "ip 2x5" in got


@pytest.mark.parametrize("phase,rankdir", [("ALL", "LR"), ("TRAIN", "TB"), ("TEST", "BT")])
def test_draw_net_dot_matches_jax(tmp_path, capsys, phase, rankdir):
    from caffe_rtpose_tpu.tools import draw_net as jdraw

    p = tmp_path / "n.prototxt"
    p.write_text(_SUMMARY_NET)
    args = ["--phase", phase, "--rankdir", rankdir]
    assert draw_net.main([str(p), str(tmp_path / "port.dot"), *args]) == 0
    assert jdraw.main([str(p), str(tmp_path / "jax.dot"), *args]) == 0
    got = (tmp_path / "port.dot").read_text()
    assert got == (tmp_path / "jax.dot").read_text()
    assert f"rankdir={rankdir}" in got and ('"drop"' in got) == (phase != "TEST")


SHIM_CASES = [
    ["train_net", "s.prototxt"],
    ["train_net", "s.prototxt", "s_iter_4.solverstate"],
    ["test_net", "n.prototxt", "w.caffemodel"],
    ["test_net", "n.prototxt", "w.caffemodel", "7"],
    ["finetune_net", "s.prototxt", "w.caffemodel"],
    ["net_speed_benchmark", "n.prototxt"],
    ["net_speed_benchmark", "n.prototxt", "3"],
]


@pytest.mark.parametrize("argv", SHIM_CASES, ids=lambda a: "-".join(a[:1] + [str(len(a))]))
def test_shims_delegate_as_jax(monkeypatch, capsys, argv):
    """Each shim calls the caffe tool with JAX's arguments (plus the
    ``--device`` given after its name) and prints JAX's warning."""
    from caffe_rtpose_tpu.tools import caffe_tool as jcaffe
    from caffe_rtpose_tpu.tools import shims as jshims
    from caffe_rtpose_tpu_torch.tools import caffe_tool

    calls = {}
    monkeypatch.setattr(caffe_tool, "main", lambda a: calls.__setitem__("port", a) or 0)
    monkeypatch.setattr(jcaffe, "main", lambda a: calls.__setitem__("jax", a) or 0)
    assert jshims.main(list(argv)) == 0
    ref_err = capsys.readouterr().err
    assert shims.main(list(argv)) == 0
    assert capsys.readouterr().err == ref_err and "is deprecated. Use caffe" in ref_err
    assert calls["port"] == calls["jax"]
    assert shims.main([argv[0], "--device", "cpu", *argv[1:]]) == 0
    assert calls["port"] == calls["jax"] + ["--device", "cpu"]


def test_shims_usage():
    assert shims.main(["bogus"]) == 2
    assert shims.main(["test_net", "n.prototxt"]) == 2


def test_shim_runs_the_port_tool(tmp_path, capsys):
    """train_net and net_speed_benchmark end to end on the CPU."""
    net = tmp_path / "n.prototxt"
    net.write_text(_LSQ_NET)
    sol = tmp_path / "s.prototxt"
    sol.write_text(f'net: "{net}"\nbase_lr: 0.05\nlr_policy: "fixed"\nmax_iter: 2\n'
                   f'snapshot_prefix: "{tmp_path}/s"\n')
    assert shims.main(["train_net", str(sol), "--device", "cpu"]) == 0
    assert os.path.exists(f"{tmp_path}/s_iter_2.caffemodel")
    assert shims.main(["net_speed_benchmark", str(net), "2", "--device", "cpu"]) == 0
    assert "net_speed_benchmark is deprecated" in capsys.readouterr().err


# ----------------------------------------------------------- aux tools


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Six seeded PNGs of two sizes, written without OpenCV, and their list."""
    d = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    lines = []
    for i in range(6):
        h, w = (20, 24) if i % 2 else (18, 26)
        (d / f"im{i}.png").write_bytes(encode_png(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)))
        lines.append(f"im{i}.png {i % 3}\n")
    (d / "list.txt").write_text("".join(lines))
    return d


def read_db(path):
    from caffe_rtpose_tpu_torch.core.data_layers import datum_chw
    from caffe_rtpose_tpu_torch.proto import datum
    from caffe_rtpose_tpu_torch.utils.db import open_db

    out = []
    with open_db(path, "r") as db:
        cur = db.new_cursor()
        cur.seek_to_first()
        while cur.valid():
            d = datum.parse_datum(cur.value())
            out.append((cur.key(), int(d.get("label", 0)), bool(d.get("encoded")), datum_chw(d)))
            cur.next()
    return out


# case -> (arguments, largest u8 difference from JAX's DB): a resize is
# cv2's fixed point in both, and --gray converts as cv2's PNG reader does
# (libpng's fixed point): equal
CONVERT_CASES = {"raw": ([], 0), "encoded": (["--encoded"], 0),
                 "resized": (["--resize_height", "16", "--resize_width", "20"], 0),
                 "gray": (["--gray"], 0),
                 "gray_resized_shuffled": (["--gray", "--shuffle", "--resize_height", "12",
                                            "--resize_width", "14"], 0),
                 "encoded_bmp": (["--encoded", "--encode_type", "bmp"], 0),
                 "encoded_ppm": (["--encoded", "--encode_type", "ppm"], 0),
                 "gray_encoded_pgm": (["--gray", "--encoded", "--encode_type", "pgm"], 0)}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_convert_imageset_matches_jax(images, tmp_path, case):
    from caffe_rtpose_tpu.tools import aux_tools as jaux

    extra, limit = CONVERT_CASES[case]
    args = [str(images / "list.txt"), str(images), *extra]
    with contextlib.redirect_stdout(io.StringIO()):
        assert aux_tools.main(["convert_imageset", args[0], args[1], str(tmp_path / "port"),
                               *args[2:]]) == 0
        assert jaux.main(["convert_imageset", args[0], args[1], str(tmp_path / "jax"),
                          *args[2:]]) == 0
    got, ref = read_db(str(tmp_path / "port")), read_db(str(tmp_path / "jax"))
    assert [g[:3] for g in got] == [r[:3] for r in ref] and len(got) == 6
    for g, r in zip(got, ref):
        assert g[3].shape == r[3].shape and g[3].dtype == np.uint8
        diff = np.abs(g[3].astype(int) - r[3].astype(int)).max()
        assert diff <= limit, (g[0], diff)


def test_convert_imageset_h5_and_mean_match_jax(images, tmp_path):
    from caffe_rtpose_tpu.tools import aux_tools as jaux

    args = [str(images / "list.txt"), str(images), "--resize_height", "16",
            "--resize_width", "16"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert aux_tools.main(["convert_imageset", args[0], args[1], str(tmp_path / "p.h5"),
                               *args[2:]]) == 0
    h5py = pytest.importorskip("h5py")  # JAX's side and the comparison
    with contextlib.redirect_stdout(io.StringIO()):
        assert jaux.main(["convert_imageset", args[0], args[1], str(tmp_path / "j.h5"),
                          *args[2:]]) == 0
    with h5py.File(tmp_path / "p.h5") as f, h5py.File(tmp_path / "j.h5") as g:
        assert f["data"].shape == g["data"].shape == (6, 3, 16, 16)
        assert list(f["label"]) == list(g["label"])
        np.testing.assert_array_equal(f["data"][...], g["data"][...])
    with contextlib.redirect_stdout(io.StringIO()):
        np.testing.assert_array_equal(aux_tools.compute_image_mean(str(tmp_path / "j.h5")),
                                      jaux.compute_image_mean(str(tmp_path / "j.h5")))


@pytest.mark.parametrize("encoded", [False, True])
def test_compute_image_mean_matches_jax(images, tmp_path, encoded):
    """Bit for bit, and the same ``.binaryproto`` bytes, over one DB (images
    of one size: a mean needs one shape)."""
    from caffe_rtpose_tpu.tools import aux_tools as jaux

    lst = tmp_path / "odd.txt"
    lst.write_text("".join(f"im{i}.png {i}\n" for i in (1, 3, 5)))
    db = str(tmp_path / "db")
    with contextlib.redirect_stdout(io.StringIO()):
        jaux.convert_imageset(str(lst), str(images), db, encoded=encoded)
        got = aux_tools.compute_image_mean(db, str(tmp_path / "port.binaryproto"))
        ref = jaux.compute_image_mean(db, str(tmp_path / "jax.binaryproto"))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (3, 20, 24) and got.dtype == np.float32
    assert ((tmp_path / "port.binaryproto").read_bytes()
            == (tmp_path / "jax.binaryproto").read_bytes())


def tiny_classifier(batch=4, crop=20, classes=6):
    return {"name": "tinycls", "input": ["data"],
            "input_shape": [{"dim": [batch, 3, crop, crop]}],
            "layer": [
                {"name": "conv", "type": "Convolution", "bottom": ["data"], "top": ["conv"],
                 "convolution_param": {"num_output": 8, "kernel_size": [5], "stride": [2],
                                       "weight_filler": {"type": "xavier"}}},
                {"name": "relu", "type": "ReLU", "bottom": ["conv"], "top": ["conv"]},
                {"name": "pool", "type": "Pooling", "bottom": ["conv"], "top": ["pool"],
                 "pooling_param": {"pool": 0, "kernel_size": 2, "stride": 2}},
                {"name": "fc7", "type": "InnerProduct", "bottom": ["pool"], "top": ["fc7"],
                 "inner_product_param": {"num_output": 12, "weight_filler": {"type": "xavier"}}},
                {"name": "fc8", "type": "InnerProduct", "bottom": ["fc7"], "top": ["fc8"],
                 "inner_product_param": {"num_output": classes,
                                         "weight_filler": {"type": "xavier"}}},
                {"name": "prob", "type": "Softmax", "bottom": ["fc8"], "top": ["prob"]}]}


@pytest.fixture(scope="module")
def classifier(tmp_path_factory):
    """The tiny classifier's deploy prototxt and seeded caffemodel."""
    from caffe_rtpose_tpu_torch.core.net import Net

    d = tmp_path_factory.mktemp("cls")
    proto = str(d / "deploy.prototxt")
    prototxt.dump_file(tiny_classifier(), proto)
    net = Net(proto, device="cpu", seed=3)
    weights = str(d / "w.caffemodel")
    net.save_caffemodel(weights)
    return d, proto, weights


def test_extract_features_matches_jax(classifier):
    from caffe_rtpose_tpu.tools import aux_tools as jaux

    d, proto, weights = classifier
    rs = np.random.RandomState(4)
    np.savez(d / "batch.npz", data=(rs.rand(4, 3, 20, 20) * 2 - 1).astype(np.float32))
    with contextlib.redirect_stdout(io.StringIO()):
        assert aux_tools.main(["extract_features", "--model", proto, "--weights", weights,
                               "--blobs", "fc7,prob", "--data", str(d / "batch.npz"),
                               "--out", str(d / "port.npz"), "--iterations", "2",
                               "--device", "cpu"]) == 0
        assert jaux.main(["extract_features", "--model", proto, "--weights", weights,
                          "--blobs", "fc7,prob", "--data", str(d / "batch.npz"),
                          "--out", str(d / "jax.npz"), "--iterations", "2"]) == 0
    got, ref = np.load(d / "port.npz"), np.load(d / "jax.npz")
    assert sorted(got.files) == sorted(ref.files) == ["fc7", "prob"]
    for k in ref.files:
        assert got[k].shape == ref[k].shape == ((8, 12) if k == "fc7" else (8, 6))
        assert np.abs(got[k] - ref[k]).max() <= TOL * max(1.0, float(np.abs(ref[k]).max())), k


def test_detect_csv_matches_jax(classifier, images, tmp_path):
    from caffe_rtpose_tpu.tools import detect as jdetect

    d, proto, weights = classifier
    win = tmp_path / "win.csv"
    win.write_text("filename, xmin, ymin, xmax, ymax\n"
                   f"{images}/im0.png, 2, 3, 20, 16\n"
                   f"{images}/im1.png, 0, 0, 24, 20\n"
                   f"{images}/im0.png, 5, 1, 25, 17\n")
    np.save(tmp_path / "mean.npy", np.array([104.0, 117.0, 123.0], np.float32))
    args = [str(win), "", "--model_def", proto, "--pretrained_model", weights,
            "--crop_mode", "list", "--mean_file", str(tmp_path / "mean.npy"), "--context_pad", "0"]
    with contextlib.redirect_stdout(io.StringIO()):
        args[1] = str(tmp_path / "port.csv")
        assert detect.main(args + ["--device", "cpu"]) == 0
        args[1] = str(tmp_path / "jax.csv")
        assert jdetect.main(args) == 0

    def rows(p):
        with open(p) as f:
            return list(csv.reader(f))

    got, ref = rows(tmp_path / "port.csv"), rows(tmp_path / "jax.csv")
    assert got[0] == ref[0] and len(got) == len(ref) == 4
    for g, r in zip(got[1:], ref[1:]):
        assert g[:5] == r[:5]
        np.testing.assert_allclose(np.array(g[5].split(), float), np.array(r[5].split(), float),
                                   atol=TOL)


def test_detect_selective_search_needs_the_package(classifier, tmp_path):
    d, proto, weights = classifier
    lst = tmp_path / "l.txt"
    lst.write_text("im0.png\n")
    with pytest.raises(SystemExit, match="selective_search"):
        detect.main([str(lst), str(tmp_path / "o.csv"), "--model_def", proto,
                     "--device", "cpu"])


def test_encoded_png_datums_without_cv2(tmp_path):
    """convert_imageset --encoded and the Data layer's decode with OpenCV
    blocked: PNG Datums round-trip, and JPEG Datums (image_to_datum "jpg",
    convert_imageset --encode_type jpg) hold cv2's bytes and pixels."""
    rs = np.random.RandomState(7)
    img = rs.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    (tmp_path / "a.png").write_bytes(encode_png(img))
    (tmp_path / "list.txt").write_text("a.png 3\n")
    np.save(tmp_path / "img.npy", img)
    code = f"""
import sys
sys.modules["cv2"] = None
import numpy as np
from caffe_rtpose_tpu_torch.tools import aux_tools
from caffe_rtpose_tpu_torch.core.data_layers import datum_chw
from caffe_rtpose_tpu_torch.proto import datum
from caffe_rtpose_tpu_torch.utils.db import open_db
d = {str(tmp_path)!r}
assert aux_tools.main(["convert_imageset", d + "/list.txt", d, d + "/db", "--encoded"]) == 0
with open_db(d + "/db", "r") as db:
    cur = db.new_cursor(); cur.seek_to_first()
    rec = datum.parse_datum(cur.value())
assert rec["encoded"] and rec["label"] == 3
img = np.load(d + "/img.npy")
assert np.array_equal(datum.datum_to_image(rec), img)
assert np.array_equal(datum_chw(rec), img.transpose(2, 0, 1))
j = datum.image_to_datum(img, 0, "jpg")
open(d + "/datum.jpg", "wb").write(j["data"])
np.save(d + "/jpg_decoded.npy", datum.datum_to_image(j))
assert aux_tools.main(["convert_imageset", d + "/list_jpg.txt", d, d + "/db_jpg", "--encoded",
                       "--encode_type", "jpg"]) == 0
with open_db(d + "/db_jpg", "r") as db:
    cur = db.new_cursor(); cur.seek_to_first()
    rec = datum.parse_datum(cur.value())
assert rec["encoded"] and rec["label"] == 4 and bytes(rec["data"][:2]) == bytes([255, 216])
np.save(d + "/db_jpg.npy", datum_chw(rec))
print("ok", "cv2" in sys.modules and sys.modules["cv2"] is not None)
"""
    (tmp_path / "b.jpg").write_bytes(cv2.imencode(".jpg", img[::-1])[1].tobytes())
    (tmp_path / "list_jpg.txt").write_text("b.jpg 4\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.split()[-2:] == ["ok", "False"], res.stderr
    # the JPEG Datum written with cv2 blocked: cv2's bytes, and cv2.imdecode's pixels
    data = (tmp_path / "datum.jpg").read_bytes()
    assert data == cv2.imencode(".jpg", img)[1].tobytes()
    np.testing.assert_array_equal(np.load(tmp_path / "jpg_decoded.npy"),
                                  cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    # convert_imageset --encode_type jpg re-encodes what it read: cv2.imread, then imencode
    ref = cv2.imread(str(tmp_path / "b.jpg"))
    ref = cv2.imdecode(cv2.imencode(".jpg", ref)[1], cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(np.load(tmp_path / "db_jpg.npy"), ref.transpose(2, 0, 1))


def test_jpeg_datums_match_jax():
    """image_to_datum(..., "jpg") and datum_to_image against the JAX
    package's (cv2): the same bytes, the same pixels, in colour and gray."""
    from caffe_rtpose_tpu.proto import datum as jdatum

    from caffe_rtpose_tpu_torch.proto import datum

    rs = np.random.RandomState(10)
    img = rs.randint(0, 256, (21, 17, 3)).astype(np.uint8)
    img[:8] = img[:8] // 8 + 100
    for x in (img, img[:, :, :1]):
        for fmt in ("jpg", "jpeg"):
            d, jd = datum.image_to_datum(x, 2, fmt), jdatum.image_to_datum(x, 2, fmt)
            assert d == jd
            got, ref = datum.datum_to_image(d), jdatum.datum_to_image(jd)
            assert got.shape == ref.shape == x.shape
            np.testing.assert_array_equal(got, ref)
    # a gray Datum of a colour JPEG decodes to libjpeg's Y plane, as IMREAD_GRAYSCALE
    d = {**datum.image_to_datum(img, 0, "jpg"), "channels": 1}
    np.testing.assert_array_equal(datum.datum_to_image(d), jdatum.datum_to_image(d))


def test_encoded_png_datum_decodes_as_cv2_does():
    """The port's PNG Datum decodes to what cv2.imdecode gives, and a Datum
    cv2 encoded decodes in the port to the same pixels."""
    from caffe_rtpose_tpu_torch.proto import datum

    img = np.random.RandomState(8).randint(0, 256, (13, 7, 3)).astype(np.uint8)
    d = datum.image_to_datum(img, 1, "png")
    ref = cv2.imdecode(np.frombuffer(d["data"], np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(datum.datum_to_image(d), ref)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    np.testing.assert_array_equal(datum.datum_to_image({**d, "data": buf.tobytes()}), img)
    gray = img[:, :, :1]
    g = datum.image_to_datum(gray, 0, "png")
    assert g["channels"] == 1
    np.testing.assert_array_equal(datum.datum_to_image(g), gray)
