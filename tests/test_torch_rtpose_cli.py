"""The port's rtpose CLI (tools/rtpose.py, ``python -m caffe_rtpose_tpu_torch
rtpose``): the JAX tool's flags and defaults plus ``--device``; an image
directory end to end on the CPU; what is not ported raises."""

import os
import subprocess
import sys

import numpy as np
import pytest

from caffe_rtpose_tpu.tools import rtpose as jax_rtpose
from caffe_rtpose_tpu_torch.pipeline.image_io import read_image
from caffe_rtpose_tpu_torch.tools import rtpose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_flags_and_defaults_match_jax():
    """Every JAX flag with its default, plus --device; --caffeproto's default
    is the reference checkout's relative path (as --caffemodel's is), not
    the JAX tool's absolute one; both fall back to the built-in graph when
    the file is missing."""
    port, ref = _flags(rtpose.build_parser()), _flags(jax_rtpose.build_parser())
    extra = port.pop("device")
    assert extra[1] == "cuda" and set(extra[2]) == {"cuda", "cpu"}
    assert port.keys() == ref.keys()
    assert port["caffeproto"][1] == "model/coco/pose_deploy_linevec.prototxt"
    assert ref["caffeproto"][1].endswith("/" + port["caffeproto"][1])
    for k in ref:
        if k == "caffeproto":
            continue
        assert port[k][:3] == ref[k][:3], k
        assert (port[k][3] is None) == (ref[k][3] is None), k
    assert port["dtype"][1] == "bfloat16"


def _png_dir(path, n, wh=(160, 96)):
    import struct
    import zlib

    os.makedirs(path)
    rs = np.random.RandomState(0)
    for i in range(n):
        rgb = (rs.rand(wh[1], wh[0], 3) * 255).astype(np.uint8)
        raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(wh[1]))

        def chunk(kind, body):
            return struct.pack(">I", len(body)) + kind + body + struct.pack(
                ">I", zlib.crc32(kind + body))

        with open(os.path.join(path, f"f{i}.png"), "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n"
                    + chunk(b"IHDR", struct.pack(">IIBBBBB", wh[0], wh[1], 8, 2, 0, 0, 0))
                    + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
        assert read_image(os.path.join(path, f"f{i}.png")).shape == (wh[1], wh[0], 3)


def test_image_dir_end_to_end_on_cpu(tmp_path, capsys):
    img, out = str(tmp_path / "img"), str(tmp_path / "json")
    _png_dir(img, 3)
    rc = rtpose.main(["--device", "cpu", "--no_weights", "--image_dir", img, "--write_json", out,
                      "--frame_limit", "2", "--net_resolution", "128x80", "--no_display",
                      "--no_frame_drops", "--caffeproto", str(tmp_path / "missing.prototxt")])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["f0.json", "f1.json"]
    assert "overflow refetches" in capsys.readouterr().out


def test_module_entry_point(tmp_path):
    img, out = str(tmp_path / "img"), str(tmp_path / "json")
    _png_dir(img, 1, wh=(64, 48))
    res = subprocess.run([sys.executable, "-m", "caffe_rtpose_tpu_torch", "rtpose", "--device",
                          "cpu", "--no_weights", "--image_dir", img, "--write_json", out,
                          "--net_resolution", "64x48", "--resolution", "64x48", "--no_display",
                          "--no_frame_drops", "--dtype", "float32"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert os.listdir(out) == ["f0.json"]
    assert "built-in COCO" in res.stderr


def test_refuses_what_is_not_ported(tmp_path):
    proto, model = tmp_path / "deploy.prototxt", tmp_path / "w.caffemodel"
    proto.write_text("name: 'x'\n")
    model.write_bytes(b"\0")
    for argv in (["--bundle", "b"], ["--caffeproto", str(proto)],
                 ["--caffemodel", str(model)]):
        with pytest.raises(NotImplementedError):
            rtpose.main(["--device", "cpu", *argv])
    missing = ["--caffeproto", str(tmp_path / "missing.prototxt")]
    with pytest.raises(NotImplementedError):  # the device pool
        rtpose.main(["--device", "cpu", "--no_weights", "--num_gpu", "2", *missing,
                     "--net_resolution", "64x48", "--image_dir", str(tmp_path)])
    assert rtpose.main(["--device", "cpu", "--net_resolution", "100x48", *missing]) == 2
