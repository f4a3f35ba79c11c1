"""Every HDF5 site of the port against the JAX package's, with h5py blocked
on the port's side: the port's half of each site runs in one subprocess with
``sys.modules["h5py"] = None`` (an ``import h5py`` there raises), the JAX
half and the comparisons here, through h5py.

Sites: HDF5Data batches (in order and shuffled), HDF5Output files,
``Net.save_hdf5``/``load_hdf5`` in both directions, ``convert_imageset``'s
``.h5`` pack and ``compute_image_mean`` over it, ``caffe``'s ``.h5`` input
batches, ``detect``'s ``.h5`` output and matcaffe's ``h5create``/``h5write``/
``h5read``/``h5info``/``h5disp`` (a store2hdf5-style script with an ``Inf``
dimension, ``ChunkSize``, batched writes at ``start`` that grow the dataset
and a read of rows not yet written).  Arrays equal bit for bit and text
equal; only ``detect``'s predictions, which the two nets compute in their own
floating point, are held within ``TOL`` as the CSV test holds them."""

import contextlib
import io
import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from caffe_rtpose_tpu_torch.core.net import Net
from caffe_rtpose_tpu_torch.pipeline.image_io import encode_png
from caffe_rtpose_tpu_torch.proto import prototxt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5

CLASSIFIER = {"name": "tinycls", "input": ["data"], "input_shape": [{"dim": [2, 3, 12, 12]}],
              "layer": [
                  {"name": "conv", "type": "Convolution", "bottom": ["data"], "top": ["conv"],
                   "convolution_param": {"num_output": 4, "kernel_size": [3], "stride": [2],
                                         "weight_filler": {"type": "xavier"}}},
                  {"name": "fc", "type": "InnerProduct", "bottom": ["conv"], "top": ["fc"],
                   "inner_product_param": {"num_output": 5,
                                           "weight_filler": {"type": "xavier"}}},
                  {"name": "prob", "type": "Softmax", "bottom": ["fc"], "top": ["prob"]}]}


def output_net(path):
    return {"input": ["x", "y"], "input_shape": [{"dim": [3, 4, 5, 2]}, {"dim": [3, 6]}],
            "layer": [{"name": "h", "type": "HDF5Output", "bottom": ["x", "y"],
                       "hdf5_output_param": {"file_name": str(path)}}]}


INPUT_NET = {"input": ["data", "label"], "input_shape": [{"dim": [2, 3, 6, 6]}, {"dim": [2]}],
             "layer": [{"name": "ip", "type": "InnerProduct", "bottom": ["data"], "top": ["ip"],
                        "inner_product_param": {"num_output": 2}}]}


def hdf5_data_layer(source, shuffle):
    return {"name": "data", "type": "HDF5Data", "top": ["data", "label"],
            "hdf5_data_param": {"source": str(source), "batch_size": 3, "shuffle": shuffle}}


MATLAB_SCRIPT = """filename = 'trial.h5';
chunksz = 2;
data = reshape(single(1:240), 4, 5, 3, 4) / 7;
labels = reshape(single(1:8), 2, 4);
h5create(filename, '/data', [4 5 3 Inf], 'Datatype', 'single', 'ChunkSize', [4 5 3 chunksz]);
h5create(filename, '/label', [2 Inf], 'Datatype', 'single', 'ChunkSize', [2 chunksz]);
h5create(filename, '/fixed', [3 2]);
h5write(filename, '/data', data(:, :, :, 3:4), [1 1 1 3], [4 5 3 chunksz]);
h5write(filename, '/label', labels(:, 3:4), [1 3], [2 chunksz]);
early = h5read(filename, '/label');
h5write(filename, '/data', data(:, :, :, 1:2), [1 1 1 1], [4 5 3 chunksz]);
h5write(filename, '/label', labels(:, 1:2), [1 1], [2 chunksz]);
h5write(filename, '/fixed', [1 2; 3 4; 5 6]);
info = h5info(filename);
back = h5read(filename, '/data');
part = h5read(filename, '/label', [1 2], [2 2]);
h5disp(filename);
"""

# the port's half of every site, run with h5py blocked
PORT_SIDE = r"""
import contextlib, io, json, os, sys
sys.modules["h5py"] = None
import numpy as np
work = sys.argv[1]
spec = json.load(open(os.path.join(work, "spec.json")))

from caffe_rtpose_tpu_torch.core import data_layers as PD
from caffe_rtpose_tpu_torch.core.net import Net
from caffe_rtpose_tpu_torch.proto import caffe_pb
import torch

for shuffle in (False, True):
    layer = PD.build(caffe_pb.view(spec["hdf5_data"][str(shuffle)], "LayerParameter"), "TRAIN")
    batches = [layer.next_batch() for _ in range(4)]
    np.savez(os.path.join(work, f"port_data_{shuffle}.npz"),
             **{f"{i}_{k}": v for i, b in enumerate(batches) for k, v in b.items()})

feeds = np.load(os.path.join(work, "output_feeds.npz"))
for i in range(3):
    Net(spec["output_net"], device="cpu").forward(
        {k: torch.from_numpy(feeds[f"{k}{i}"]) for k in ("x", "y")})

net = Net(spec["classifier"], device="cpu")
net.load_hdf5(os.path.join(work, "jax_weights.h5"))
w = net.export_weights()
np.savez(os.path.join(work, "port_loaded.npz"),
         **{f"{k}/{i}": a for k, blobs in w.items() for i, a in enumerate(blobs)})
net.save_hdf5(os.path.join(work, "port_weights.h5"))

from caffe_rtpose_tpu_torch.tools import aux_tools
with contextlib.redirect_stdout(io.StringIO()):
    aux_tools.main(["convert_imageset", spec["list"], spec["images"],
                    os.path.join(work, "port_pack.h5")])
    for name in ("port_pack", "jax_pack"):
        np.save(os.path.join(work, f"port_mean_{name}.npy"),
                aux_tools.compute_image_mean(os.path.join(work, name + ".h5")))

from caffe_rtpose_tpu_torch.tools.caffe_tool import make_data_iter
it = make_data_iter(os.path.join(work, "input.h5"), Net(spec["input_net"], device="cpu"))
np.savez(os.path.join(work, "port_input.npz"),
         **{f"{i}_{k}": v for i in range(6) for k, v in next(it).items()})

from caffe_rtpose_tpu_torch.tools import detect
with contextlib.redirect_stdout(io.StringIO()):
    detect.main(spec["detect_args"] + [os.path.join(work, "port_detect.h5"), "--device", "cpu"])

from caffe_rtpose_tpu_torch import api
from caffe_rtpose_tpu_torch import matlab_engine as me
api.set_mode_cpu()
os.makedirs(os.path.join(work, "port_mat"))
os.chdir(os.path.join(work, "port_mat"))
env = me.MatlabEngine(spec["matlab"]).run_script(os.path.join(work, "store.m"))
info = env["info"]
json.dump({"stdout": me.engine_stdout(),
           "info": [[str(d.fields["Name"]), me.to_python(d.fields["Dataspace"].fields["Size"]).tolist()]
                    for d in info.fields["Datasets"].items]},
          open(os.path.join(work, "port_mat.json"), "w"))
np.savez(os.path.join(work, "port_mat.npz"),
         **{k: me.to_python(env[k]) for k in ("early", "back", "part")})
assert sys.modules.get("h5py") is None
print("port side done")
"""


def matlab_outputs(env, engine_module):
    info = env["info"]
    return ([[str(d.fields["Name"]),
              engine_module.to_python(d.fields["Dataspace"].fields["Size"]).tolist()]
             for d in info.fields["Datasets"].items],
            {k: engine_module.to_python(env[k]) for k in ("early", "back", "part")})


@pytest.fixture(scope="module")
def sites(tmp_path_factory):
    """The inputs, written here; the port's half in a subprocess with h5py
    blocked; the JAX half here."""
    from caffe_rtpose_tpu import matlab_engine as jme
    from caffe_rtpose_tpu.core import data_layers as JD
    from caffe_rtpose_tpu.core.net import Net as JNet
    from caffe_rtpose_tpu.proto import caffe_pb as jpb
    from caffe_rtpose_tpu.tools import aux_tools as jaux
    from caffe_rtpose_tpu.tools import detect as jdetect
    from caffe_rtpose_tpu.tools.caffe_tool import make_data_iter as jmake_data_iter

    work = tmp_path_factory.mktemp("hdf5_sites")
    rs = np.random.RandomState(14)
    spec = {"matlab": os.path.join(ROOT, "matlab")}
    # HDF5Data: two files, the second with other rows
    for name, n in (("d1.h5", 7), ("d2.h5", 5)):
        with h5py.File(work / name, "w") as f:
            f["data"] = rs.rand(n, 2, 4, 4).astype(np.float32)
            f["label"] = np.arange(n, dtype=np.float32)
    (work / "files.txt").write_text(f"{work / 'd1.h5'}\n{work / 'd2.h5'}\n")
    spec["hdf5_data"] = {str(s): hdf5_data_layer(work / "files.txt", s) for s in (False, True)}
    jax_data = {}
    for s in (False, True):
        layer = JD.build(jpb.view(spec["hdf5_data"][str(s)], "LayerParameter"), "TRAIN")
        jax_data[s] = [layer.next_batch() for _ in range(4)]
    # HDF5Output: three forwards of the same feeds on each side
    feeds = {f"{k}{i}": rs.rand(*shape).astype(np.float32)
             for i in range(3) for k, shape in (("x", (3, 4, 5, 2)), ("y", (3, 6)))}
    np.savez(work / "output_feeds.npz", **feeds)
    spec["output_net"] = output_net(work / "port_out.h5")
    for i in range(3):
        JNet(output_net(work / "jax_out.h5")).forward({k: feeds[f"{k}{i}"] for k in ("x", "y")})
    # weights: JAX's file for the port to load; the port's for JAX to load
    jnet = JNet(CLASSIFIER, seed=5)
    jnet.save_hdf5(str(work / "jax_weights.h5"))
    spec["classifier"] = CLASSIFIER
    # convert_imageset: six PNGs of one size
    (work / "imgs").mkdir()
    lines = []
    for i in range(6):
        (work / "imgs" / f"im{i}.png").write_bytes(
            encode_png(rs.randint(0, 256, (14, 17, 3)).astype(np.uint8)))
        lines.append(f"im{i}.png {i % 3}\n")
    (work / "list.txt").write_text("".join(lines))
    spec["list"], spec["images"] = str(work / "list.txt"), str(work / "imgs")
    with contextlib.redirect_stdout(io.StringIO()):
        assert jaux.main(["convert_imageset", spec["list"], spec["images"],
                          str(work / "jax_pack.h5")]) == 0
        jax_means = {n: jaux.compute_image_mean(str(work / f"{n}.h5"))
                     for n in ("jax_pack",)}
    # caffe's .h5 input: 5 rows, batches of 2 wrap around
    with h5py.File(work / "input.h5", "w") as f:
        f["data"] = rs.rand(5, 3, 6, 6).astype(np.float32)
        f["label"] = np.arange(5, dtype=np.float32)
    spec["input_net"] = INPUT_NET
    it = jmake_data_iter(str(work / "input.h5"), JNet(INPUT_NET))
    jax_input = [next(it) for _ in range(6)]
    # detect: a classifier over windows of two images
    proto = str(work / "deploy.prototxt")
    prototxt.dump_file(CLASSIFIER, proto)
    Net(proto, device="cpu", seed=3).save_caffemodel(str(work / "w.caffemodel"))
    (work / "win.csv").write_text("filename, xmin, ymin, xmax, ymax\n"
                                  f"{work}/imgs/im0.png, 2, 3, 12, 11\n"
                                  f"{work}/imgs/im1.png, 0, 0, 17, 14\n"
                                  f"{work}/imgs/im0.png, 5, 1, 16, 13\n")
    spec["detect_args"] = [str(work / "win.csv"), "--model_def", proto, "--pretrained_model",
                           str(work / "w.caffemodel"), "--crop_mode", "list",
                           "--context_pad", "0"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert jdetect.main(spec["detect_args"] + [str(work / "jax_detect.h5")]) == 0
    # matcaffe
    (work / "store.m").write_text(MATLAB_SCRIPT)
    (work / "jax_mat").mkdir()
    cwd = os.getcwd()
    try:
        os.chdir(work / "jax_mat")
        before = len(jme.engine_stdout())
        env = jme.MatlabEngine(spec["matlab"]).run_script(str(work / "store.m"))
        jax_stdout = jme.engine_stdout()[before:]
    finally:
        os.chdir(cwd)
    jax_info, jax_mat = matlab_outputs(env, jme)

    (work / "spec.json").write_text(json.dumps(spec))
    res = subprocess.run([sys.executable, "-c", PORT_SIDE, str(work)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "port side done" in res.stdout, res.stderr[-4000:]
    return dict(work=work, jax_data=jax_data, jax_means=jax_means, jax_input=jax_input,
                jax_info=jax_info, jax_mat=jax_mat, jax_stdout=jax_stdout, jnet=jnet)


def assert_h5_equal(a, b, exact_dtype=True):
    """Two files hold the same groups and datasets (shape, dtype, chunks,
    maxshape and values bit for bit)."""
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        def walk(ga, gb, name):
            assert list(ga.keys()) == list(gb.keys()), name
            for k in gb:
                oa, ob = ga[k], gb[k]
                if isinstance(ob, h5py.Group):
                    walk(oa, ob, f"{name}/{k}")
                    continue
                assert (oa.shape, oa.dtype, oa.chunks, oa.maxshape, oa.compression) == \
                    (ob.shape, ob.dtype, ob.chunks, ob.maxshape, ob.compression), f"{name}/{k}"
                va, vb = oa[()], ob[()]
                if oa.dtype == object:
                    assert va.tolist() == vb.tolist(), f"{name}/{k}"
                else:
                    assert np.asarray(va).tobytes() == np.asarray(vb).tobytes(), f"{name}/{k}"
        walk(fa, fb, "")


@pytest.mark.parametrize("shuffle", [False, True])
def test_hdf5_data_batches(sites, shuffle):
    got = np.load(sites["work"] / f"port_data_{shuffle}.npz")
    for i, batch in enumerate(sites["jax_data"][shuffle]):
        for k, v in batch.items():
            a = got[f"{i}_{k}"]
            assert a.dtype == v.dtype and a.tobytes() == v.tobytes(), (i, k)


def test_hdf5_output_file(sites):
    assert_h5_equal(sites["work"] / "port_out.h5", sites["work"] / "jax_out.h5")
    with h5py.File(sites["work"] / "port_out.h5", "r") as f:
        assert f["x"].shape == (9, 4, 5, 2) and f["y"].shape == (9, 6)


def test_weights_jax_to_port(sites):
    got = np.load(sites["work"] / "port_loaded.npz")
    want = sites["jnet"].export_weights()
    assert sorted(got.files) == sorted(f"{k}/{i}" for k, b in want.items() for i in range(len(b)))
    for k, blobs in want.items():
        for i, a in enumerate(blobs):
            assert got[f"{k}/{i}"].tobytes() == np.asarray(a, np.float32).tobytes(), (k, i)


def test_weights_port_to_jax(sites):
    from caffe_rtpose_tpu.core.net import Net as JNet

    assert_h5_equal(sites["work"] / "port_weights.h5", sites["work"] / "jax_weights.h5")
    other = JNet(CLASSIFIER, seed=9)
    other.load_hdf5(str(sites["work"] / "port_weights.h5"))
    for k, blobs in sites["jnet"].export_weights().items():
        for a, b in zip(other.export_weights()[k], blobs):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), k


def test_convert_imageset_pack_and_mean(sites):
    work = sites["work"]
    assert_h5_equal(work / "port_pack.h5", work / "jax_pack.h5")
    with h5py.File(work / "port_pack.h5", "r") as f:
        assert f["data"].compression == "gzip" and f["data"].dtype == np.uint8
        assert f["label"].dtype == np.int64
    want = sites["jax_means"]["jax_pack"]
    for name in ("port_pack", "jax_pack"):
        got = np.load(work / f"port_mean_{name}.npy")
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name


def test_caffe_h5_input_batches(sites):
    got = np.load(sites["work"] / "port_input.npz")
    for i, batch in enumerate(sites["jax_input"]):
        for k, v in batch.items():
            assert got[f"{i}_{k}"].tobytes() == np.asarray(v).tobytes(), (i, k)


def test_detect_h5_output(sites):
    work = sites["work"]
    with h5py.File(work / "port_detect.h5", "r") as a, h5py.File(work / "jax_detect.h5", "r") as b:
        assert list(a.keys()) == list(b.keys()) == sorted(
            ["prediction", "ymin", "xmin", "ymax", "xmax", "filename"])
        for k in b:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
            assert h5py.check_string_dtype(a[k].dtype) == h5py.check_string_dtype(b[k].dtype)
        for k in ("ymin", "xmin", "ymax", "xmax", "filename"):
            assert a[k][()].tolist() == b[k][()].tolist(), k
        assert sorted(set(a["filename"][()].tolist())) == [
            f"{work}/imgs/im{i}.png".encode() for i in (0, 1)]
        np.testing.assert_allclose(a["prediction"][()], b["prediction"][()], rtol=0, atol=TOL)


def test_matcaffe_h5_builtins(sites):
    work = sites["work"]
    assert_h5_equal(work / "port_mat" / "trial.h5", work / "jax_mat" / "trial.h5")
    port = json.loads((work / "port_mat.json").read_text())
    assert port["stdout"] == sites["jax_stdout"]
    assert "Dataset 'data'  Size: 4x5x3x4" in port["stdout"]
    assert port["info"] == sites["jax_info"]
    got = np.load(work / "port_mat.npz")
    for k, v in sites["jax_mat"].items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    assert (got["early"][:, :2] == 0).all() and (got["early"][:, 2:] != 0).all()
