"""The port's MATLAB engine (``caffe_rtpose_tpu_torch/matlab_engine.py``)
against the JAX package's, on the shipped matcaffe M-files (``matlab/``,
unchanged: they name the JAX package and ``py.jax``, which the port's
engine maps through its alias table).

Every ``.m`` parses; the same M-file calls through both engines on the CPU
agree: ``Net`` forward and backward (within 1e-5 of each blob's largest,
both sides on the same caffemodel), blob get/set/reshape, layer params,
``Solver`` step, ``io.load_image``, ``io`` mean round trip, ``version``;
``caffe.run_tests()`` runs end to end; ``set_mode_cpu``/``set_mode_gpu``
set the port facade's mode; and the engine never imports jax (a subprocess
with ``sys.modules["jax"] = None`` runs ``caffe.run_tests()``)."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from caffe_rtpose_tpu import matlab_engine as jme
from caffe_rtpose_tpu_torch import api
from caffe_rtpose_tpu_torch import matlab_engine as me
from caffe_rtpose_tpu_torch.pipeline.image_io import encode_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATLAB = os.path.join(ROOT, "matlab")
TOL = 1e-5

NET = """name: "n"
input: "x"
input_shape { dim: 2 dim: 3 dim: 6 dim: 5 }
layer { name: "c" type: "Convolution" bottom: "x" top: "y"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.3 } bias_filler { type: "constant" value: 0.1 } } }
layer { name: "r" type: "ReLU" bottom: "y" top: "y" }
layer { name: "ip" type: "InnerProduct" bottom: "y" top: "z"
  inner_product_param { num_output: 7 weight_filler { type: "gaussian" std: 0.2 } } }
"""


@pytest.fixture(autouse=True, scope="module")
def cpu_mode():
    api.set_mode_cpu()
    yield
    api.set_mode_gpu()


@pytest.fixture(scope="module")
def engines():
    return me.MatlabEngine(MATLAB), jme.MatlabEngine(MATLAB)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The test net's prototxt and a seeded caffemodel both engines load."""
    from caffe_rtpose_tpu_torch.core.net import Net

    d = tmp_path_factory.mktemp("mat")
    proto = d / "n.prototxt"
    proto.write_text(NET)
    weights = str(d / "w.caffemodel")
    Net(str(proto), device="cpu", seed=5).save_caffemodel(weights)
    return str(proto), weights


def close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * max(1.0, float(np.abs(ref).max()))


def test_every_m_file_parses():
    files = glob.glob(os.path.join(MATLAB, "**", "*.m"), recursive=True)
    assert len(files) >= 15
    for path in files:
        with open(path) as f:
            me.Parser(me.tokenize(f.read())).parse_file()


def test_version(engines):
    import caffe_rtpose_tpu_torch

    eng, _ = engines
    assert eng.call("caffe.version") == caffe_rtpose_tpu_torch.__version__


def test_set_mode_goes_through_the_alias_table(engines):
    eng, _ = engines
    eng.call("caffe.set_mode_gpu")
    assert api._mode == "gpu"
    eng.call("caffe.set_mode_cpu")
    assert api._mode == "cpu"


def test_alias_table():
    assert me._port_module_name("caffe_rtpose_tpu.api") == "caffe_rtpose_tpu_torch.api"
    assert me._port_module_name("caffe_rtpose_tpu") == "caffe_rtpose_tpu_torch"
    assert me._port_module_name("numpy") == "numpy"
    assert me._import_module("caffe_rtpose_tpu.core.data_layers").__name__ == \
        "caffe_rtpose_tpu_torch.core.data_layers"
    with pytest.raises(me.MatlabError, match="jax"):
        me._import_module("jax.numpy")
    with pytest.raises(me.MatlabError, match="jax"):
        me.PyModuleRef(("jax", "numpy", "zeros")).resolve()
    with pytest.raises(me.MatlabError, match="counterpart"):
        me._jax_config_update("jax_enable_x64", True)
    assert me.PyModuleRef(("caffe_rtpose_tpu", "api", "Net")).resolve() is api.Net


def test_other_py_jax_names_raise(engines, tmp_path):
    eng, _ = engines
    p = tmp_path / "s.m"
    p.write_text("x = py.jax.numpy.zeros(3);\n")
    with pytest.raises(me.MatlabError, match="jax"):
        eng.run_script(str(p))


@pytest.mark.parametrize("side", ["forward", "backward"])
def test_net_forward_backward_match_jax(engines, model, side):
    proto, weights = model
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 6, 5).astype(np.float32)
    diff = rs.randn(2, 7).astype(np.float32)
    res = []
    for eng, mod in zip(engines, (me, jme)):
        net = eng.call("caffe.get_net", proto, weights, "test")
        out = eng.call_method(net, "forward", mod.MatCell([eng.call("caffe.private.py2mat", x)]))
        if side == "forward":
            res.append(mod.to_python(out.items[0]))
        else:
            back = eng.call_method(net, "backward",
                                   mod.MatCell([eng.call("caffe.private.py2mat", diff)]))
            res.append(mod.to_python(back.items[0]))
    close(*res)
    assert res[0].shape == ((7, 2) if side == "forward" else (5, 6, 3, 2))


def test_blob_get_set_reshape_match_jax(engines, model):
    proto, weights = model
    data = np.random.RandomState(2).rand(5, 6, 3, 2).astype(np.float32)
    res = []
    for eng, mod in zip(engines, (me, jme)):
        net = eng.call("caffe.get_net", proto, weights, "test")
        blob = eng.call_method(net, "blobs", "x")
        eng.call_method(blob, "set_data", mod.MatArray(data))
        got = mod.to_python(eng.call_method(blob, "get_data"))
        eng.call_method(blob, "set_diff", mod.MatArray(2 * data))
        gdiff = mod.to_python(eng.call_method(blob, "get_diff"))
        eng.call_method(blob, "reshape", mod.MatArray(np.array([[4.0, 6.0, 3.0, 1.0]])))
        shape = mod.to_python(eng.call_method(blob, "shape")).reshape(-1)
        y = eng.call_method(net, "blobs", "y")
        res.append((got, gdiff, shape, mod.to_python(eng.call_method(y, "shape")).reshape(-1),
                    mod.to_python(net.props["blob_names"]), mod.to_python(net.props["inputs"]),
                    mod.to_python(net.props["outputs"])))
    got, ref = res
    np.testing.assert_array_equal(got[0], data)
    np.testing.assert_array_equal(got[1], 2 * data)
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4:] == ref[4:] == (["x", "y", "z"], ["x"], ["z"])


def test_layer_params_match_jax(engines, model):
    proto, weights = model
    res = []
    for eng, mod in zip(engines, (me, jme)):
        net = eng.call("caffe.get_net", proto, weights, "test")
        layer = eng.call_method(net, "layers", "c")
        params = layer.props["params"].items
        res.append((eng.call_method(layer, "type"),
                    [mod.to_python(eng.call_method(p, "shape")).reshape(-1) for p in params],
                    [mod.to_python(eng.call_method(p, "get_data")) for p in params],
                    mod.to_python(eng.call_method(eng.call_method(net, "params", "ip", 1.0),
                                                  "get_data"))))
    got, ref = res
    assert got[0] == ref[0] == "Convolution"
    for a, b in zip(got[1] + got[2] + [got[3]], ref[1] + ref[2] + [ref[3]]):
        np.testing.assert_array_equal(a, b)


def test_solver_step_matches_jax(engines, tmp_path):
    net = tmp_path / "t.prototxt"
    net.write_text(
        'name: "t"\n'
        'layer { name: "d" type: "DummyData" top: "x" top: "t"\n'
        '  dummy_data_param { shape { dim: 4 dim: 3 } shape { dim: 4 dim: 1 }\n'
        '    data_filler { type: "constant" value: 1.0 }\n'
        '    data_filler { type: "constant" value: 0.5 } } }\n'
        'layer { name: "ip" type: "InnerProduct" bottom: "x" top: "p"\n'
        '  inner_product_param { num_output: 1\n'
        '    weight_filler { type: "constant" value: 0.2 } } }\n'
        'layer { name: "l" type: "EuclideanLoss" bottom: "p" bottom: "t" top: "l" }\n')
    sol = tmp_path / "s.prototxt"
    sol.write_text(f'net: "{net}"\nbase_lr: 0.01\nlr_policy: "fixed"\nmomentum: 0.9\n'
                   f'max_iter: 4\nsnapshot_prefix: "{tmp_path / "snap"}"\n')
    res = []
    for eng, mod in zip(engines, (me, jme)):
        solver = eng.call("caffe.get_solver", str(sol))
        assert mod.to_python(eng.call_method(solver, "iter")) == 0.0
        eng.call_method(solver, "step", 2.0)
        w = eng.call_method(eng.call_method(solver.props["net"], "params", "ip", 1.0), "get_data")
        # the solver's net read through a fresh facade of the Python solver
        fresh = solver.props["pysolver"].net.params["ip"][0].data
        res.append((mod.to_python(eng.call_method(solver, "iter")), mod.to_python(w), fresh))
    (it, w, fresh), (jit, _, jfresh) = res
    assert it == jit == 2.0
    close(fresh, jfresh)
    assert not np.allclose(fresh, 0.2)  # the steps moved the weights
    # the port's Blob handle reads the updated weights (matcaffe's handles
    # alias the net's memory)
    np.testing.assert_array_equal(w, fresh.T)


def test_io_load_image_and_mean_match_jax(engines, tmp_path):
    img = np.random.RandomState(5).randint(0, 256, (6, 8, 3)).astype(np.uint8)
    p = tmp_path / "im.png"
    p.write_bytes(encode_png(img))
    mean = np.random.RandomState(6).rand(3, 4, 5).astype(np.float32) * 255
    res = []
    for eng, mod in zip(engines, (me, jme)):
        loaded = mod.to_python(eng.call("caffe.io.load_image", str(p)))
        f = str(tmp_path / f"mean_{mod.__name__}.binaryproto")
        eng.call("caffe.io.write_mean", eng.call("caffe.private.py2mat", mean), f)
        res.append((loaded, mod.to_python(eng.call("caffe.io.read_mean", f))))
    (a, m), (ja, jm) = res
    assert a.shape == (8, 6, 3) and a.dtype == np.float32
    np.testing.assert_allclose(a, ja, atol=1e-3)
    np.testing.assert_allclose(a, np.transpose(img, (1, 0, 2)).astype(np.float32), atol=1e-3)
    np.testing.assert_array_equal(m, jm)


def test_run_tests_end_to_end(engines):
    eng, _ = engines
    res = eng.call("caffe.run_tests")
    assert "test_net: 5/5 passed" in res
    assert "test_solver: 2/2 passed" in res
    assert "test_io: 1/1 passed" in res
    assert "caffe version" in me.engine_stdout()
    assert api._mode == "cpu"  # run_tests.m calls caffe.set_mode_cpu first


def test_engine_never_imports_jax():
    code = ("import sys\nsys.modules['jax'] = None\n"
            "from caffe_rtpose_tpu_torch.matlab_engine import MatlabEngine\n"
            f"res = MatlabEngine({MATLAB!r}).call('caffe.run_tests')\n"
            "assert 'test_io: 1/1 passed' in res, res\n"
            "assert not any(k == 'caffe_rtpose_tpu' or k.startswith('caffe_rtpose_tpu.')\n"
            "               for k in sys.modules)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def test_imresize_and_imread_without_opencv(tmp_path):
    """The engine's imread/imresize read PNGs and resize as cv2.resize does
    on float images (bilinear within 1e-4), on u8 ones bit for bit."""
    import cv2

    img = np.random.RandomState(7).randint(0, 256, (9, 12, 3)).astype(np.uint8)
    p = tmp_path / "a.png"
    p.write_bytes(encode_png(img))
    rgb = me.to_python(me._b_imread(str(p)))
    np.testing.assert_array_equal(rgb, img[:, :, ::-1])
    f = img.astype(np.float32) / 255
    got = me.to_python(me._b_imresize(me.MatArray(f), me.MatArray(np.array([[5.0, 7.0]]))))
    np.testing.assert_allclose(got, cv2.resize(f, (7, 5)), atol=1e-4)
    got8 = me.to_python(me._b_imresize(me.MatArray(img), me.MatArray(np.array([[5.0, 7.0]]))))
    assert got8.dtype == np.uint8
    np.testing.assert_array_equal(got8, cv2.resize(img, (7, 5)))


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("dtype", ["uint8", "float32", "float64"])
def test_imresize_matches_jax(method, dtype):
    """ROADMAP C8: matcaffe's imresize against the JAX engine's (cv2.resize)
    in the image's dtype: u8 nearest and bilinear equal, u8 bicubic within
    ROADMAP C5 (one level on at most 0.0872 % of values), float within
    1e-5; gray and colour, up and down."""
    rs = np.random.RandomState(len(method) + len(dtype))
    for shape, size in (((9, 12, 3), (5.0, 7.0)), ((20, 17), (33.0, 26.0)),
                        ((31, 40, 3), (62.0, 13.0))):
        a = (rs.randint(0, 256, shape) if dtype == "uint8" else rs.rand(*shape)).astype(dtype)
        sz = np.array([size])
        got = me.to_python(me._b_imresize(me.MatArray(a), me.MatArray(sz), method))
        ref = jme.to_python(jme._b_imresize(jme.MatArray(a), jme.MatArray(sz), method))
        assert got.dtype == ref.dtype == np.dtype(dtype) and got.shape == ref.shape
        diff = np.abs(got.astype(np.float64) - ref)
        if dtype != "uint8":
            assert diff.max() <= 1e-5
        elif method == "bicubic":
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.000872
        else:
            np.testing.assert_array_equal(got, ref)
