"""The shape, routing and source layer types of the port's registry against
JAX (``torch_zoo.run_case``: forward within 1e-5·max(1,|y|), integer tops
exactly, gradients within 1e-4 of each blob's largest), one small net a
case on the CPU: Concat, Slice, Split, Silence, Flatten, Reshape, Tile,
Eltwise, ArgMax, Reduction, Filter, BatchReindex, Parameter, DummyData,
Switch, Python, HDF5Output and Input."""

import numpy as np
import pytest
import torch

from torch_zoo import Case, rnd, run_case

X = rnd(3, 4, 5, 2, seed=1)
Y = rnd(3, 4, 5, 2, seed=2)


def one(t, param=None, key=None, bottoms=("x",), tops=("y",), inputs=None, **kw):
    layer = {"name": "l", "type": t, "bottom": list(bottoms), "top": list(tops)}
    if param is not None:
        layer[key] = param
    return Case(f"{t}-{param}", [layer], inputs or {"x": X}, **kw)


CASES = [
    one("Concat", {"axis": 1}, "concat_param", ("x", "x2"), inputs={"x": X, "x2": Y}),
    one("Concat", {"axis": 3}, "concat_param", ("x", "x2"), inputs={"x": X, "x2": Y}),
    one("Slice", {"axis": 1, "slice_point": [1, 3]}, "slice_param", tops=("a", "b", "c")),
    one("Slice", {"axis": 2}, "slice_param", tops=("a", "b")[:1] + ("b",)),
    one("Split", tops=("a", "b")),
    one("Flatten"),
    one("Flatten", {"axis": 2, "end_axis": -1}, "flatten_param"),
    one("Reshape", {"shape": {"dim": [0, -1, 5]}}, "reshape_param"),
    one("Reshape", {"shape": {"dim": [2, 2]}, "axis": 1, "num_axes": 1}, "reshape_param"),
    one("Tile", {"axis": 2, "tiles": 3}, "tile_param"),
    one("Eltwise", {"operation": 0}, "eltwise_param", ("x", "x2"), inputs={"x": X, "x2": Y}),
    one("Eltwise", {"operation": 1, "coeff": [0.5, -2.0]}, "eltwise_param", ("x", "x2"),
        inputs={"x": X, "x2": Y}),
    one("Eltwise", {"operation": 2}, "eltwise_param", ("x", "x2"), inputs={"x": X, "x2": Y}),
    one("ArgMax", {"top_k": 2}, "argmax_param", int_tops=("y",), grads=False),
    one("ArgMax", {"top_k": 2, "out_max_val": True}, "argmax_param", grads=False),
    one("ArgMax", {"axis": 1, "top_k": 1}, "argmax_param", int_tops=("y",), grads=False),
    one("Reduction", {"operation": 1, "axis": 1}, "reduction_param"),
    one("Reduction", {"operation": 2, "coeff": 0.5}, "reduction_param"),
    one("Reduction", {"operation": 3, "axis": 2}, "reduction_param"),
    one("Reduction", {"operation": 4, "axis": -1}, "reduction_param"),
    one("Filter", bottoms=("x", "x2", "sel"), tops=("y", "y2"),
        inputs={"x": X, "x2": rnd(3, 2, seed=3), "sel": np.array([1, 0, 1], np.float32)},
        no_grad=("sel",)),
    one("BatchReindex", bottoms=("x", "idx"),
        inputs={"x": X, "idx": np.array([2, 0, 2, 1], np.float32)}, no_grad=("idx",)),
    Case("Parameter", [{"name": "p", "type": "Parameter", "top": ["y"],
                        "parameter_param": {"shape": {"dim": [2, 3, 4, 1]}}}], {}),
    Case("DummyData", [{"name": "d", "type": "DummyData", "top": ["a", "b"],
                        "dummy_data_param": {"shape": [{"dim": [2, 3]}, {"dim": [4]}],
                                             "data_filler": [{"type": "constant",
                                                              "value": 1.5}]}}], {},
         grads=False),
    one("Switch", bottoms=("x", "x2"), inputs={"x": X, "x2": Y}),
    one("Python", {"module": "torch_zoo", "layer": "ScaleShiftLayer", "param_str": "3"},
        "python_param"),
    Case("Silence", [{"name": "r", "type": "ReLU", "bottom": ["x"], "top": ["y"]},
                     {"name": "s", "type": "Silence", "bottom": ["y"], "top": []}], {"x": X}),
    Case("Input", [{"name": "in", "type": "Input", "top": ["z"],
                    "input_param": {"shape": [{"dim": [2, 3]}]}},
                   {"name": "s", "type": "Sigmoid", "bottom": ["z"], "top": ["y"]}],
         {"z": rnd(2, 3, seed=4)}, tops=["y"]),
]


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_shape_layer_matches_jax(case):
    run_case(case)


def test_input_layer_declares_its_tops():
    """An Input layer's tops are the port's inputs with their shapes, as in
    JAX, and it never runs."""
    from caffe_rtpose_tpu.core.net import Net as JNet

    from caffe_rtpose_tpu_torch.core.net import Net

    proto = {"layer": CASES[-1].layers}
    net, jnet = Net(proto, device="cpu"), JNet(proto)
    assert net.input_names == jnet.input_names == ["z"]
    assert net.blob_shapes["z"] == (2, 3) and [l.type for l in net.layers] == ["Sigmoid"]


def test_switch_knob_and_filter_count():
    """Switch picks a bottom by the ``switch_index`` knob; Filter keeps its
    selected items first, then zeros."""
    from caffe_rtpose_tpu_torch.core.net import Net

    proto = {"input": ["x", "x2"], "input_shape": [{"dim": [3, 4, 5, 2]}] * 2,
             "layer": [{"name": "s", "type": "Switch", "bottom": ["x", "x2"], "top": ["y"]}]}
    net = Net(proto, device="cpu")
    feed = {"x": torch.from_numpy(X), "x2": torch.from_numpy(Y)}
    assert torch.equal(net.forward(feed, knobs={"switch_index": 0})["y"], feed["x"])
    assert torch.equal(net.forward(feed)["y"], feed["x2"])


def test_hdf5_output_appends_like_jax(tmp_path):
    """HDF5Output appends its bottoms to the file each forward, as JAX's net
    writes them."""
    from caffe_rtpose_tpu.core.net import Net as JNet

    from caffe_rtpose_tpu_torch.core.net import Net

    def proto(path):
        return {"input": ["x"], "input_shape": [{"dim": [3, 4, 5, 2]}],
                "layer": [{"name": "h", "type": "HDF5Output", "bottom": ["x"],
                           "hdf5_output_param": {"file_name": str(path)}}]}

    for _ in range(2):
        Net(proto(tmp_path / "port.h5"), device="cpu").forward({"x": torch.from_numpy(X)})
    h5py = pytest.importorskip("h5py")  # JAX's side and the comparison
    for _ in range(2):
        JNet(proto(tmp_path / "jax.h5")).forward({"x": X})
    with h5py.File(tmp_path / "port.h5") as a, h5py.File(tmp_path / "jax.h5") as b:
        assert a["x"].shape == (6, 4, 5, 2)
        np.testing.assert_array_equal(a["x"][()], b["x"][()])
