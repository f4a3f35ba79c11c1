"""``python -m caffe_rtpose_tpu_torch caffe`` (``tools/caffe_tool.py``) on the
CPU: ``train`` on the 2-stage CPM train net (crop 64, batch 2) from the
synthetic pose source, with labels on the device (``--fused_labels``) and
from the host, from an ``.npz`` of input blobs, snapshot and ``--snapshot``
resume; ``time --phase TRAIN``; ``device_query``; ``train`` with a test
net on a self-feeding train_val and ``test`` against the JAX tool; and the
options that are not ported say so."""

import contextlib
import io
import os
import re

import numpy as np
import pytest

from caffe_rtpose_tpu_torch import __main__ as entry
from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
from caffe_rtpose_tpu_torch.proto import prototxt


def run(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = entry.main(["caffe", *argv])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    work = tmp_path_factory.mktemp("caffe_cli")
    net = work / "pose_train.prototxt"
    prototxt.dump_file(make_pose_train_net(batch=2, crop=64, stages=2), str(net))

    def solver(name, extra=""):
        path = work / name
        path.write_text(f'net: "{net}"\nbase_lr: 2e-5\nlr_policy: "fixed"\nmomentum: 0.9\n'
                        f'weight_decay: 5e-4\ndisplay: 1\n{extra}')
        return str(path)

    return work, str(net), solver


def iteration_lines(text):
    return re.findall(r"^Iteration (\d+) \([\d.e+-]+ iter/s, .*\), loss = ([\d.e+-]+)", text, re.M)


def test_train_fused_labels_snapshot_and_resume(files):
    work, _, solver = files
    prefix = str(work / "snap")
    s = solver("fused.prototxt", f'max_iter: 2\nsnapshot_prefix: "{prefix}"\n')
    rc, text = run("train", "--solver", s, "--data", "synthetic-pose", "--fused_labels",
                   "--device", "cpu")
    assert rc == 0 and "Optimization Done" in text
    its = iteration_lines(text)
    assert [int(i) for i, _ in its] == [1, 2] and all(np.isfinite(float(l)) for _, l in its)
    assert "Train net output #0: loss_stage1_L1 = " in text and "lr = 2e-05" in text
    assert os.path.exists(prefix + "_iter_2.caffemodel")
    assert os.path.exists(prefix + "_iter_2.solverstate")
    s3 = solver("resume.prototxt", "max_iter: 3\nsnapshot_after_train: false\n")
    rc, text = run("train", "--solver", s3, "--data", "synthetic-pose", "--fused_labels",
                   "--snapshot", prefix + "_iter_2.solverstate", "--device", "cpu")
    assert rc == 0 and "at iter 2" in text
    assert [int(i) for i, _ in iteration_lines(text)] == [3]


@pytest.mark.parametrize("source", ["synthetic-pose", "npz"])
def test_train_host_data(files, source):
    work, _, solver = files
    data = source
    if source == "npz":
        rs = np.random.RandomState(0)
        data = str(work / "batch.npz")
        np.savez(data, data=rs.rand(2, 3, 64, 64).astype(np.float32) - 0.5,
                 label=rs.rand(2, 114, 8, 8).astype(np.float32))
    s = solver(f"host_{source}.prototxt", "max_iter: 2\nsnapshot_after_train: false\n")
    rc, text = run("train", "--solver", s, "--data", data, "--device", "cpu")
    assert rc == 0 and len(iteration_lines(text)) == 2 and "Optimization Done" in text


def test_time_train_phase(files):
    _, net, _ = files
    rc, text = run("time", "--model", net, "--phase", "TRAIN", "--iterations", "1",
                   "--device", "cpu")
    assert rc == 0
    rows = re.findall(r"^\s*(\S+)\s+forward:\s+([\d.]+) ms\s+backward:\s+([\d.]+|n/a) ms",
                      text, re.M)
    n_layers = len(prototxt.parse_file(net)["layer"])
    assert len(rows) == n_layers
    by_name = {n: (f, b) for n, f, b in rows}
    assert by_name["conv1_1"][1] != "n/a" and by_name["loss_stage2_L2"][1] != "n/a"
    assert "TOTAL (per-layer sum)" in text and "whole-net forward" in text


def test_time_trace_dir_writes_a_trace_by_layer(tmp_path):
    """``caffe time --trace_dir``: a torch.profiler Chrome trace of the timed
    passes whose events name each layer's forward and backward."""
    import json

    net = tmp_path / "tiny.prototxt"
    net.write_text('input: "data" input_dim: 2 input_dim: 3 input_dim: 12 input_dim: 12\n'
                   'layer { name: "conv" type: "Convolution" bottom: "data" top: "conv" '
                   'convolution_param { num_output: 4 kernel_size: 3 } }\n'
                   'layer { name: "pool" type: "Pooling" bottom: "conv" top: "pool" '
                   'pooling_param { pool: MAX kernel_size: 2 stride: 2 } }\n'
                   'layer { name: "fc" type: "InnerProduct" bottom: "pool" top: "fc" '
                   'inner_product_param { num_output: 3 } }\n')
    trace = tmp_path / "trace"
    rc, text = run("time", "--model", str(net), "--phase", "TRAIN", "--iterations", "1",
                   "--trace_dir", str(trace), "--device", "cpu")
    path = trace / "caffe_time.trace.json"
    assert rc == 0 and f"Profiler trace written to {path}" in text and "whole-net forward" in text
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    for layer in ("conv", "pool", "fc"):
        assert f"{layer} forward" in names
    assert "conv backward" in names and "fc backward" in names


def test_device_query_and_not_ported(files):
    rc, text = run("device_query")
    assert rc == 0 and "torch:" in text and "cuda_available:" in text
    with pytest.raises(SystemExit):  # caffe test is ported: it needs --model
        run("test")
    _, _, solver = files
    # --gpu is ported (tests/test_torch_dp.py trains over two ranks); one id
    # trains on one device, and --spatial then warns that it needs a mesh
    rc, text = run("train", "--solver", solver("gpu.prototxt", "max_iter: 1"), "--gpu", "0",
                   "--spatial", "2", "--device", "cpu")
    assert rc == 0 and "--spatial 2 ignored" in text and "Optimization Done" in text


def test_default_device_is_cuda(files):
    """Without --device the tool runs on the card, and says so without one."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    _, net, _ = files
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run("time", "--model", net, "--phase", "TRAIN", "--iterations", "1")


def narrow_train_val(work, crop=27, size=32, n=8):
    """CaffeNet's train_val (Data layers with TRAIN and TEST rules, a mean
    file, crop and mirror) at small widths over a kvdb of ``n`` seeded
    3 x size x size Datums."""
    from caffe_rtpose_tpu_torch.core.data_layers import write_mean_binaryproto
    from caffe_rtpose_tpu_torch.models.caffenet import make_caffenet_train_val
    from caffe_rtpose_tpu_torch.proto import datum
    from caffe_rtpose_tpu_torch.utils import db as dbmod

    rs = np.random.RandomState(0)
    d = dbmod.open_db(str(work / "db"), "w", backend="kvdb")
    txn = d.new_transaction()
    imgs = rs.randint(0, 256, (n, 3, size, size)).astype(np.uint8)
    for i in range(n):
        txn.put(f"{i:08d}", datum.serialize_datum(datum.array_to_datum(imgs[i], int(i % 5))))
    txn.commit()
    d.close()
    write_mean_binaryproto(str(work / "mean.binaryproto"), imgs.mean(0).astype(np.float32))
    net = make_caffenet_train_val(str(work / "db"), str(work / "db"),
                                  str(work / "mean.binaryproto"), batch=4, test_batch=4,
                                  crop=crop, num_classes=5)
    widths = {"conv1": 8, "conv2": 8, "conv3": 8, "conv4": 8, "conv5": 8, "fc6": 16, "fc7": 16}
    for l in net["layer"]:
        p = l.get("convolution_param") or l.get("inner_product_param")
        if l["name"] in widths:
            p["num_output"] = widths[l["name"]]
        if l["name"] == "conv1":
            p["kernel_size"], p["stride"] = [3], [1]
    path = work / "train_val.prototxt"
    prototxt.dump_file(net, str(path))
    return str(path)


def test_train_with_a_test_net_then_caffe_test_matches_jax(tmp_path):
    """``caffe train`` on a self-feeding train_val with a test net (the
    train_val file at TEST: test_interval 2, test_iter 2), its snapshot, and
    ``caffe test --model train_val --weights snapshot --iterations 2``: the
    loss and accuracy the JAX ``caffe test`` prints for the same weights
    (within 1e-5 relative)."""
    from caffe_rtpose_tpu.tools import caffe_tool as jtool

    tv = narrow_train_val(tmp_path)
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{tv}"\nbase_lr: 0.01\nmomentum: 0.9\nweight_decay: 5e-4\n'
                      f'lr_policy: "fixed"\nmax_iter: 3\ndisplay: 1\ntest_interval: 2\n'
                      f'test_iter: 2\nsnapshot_prefix: "{tmp_path}/snap"\n')
    rc, text = run("train", "--solver", str(solver), "--device", "cpu")
    assert rc == 0 and "Optimization Done" in text
    assert text.count("Testing net (#0)") == 2  # test_initialization, then iteration 2
    outs = dict(re.findall(r"Test net output #\d+: (\w+) = ([\d.e+-]+)", text))
    assert set(outs) == {"accuracy", "loss"} and np.isfinite(float(outs["loss"]))
    snap = f"{tmp_path}/snap_iter_3.caffemodel"
    assert os.path.exists(snap)
    rc, text = run("test", "--model", tv, "--weights", snap, "--iterations", "2",
                   "--device", "cpu")
    assert rc == 0
    got = dict(re.findall(r"^(\w+) = ([\d.e+-]+)$", text, re.M))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jtool.main(["test", "--model", tv, "--weights", snap, "--iterations", "2"]) == 0
    ref = dict(re.findall(r"^(\w+) = ([\d.e+-]+)$", out.getvalue(), re.M))
    assert set(got) == set(ref) == {"accuracy", "loss"}
    for k in got:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-5, abs=1e-6)
