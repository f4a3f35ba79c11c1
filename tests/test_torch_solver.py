"""The port's solvers (``caffe_rtpose_tpu_torch/training/solver.py``) against
the JAX package's.

* The update rules alone: every solver type, clipping, ``iter_size``, L1 and
  L2 with ``lr_mult``/``decay_mult`` (0 included), given the same
  parameters, gradients and history: within 1e-6 of each blob's largest
  magnitude (f32 arithmetic in the same order).
* Whole solvers, 4 steps on the 2-stage CPM train net (crop 32, batch 2)
  from the same weights and batches: each loss within 1e-4 relative, the
  parameters' total update and each history slot within 5e-2 in relative L2
  norm.  The end-to-end tolerance is that of f32 at a ReLU kink: on this
  net's first batch one conv5_1_CPM_L1 pre-activation is 3.2e-7 in f64,
  -1.2e-7 in the port's f32 and +6.7e-8 in JAX's, and that one element moves
  its channel's weight gradient by 3 % (the port's f64 run of the same
  code agrees with JAX's f32 gradient to 3e-7 there); the trajectories then
  differ by 0.5-2.5 % in L2 (measured), where a wrong rule differs by far
  more.
* Snapshots: a port solver restored from its own snapshot continues bit for
  bit; the ``.solverstate`` files of the two packages restore into each
  other exactly and continue together within the end-to-end tolerance; the
  HDF5 ones with h5py blocked on the port's side (its own codec), and a
  solverstate in the form Caffe's C++ writes restores as JAX's does.

oneDNN is off in this module (XLA parity of CPU convolutions)."""

import contextlib
import itertools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu.models.cpm import make_pose_train_net as jmake_train
from caffe_rtpose_tpu.proto import caffe_pb as jpb
from caffe_rtpose_tpu.proto import prototxt as jprototxt
from caffe_rtpose_tpu.training.solver import Solver as JSolver
from caffe_rtpose_tpu.training.solver import learning_rate as jlearning_rate
from caffe_rtpose_tpu_torch.core.net import (Net, history_from_jax, history_to_jax,
                                             params_from_jax, params_to_jax)
from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
from caffe_rtpose_tpu_torch.proto import caffe_pb, prototxt
from caffe_rtpose_tpu_torch.training.solver import Solver, learning_rate

B, CROP, STAGES, STEPS = 2, 32, 2, 4
RULE_TOL = 1e-6
LOSS_RTOL, L2_TOL = 1e-4, 5e-2


@pytest.fixture(scope="module", autouse=True)
def _no_onednn():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = prev


@pytest.fixture(scope="module")
def setup():
    jnet = JNet(jmake_train(batch=B, crop=CROP, stages=STAGES), phase="TRAIN", seed=0)
    rs = np.random.RandomState(0)
    weights = {}
    for impl in jnet.impls:
        if impl.params:
            o, i, kh, kw = impl.params[0].caffe_shape
            weights[impl.name] = [(rs.randn(o, i, kh, kw) * np.sqrt(2.0 / (i * kh * kw))).astype(
                np.float32), (rs.randn(o) * 0.1).astype(np.float32)]
    batches = [{"data": (rs.rand(B, 3, CROP, CROP) - 0.5).astype(np.float32),
                "label": rs.rand(B, 114, CROP // 8, CROP // 8).astype(np.float32)}
               for _ in range(2 * STEPS)]
    return jnet, weights, batches


def _feed(batches):
    count = itertools.count()
    return lambda it: batches[next(count) % len(batches)]


_JAX_JIT = {}  # the module net's jitted loss gradient and update functions, compiled once


def make_jax(setup, sp):
    jnet, weights, batches = setup
    jnet.params = {k: [jnp.asarray(a) for a in v] for k, v in params_to_jax(weights).items()}
    js = JSolver(sp, jnet, _feed(batches))
    # the gradient is a function of the net alone, the update of the net
    # and the solver text (the solver passes parameters, batch, history and
    # rate): the module's solvers share one compile of each
    js._grad = _JAX_JIT.setdefault(id(jnet), js._grad)
    js._update = _JAX_JIT.setdefault((id(jnet), sp), js._update)
    return js


def make_port(setup, sp):
    _, weights, batches = setup
    net = Net(make_pose_train_net(batch=B, crop=CROP, stages=STAGES), phase="TRAIN", device="cpu")
    net.load_weights(weights)
    return Solver(sp, net, _feed(batches))


def _flat(tree, keys):
    return [np.asarray(b.detach() if isinstance(b, torch.Tensor) else b, np.float64)
            for k in keys for b in tree[k]]


def l2_gap(port_tree, jax_tree, base=None):
    """||port - jax|| / ||jax|| over the tree's blobs (OIHW), each side less
    ``base`` when given (the total update from the initial weights)."""
    ref = params_from_jax(jax_tree)
    keys = list(ref)
    assert set(port_tree) == set(keys)
    got, want = _flat(port_tree, keys), _flat(ref, keys)
    if base is not None:
        b = _flat(base, keys)
        got, want = [g - x for g, x in zip(got, b)], [w - x for w, x in zip(want, b)]
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    return (num / sum(float((w ** 2).sum()) for w in want)) ** 0.5


def assert_solvers_close(ps, js, base):
    assert ps.it == js.it
    assert l2_gap(ps.params, js.net.params, base) <= L2_TOL
    assert set(ps.history) == set(js.history)
    for key in js.history:
        assert l2_gap(ps.history[key], js.history[key]) <= L2_TOL


def assert_restored_exactly(ps, js):
    for tree, jtree in [(ps.params, js.net.params)] + [(ps.history[k], js.history[k])
                                                       for k in js.history]:
        ref = params_from_jax(jtree)
        for k in ref:
            for g, w in zip(tree[k], ref[k]):
                np.testing.assert_array_equal(g.detach().numpy(), w)


@pytest.mark.parametrize("policy,extra", [
    ("fixed", ""), ("step", "gamma: 0.5 stepsize: 3"), ("exp", "gamma: 0.9"),
    ("inv", "gamma: 0.01 power: 0.75"), ("multistep", "gamma: 0.3 stepvalue: 2 stepvalue: 5"),
    ("poly", "power: 2 max_iter: 20"), ("sigmoid", "gamma: -0.5 stepsize: 6")])
def test_learning_rate_policies(policy, extra):
    text = f"base_lr: 0.01 lr_policy: '{policy}' {extra}"
    sp = caffe_pb.view(prototxt.parse(text, "SolverParameter"), "SolverParameter")
    jsp = jpb.view(jprototxt.parse(text, "SolverParameter"), "SolverParameter")
    for it in range(12):
        assert learning_rate(sp, it) == jlearning_rate(jsp, it)


def test_learning_rate_unknown_policy():
    sp = caffe_pb.view(prototxt.parse("base_lr: 0.01 lr_policy: 'cosine'", "SolverParameter"),
                       "SolverParameter")
    with pytest.raises(ValueError, match="unknown lr policy"):
        learning_rate(sp, 0)


RULES = [
    ("SGD", "momentum: 0.9 weight_decay: 5e-4"),
    ("Nesterov", "momentum: 0.9 weight_decay: 5e-4"),
    ("AdaGrad", "delta: 1e-6 weight_decay: 5e-4"),
    ("RMSProp", "rms_decay: 0.98 delta: 1e-6 weight_decay: 5e-4"),
    ("AdaDelta", "momentum: 0.95 delta: 1e-6 weight_decay: 5e-4"),
    ("Adam", "momentum: 0.9 momentum2: 0.999 delta: 1e-8 weight_decay: 5e-4"),
    ("SGD", "momentum: 0.9 clip_gradients: 0.5"),
    ("Adam", "momentum: 0.9 clip_gradients: 0.5 iter_size: 2"),
    ("SGD", "momentum: 0.9 iter_size: 3 weight_decay: 5e-4"),
    ("SGD", "momentum: 0.9 weight_decay: 5e-3 regularization_type: 'L1'"),
    ("RMSProp", "weight_decay: 5e-3 regularization_type: 'L1'"),
]


@pytest.mark.parametrize("typ,extra", RULES, ids=[t for t, _ in RULES[:6]] + [
    "SGD_clip", "Adam_clip_iter_size", "SGD_iter_size", "SGD_L1", "RMSProp_L1"])
def test_update_rule_matches_jax(typ, extra):
    """Three updates from the same parameters, gradients and history; lr_mult
    0, 1 and 2 and decay_mult 0 and 1, as the CPM nets set them."""
    import jax.numpy as jnp

    from caffe_rtpose_tpu.training.solver import init_history as jinit_history
    from caffe_rtpose_tpu.training.solver import make_update_fn as jmake_update_fn
    from caffe_rtpose_tpu_torch.training.solver import init_history, make_update_fn

    text = f"type: '{typ}' base_lr: 0.01 lr_policy: 'fixed' {extra}"
    sp = caffe_pb.view(prototxt.parse(text, "SolverParameter"), "SolverParameter")
    jsp = jpb.view(jprototxt.parse(text, "SolverParameter"), "SolverParameter")
    rs = np.random.RandomState(0)
    shapes = {"a": [(8, 4, 3, 3), (8,)], "b": [(5, 8, 1, 1), (5,)], "frozen": [(3, 5, 1, 1), (3,)]}
    lr_mults = {"a": [1.0, 2.0], "b": [4.0, 8.0], "frozen": [0.0, 0.0]}
    decay_mults = {"a": [1.0, 0.0], "b": [1.0, 0.0], "frozen": [1.0, 0.0]}
    params = {k: [torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in v]
              for k, v in shapes.items()}
    jparams = {k: [jnp.asarray(a) for a in v] for k, v in params_to_jax(params).items()}
    update = make_update_fn(typ, sp, lr_mults, decay_mults)
    jupdate = jmake_update_fn(typ, jsp, lr_mults, decay_mults)
    history, jhistory = init_history(typ, params), jinit_history(typ, jparams)
    for it in range(3):
        grads = {k: [torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in v]
                 for k, v in shapes.items()}
        jgrads = {k: [jnp.asarray(a) for a in v] for k, v in params_to_jax(grads).items()}
        update(params, grads, history, 0.01, it)
        jparams, jhistory = jupdate(jparams, jgrads, jhistory, jnp.float32(0.01), it)
    for tree, jtree in [(params, jparams)] + [(history[k], jhistory[k]) for k in jhistory]:
        ref = params_from_jax(jtree)
        for k in ref:
            for g, w in zip(tree[k], ref[k]):
                assert np.abs(g.numpy() - w).max() <= RULE_TOL * max(np.abs(w).max(), 1e-30), k
    np.testing.assert_array_equal(params["frozen"][0].numpy(),
                                  params_from_jax(jparams)["frozen"][0])


SOLVERS = [
    ("SGD", "base_lr: 3e-5 momentum: 0.9 weight_decay: 5e-4"),
    ("Nesterov", "base_lr: 3e-5 momentum: 0.9 weight_decay: 5e-4"),
    ("AdaGrad", "base_lr: 3e-6 delta: 1e-6 weight_decay: 5e-4"),
    ("RMSProp", "base_lr: 3e-7 rms_decay: 0.98 delta: 1e-6"),
    ("AdaDelta", "base_lr: 3e-4 momentum: 0.95 delta: 1e-6"),
    ("Adam", "base_lr: 3e-6 momentum: 0.9 momentum2: 0.999 delta: 1e-8 iter_size: 2"),
]


@pytest.mark.parametrize("typ,extra", SOLVERS, ids=[t for t, _ in SOLVERS])
def test_trajectory_matches_jax(setup, typ, extra):
    sp = f"type: '{typ}' lr_policy: 'fixed' average_loss: 3 {extra}"
    js, ps = make_jax(setup, sp), make_port(setup, sp)
    for _ in range(STEPS):
        np.testing.assert_allclose(ps.step(1), js.step(1), rtol=LOSS_RTOL)
    np.testing.assert_allclose(ps.smoothed_loss, js.smoothed_loss, rtol=LOSS_RTOL)
    assert_solvers_close(ps, js, setup[1])


def test_snapshot_restore_continue(setup, tmp_path):
    sp = "type: 'Adam' base_lr: 3e-6 lr_policy: 'fixed' momentum: 0.9"
    a = make_port(setup, sp)
    a.step(2)
    model, state = a.snapshot(str(tmp_path / "port"))
    assert model.endswith("port_iter_2.caffemodel") and state.endswith("port_iter_2.solverstate")
    b = make_port(setup, sp)
    b.net.init_params(9)  # other weights: the restore must replace them
    b.restore(state)
    assert b.it == 2
    feed = _feed(setup[2][4:])
    a.next_batch = b.next_batch = feed
    a.step(1)
    b.next_batch = _feed(setup[2][4:])
    b.step(1)
    for k in a.params:
        for x, y in zip(a.params[k], b.params[k]):
            assert torch.equal(x, y)
    for key in a.history:
        for k in a.history[key]:
            for x, y in zip(a.history[key][k], b.history[key][k]):
                assert torch.equal(x, y)


@contextlib.contextmanager
def h5py_blocked():
    """``import h5py`` raises inside the block, as on the card's machine."""
    saved = sys.modules.get("h5py")
    sys.modules["h5py"] = None
    try:
        yield
    finally:
        sys.modules["h5py"] = saved


@pytest.mark.parametrize("fmt", ["BINARYPROTO", "HDF5"])
def test_solverstates_interchange(setup, tmp_path, fmt):
    """A JAX snapshot restored in the port continues as JAX does, and a
    port snapshot restored in JAX continues as the port does (HDF5: the
    restores alone; the steps after them are the same code)."""
    sp = f"type: 'Adam' base_lr: 3e-6 lr_policy: 'fixed' momentum: 0.9 snapshot_format: {fmt}"
    rest = setup[2][4:]
    # JAX -> port
    js = make_jax(setup, sp)
    js.step(2)
    _, jstate = js.snapshot(str(tmp_path / "jax"))
    ps = make_port(setup, sp)
    with h5py_blocked():
        ps.restore(jstate)
    assert ps.it == 2
    assert_restored_exactly(ps, js)
    if fmt == "BINARYPROTO":
        js.next_batch, ps.next_batch = _feed(rest), _feed(rest)
        for _ in range(2):
            np.testing.assert_allclose(ps.step(1), js.step(1), rtol=LOSS_RTOL)
        assert_solvers_close(ps, js, setup[1])
    # port -> JAX
    ps = make_port(setup, sp)
    ps.step(2)
    with h5py_blocked():
        _, pstate = ps.snapshot(str(tmp_path / "port"))
    js = make_jax(setup, sp)
    js.restore(pstate)
    assert js.it == 2
    assert_restored_exactly(ps, js)
    if fmt == "BINARYPROTO":
        js.next_batch, ps.next_batch = _feed(rest), _feed(rest)
        for _ in range(2):
            np.testing.assert_allclose(ps.step(1), js.step(1), rtol=LOSS_RTOL)
        assert_solvers_close(ps, js, setup[1])


def test_restores_caffe_cpp_hdf5_solverstate(setup, tmp_path):
    """A solverstate as SGDSolver::SnapshotSolverStateToHDF5 writes it (H5LT:
    ``iter`` and ``current_step`` int32 of dims [1], ``learned_net`` a
    fixed-length null-terminated string) restores in the port, h5py blocked,
    exactly as in JAX."""
    import h5py

    sp = "type: 'Nesterov' base_lr: 1e-5 lr_policy: 'step' stepsize: 1 gamma: 0.5 " \
         "momentum: 0.9 snapshot_format: HDF5"
    js = make_jax(setup, sp)
    js.step(3)
    model, state = js.snapshot(str(tmp_path / "jax"))
    caffe_state = str(tmp_path / "caffe.solverstate.h5")
    with h5py.File(state, "r") as src, h5py.File(caffe_state, "w") as f:
        for key in ("iter", "current_step"):
            f.create_dataset(key, data=np.array([int(src[key][()])], np.int32))
        name = model.encode() + b"\x00"
        t = h5py.h5t.C_S1.copy()
        t.set_size(len(name))
        h5py.h5d.create(f.id, b"learned_net", t, h5py.h5s.create(h5py.h5s.SCALAR))
        f["learned_net"].id.write(h5py.h5s.ALL, h5py.h5s.ALL, np.array(name, f"S{len(name)}"))
        src.copy("history", f)
    ps = make_port(setup, sp)
    with h5py_blocked():
        ps.restore(caffe_state)
    jr = make_jax(setup, sp)
    jr.restore(caffe_state)
    assert ps.it == jr.it == 3 and ps.current_step == jr.current_step == js.current_step
    assert_restored_exactly(ps, jr)
    assert_restored_exactly(ps, js)


def test_history_maps_to_and_from_jax(setup):
    sp = "type: 'AdaDelta' base_lr: 1e-3 lr_policy: 'fixed' momentum: 0.95"
    js = make_jax(setup, sp)
    js.step(1)
    mapped = history_from_jax(js.history)
    back = history_to_jax(mapped)
    for key in js.history:
        for k in js.history[key]:
            for a, b in zip(back[key][k], js.history[key][k]):
                np.testing.assert_array_equal(a, np.asarray(b))


def test_out_of_slice_options_raise(setup):
    # test nets are ported: a test_interval without test nets tests nothing
    assert make_port(setup, "base_lr: 1e-4 lr_policy: 'fixed' test_interval: 10 "
                            "test_iter: 2").test_nets == []
    ps = make_port(setup, "base_lr: 1e-4 lr_policy: 'fixed'")
    # a mesh is ported (tests/test_torch_dp.py); anything else is refused
    with pytest.raises(TypeError, match="mesh"):
        Solver("base_lr: 1e-4 lr_policy: 'fixed'", ps.net, ps.next_batch, mesh=object())
    # bf16 training is ported: the solver takes a bf16 net and keeps f32 state
    bf16 = Net(make_pose_train_net(batch=1, crop=16, stages=1), phase="TRAIN", device="cpu",
               dtype=torch.bfloat16)
    solver = Solver("base_lr: 1e-4 lr_policy: 'fixed'", bf16, ps.next_batch)
    assert all(h.dtype == torch.float32 for slot in solver.history.values()
               for hs in slot.values() for h in hs)


def _bn_net():
    """Inner product, BatchNorm (TRAIN: batch statistics), Scale, loss."""
    return {"input": ["x", "t"], "input_shape": [{"dim": [8, 5, 3, 2]}, {"dim": [8, 4, 3, 2]}],
            "layer": [
                {"name": "c", "type": "Convolution", "bottom": ["x"], "top": ["c"],
                 "convolution_param": {"num_output": 4, "kernel_size": [1]}},
                {"name": "bn", "type": "BatchNorm", "bottom": ["c"], "top": ["c"],
                 "batch_norm_param": {"moving_average_fraction": 0.9}},
                {"name": "sc", "type": "Scale", "bottom": ["c"], "top": ["c"],
                 "scale_param": {"bias_term": True}},
                {"name": "loss", "type": "EuclideanLoss", "bottom": ["c", "t"], "top": ["loss"]}]}


def test_batchnorm_statistics_roll_as_jax():
    """3 SGD steps of a TRAIN net with BatchNorm on both sides from the same
    weights and batches: the rolled mean, variance and scale factor (and the
    losses and learnable blobs) within 1e-5 of each blob's largest; the TEST
    net then normalizes by them alike."""
    proto = _bn_net()
    rs = np.random.RandomState(3)
    batches = [{"x": rs.randn(8, 5, 3, 2).astype(np.float32) * 2 + 1,
                "t": rs.randn(8, 4, 3, 2).astype(np.float32)} for _ in range(3)]
    jnet = JNet(proto, phase="TRAIN")
    w = {impl.name: [rs.randn(*pi.caffe_shape).astype(np.float32) * 0.5 for pi in impl.params]
         for impl in jnet.impls if impl.params}
    w["bn"] = [np.zeros(4, np.float32), np.zeros(4, np.float32), np.zeros(1, np.float32)]
    jnet.load_weights(w)
    net = Net(proto, phase="TRAIN", device="cpu")
    net.load_weights(w)
    sp = "base_lr: 0.05 lr_policy: 'fixed' momentum: 0.9 weight_decay: 1e-3"
    js, ps = JSolver(sp, jnet, lambda it: batches[it]), Solver(sp, net, lambda it: batches[it])
    losses = [(ps.step(1), js.step(1)) for _ in range(3)]
    np.testing.assert_allclose([a for a, _ in losses], [b for _, b in losses], rtol=1e-5)
    got, ref = net.export_weights(), jnet.export_weights()
    for name in ref:
        for a, b in zip(got[name], ref[name]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    assert ref["bn"][2][0] == pytest.approx(1 + 0.9 + 0.81)
    test, jtest = Net(proto, device="cpu"), JNet(proto)
    test.load_weights(got)
    jtest.load_weights(ref)
    a = test.forward({k: torch.from_numpy(v) for k, v in batches[0].items()}, outputs=["c"])["c"]
    np.testing.assert_allclose(a.numpy(), jtest.forward(batches[0], outputs=["c"])["c"],
                               rtol=1e-5, atol=1e-5)


def test_test_nets_share_weights_and_average_like_jax(capsys):
    """A solver with a test net (test_interval 2, test_iter 2,
    test_initialization): the test net shares the train net's blobs by layer
    name, and each test pass prints and returns the JAX solver's means
    (within 1e-5)."""
    proto = {"input": ["x", "label"], "input_shape": [{"dim": [4, 3]}, {"dim": [4]}],
             "layer": [{"name": "ip", "type": "InnerProduct", "bottom": ["x"], "top": ["s"],
                        "inner_product_param": {"num_output": 3}},
                       {"name": "loss", "type": "SoftmaxWithLoss", "bottom": ["s", "label"],
                        "top": ["loss"]},
                       {"name": "acc", "type": "Accuracy", "bottom": ["s", "label"],
                        "top": ["acc"], "include": [{"phase": 1}]}]}
    rs = np.random.RandomState(4)
    feeds = [{"x": rs.randn(4, 3).astype(np.float32),
              "label": rs.randint(0, 3, 4).astype(np.float32)} for _ in range(4)]
    w = {"ip": [rs.randn(3, 3).astype(np.float32), rs.randn(3).astype(np.float32)]}
    sp = ("base_lr: 0.1 lr_policy: 'fixed' test_interval: 2 test_iter: 2 "
          "test_initialization: true")
    jnet, jtest = JNet(proto, phase="TRAIN"), JNet(proto, phase="TEST")
    jnet.load_weights(w)
    net, test = Net(proto, phase="TRAIN", device="cpu"), Net(proto, device="cpu")
    net.load_weights(w)
    feed = lambda it: feeds[it % 4]  # noqa: E731
    js = JSolver(sp, jnet, feed, test_nets=[(jtest, feed, 2)])
    ps = Solver(sp, net, feed, test_nets=[(test, feed, 2)])
    ps.step(3)
    port_out = capsys.readouterr().out
    js.step(3)
    jax_out = capsys.readouterr().out
    assert port_out.count("Testing net (#0)") == jax_out.count("Testing net (#0)") == 2
    assert test.mods["ip"].weight is net.mods["ip"].weight
    a, b = ps.test(0), js.test(0)
    assert set(a) == set(b) == {"acc", "loss"}
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-5)
