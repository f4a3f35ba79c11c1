"""The port's data-parallel training (caffe_rtpose_tpu_torch/parallel/dp.py)
on gloo ranks on the CPU, against JAX's ``make_dp_train_step`` on the
suite's virtual CPU devices and against the port's own one-rank step.

The 2-stage CPM train net at crop 48, global batch 4, fan-in weights (as
tests/test_torch_solver.py draws them), SGD 4e-5 with momentum 0.9 and
weight decay 5e-4 (JAX's dry-run solver).  Two ranks are spawned once for
the module (``dp.spawn``, 240 s limit: a hung rank fails the fixture, not
the run) and run every case: the DP step, ``Solver(mesh=)`` for two
iterations.  Tolerances:

* 2 ranks against 1 rank of the port: JAX's multihost rule (loss rtol
  1e-5; each layer's parameter sums rtol 1e-4, atol 1e-5), and the
  parameters within 1e-6 of each blob's largest magnitude (the same f32
  arithmetic, the gradient summed over two halves);
* the port against JAX: the loss within 1e-4 relative and the step's update
  within 5e-2 relative L2 (test_torch_solver.py's end-to-end tolerance: an
  f32 ReLU kink moves a bias gradient by percents, so the multihost rule on
  parameter sums holds only within one framework's arithmetic).

``caffe train --gpu 0,1 --device cpu`` spawns its own two ranks; its
snapshot after one iteration is held to the one-rank CLI's.  oneDNN is off
in the ranks and here (XLA parity of CPU convolutions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu.models.cpm import make_pose_train_net as jmake_train
from caffe_rtpose_tpu.ops import layout
from caffe_rtpose_tpu.parallel import dp as jdp
from caffe_rtpose_tpu.proto import caffe_pb as jpb
from caffe_rtpose_tpu.proto import prototxt as jprototxt
from caffe_rtpose_tpu.training.solver import init_history as jinit_history
from caffe_rtpose_tpu.training.solver import make_update_fn as jmake_update
from caffe_rtpose_tpu_torch.core.net import Net, params_from_jax, params_to_jax
from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net
from caffe_rtpose_tpu_torch.parallel import dp, dryrun
from caffe_rtpose_tpu_torch.parallel import multihost
from caffe_rtpose_tpu_torch.parallel.multihost import SOLVER, cpm_global_batch
from caffe_rtpose_tpu_torch.training.solver import Solver

B, CROP, STAGES, LR = 4, 48, 2, 4e-5
LOSS_RTOL, L2_TOL, SAME_TOL = 1e-4, 5e-2, 1e-6
SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def _no_onednn():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = prev


def fan_in_weights(net_param, seed=0):
    """{layer: [OIHW, bias]} at fan-in scale, drawn in the port net's layer
    order."""
    net = Net(net_param, phase="TRAIN", device="cpu")
    rs = np.random.RandomState(seed)
    return {k: [(rs.randn(*c.weight.shape) * np.sqrt(2.0 / np.prod(c.weight.shape[1:])))
                .astype(np.float32), (rs.randn(c.cout) * 0.1).astype(np.float32)]
            for k, c in net.convs.items()}


@pytest.fixture(scope="module")
def setup():
    net_param = make_pose_train_net(batch=B, crop=CROP, stages=STAGES)
    weights = fan_in_weights(net_param)
    batches = [cpm_global_batch(B, CROP, seed=s) for s in (0, 1)]
    return net_param, weights, batches


@pytest.fixture(scope="module")
def ranks(setup):
    net_param, weights, batches = setup
    cases = [("dryrun_cpm_train", dict(n_devices=2, crop=CROP, batch=B, stages=STAGES,
                                       weights=weights, batch_arrays=batches[0])),
             ("case_solver", dict(n_devices=2, proto=net_param, weights=weights,
                                  batches=batches, solver=SOLVER))]
    return dp.spawn(dryrun.rank_cases, 2, ["cpu"] * 2, args=(cases, False),
                    timeout=SPAWN_TIMEOUT)


def _rel_l2(got, want):
    num = sum(float(((np.float64(g) - w) ** 2).sum()) for g, w in zip(got, want))
    return (num / max(sum(float((np.float64(w) ** 2).sum()) for w in want), 1e-300)) ** 0.5


def _flat(tree):
    return [np.asarray(a, np.float64) for k in sorted(tree) for a in tree[k]]


def _assert_same(got, want):
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a, b, rtol=0, atol=SAME_TOL * max(1.0, np.abs(b).max()),
                                       err_msg=k)


def test_dp_step_matches_one_rank(ranks):
    """Two ranks' step == the one-rank step on the same global batch (the
    dry run asserts JAX's multihost rule inside; held here again), and every
    rank ends with the same parameters."""
    r0 = ranks[0]["dryrun_cpm_train"]
    multihost.check_digests(r0["digest"], r0["ref_digest"])
    assert ranks[1]["dryrun_cpm_train"]["digest"] == r0["digest"]
    assert r0["loss"] == pytest.approx(r0["ref_loss"], rel=1e-5)


def test_dp_step_matches_jax_make_dp_train_step(setup, ranks):
    net_param, weights, batches = setup
    jnet = JNet(jmake_train(batch=B, crop=CROP, stages=STAGES), phase="TRAIN", seed=0)
    jparams = {k: [jnp.asarray(a) for a in v] for k, v in params_to_jax(weights).items()}
    sp = jpb.view(jprototxt.parse(SOLVER, "SolverParameter"), "SolverParameter")
    lr_mults = {i.name: [pi.lr_mult for pi in i.params] for i in jnet.impls if i.params}
    decay_mults = {i.name: [pi.decay_mult for pi in i.params] for i in jnet.impls if i.params}
    mesh = jdp.make_mesh(2)
    step = jdp.make_dp_train_step(mesh, jnet.make_loss_fn(),
                                  jmake_update("SGD", sp, lr_mults, decay_mults))
    inputs = jdp.shard_batch(mesh, {k: layout.to_physical(v) for k, v in batches[0].items()})
    with mesh:
        loss, new, _ = step(jdp.replicate(mesh, jparams),
                            jdp.replicate(mesh, jinit_history("SGD", jparams)), inputs,
                            jax.random.PRNGKey(0), jnp.float32(LR), 0)
    r0 = ranks[0]["dryrun_cpm_train"]
    assert r0["loss"] == pytest.approx(float(loss), rel=LOSS_RTOL)
    ref = params_from_jax(jax.device_get(new))
    base = _flat(weights)
    upd = [g - b for g, b in zip(_flat(r0["params"]), base)]
    want = [w - b for w, b in zip(_flat(ref), base)]
    assert _rel_l2(upd, want) <= L2_TOL


def test_solver_mesh_matches_one_rank_solver(setup, ranks):
    """``Solver(mesh=)`` over two ranks, two iterations, == the one-rank
    Solver on the same global batches."""
    net_param, weights, batches = setup
    net = Net(net_param, phase="TRAIN", device="cpu")
    net.load_weights(weights)
    s = Solver(SOLVER, net, lambda it: batches[it])
    losses = [s.step(1) for _ in batches]
    got = ranks[0]["case_solver"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _assert_same(got["params"], {k: [p.detach().numpy() for p in v] for k, v in s.params.items()})
    assert ranks[1]["case_solver"]["losses"] == got["losses"]


def test_caffe_train_gpu_trains_over_cpu_ranks(setup, tmp_path):
    """``caffe train --gpu 0,1 --device cpu``: two ranks the tool spawns
    itself, JAX's line, one iteration; rank 0's snapshot == the one-rank
    CLI's (same synthetic global batch, same seed)."""
    import contextlib
    import io

    from caffe_rtpose_tpu_torch import __main__ as entry
    from caffe_rtpose_tpu_torch.proto import prototxt

    net = tmp_path / "train.prototxt"
    prototxt.dump_file(make_pose_train_net(batch=B, crop=CROP, stages=STAGES), str(net))

    def train(prefix, *extra):
        solver = tmp_path / f"{prefix}.prototxt"
        solver.write_text(f'net: "{net}"\n{SOLVER}\nmax_iter: 1\ndisplay: 1\n'
                          f'snapshot_prefix: "{tmp_path / prefix}"\n')
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = entry.main(["caffe", "train", "--solver", str(solver), "--device", "cpu",
                             *extra])
        return rc, out.getvalue(), str(tmp_path / f"{prefix}_iter_1.caffemodel")

    rc, text, two = train("two", "--gpu", "0,1")
    assert rc == 0
    assert "Data-parallel training over 2 devices" in text and "backend gloo" in text
    rc1, _, one = train("one")
    assert rc1 == 0
    a, b = Net(str(net), device="cpu"), Net(str(net), device="cpu")
    a.load_weights(two)
    b.load_weights(one)
    _assert_same({k: [t.detach().numpy() for t in v] for k, v in a.layer_blobs().items()},
                 {k: [t.detach().numpy() for t in v] for k, v in b.layer_blobs().items()})


def test_placement_rules():
    """``row_split``, ``pick_backend`` and ``shard_batch``'s refusal of a
    batch that does not divide (JAX's placement refuses it too)."""
    assert dp.row_split(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert dp.row_split(46, 4) == [(0, 12), (12, 24), (24, 35), (35, 46)]
    assert dp.pick_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert dp.pick_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert dp.pick_backend(["cpu", "cpu"]) == "gloo"
    mesh = type("M", (), {"n": lambda self, a: 2, "index": lambda self, a: 1,
                          "device": torch.device("cpu")})()
    got = dp.shard_batch(mesh, {"x": np.arange(8).reshape(4, 2), "s": np.float32(3)})
    assert got["x"].tolist() == [[4, 5], [6, 7]] and float(got["s"]) == 3.0
    with pytest.raises(ValueError, match="does not split"):
        dp.shard_batch(mesh, {"x": np.zeros((3, 2))})
    with pytest.raises(TypeError, match="mesh"):
        Solver(SOLVER, Net(make_pose_train_net(batch=1, crop=16, stages=1), phase="TRAIN",
                           device="cpu"), lambda it: {}, mesh=object())
