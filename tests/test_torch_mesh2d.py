"""The port's two composed axes (caffe_rtpose_tpu_torch/parallel/mesh2d.py)
on four gloo ranks on the CPU (a 2x2 mesh), against JAX.

* ``make_dp_sp_train_step`` as tests/test_eval_and_parallel.py's case
  (2 stages, crop 48, global batch 4), with fan-in weights: against the
  port's one-rank step in the ranks (JAX ``mesh2d.dryrun_dp_sp_train``'s
  rule: loss within 1e-3, every 7th parameter blob of the first 56 within
  rtol 2e-3, atol 2e-5) and here against JAX's single-device step, the
  reference JAX's own dry run holds its sharded step to (same rule, blobs
  in JAX's leaf order; and the update within 5e-2 relative L2, the f32
  ReLU-kink tolerance of test_torch_solver.py).  Batch 3 does not divide
  the data axis: it is replicated there and the gradients averaged.
* ``Solver(mesh=)`` on the 2x2 mesh for two iterations == the one-rank
  Solver (losses rtol 1e-5; parameters within 1e-5 of each blob's largest),
  and the same with the fused label transform (``--fused_labels``: u8
  images and joints in, the labels rasterized on each rank's whole examples
  before the rows split) against the one-rank fused Solver.
* ``dp_tp_estimator_fn``: 2 frames over ``data``, weights over ``model``,
  on the 2-stage COCO net at 128x80 with test_torch_estimator.py's weights
  and thresholds: against the port's one-device batched estimator by JAX's
  dry-run rule (in the ranks) and JAX's batched estimator by
  ``_assert_outputs_close``; and the heatmap estimator so (K3's path: each
  rank its frame, every rank all frames' outputs) against the port's
  one-device heatmap estimator (in the ranks; heatmaps rtol/atol 2e-4).
* ``batch_spec_2d`` against JAX's ``shard_batch_2d`` placements, case for
  case (NHWC's H is the port's NCHW axis 2).

Four ranks spawned once (``dp.spawn``, 300 s limit).  oneDNN off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.models.cpm import make_pose_train_net as jmake_train
from caffe_rtpose_tpu.ops import layout
from caffe_rtpose_tpu.parallel.mesh2d import make_mesh2d as j_make_mesh2d
from caffe_rtpose_tpu.parallel.mesh2d import shard_batch_2d as j_shard_batch_2d
from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
from caffe_rtpose_tpu.proto import caffe_pb as jpb
from caffe_rtpose_tpu.proto import prototxt as jprototxt
from caffe_rtpose_tpu.training.solver import init_history as jinit_history
from caffe_rtpose_tpu.training.solver import make_update_fn as jmake_update
from caffe_rtpose_tpu_torch.core.net import Net, params_from_jax, params_to_jax
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net, make_pose_train_net
from caffe_rtpose_tpu_torch.parallel import dp, dryrun, mesh2d
from caffe_rtpose_tpu_torch.parallel.multihost import SOLVER, cpm_global_batch
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator
from caffe_rtpose_tpu_torch.training.solver import Solver

from test_torch_dp import _flat, _rel_l2, fan_in_weights
from test_torch_estimator import (THR, WITNESS_SEEDS, _assert_outputs_close, _fan_in_weights,
                                  witness_frame)
from test_torch_sp import heat_frames

B, CROP, STAGES, LR = 4, 48, 2, 4e-5
RES = (128, 80)
TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def _no_onednn():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = prev


@pytest.fixture(scope="module")
def setup():
    net_param = make_pose_train_net(batch=B, crop=CROP, stages=STAGES)
    weights = fan_in_weights(net_param)
    glob = cpm_global_batch(B, CROP, seed=7)
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=RES, input_u8=True, batch=2)
    est_w = _fan_in_weights(jest, 0)
    frames = [np.stack([witness_frame(s) for s in WITNESS_SEEDS[:2]])]
    ref = jest.fetch_batch(jest.run_device(frames[0], **THR))
    return net_param, weights, glob, est_w, frames, ref


def _fused():
    """The fused-label pipeline's transform and two global batches (u8
    images, joints, visibility, mask) at crop 48."""
    from caffe_rtpose_tpu_torch.training.datasets import SyntheticPoseSource
    from caffe_rtpose_tpu_torch.training.labels_device import pose_batches_jointfeed
    from caffe_rtpose_tpu_torch.training.transformer import AugParams

    prm = AugParams(crop_size_x=CROP, crop_size_y=CROP)
    it = pose_batches_jointfeed(SyntheticPoseSource(size=CROP + 52), prm, B, data_u8=True)
    return ("make_input_transform", {"prm": prm, "data_u8": True}), [next(it), next(it)]


@pytest.fixture(scope="module")
def ranks(setup):
    net_param, weights, glob, est_w, frames, _ = setup
    odd = cpm_global_batch(3, CROP, seed=8)
    cases = [("dryrun_dp_sp_train", dict(n_devices=4, crop=CROP, batch=B, stages=STAGES,
                                         spatial=2, weights=weights, batch_arrays=glob)),
             ("dryrun_dp_sp_train#odd", dict(n_devices=4, crop=CROP, batch=3, stages=STAGES,
                                         spatial=2, weights=weights, batch_arrays=odd)),
             ("case_solver", dict(n_devices=4, proto=net_param, weights=weights,
                                  batches=[glob, cpm_global_batch(B, CROP, seed=9)],
                                  solver=SOLVER, spatial=2)),
             ("case_estimator", dict(kind="dp_tp", n_devices=4, weights=est_w, frames=frames,
                                     batch=2)),
             ("case_solver#fused", dict(n_devices=4, proto=net_param, weights=weights,
                                        batches=_fused()[1], solver=SOLVER, spatial=2,
                                        transform=_fused()[0])),
             ("case_estimator#heat", dict(kind="dp_tp", n_devices=4, weights=est_w,
                                          frames=[np.stack(heat_frames(
                                              list(frames[0])))],
                                          keep_heatmap=True))]
    return dp.spawn(dryrun.rank_cases, 4, ["cpu"] * 4, timeout=TIMEOUT, args=(
        cases, False, {"nms": THR["nms_threshold"], "inter": THR["inter_threshold"]}))


def test_dp_sp_step_matches_jax_single_device_step(setup, ranks):
    net_param, weights, glob, *_ = setup
    r0 = ranks[0]["dryrun_dp_sp_train"]
    jnet = JNet(jmake_train(batch=B, crop=CROP, stages=STAGES), phase="TRAIN", seed=0)
    params = {k: [jnp.asarray(a) for a in v] for k, v in params_to_jax(weights).items()}
    sp = jpb.view(jprototxt.parse(SOLVER, "SolverParameter"), "SolverParameter")
    lr_mults = {i.name: [pi.lr_mult for pi in i.params] for i in jnet.impls if i.params}
    decay_mults = {i.name: [pi.decay_mult for pi in i.params] for i in jnet.impls if i.params}
    loss, grads = jax.value_and_grad(jnet.make_loss_fn())(
        params, {k: jnp.asarray(layout.to_physical(v)) for k, v in glob.items()},
        jax.random.PRNGKey(0))
    new, _ = jmake_update("SGD", sp, lr_mults, decay_mults)(
        params, grads, jinit_history("SGD", params), jnp.float32(LR), 0)
    assert abs(r0["loss"] - float(loss)) <= 1e-3 * max(1.0, abs(float(loss)))
    ref = params_from_jax(jax.device_get(new))
    got = r0["params"]
    # JAX's leaf order: layers sorted by name, then blobs
    flat_s, flat_r = _flat(got), _flat(ref)
    for a, b in list(zip(flat_s, flat_r))[::7][:8]:
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5)
    base = _flat(weights)
    assert _rel_l2([a - x for a, x in zip(flat_s, base)],
                   [b - x for b, x in zip(flat_r, base)]) <= 5e-2


def test_dp_sp_step_every_rank_agrees(ranks):
    r = [x["dryrun_dp_sp_train"] for x in ranks]
    assert len({x["loss"] for x in r}) == 1
    assert abs(r[0]["loss"] - r[0]["ref_loss"]) <= 1e-3 * max(1.0, abs(r[0]["ref_loss"]))


def test_dp_sp_step_replicates_a_batch_that_does_not_divide(ranks):
    """Batch 3 over a 2-way data axis: replicated there (JAX's fallback),
    rows still split, gradients averaged over ``data``; the dry run holds it
    to the one-rank step."""
    r = ranks[0]["dryrun_dp_sp_train#odd"]
    assert abs(r["loss"] - r["ref_loss"]) <= 1e-3 * max(1.0, abs(r["ref_loss"]))


def test_solver_mesh2d_matches_one_rank_solver(setup, ranks):
    net_param, weights, glob, *_ = setup
    batches = [glob, cpm_global_batch(B, CROP, seed=9)]
    net = Net(net_param, phase="TRAIN", device="cpu")
    net.load_weights(weights)
    s = Solver(SOLVER, net, lambda it: batches[it])
    losses = [s.step(1) for _ in batches]
    got = ranks[0]["case_solver"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    want = {k: [p.detach().numpy() for p in v] for k, v in s.params.items()}
    for k in want:
        for a, b in zip(got["params"][k], want[k]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(1.0, np.abs(b).max()))


def test_dp_tp_estimator_matches_jax_batched_single_device(setup, ranks):
    *_, frames, ref = setup
    est = PoseEstimator(make_pose_deploy_net("COCO", stages=2), net_resolution=RES,
                        input_u8=True, device="cpu")
    for r in ranks:
        got = r["case_estimator"]
        assert got["frames"] == 2
        rows = got["packed"][0]
        assert rows.shape[0] == 2  # every rank returns both frames
        for row, want in zip(rows, ref):
            _assert_outputs_close(est.unpack(row), want, est.descriptor)


def test_batch_spec_2d_matches_jax_shard_batch_2d():
    mesh = j_make_mesh2d(8, spatial=2)
    shape = {"data": 4, "spatial": 2}

    def jax_spec(arr, **kw):
        return j_shard_batch_2d(mesh, {"x": arr}, **kw)["x"].sharding.spec

    def port(spec):  # JAX's NHWC spec in the port's NCHW axes
        return tuple(spec[:1]) + ((None, spec[1]) + tuple(spec[2:-1]) if len(spec) > 1 else ())

    cases = [((4, 16, 16, 3), None), ((4, 8, 8, 10), None), ((4, 23, 16, 3), None),
             ((10, 16, 16, 3), None), ((4, 16, 16, 3), {"x"}), ((4, 16, 16, 3), set())]
    for nhwc, keys in cases:
        kw = {} if keys is None else {"nhwc_keys": keys}
        want = jax_spec(np.zeros(nhwc, np.float32), **kw)
        n, h, w, c = nhwc
        got = mesh2d.batch_spec_2d(shape, (n, c, h, w), keys is None or "x" in keys)
        assert got == (port(tuple(want)) if len(want) > 1 else tuple(want)), (nhwc, keys)
    assert mesh2d.batch_spec_2d(shape, ()) == () == tuple(jax_spec(np.float32(1.0)))
    with pytest.raises(ValueError):
        mesh2d.make_mesh2d(8, spatial=3)


def test_solver_mesh2d_fused_labels_matches_one_rank_fused_solver(setup, ranks):
    from caffe_rtpose_tpu_torch.training import labels_device

    net_param, weights, *_ = setup
    (name, kw), batches = _fused()
    net = Net(net_param, phase="TRAIN", device="cpu")
    net.load_weights(weights)
    s = Solver(SOLVER, net, lambda it: batches[it],
               input_transform=getattr(labels_device, name)(**kw))
    losses = [s.step(1) for _ in batches]
    got = ranks[0]["case_solver#fused"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for k, v in s.params.items():
        for a, b in zip(got["params"][k], v):
            b = b.detach().numpy()
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(1.0, np.abs(b).max()))


def test_dp_tp_heatmap_estimator_matches_one_device(ranks):
    """Both frames on every rank, equal to the port's one-device heatmap
    estimator frame by frame (held in the ranks), and the same on every
    rank."""
    for r in ranks:
        got = r["case_estimator#heat"]
        assert got["frames"] == 2 and len(got["heat"]) == 2
        assert got["k3_launches"] == 0 == got["k1_launches"]
    for a, b in zip(ranks[0]["case_estimator#heat"]["heat"],
                    ranks[3]["case_estimator#heat"]["heat"]):
        np.testing.assert_array_equal(a, b)
