"""The port's pipeline parallelism (caffe_rtpose_tpu_torch/parallel/pp.py)
against JAX's ``parallel/pp.py``, on four gloo ranks on the CPU.

* ``pipeline_refine``: stages 2..5 of the COCO net at 8x12 (a prefix of the
  five refinement stages, one a rank), 5 microbatches (more than the
  stages: the pipe fills and drains) and 3 (fewer), on JAX's full-net
  weights: against the port's monolithic net in the ranks and against
  JAX's ``pipeline_refine`` on a 4-device mesh fed the same stage inputs,
  JAX's dry-run tolerance rtol/atol 2e-4.
* ``make_pp_train_step``: JAX ``dryrun_pp_train``'s draws (RandomState(23),
  width 8, 6x8, 4 microbatches) over the 4 stages: against the port's
  ``monolithic_train_step`` in the ranks and JAX's ``make_pp_train_step``
  here, loss rtol 1e-5 and every updated weight rtol 1e-4, atol 1e-6.
* ``make_refine_stage_net`` fed stage 3's weights reproduces the full net's
  stage 3, and ``stack_stage_params`` stacks as JAX's does.

Four ranks spawned once (``dp.spawn``, 300 s limit).  oneDNN off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.parallel import pp as jpp
from caffe_rtpose_tpu_torch.core.net import Net, params_from_jax
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.parallel import dp, dryrun, pp

HW, TRAIN_HW, WIDTH, MICRO = (8, 12), (6, 8), 8, 4
S = 4
TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def _no_onednn():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = prev


@pytest.fixture(scope="module")
def jfull():
    h, w = HW
    return JNet(j_make_net("COCO", input_dim=(1, 3, h * 8, w * 8)), phase="TEST", seed=7)


def _train_draws():
    """JAX dryrun_pp_train's draws, and the same in the port's layouts."""
    net = jpp.make_refine_stage_net(n_paf=4, n_heat=3, hw=TRAIN_HW, feat_ch=8, width=WIDTH)
    rs = np.random.RandomState(23)
    stacked = {k: [jnp.asarray(np.stack([rs.rand(*np.asarray(p).shape).astype(np.float32)
                                         * 0.1 - 0.05 for _ in range(S)])) for p in v]
               for k, v in net.params.items()}
    h, w = TRAIN_HW
    args = [jnp.asarray(rs.rand(MICRO, 1, h, w, c).astype(np.float32) - 0.5)
            for c in (4, 3, 8, 4, 3)]
    port_stacked = {k: [np.stack([params_from_jax({"x": [np.asarray(a[t])]})["x"][0]
                                  for t in range(S)]) for a in v] for k, v in stacked.items()}
    port_args = [np.asarray(a).transpose(0, 1, 4, 2, 3).copy() for a in args]
    return net, stacked, args, port_stacked, port_args


@pytest.fixture(scope="module")
def ranks(jfull):
    _, _, _, pst, pargs = _train_draws()
    w = jfull.export_weights()
    cases = [("dryrun_pp", dict(n_devices=S, hw=HW, micro=5, weights=w)),
             ("dryrun_pp#m3", dict(n_devices=S, hw=HW, micro=3, weights=w)),
             ("dryrun_pp_train", dict(n_devices=S, hw=TRAIN_HW, micro=MICRO, width=WIDTH,
                                      stacked=pst, args=pargs))]
    return dp.spawn(dryrun.rank_cases, S, ["cpu"] * S, args=(cases, False), timeout=TIMEOUT)


@pytest.mark.parametrize("case", ["dryrun_pp", "dryrun_pp#m3"])
def test_pipeline_matches_jax_pipeline_refine(jfull, ranks, case):
    got = ranks[0][case]
    l1, l2, ft = got["inputs"]
    mesh = JMesh(np.array(jax.devices()[:S]), ("stage",))
    phys = lambda a: jnp.asarray(np.asarray(a).transpose(0, 1, 3, 4, 2))  # noqa: E731
    o1, o2 = jpp.pipeline_refine(mesh, jpp.make_refine_stage_net(hw=HW),
                                 jpp.stack_stage_params(jfull.params, range(2, 2 + S)),
                                 phys(l1), phys(l2), phys(ft))
    for mine, theirs in zip(got["outputs"], (o1, o2)):
        np.testing.assert_allclose(mine, np.asarray(theirs).transpose(0, 1, 4, 2, 3),
                                   rtol=2e-4, atol=2e-4)


def test_pp_train_step_matches_jax_make_pp_train_step(ranks):
    net, stacked, args, _, _ = _train_draws()
    mesh = JMesh(np.array(jax.devices()[:S]), ("stage",))
    loss, new = jpp.make_pp_train_step(mesh, net, MICRO)(stacked, *args)
    got = ranks[0]["dryrun_pp_train"]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    for k, v in new.items():
        for a, b in zip(got["new"][k], v):
            b = np.stack([params_from_jax({"x": [np.asarray(b[t])]})["x"][0] for t in range(S)])
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=k)
    assert {r["dryrun_pp_train"]["loss"] for r in ranks} == {got["loss"]}


def test_stage_subnet_reproduces_full_net_stage():
    h, w = 16, 24
    full = Net(make_pose_deploy_net("COCO", input_dim=(1, 3, h * 8, w * 8)), device="cpu",
               seed=5)
    rs = np.random.RandomState(1)
    img = torch.from_numpy(rs.rand(1, 3, h * 8, w * 8).astype(np.float32) - 0.5)
    with torch.no_grad():
        out = full.forward({"image": img}, outputs=[
            "Mconv7_stage2_L1", "Mconv7_stage2_L2", "conv4_4_CPM", "Mconv7_stage3_L1",
            "Mconv7_stage3_L2"])
        sub = pp.make_refine_stage_net(hw=(h, w), device="cpu")
        sub.load_weights({f"Mconv{i}_{br}": full.export_weights()[f"Mconv{i}_stage3_{br}"]
                          for i in range(1, 8) for br in ("L1", "L2")})
        got = sub.forward({"prev_L1": out["Mconv7_stage2_L1"],
                           "prev_L2": out["Mconv7_stage2_L2"], "feat": out["conv4_4_CPM"]})
    for br in ("L1", "L2"):
        np.testing.assert_allclose(got[f"Mconv7_{br}"].numpy(),
                                   out[f"Mconv7_stage3_{br}"].numpy(), rtol=1e-4, atol=1e-5)


def test_stack_stage_params_matches_jax(jfull):
    mine = pp.stack_stage_params(jfull.export_weights(), range(2, 7))
    theirs = jpp.stack_stage_params(jfull.params, range(2, 7))
    assert set(mine) == set(theirs) == {f"Mconv{i}_{br}" for i in range(1, 8)
                                        for br in ("L1", "L2")}
    for k, v in theirs.items():
        for a, b in zip(mine[k], v):
            assert a.shape[0] == 5
            want = np.stack([params_from_jax({"x": [np.asarray(b[t])]})["x"][0]
                             for t in range(5)])
            np.testing.assert_array_equal(a, want)
