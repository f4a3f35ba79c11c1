"""The port's tensor (channel) parallelism (caffe_rtpose_tpu_torch/parallel/
tp.py) against JAX's ``parallel/tp.py``.

* ``channel_spec``'s rule case for case with tests/test_tp.py (a weight's
  output-feature axis split when it divides the ``model`` axis; biases and
  odd-width heads replicated), on the port's layouts (OIHW, InnerProduct
  (N, K)).
* The channel-sharded trunk (JAX ``dryrun_tp``'s net: conv 32, ReLU, conv
  16, InnerProduct 24) over 2 gloo ranks against JAX's ``make_tp_forward``
  on a 2-device mesh: JAX's dry-run tolerance, rtol/atol 2e-4; pre-sharded
  and whole weights give the same outputs bit for bit (asserted in the
  ranks), and a rank holds about half the weight bytes.
* A grouped trunk (``GROUPED``: conv 12; a group-3 conv 12, whose 6
  filters a rank reads span one and a half groups, so it convolves each
  group apart; a group-2 conv 16, one whole group a rank; InnerProduct 24)
  the same way against JAX's ``make_tp_forward``.
* ``tp_estimator_fn`` on the 2-stage COCO net at 128x80 with
  test_torch_estimator.py's fan-in weights, frames and thresholds: against
  the port's one-device estimator by JAX's dry-run rule (in the ranks) and
  against the JAX estimator on one device by ``_assert_outputs_close``
  (JAX's own dry run holds its sharded estimator to that result); and with
  ``keep_heatmap`` (the upsample-keys path) on f32 canvases, against the
  port's one-device heatmap estimator in the ranks (heatmap rtol/atol 2e-4)
  and JAX's heatmap estimator here.

Two ranks spawned once (``dp.spawn``, 300 s limit).  oneDNN off."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.ops import layout
from caffe_rtpose_tpu.parallel.dp import make_mesh as j_make_mesh
from caffe_rtpose_tpu.parallel.tp import make_tp_forward as j_tp_forward
from caffe_rtpose_tpu.parallel.tp import shard_params_channelwise as j_shard
from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.parallel import dp, dryrun, tp
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

from test_torch_estimator import (THR, WITNESS_SEEDS, _assert_outputs_close, _fan_in_weights,
                                  witness_frame)
from test_torch_sp import heat_frames

RES = (128, 80)
TIMEOUT = 300
TRUNK = """
input: "image" input_dim: 2 input_dim: 3 input_dim: 32 input_dim: 32
layer { name: "c1" type: "Convolution" bottom: "image" top: "c1"
  convolution_param { num_output: 32 pad: 1 kernel_size: 3 weight_filler { type: "msra" } } }
layer { name: "r1" type: "ReLU" bottom: "c1" top: "c1" }
layer { name: "c2" type: "Convolution" bottom: "c1" top: "c2"
  convolution_param { num_output: 16 pad: 1 kernel_size: 3 weight_filler { type: "msra" } } }
layer { name: "fc" type: "InnerProduct" bottom: "c2" top: "fc"
  inner_product_param { num_output: 24 weight_filler { type: "msra" } } }
"""


GROUPED = """
input: "image" input_dim: 2 input_dim: 3 input_dim: 16 input_dim: 16
layer { name: "c1" type: "Convolution" bottom: "image" top: "c1"
  convolution_param { num_output: 12 pad: 1 kernel_size: 3 weight_filler { type: "msra" } } }
layer { name: "r1" type: "ReLU" bottom: "c1" top: "c1" }
layer { name: "g3" type: "Convolution" bottom: "c1" top: "g3"
  convolution_param { num_output: 12 pad: 1 kernel_size: 3 group: 3
    weight_filler { type: "msra" } } }
layer { name: "g2" type: "Convolution" bottom: "g3" top: "g2"
  convolution_param { num_output: 16 pad: 1 kernel_size: 3 group: 2
    weight_filler { type: "msra" } } }
layer { name: "fc" type: "InnerProduct" bottom: "g2" top: "fc"
  inner_product_param { num_output: 24 weight_filler { type: "msra" } } }
"""


def _mesh(n, i=0):
    """What ``channel_spec`` and the shares read of a mesh."""
    return types.SimpleNamespace(n=lambda axis: n, index=lambda axis: i)


@pytest.fixture(scope="module", autouse=True)
def _no_onednn():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = prev


@pytest.fixture(scope="module")
def setup():
    jnet = JNet(TRUNK, seed=0)
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32) - 0.5
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=RES, input_u8=True)
    weights = _fan_in_weights(jest, 0)
    frames = [witness_frame(s) for s in WITNESS_SEEDS[:2]]
    ref = [jest.fetch(jest.run_device(f, **THR)) for f in frames]
    return jnet, x, jest, weights, frames, ref


@pytest.fixture(scope="module")
def grouped():
    jnet = JNet(GROUPED, seed=1)
    return jnet, np.random.RandomState(1).rand(2, 3, 16, 16).astype(np.float32) - 0.5


@pytest.fixture(scope="module")
def ranks(setup, grouped):
    jnet, x, _, weights, frames, _ = setup
    gnet, gx = grouped
    # export_weights: Caffe's layout (the InnerProduct weight (N, K), K in
    # Caffe's flatten order)
    cases = [("case_tp_forward", dict(n_devices=2, proto=TRUNK, weights=jnet.export_weights(),
                                      inputs={"image": x}, outputs=["fc"])),
             ("case_estimator", dict(kind="tp", n_devices=2, weights=weights, frames=frames)),
             ("case_tp_forward#grouped", dict(n_devices=2, proto=GROUPED,
                                              weights=gnet.export_weights(),
                                              inputs={"image": gx}, outputs=["fc", "g3"])),
             ("case_estimator#heat", dict(kind="tp", n_devices=2, weights=weights,
                                          frames=heat_frames(frames), keep_heatmap=True))]
    return dp.spawn(dryrun.rank_cases, 2, ["cpu"] * 2, timeout=TIMEOUT, args=(
        cases, False, {"nms": THR["nms_threshold"], "inter": THR["inter_threshold"]}))


def test_channel_spec_rules():
    mesh = _mesh(8)
    # OIHW conv kernel: O = 64 divides 8 -> split on axis 0 (JAX: HWIO's last)
    assert tp.channel_spec(mesh, torch.zeros(64, 16, 3, 3)) == ("model", None, None, None)
    # bias (1-D) and odd-width heads stay replicated
    assert tp.channel_spec(mesh, torch.zeros(64)) == ()
    assert tp.channel_spec(mesh, torch.zeros(19, 16)) == ()


def test_tp_params_are_actually_distributed():
    """Each rank holds 1/n of a sharded kernel (a copy, not a view of the
    whole), and the shares put back together are the kernel."""
    w = torch.from_numpy(np.random.RandomState(0).rand(64, 16, 3, 3).astype(np.float32))
    shares = [tp.shard_params_channelwise(_mesh(8, i), {"c": [w, w[:, 0, 0, 0]]})["c"]
              for i in range(8)]
    assert all(s[0].shape == (8, 16, 3, 3) and s[0].untyped_storage().nbytes() == w.nbytes // 8
               for s in shares)
    assert all(s[1].shape == (64,) for s in shares)
    assert torch.equal(torch.cat([s[0] for s in shares]), w)


def test_tp_trunk_matches_jax_make_tp_forward(setup, ranks):
    jnet, x, *_ = setup
    mesh = j_make_mesh(2, axis="model")

    def forward(params, image):
        return jnet._apply(params, {"image": image}, jax.random.PRNGKey(0), None, False)["fc"]

    with mesh:
        want = j_tp_forward(mesh, forward)(j_shard(mesh, jnet.params),
                                           layout.to_physical(jnp.asarray(x)))
    for r in ranks:
        got = r["case_tp_forward"]
        np.testing.assert_allclose(got["out"]["fc"], np.asarray(want), rtol=2e-4, atol=2e-4)
        # the 32- and 16-channel convs and the 24-wide FC split; the biases stay whole
        assert 0.49 < got["share"] < 0.52


def test_tp_estimator_matches_jax_single_device(setup, ranks):
    *_, frames, ref = setup
    est = PoseEstimator(make_pose_deploy_net("COCO", stages=2), net_resolution=RES,
                        input_u8=True, device="cpu")
    for r in ranks:
        got = r["case_estimator"]
        assert got["frames"] == len(frames)
        assert 0.49 < got["weight_share"] < 0.55
        for packed, want in zip(got["packed"], ref):
            _assert_outputs_close(est.unpack(packed), want, est.descriptor)
    for a, b in zip(ranks[0]["case_estimator"]["packed"], ranks[1]["case_estimator"]["packed"]):
        np.testing.assert_array_equal(a, b)


def test_tp_grouped_trunk_matches_jax_make_tp_forward(grouped, ranks):
    jnet, x = grouped
    mesh = j_make_mesh(2, axis="model")

    def forward(params, image):
        return jnet._apply(params, {"image": image}, jax.random.PRNGKey(0), None, False)

    with mesh:
        want = j_tp_forward(mesh, forward)(j_shard(mesh, jnet.params),
                                           layout.to_physical(jnp.asarray(x)))
    for r in ranks:
        got = r["case_tp_forward#grouped"]["out"]
        np.testing.assert_allclose(got["fc"], np.asarray(want["fc"]), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got["g3"], np.asarray(layout.to_caffe(want["g3"])),
                                   rtol=2e-4, atol=2e-4)


def test_tp_heatmap_estimator_matches_jax_single_device(setup, ranks):
    *_, weights, frames, _ = setup
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=RES, keep_heatmap=True)
    _fan_in_weights(jest, 0)
    ref = [jest.run_device(x, **THR) for x in heat_frames(frames)]
    for r in ranks:
        got = r["case_estimator#heat"]
        assert got["frames"] == len(frames) and got["k3_launches"] == 0 == got["k1_launches"]
        for outs, heat, want in zip(got["outputs"], got["heat"], ref):
            _assert_outputs_close(outs, jest.fetch(want), jest.descriptor)
            np.testing.assert_allclose(heat, np.asarray(want["heatmap"]), rtol=2e-4, atol=2e-4)
