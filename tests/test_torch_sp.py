"""The port's spatial parallelism (caffe_rtpose_tpu_torch/parallel/sp.py) on
gloo ranks on the CPU, against JAX.

* The halo trunk (JAX ``dryrun_spatial``'s net: 3x3 conv, 2x2 pool, 7x7
  conv), rows split evenly over 2 ranks against JAX's
  ``make_spatial_forward`` on a 2-device mesh, and unevenly over 3 ranks
  (20 rows at the pool's resolution: 7, 7, 6) against JAX's unsharded
  forward (a JAX mesh cannot place an uneven split); JAX's dry-run
  tolerance, rtol/atol 2e-4.  Its backward (the halo rows' gradients sent
  back) against the port's one-device ``Net.backward`` within 1e-5 of each
  blob's largest magnitude.
* ``spatial_estimator_fn`` on the 2-stage COCO net at 128x80 (10 rows at
  1/8: 5, 5 over 2 ranks and 4, 3, 3 over 3), on test_torch_estimator.py's
  fan-in weights, frames and thresholds: against the port's one-device
  estimator by JAX's dry-run rule (peaks rtol/atol 1e-4, scores 2e-2, pair
  counts exact; asserted in the ranks), and against the JAX estimator on
  one device by ``_assert_outputs_close`` (JAX's own dry run holds its
  sharded estimator to that single-device result; a sharded JAX compile of
  the estimator would take most of this file's budget).

Each world size is spawned once (``dp.spawn``, 300 s limit).  oneDNN off.
The card-only test holds K1's launches on the sharded path."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caffe_rtpose_tpu.core.net import Net as JNet
from caffe_rtpose_tpu.models.cpm import make_pose_deploy_net as j_make_net
from caffe_rtpose_tpu.ops import layout
from caffe_rtpose_tpu.parallel.dp import make_mesh as j_make_mesh
from caffe_rtpose_tpu.parallel.sp import make_spatial_forward as j_spatial_forward
from caffe_rtpose_tpu.pose.estimator import PoseEstimator as JEstimator
from caffe_rtpose_tpu_torch.core.net import Net, params_from_jax
from caffe_rtpose_tpu_torch.models.cpm import make_pose_deploy_net
from caffe_rtpose_tpu_torch.parallel import dp, dryrun, sp
from caffe_rtpose_tpu_torch.pose.estimator import PoseEstimator

from test_torch_estimator import (THR, WITNESS_SEEDS, _assert_outputs_close, _fan_in_weights,
                                  witness_frame)

RES = (128, 80)
TIMEOUT = 300
TRUNK = """
input: "image" input_dim: 2 input_dim: 3 input_dim: {h} input_dim: 24
layer {{ name: "c1" type: "Convolution" bottom: "image" top: "c1"
  convolution_param {{ num_output: 16 pad: 1 kernel_size: 3 weight_filler {{ type: "msra" }} }} }}
layer {{ name: "r1" type: "ReLU" bottom: "c1" top: "c1" }}
layer {{ name: "p1" type: "Pooling" bottom: "c1" top: "p1"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "c2" type: "Convolution" bottom: "p1" top: "c2"
  convolution_param {{ num_output: 16 pad: 3 kernel_size: 7 weight_filler {{ type: "msra" }} }} }}
"""


@pytest.fixture(scope="module", autouse=True)
def _no_onednn():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = prev


def _trunk(h, seed):
    jnet = JNet(TRUNK.format(h=h), seed=seed)
    x = np.random.RandomState(seed).rand(2, 3, h, 24).astype(np.float32) - 0.5
    diff = np.random.RandomState(seed + 1).randn(2, 16, h // 2, 12).astype(np.float32)
    return jnet, params_from_jax(jnet.params), x, diff


@pytest.fixture(scope="module")
def coco():
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=RES, input_u8=True)
    weights = _fan_in_weights(jest, 0)
    frames = [witness_frame(s) for s in WITNESS_SEEDS[:2]]
    ref = [jest.fetch(jest.run_device(x, **THR)) for x in frames]
    return jest, weights, frames, ref


def _cases(n, h, coco):
    _, weights, frames, _ = coco
    jnet, w, x, diff = _trunk(h, n)
    return [("case_halo_forward", dict(n_devices=n, proto=TRUNK.format(h=h), weights=w,
                                       inputs={"image": x}, outputs=["c2"])),
            ("case_halo_grad", dict(n_devices=n, proto=TRUNK.format(h=h), weights=w,
                                    inputs={"image": x}, outputs=["c2"],
                                    top_diffs={"c2": diff})),
            ("case_estimator", dict(kind="spatial", n_devices=n, weights=weights,
                                    frames=frames))]


THR_RANKS = {"nms": THR["nms_threshold"], "inter": THR["inter_threshold"]}


@pytest.fixture(scope="module")
def two(coco):
    return dp.spawn(dryrun.rank_cases, 2, ["cpu"] * 2, args=(_cases(2, 64, coco), False,
                                                             THR_RANKS), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def three(coco):
    return dp.spawn(dryrun.rank_cases, 3, ["cpu"] * 3, args=(_cases(3, 40, coco), False,
                                                             THR_RANKS), timeout=TIMEOUT)


def _jax_forward(jnet):
    return lambda params, image: jnet._apply(params, {"image": image}, jax.random.PRNGKey(0),
                                             None, False)["c2"]


def test_halo_trunk_even_matches_jax_make_spatial_forward(two):
    jnet, _, x, _ = _trunk(64, 2)
    mesh = j_make_mesh(2, axis="spatial")
    with mesh:
        want = j_spatial_forward(mesh, _jax_forward(jnet))(jnet.params,
                                                           layout.to_physical(jnp.asarray(x)))
    want = np.asarray(layout.to_caffe(want))
    for r in two:
        np.testing.assert_allclose(r["case_halo_forward"]["c2"], want, rtol=2e-4, atol=2e-4)


def test_halo_trunk_uneven_matches_jax(three):
    jnet, _, x, _ = _trunk(40, 3)
    want = np.asarray(layout.to_caffe(_jax_forward(jnet)(jnet.params,
                                                         layout.to_physical(jnp.asarray(x)))))
    assert sp.slab_counts(40, 20, 3) == [14, 14, 12]
    for r in three:
        np.testing.assert_allclose(r["case_halo_forward"]["c2"], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("world", ["two", "three"])
def test_halo_backward_matches_one_device(world, request):
    ranks = request.getfixturevalue(world)
    n = len(ranks)
    h = 64 if n == 2 else 40
    _, w, x, diff = _trunk(h, n)
    net = Net(TRUNK.format(h=h), device="cpu")
    net.load_weights(w)
    in_d, p_d = net.backward({"image": torch.from_numpy(x)}, {"c2": diff})
    got = ranks[0]["case_halo_grad"]
    want = {"image": in_d["image"].numpy()}
    np.testing.assert_allclose(got["inputs"]["image"], want["image"], rtol=0,
                               atol=1e-5 * np.abs(want["image"]).max())
    for k, blobs in p_d.items():
        for a, b in zip(got["params"][k], blobs):
            b = b.numpy()
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=k)


@pytest.mark.parametrize("world", ["two", "three"])
def test_spatial_estimator_matches_jax_single_device(world, coco, request):
    jest, _, frames, ref = coco
    ranks = request.getfixturevalue(world)
    for r in ranks:
        got = r["case_estimator"]
        assert got["frames"] == len(frames)
        for packed, want in zip(got["packed"], ref):
            _assert_outputs_close(_unpack(packed), want, jest.descriptor)
    # the outputs are replicated: every rank returns the same rows
    for r in ranks[1:]:
        for a, b in zip(r["case_estimator"]["packed"], ranks[0]["case_estimator"]["packed"]):
            np.testing.assert_array_equal(a, b)


def _unpack(packed):
    """A packed row as the port's estimator unpacks it."""
    return PoseEstimator(make_pose_deploy_net("COCO", stages=2), net_resolution=RES,
                         input_u8=True, device="cpu").unpack(packed)


def test_row_split_rules():
    """Rows split at the coarsest resolution and scaled up; a convolution
    whose window is not 2p+1 rows, or a pool that straddles slabs, is
    refused."""
    assert [sp.slab_bounds(368, 46, 4, i) for i in range(4)] == [
        (0, 96), (96, 192), (192, 280), (280, 368)]
    assert sp.slab_counts(46, 46, 4) == [12, 12, 11, 11]
    with pytest.raises(ValueError, match="multiple"):
        sp.slab_bounds(30, 8, 2, 0)
    bad = TRUNK.format(h=64).replace("kernel_size: 2 stride: 2", "kernel_size: 3 stride: 2")
    net = Net(bad, device="cpu")
    with pytest.raises(NotImplementedError, match="p1"):
        sp.check_row_local(net, net.layers)
