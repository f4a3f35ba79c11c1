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

* A CaffeNet-shaped trunk at crop 131, batch 2 (``CAFFENET``: an 11x11/4
  conv to 31 rows, across-channel LRN, a 3x3/2 max pool to 15, a group-2
  5x5 conv, a padded 3x3/2 average pool to 8, a WITHIN_CHANNEL LRN, a
  group-2 3x3 conv, a padded 3x3/2 max pool to 4, InnerProduct, Dropout
  inactive in TEST, InnerProduct): against JAX's ``make_spatial_forward`` on
  a 2-device mesh and JAX's unsharded forward under the port's uneven
  3-rank split (44, 44, 43 input rows), rtol/atol 2e-4; its backward (the
  window and gather exchanges) against the port's one-device
  ``Net.backward`` within 1e-5 of each blob's largest magnitude; and its
  TRAIN form (SoftmaxWithLoss, Dropout active) stepped by
  ``mesh2d.make_dp_sp_train_step`` against the one-rank step (in the ranks:
  loss within 1e-3, every blob rtol 2e-3, atol 2e-5: JAX's dry-run rule),
  with the replicated tail (fc6, fc7) equal on every rank after 3 steps.
* ``spatial_estimator_fn`` with ``keep_heatmap`` (the upsample-keys path)
  on the same 2-stage net and weights, f32 canvases of the witness frames:
  against the port's one-device heatmap estimator in the ranks (heatmap
  rtol/atol 2e-4) and the JAX heatmap estimator by ``_assert_outputs_close``.

Each world size is spawned once (``dp.spawn``, 300 s limit).  oneDNN off.
The card-only test holds K1's and K3's launches on the sharded paths."""

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
from caffe_rtpose_tpu_torch.core.net import Net, params_from_jax, params_to_jax
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


CAFFENET = """
input: "data" input_dim: 2 input_dim: 3 input_dim: 131 input_dim: 131
{label}
layer {{ name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param {{ num_output: 8 kernel_size: 11 stride: 4 weight_filler {{ type: "msra" }} }} }}
layer {{ name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }}
layer {{ name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param {{ local_size: 5 alpha: 0.0001 beta: 0.75 }} }}
layer {{ name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param {{ pool: MAX kernel_size: 3 stride: 2 }} }}
layer {{ name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
  convolution_param {{ num_output: 8 pad: 2 kernel_size: 5 group: 2 weight_filler {{ type: "msra" }} }} }}
layer {{ name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }}
layer {{ name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
  pooling_param {{ pool: AVE kernel_size: 3 stride: 2 pad: 1 }} }}
layer {{ name: "norm2" type: "LRN" bottom: "pool2" top: "norm2"
  lrn_param {{ local_size: 3 alpha: 0.01 beta: 0.75 norm_region: WITHIN_CHANNEL }} }}
layer {{ name: "conv3" type: "Convolution" bottom: "norm2" top: "conv3"
  convolution_param {{ num_output: 8 pad: 1 kernel_size: 3 group: 2 weight_filler {{ type: "msra" }} }} }}
layer {{ name: "relu3" type: "ReLU" bottom: "conv3" top: "conv3" }}
layer {{ name: "pool5" type: "Pooling" bottom: "conv3" top: "pool5"
  pooling_param {{ pool: MAX kernel_size: 3 stride: 2 pad: 1 }} }}
layer {{ name: "fc6" type: "InnerProduct" bottom: "pool5" top: "fc6"
  inner_product_param {{ num_output: 16 weight_filler {{ type: "msra" }} }} }}
layer {{ name: "relu6" type: "ReLU" bottom: "fc6" top: "fc6" }}
layer {{ name: "drop6" type: "Dropout" bottom: "fc6" top: "fc6" }}
layer {{ name: "fc7" type: "InnerProduct" bottom: "fc6" top: "fc7"
  inner_product_param {{ num_output: 10 weight_filler {{ type: "msra" }} }} }}
{loss}
"""
CAFFENET_TEST = CAFFENET.format(label="", loss="")
CAFFENET_TRAIN = CAFFENET.format(
    label='input: "label" input_dim: 2',
    loss='layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc7" bottom: "label" '
         'top: "loss" }')

def _caffenet():
    """The trunk's seed-3 JAX weights (Caffe layout), input, top diff and
    TRAIN batch."""
    jnet = JNet(CAFFENET_TEST, seed=3)
    rs = np.random.RandomState(3)
    x = rs.rand(2, 3, 131, 131).astype(np.float32) - 0.5
    return (jnet, jnet.export_weights(), x, rs.randn(2, 10).astype(np.float32),
            {"data": x, "label": np.array([3, 7], np.float32)})


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


def heat_frames(frames):
    """The u8 witness frames as the heatmap estimator's f32 canvases."""
    return [(f[0].astype(np.float32) / 256.0 - 0.5).transpose(2, 0, 1)[None].copy()
            for f in frames]


def _cases(n, h, coco):
    _, weights, frames, _ = coco
    jnet, w, x, diff = _trunk(h, n)
    _, cw, cx, cdiff, batch = _caffenet()
    cases = [("case_halo_forward", dict(n_devices=n, proto=TRUNK.format(h=h), weights=w,
                                        inputs={"image": x}, outputs=["c2"])),
             ("case_halo_grad", dict(n_devices=n, proto=TRUNK.format(h=h), weights=w,
                                     inputs={"image": x}, outputs=["c2"],
                                     top_diffs={"c2": diff})),
             ("case_estimator", dict(kind="spatial", n_devices=n, weights=weights,
                                     frames=frames)),
             ("case_halo_forward#caffenet", dict(n_devices=n, proto=CAFFENET_TEST, weights=cw,
                                                 inputs={"data": cx}, outputs=["fc7", "pool5"])),
             ("case_halo_grad#caffenet", dict(n_devices=n, proto=CAFFENET_TEST, weights=cw,
                                              inputs={"data": cx}, outputs=["fc7"],
                                              top_diffs={"fc7": cdiff})),
             ("case_spatial_train", dict(n_devices=n, proto=CAFFENET_TRAIN, batch=batch,
                                         weights=cw)),
             ("case_estimator#heat", dict(kind="spatial", n_devices=n, weights=weights,
                                          frames=heat_frames(frames), keep_heatmap=True))]
    if n == 2:  # the 3x3/2 pool that straddles slabs, against JAX
        cases.append(("case_halo_forward#pool3", dict(
            n_devices=n, proto=POOL3.format(h=h), weights=w, inputs={"image": x},
            outputs=["c2"])))
    return cases


POOL3 = TRUNK.replace("kernel_size: 2 stride: 2", "kernel_size: 3 stride: 2")


THR_RANKS = {"nms": THR["nms_threshold"], "inter": THR["inter_threshold"]}


@pytest.fixture(scope="module")
def heat_ref(coco):
    """The JAX heatmap estimator's outputs on the witness frames' canvases
    (the same fan-in weights)."""
    _, _, frames, _ = coco
    jest = JEstimator(j_make_net("COCO", stages=2), net_resolution=RES, keep_heatmap=True)
    _fan_in_weights(jest, 0)
    outs = [jest.run_device(x, **THR) for x in heat_frames(frames)]
    return jest, [(jest.fetch(o), np.asarray(o["heatmap"])) for o in outs]


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


def test_row_split_rules(two):
    """Rows split at the coarsest resolution and scaled up; a pool whose
    windows straddle slabs (3x3/2, which the port once refused) now runs
    on 2 ranks and equals JAX's forward."""
    assert [sp.slab_bounds(368, 46, 4, i) for i in range(4)] == [
        (0, 96), (96, 192), (192, 280), (280, 368)]
    assert sp.slab_counts(46, 46, 4) == [12, 12, 11, 11]
    with pytest.raises(ValueError, match="multiple"):
        sp.slab_bounds(30, 8, 2, 0)
    _, w, x, _ = _trunk(64, 2)  # the weights and input the ranks ran
    params = {k: [jnp.asarray(a) for a in v] for k, v in params_to_jax(w).items()}
    want = np.asarray(layout.to_caffe(_jax_forward(JNet(POOL3.format(h=64)))(
        params, layout.to_physical(jnp.asarray(x)))))
    for r in two:
        np.testing.assert_allclose(r["case_halo_forward#pool3"]["c2"], want, rtol=2e-4, atol=2e-4)


def _jax_caffenet(jnet):
    return lambda params, data: jnet._apply(params, {"data": data}, jax.random.PRNGKey(0),
                                            None, False)


def test_caffenet_trunk_even_matches_jax_make_spatial_forward(two):
    jnet, _, x, _, _ = _caffenet()
    mesh = j_make_mesh(2, axis="spatial")
    with mesh:
        want = j_spatial_forward(mesh, _jax_caffenet(jnet))(jnet.params,
                                                            layout.to_physical(jnp.asarray(x)))
    for r in two:
        got = r["case_halo_forward#caffenet"]
        np.testing.assert_allclose(got["fc7"], np.asarray(want["fc7"]), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got["pool5"], np.asarray(layout.to_caffe(want["pool5"])),
                                   rtol=2e-4, atol=2e-4)


def test_caffenet_trunk_uneven_matches_jax(three):
    """44, 44, 43 input rows; conv1's rows follow their windows' centres
    (10, 11, 10 of 31) and pool5's 4 rows split 2, 1, 1."""
    jnet, _, x, _, _ = _caffenet()
    want = _jax_caffenet(jnet)(jnet.params, layout.to_physical(jnp.asarray(x)))
    for r in three:
        got = r["case_halo_forward#caffenet"]
        np.testing.assert_allclose(got["fc7"], np.asarray(want["fc7"]), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got["pool5"], np.asarray(layout.to_caffe(want["pool5"])),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("world", ["two", "three"])
def test_caffenet_trunk_backward_matches_one_device(world, request):
    ranks = request.getfixturevalue(world)
    _, w, x, diff, _ = _caffenet()
    net = Net(CAFFENET_TEST, device="cpu")
    net.load_weights(w)
    in_d, p_d = net.backward({"data": torch.from_numpy(x)}, {"fc7": diff})
    got = ranks[0]["case_halo_grad#caffenet"]
    assert got["whole_layers"] == ["drop6", "fc6", "fc7", "relu6"]
    want = in_d["data"].numpy()
    np.testing.assert_allclose(got["inputs"]["data"], want, rtol=0, atol=1e-5 * np.abs(want).max())
    for k, blobs in p_d.items():
        for a, b in zip(got["params"][k], blobs):
            b = b.numpy()
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=k)


@pytest.mark.parametrize("world", ["two", "three"])
def test_caffenet_spatial_train_step_matches_one_device(world, request):
    """The TRAIN form (Dropout active) over 1 x n ranks against the port's
    one-rank step: the tail draws the one-device masks from the net's own
    generator, so JAX's dry-run rule holds for every blob; after 3 steps the
    replicated tail's parameters are bit for bit the same on every rank."""
    ranks = request.getfixturevalue(world)
    r0 = ranks[0]["case_spatial_train"]
    assert r0["tail_layers"] == ["fc6", "fc7"]
    assert all(r["case_spatial_train"]["tail_identical"] for r in ranks)
    assert len({r["case_spatial_train"]["loss"] for r in ranks}) == 1
    assert abs(r0["loss"] - r0["ref_loss"]) <= 1e-3 * max(1.0, abs(r0["ref_loss"]))
    for k, blobs in r0["ref_params"].items():
        for a, b in zip(r0["params"][k], blobs):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("world", ["two", "three"])
def test_spatial_heatmap_estimator_matches_jax_single_device(world, heat_ref, request):
    jest, ref = heat_ref
    ranks = request.getfixturevalue(world)
    for r in ranks:
        got = r["case_estimator#heat"]
        assert got["frames"] == len(ref) and got["k3_launches"] == 0 == got["k1_launches"]
        for (outs, heat), ((want, want_heat)) in zip(zip(got["outputs"], got["heat"]), ref):
            _assert_outputs_close(outs, want, jest.descriptor)
            np.testing.assert_allclose(heat, want_heat, rtol=2e-4, atol=2e-4)
    for a, b in zip(ranks[0]["case_estimator#heat"]["heat"],
                    ranks[-1]["case_estimator#heat"]["heat"]):
        np.testing.assert_array_equal(a, b)
