"""On-device CPM labels (``caffe_rtpose_tpu_torch/training/labels_device.py``)
against the host reference ``transformer.generate_label_map`` (the JAX
package's) and JAX's ``labels_device``, on the CPU.

Against the host reference: every channel bit for bit, overlapping people
(the last-writer PAF corridors) included.  Against JAX's device path: the
weight and PAF channels bit for bit; the gaussians and the background within
2.4e-7 (JAX takes the exponential in f32, the host reference and the port in
f64 rounded to f32: one f32 ulp at 1)."""

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.training.labels_device import make_label_fn as jmake_label_fn
from caffe_rtpose_tpu.training.transformer import AugParams as JAugParams
from caffe_rtpose_tpu.training.transformer import Meta, Person, generate_label_map
from caffe_rtpose_tpu_torch.training.labels_device import make_input_transform, make_label_fn
from caffe_rtpose_tpu_torch.training.transformer import AugParams

JAX_GAUSS_TOL = 2.4e-7


def _batch(seed, bsz, people, crop, overlap):
    """Joints of ``people`` per sample (padded to 12 with vis 3), every
    visibility code, and a u8 mask grid."""
    rs = np.random.RandomState(seed)
    grid = crop // 8
    joints = np.zeros((bsz, 12, 18, 2), np.float32)
    vis = np.full((bsz, 12, 18), 3, np.int32)
    for b in range(bsz):
        centre = rs.uniform(40, crop - 40, size=(18, 2))
        for p in range(people):
            spread = 10 if overlap else crop / 3
            joints[b, p] = (centre + rs.randn(18, 2) * spread).astype(np.float32)
            vis[b, p] = rs.choice([0, 1, 2, 3], size=18, p=[0.5, 0.2, 0.1, 0.2])
    mask = rs.randint(0, 256, size=(bsz, grid, grid)).astype(np.uint8)
    return joints, vis, mask


def _host(joints, vis, mask, prm):
    return np.stack([generate_label_map(
        Meta(people=[Person(joints[b, p], vis[b, p]) for p in range(joints.shape[1])]),
        prm, mask[b]) for b in range(joints.shape[0])])


@pytest.mark.parametrize("people,overlap", [(1, False), (5, False), (12, True), (3, True)])
def test_labels_match_host_and_jax(people, overlap):
    crop = 368 if people == 12 else 128
    jprm = JAugParams(crop_size_x=crop, crop_size_y=crop)
    prm = AugParams(crop_size_x=crop, crop_size_y=crop)
    joints, vis, mask = _batch(people, 3, people, crop, overlap)
    weight = mask.astype(np.float32) / 255.0
    got = make_label_fn(prm, 12)(torch.from_numpy(joints), torch.from_numpy(vis),
                                 torch.from_numpy(weight)).numpy()
    host = _host(joints, vis, mask, jprm)
    assert got.shape == host.shape == (3, 114, crop // 8, crop // 8)
    np.testing.assert_array_equal(got, host)
    jax_nchw = np.transpose(np.asarray(jmake_label_fn(jprm, 12)(joints, vis, weight)), (0, 3, 1, 2))
    np.testing.assert_array_equal(got[:, :95], jax_nchw[:, :95])
    np.testing.assert_allclose(got[:, 95:], jax_nchw[:, 95:], rtol=0, atol=JAX_GAUSS_TOL)
    if overlap:  # corridors of several people cross: the last writer wins
        assert (got[:, 57:95] != 0).sum() > 0


def test_last_writer_order():
    """Two people with the same limb through the same pixels: the later one's
    direction is the label, as the reference's count bug makes it."""
    prm = AugParams(crop_size_x=64, crop_size_y=64)
    joints = np.zeros((1, 2, 18, 2), np.float32)
    vis = np.full((1, 2, 18), 3, np.int32)
    joints[0, 0, 1], joints[0, 0, 8] = (10, 30), (50, 30)  # neck -> right hip, +x
    joints[0, 1, 1], joints[0, 1, 8] = (50, 31), (10, 31)  # the same corridor, -x
    vis[0, :, [1, 8]] = 1
    lab = make_label_fn(prm, 2)(torch.from_numpy(joints), torch.from_numpy(vis),
                                torch.ones(1, 8, 8)).numpy()
    paf_x = lab[0, 57]  # limb 0 (neck -> right hip), x component
    assert paf_x.min() == -1.0 and paf_x.max() == 0.0
    host = _host(joints, vis, np.full((1, 8, 8), 255, np.uint8), JAugParams(crop_size_x=64,
                                                                              crop_size_y=64))
    np.testing.assert_array_equal(lab, host)


def test_input_transform():
    """{data u8, joints, vis, weight} -> {data, label}: the exact
    (x - 128) / 256 and the labels."""
    prm = AugParams(crop_size_x=64, crop_size_y=64)
    joints, vis, mask = _batch(9, 2, 3, 64, False)
    rs = np.random.RandomState(0)
    data = rs.randint(0, 256, size=(2, 3, 64, 64)).astype(np.uint8)
    weight = torch.from_numpy(mask.astype(np.float32) / 255.0)
    out = make_input_transform(prm, 12, data_u8=True)(
        {"data": torch.from_numpy(data), "joints": torch.from_numpy(joints),
         "vis": torch.from_numpy(vis), "weight": weight})
    assert set(out) == {"data", "label"}
    np.testing.assert_array_equal(out["data"].numpy(), (data.astype(np.float32) - 128.0) / 256.0)
    np.testing.assert_array_equal(out["label"].numpy(), make_label_fn(prm, 12)(
        torch.from_numpy(joints), torch.from_numpy(vis), weight).numpy())
