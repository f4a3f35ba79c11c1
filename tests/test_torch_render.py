"""The port's renderers (pose/render.py) against the JAX package's on the
same canvas, poses and maps: within 1e-3 on the 0..255 scale (both compute
in f32; the bicubic and colour sums are taken in other orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from caffe_rtpose_tpu.pose import render as J
from caffe_rtpose_tpu_torch.pose import render as T

TOL = 1e-3


def _canvas(rs, h, w):
    return (rs.rand(h, w, 3) * 255).astype(np.float32)


def _poses(rs, num_parts, h, w, maxp=4, people=3):
    """``people`` skeletons around distinct centres, one joint of the first
    person missing; the slots past ``people`` are garbage (never drawn)."""
    poses = rs.rand(maxp, num_parts, 3).astype(np.float32)
    for p in range(people):
        cy, cx = rs.uniform(0.3, 0.7) * h, (p + 1) / (people + 1) * w
        poses[p, :, 0] = cx + rs.uniform(-0.15, 0.15, num_parts) * w
        poses[p, :, 1] = cy + rs.uniform(-0.3, 0.3, num_parts) * h
        poses[p, :, 2] = rs.uniform(0.2, 1.0, num_parts)
    poses[0, 3, 2] = 0.0
    return poses


def _maps(rs, c=57, h=40, w=64):
    maps = rs.rand(c, h, w).astype(np.float32)
    maps[19:] = maps[19:] * 2 - 1  # PAF channels in [-1, 1]
    return maps


def _check(got, ref, canvas):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape == canvas.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert np.abs(got - canvas).max() > 1.0, "the view drew nothing"


@pytest.mark.parametrize("googly", [False, True])
def test_render_pose_coco(googly):
    rs = np.random.RandomState(1)
    h, w = 240, 320
    canvas, poses = _canvas(rs, h, w), _poses(rs, 18, h, w)
    ref = J.render_pose(jnp.asarray(canvas), jnp.asarray(poses), jnp.int32(3), num_parts=18,
                        googly_eyes=googly)
    got = T.render_pose(torch.from_numpy(canvas), torch.from_numpy(poses), 3, num_parts=18,
                        googly_eyes=googly)
    _check(got, ref, canvas)


def test_render_pose_mpi():
    rs = np.random.RandomState(2)
    h, w = 240, 320
    canvas, poses = _canvas(rs, h, w), _poses(rs, 15, h, w)
    ref = J.render_pose_mpi(jnp.asarray(canvas), jnp.asarray(poses), jnp.int32(3))
    got = T.render_pose_mpi(torch.from_numpy(canvas), torch.from_numpy(poses), 3)
    _check(got, ref, canvas)


@pytest.mark.parametrize("part_to_show", [1, 18, 19, 20, 21, 30])
def test_heatmap_views_coco(part_to_show):
    """The views runner._render dispatches for COCO: one part channel (18
    is the out-of-box default-1 quirk), all parts (19), the accumulated
    PAFs (20) and single PAF pairs (21, 30)."""
    rs = np.random.RandomState(part_to_show)
    canvas, maps = _canvas(rs, 64, 96), _maps(rs)
    P = 18
    if part_to_show <= P:
        fj, ft, args = J.render_heatmap, T.render_heatmap, (part_to_show - 1, P)
    elif part_to_show == P + 1:
        fj, ft, args = J.render_all_parts, T.render_all_parts, (P,)
    elif part_to_show == P + 2:
        fj, ft, args = J.render_paf, T.render_paf, (P + 1, P + 1)
    else:
        fj, ft, args = J.render_paf, T.render_paf, (P + 1 + 2 * (part_to_show - P - 3),)
    ref = fj(jnp.asarray(canvas), jnp.asarray(maps), *args)
    got = ft(torch.from_numpy(canvas), torch.from_numpy(maps), *args)
    _check(got, ref, canvas)


def test_heatmap_view_mpi():
    rs = np.random.RandomState(3)
    canvas, maps = _canvas(rs, 64, 96), _maps(rs, c=44)
    ref = J.render_heatmap(jnp.asarray(canvas), jnp.asarray(maps), 14, num_parts=15)
    got = T.render_heatmap(torch.from_numpy(canvas), torch.from_numpy(maps), 14, num_parts=15)
    _check(got, ref, canvas)


def test_colour_maps():
    rs = np.random.RandomState(4)
    v = (rs.rand(500).astype(np.float32) * 3 - 1.5)
    vy = (rs.rand(500).astype(np.float32) * 3 - 1.5)
    vy[:3] = 0.0
    v[:3] = 0.0  # atan2(-0, -0)
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0)):
        np.testing.assert_allclose(T.jet_color(torch.from_numpy(v), lo, hi).numpy(),
                                   np.asarray(J.jet_color(jnp.asarray(v), lo, hi)),
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(T.flow_color(torch.from_numpy(v), torch.from_numpy(vy)).numpy(),
                               np.asarray(J.flow_color(jnp.asarray(v), jnp.asarray(vy))),
                               rtol=0, atol=TOL)
