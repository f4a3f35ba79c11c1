"""The port's limb scoring and assembly (pose/connect.py) against the JAX
package's: pair counts exact, pair scores within 1e-4 relative (f32 sums in
another order), the copied numpy assembly exactly, and the port's own
native binding against the copied assembly."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caffe_rtpose_tpu.pose import connect as JC
from caffe_rtpose_tpu_torch import native as TN
from caffe_rtpose_tpu_torch.pose import connect as TC
from caffe_rtpose_tpu_torch.pose.descriptor import COCO_18, MPI_15


def _random_peaks(rs, num_parts, max_peaks, th, tw, lo=1, hi=6):
    peaks = np.zeros((num_parts, max_peaks + 1, 3), np.float32)
    for p in range(num_parts):
        n = rs.randint(lo, hi)
        peaks[p, 0, 0] = n
        for i in range(1, min(n, max_peaks) + 1):
            peaks[p, i] = (rs.uniform(0, tw - 1), rs.uniform(0, th - 1), rs.rand())
    return peaks


@pytest.mark.parametrize("desc", [COCO_18, MPI_15], ids=["coco", "mpi"])
@pytest.mark.parametrize("s,start,gap", [(1, 1.0, 0.3), (3, 0.9, 0.1)])
def test_score_pairs_lowres_matches_jax(desc, s, start, gap):
    rs = np.random.RandomState(s + desc.num_parts)
    h, w, f = 12, 16, 8
    th, tw = h * f, w * f
    c_total = 57 if desc is COCO_18 else 44
    low = rs.rand(s, h, w, c_total).astype(np.float32) * 2 - 1
    peaks = _random_peaks(rs, desc.num_parts, 16, th, tw)
    peaks[0, 2, :2] = peaks[0, 1, :2]  # a coincident pair scores nothing
    thr = 0.05
    s_j, c_j = jax.jit(JC.score_pairs_lowres, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(low), jnp.asarray(peaks), desc, (th, tw), start, gap, jnp.float32(thr))
    s_t, c_t = TC.score_pairs_lowres(torch.from_numpy(low)[None], torch.from_numpy(peaks)[None],
                                     desc, (th, tw), start, gap, thr)
    s_t, c_t = s_t[0], c_t[0]
    assert c_t.dtype == torch.int32 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4, atol=0)
    assert c_t.numpy().sum() > 0


def _assembly_inputs(rs, desc, max_peaks=12):
    th, tw = 96, 128
    peaks = _random_peaks(rs, desc.num_parts, max_peaks, th, tw, lo=0, hi=9)
    L = desc.num_limbs
    score = (rs.rand(L, max_peaks, max_peaks) * 12).astype(np.float16).astype(np.float32)
    count = rs.randint(0, 11, size=(L, max_peaks, max_peaks)).astype(np.int32)
    return peaks, score, count


@pytest.mark.parametrize("desc", [COCO_18, MPI_15], ids=["coco", "mpi"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assemble_copy_matches_jax(desc, seed):
    rs = np.random.RandomState(seed)
    peaks, score, count = _assembly_inputs(rs, desc)
    for pc in (desc.defaults,
               dataclasses.replace(desc.defaults, min_subset_score=-10.0, min_subset_cnt=0)):
        ref = JC.assemble(peaks, score, count, desc, pc, scale_xy=(1.5, 0.75))
        got = TC.assemble(peaks, score, count, desc, pc, scale_xy=(1.5, 0.75))
        assert got.num_people == ref.num_people
        np.testing.assert_array_equal(got.joints, ref.joints)
        assert len(got.subsets) == len(ref.subsets)
        for a, b in zip(got.subsets, ref.subsets):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("desc", [COCO_18, MPI_15], ids=["coco", "mpi"])
@pytest.mark.parametrize("seed", [3, 4])
def test_native_assembly_matches_copied_assemble(desc, seed):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build native/pose_host.cpp")
    assert TN.load() is not None
    rs = np.random.RandomState(seed)
    peaks, score, count = _assembly_inputs(rs, desc)
    pc = dataclasses.replace(desc.defaults, min_subset_score=-10.0, min_subset_cnt=0)
    ref = TC.assemble(peaks, score, count, desc, pc, scale_xy=(2.0, 0.5))
    joints, n = TN.assemble_native(peaks, score, count, desc, pc, (2.0, 0.5))
    assert n == ref.num_people and n > 0
    np.testing.assert_allclose(joints, ref.joints, rtol=1e-6)
    fast = TC.assemble_fast(peaks, score, count, desc, pc, (2.0, 0.5))
    assert fast.num_people == n


def test_native_assembly_rejects_mismatched_shapes():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build native/pose_host.cpp")
    rs = np.random.RandomState(5)
    peaks, score, count = _assembly_inputs(rs, COCO_18)
    with pytest.raises(ValueError):
        TN.assemble_native(peaks, score[:, :4], count, COCO_18, COCO_18.defaults)


@pytest.mark.parametrize("desc", [COCO_18, MPI_15], ids=["coco", "mpi"])
def test_score_pairs_matches_jax(desc):
    """Full-res scoring (the heatmap path): gathers from the PAF planes, the
    COCO clamp (MPI has none), the always-on clip and the distinct gate.
    Peaks reach the map's last row and column, so the clamps act."""
    rs = np.random.RandomState(10 + desc.num_parts)
    th, tw = 96, 128
    c_total = 57 if desc is COCO_18 else 44
    heat = rs.rand(c_total, th, tw).astype(np.float32) * 2 - 1
    peaks = _random_peaks(rs, desc.num_parts, 16, th, tw)
    peaks[0, 2, :2] = peaks[0, 1, :2]  # a coincident pair scores nothing
    peaks[1, 1, :2] = (tw - 0.6, th - 0.6)  # rounds past the last pixel
    thr = 0.05
    s_j, c_j = JC.score_pairs(jnp.asarray(heat), jnp.asarray(peaks), desc, jnp.float32(thr))
    s_t, c_t = TC.score_pairs(torch.from_numpy(heat), torch.from_numpy(peaks), desc, thr)
    assert c_t.dtype == torch.int32 and s_t.dtype == torch.float32
    assert s_t.shape == (desc.num_limbs, 16, 16)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=1e-5)
    assert c_t.numpy().sum() > 0


@pytest.mark.parametrize("desc", [COCO_18, MPI_15], ids=["coco", "mpi"])
def test_host_oracles_match_jax(desc):
    """ROADMAP A.3: ``score_pairs_np`` (the loop oracle) equal to JAX's and
    to the port's device ``score_pairs``; ``connect_limbs`` equal to JAX's;
    ``distance_threshold_peaks`` equal to JAX's (peaks 4 px apart merge)."""
    rs = np.random.RandomState(20 + desc.num_parts)
    th, tw = 48, 64
    c_total = 57 if desc is COCO_18 else 44
    heat = rs.rand(c_total, th, tw).astype(np.float32) * 2 - 1
    peaks = _random_peaks(rs, desc.num_parts, 8, th, tw)
    peaks[1, 2, :2] = peaks[1, 1, :2] + 4.0
    s_n, c_n = TC.score_pairs_np(heat, peaks, desc, 0.05)
    s_j, c_j = JC.score_pairs_np(heat, peaks, desc, 0.05)
    np.testing.assert_array_equal(s_n, s_j)
    np.testing.assert_array_equal(c_n, c_j)
    # the device scores every slot; the oracle only the peaks each part has
    s_t, c_t = TC.score_pairs(torch.from_numpy(heat), torch.from_numpy(peaks), desc, 0.05)
    n = peaks[:, 0, 0].astype(int)
    live = np.zeros_like(c_n, bool)
    for k in range(desc.num_limbs):
        a, b = desc.limb(k)
        live[k, : n[a], : n[b]] = True
    np.testing.assert_array_equal(c_t.numpy()[live], c_n[live])
    np.testing.assert_allclose(s_t.numpy()[live], s_n[live], rtol=0, atol=1e-5)
    pc = dataclasses.replace(desc.defaults, min_subset_score=-10.0, min_subset_cnt=0,
                             inter_threshold=-10.0, inter_min_above_threshold=0)
    got = TC.connect_limbs(heat, peaks, desc, pc, scale_xy=(2.0, 2.0))
    ref = JC.connect_limbs(heat, peaks, desc, pc, scale_xy=(2.0, 2.0))
    assert got.num_people == ref.num_people > 0
    np.testing.assert_array_equal(got.joints, ref.joints)
    for thr in (6.0, 1.0):
        np.testing.assert_array_equal(TC.distance_threshold_peaks(peaks, thr),
                                      JC.distance_threshold_peaks(peaks, thr))
    assert TC.distance_threshold_peaks(peaks)[1, 0, 0] < peaks[1, 0, 0]
