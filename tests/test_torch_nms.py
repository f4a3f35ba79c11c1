"""The port's NMS (ops/nms.py) against the JAX package's: key building and
compaction exactly, refinement within 1e-5 relative (f32 matmuls summed in
another order), with every reference quirk of refine_from_low."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from caffe_rtpose_tpu.ops import nms as J
from caffe_rtpose_tpu_torch.ops import nms as T


def _thinned_mask(rs, c, h, w, density):
    """Random masks with no two set pixels 8-adjacent and none on the border
    (what a strict-maximum mask guarantees)."""
    raw = rs.rand(c, h, w) < density
    raw[:, 0, :] = raw[:, -1, :] = False
    raw[:, :, 0] = raw[:, :, -1] = False
    mask = np.zeros_like(raw)
    for ch in range(c):
        for y in range(1, h - 1):
            for x in range(1, w - 1):
                if raw[ch, y, x] and not (mask[ch, y - 1, x - 1 : x + 2].any() or mask[ch, y, x - 1]):
                    mask[ch, y, x] = True
    return mask


@pytest.mark.parametrize("h,w", [(46, 82), (47, 83)])
@pytest.mark.parametrize("density,topk", [(0.002, 8), (0.05, 16), (0.4, 32), (0.9, 64)])
def test_block_keys_and_compaction_match_jax(h, w, density, topk):
    rs = np.random.RandomState(int(density * 1000) + topk + w)
    mask = _thinned_mask(rs, 3, h, w, density)
    kb_j = J.block_keys(jnp.asarray(mask), h, w)
    kb_t = T.block_keys(torch.from_numpy(mask), h, w)
    np.testing.assert_array_equal(kb_t.numpy(), np.asarray(kb_j))
    pos_j, val_j, cnt_j = map(np.asarray, jax.jit(J.compact_keys, static_argnums=(1, 2))(kb_j, h * w, topk))
    pos_t, val_t, cnt_t = (a.numpy() for a in T.compact_keys(kb_t, h * w, topk))
    np.testing.assert_array_equal(pos_t, pos_j)
    np.testing.assert_array_equal(val_t, val_j)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    for ch in range(3):  # and the raster scan itself, counts uncapped
        ref = np.flatnonzero(mask[ch].reshape(-1))
        assert cnt_t[ch] == len(ref)
        k = min(topk, len(ref))
        np.testing.assert_array_equal(pos_t[ch, :k], ref[:k])
    if density >= 0.05:  # dense masks overflow max_peaks
        assert (cnt_t > topk).any()


def test_find_peaks_mask_matches_jax():
    rs = np.random.RandomState(1)
    heat = rs.rand(4, 30, 41).astype(np.float32)
    heat[0, 10, 10] = heat[0, 10, 11] = 5.0  # a plateau is no strict peak
    for thr in (0.3, 0.9):
        ref = np.asarray(J.find_peaks_mask(jnp.asarray(heat), jnp.float32(thr)))
        got = T.find_peaks_mask(torch.from_numpy(heat), thr).numpy()
        np.testing.assert_array_equal(got, ref)


def _refine_both(low, pos_list, th, tw, max_peaks, start, gap, p):
    """Refine explicit peak positions (one list per channel) in both packages."""
    topk = min(max_peaks, th * tw)
    pos = np.zeros((p, topk), np.int32)
    cnt = np.zeros((p,), np.int32)
    for ch, lst in enumerate(pos_list):
        cnt[ch] = len(lst)
        pos[ch, : min(len(lst), topk)] = lst[:topk]
    val = np.arange(topk)[None, :] < cnt[:, None]
    ref = np.asarray(jax.jit(J.refine_from_low, static_argnums=(4, 5, 6, 7))(jnp.asarray(low), jnp.asarray(pos), jnp.asarray(val),
                                       jnp.asarray(cnt), (th, tw), max_peaks, start, gap))
    got = T.refine_from_low(torch.from_numpy(low), torch.from_numpy(pos), torch.from_numpy(val),
                            torch.from_numpy(cnt), (th, tw), max_peaks, start, gap).numpy()
    return got, ref


@pytest.mark.parametrize("s,start,gap", [(1, 1.0, 0.3), (3, 0.9, 0.1)])
def test_refine_from_low_wide_map_reads_next_channel(s, start, gap):
    """Wide map (tw > th): windows of peaks within 3 rows of the bottom
    cross into channel c+1, as the reference's flat-buffer reads do."""
    rs = np.random.RandomState(2)
    p, h, w = 4, 12, 16
    th, tw = 96, 128
    low = rs.rand(s, h, w, p + 1).astype(np.float32) * 2 - 0.5
    rows = [th - 1, th - 2, th - 3, 50, 1, 0]
    pos_list = [[y * tw + rs.randint(1, tw - 1) for y in sorted(rs.choice(rows, 4, replace=False))]
                for _ in range(p)]
    got, ref = _refine_both(low, pos_list, th, tw, 10, start, gap, p)
    assert got.shape == (p, 11, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # the crossing reads matter: without channel p the result differs
    alone, _ = _refine_both(low[..., :p], pos_list, th, tw, 10, start, gap, p)
    assert not np.allclose(alone, got, equal_nan=True)


def test_refine_from_low_tall_map_nan_and_capped_count():
    """Tall map (th > tw): a peak at y >= tw + 3 has its whole window cut by
    the y-vs-width check, so its coords are 0/0 = NaN (score intact); and
    slot 0 caps the count at max_peaks."""
    rs = np.random.RandomState(3)
    p, h, w = 3, 16, 12
    th, tw = 128, 96
    low = rs.rand(1, h, w, p).astype(np.float32)
    pos_list = [[10 * tw + 20, 110 * tw + 40, 120 * tw + 5],
                [(5 + 3 * i) * tw + 7 + 2 * i for i in range(9)],  # 9 peaks > max_peaks
                []]
    got, ref = _refine_both(low, pos_list, th, tw, 6, 1.0, 0.3, p)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)  # NaNs compare equal
    assert np.isnan(got[0, 2:4, :2]).all() and np.isfinite(got[0, 2:4, 2]).all()
    assert got[1, 0, 0] == 6 and got[2, 0, 0] == 0
    assert not np.isnan(got[1:]).any()


@pytest.mark.parametrize("s,start,gap", [(1, 1.0, 0.3), (3, 0.9, 0.1)])
def test_refined_peaks_lowres_matches_jax(s, start, gap):
    rs = np.random.RandomState(4)
    p, th, tw = 5, 96, 128
    low = rs.rand(s, 12, 16, p + 1).astype(np.float32) * 2 - 1
    from caffe_rtpose_tpu.ops.imresize import imresize_average
    heat = jnp.transpose(imresize_average(jnp.asarray(low[..., :p]), th, tw, start, gap)[0], (2, 0, 1))
    ref = np.asarray(jax.jit(J.refined_peaks_lowres, static_argnums=(3, 4, 5))(
        jnp.asarray(low), heat, jnp.float32(0.1), 12, start, gap))
    got = T.refined_peaks_lowres(torch.from_numpy(low), torch.from_numpy(np.array(heat)),
                                 0.1, 12, start, gap).numpy()
    np.testing.assert_array_equal(got[:, 0, 0], ref[:, 0, 0])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _planted_heat(rs, c, h, w, rows, noise=0.5):
    """Noise below ``noise`` plus one planted peak (> 1) per channel on each
    of ``rows``."""
    heat = rs.rand(c, h, w).astype(np.float32) * noise
    for ch in range(c):
        for y in rows:
            heat[ch, y, rs.randint(1, w - 1)] = 1.0 + rs.rand()
    return heat


def _nms_both(heat, thr, max_peaks, num_parts=None):
    ref = np.asarray(jax.jit(J.nms_peaks, static_argnums=(2, 3))(
        jnp.asarray(heat), jnp.float32(thr), max_peaks, num_parts))
    got = T.nms_peaks(torch.from_numpy(heat), thr, max_peaks, num_parts).numpy()
    return got, ref


def test_nms_peaks_wide_map_reads_next_channel():
    """57-channel wide map, NMS on the first 18: peaks within 3 rows of a
    channel's bottom refine over rows of channel c+1."""
    rs = np.random.RandomState(6)
    h, w = 24, 40
    heat = _planted_heat(rs, 57, h, w, rows=[h - 2, h - 3, h - 4, 10])
    got, ref = _nms_both(heat, 0.8, 16, num_parts=18)
    assert got.shape == (18, 17, 3)
    np.testing.assert_array_equal(got[:, 0, 0], ref[:, 0, 0])
    assert (got[:, 0, 0] >= 3).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    alone, _ = _nms_both(heat[:18], 0.8, 16)  # without channel c+1 the windows differ
    assert not np.allclose(alone, got)


def test_nms_peaks_tall_map_nan():
    """Tall map: a peak at y >= W+3 has its whole window cut by the
    y-vs-width check, so its coords are 0/0 = NaN (score intact)."""
    rs = np.random.RandomState(7)
    heat = _planted_heat(rs, 3, 60, 20, rows=[5, 40, 50])
    got, ref = _nms_both(heat, 0.8, 6)
    np.testing.assert_array_equal(got[:, 0, 0], ref[:, 0, 0])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)  # NaNs compare equal
    assert np.isnan(got[:, 2:4, :2]).all() and np.isfinite(got[:, 1:4, 2]).all()


@pytest.mark.parametrize("ordered", [True, False])
def test_peaks_from_keys_more_peaks_than_max(ordered):
    """Dense noise: more strict peaks than max_peaks in every channel; the
    first max_peaks in raster order, counts capped, in both compactions."""
    rs = np.random.RandomState(8)
    heat = rs.rand(5, 30, 41).astype(np.float32)
    mask = np.asarray(J.find_peaks_mask(jnp.asarray(heat[:4]), jnp.float32(0.3)))
    kb = np.array(J.block_keys(jnp.asarray(mask), 30, 41))
    ref = np.asarray(jax.jit(J.peaks_from_keys, static_argnums=(2, 3))(
        jnp.asarray(heat), jnp.asarray(kb), 8, ordered))
    got = T.peaks_from_keys(torch.from_numpy(heat), torch.from_numpy(kb), 8,
                            ordered=ordered).numpy()
    assert (mask.reshape(4, -1).sum(1) > 8).all()
    np.testing.assert_array_equal(got[:, 0, 0], ref[:, 0, 0])
    assert (got[:, 0, 0] == 8).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    same = T.nms_peaks(torch.from_numpy(heat), 0.3, 8, num_parts=4).numpy()
    np.testing.assert_array_equal(got, same)
