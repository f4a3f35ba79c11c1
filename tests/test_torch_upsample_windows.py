"""The source windows of the peak-mask kernel K1 (csrc/peak_mask.cu),
computed on the host by ops/nms_cuda.tile_geometry, checked on the CPU
(K3's tiling: tests/test_torch_upsample_store.py):

* each 32x64 tile's window (per scale, rows and columns) covers every
  nonzero tap of every output row and column the tile serves, the one-pixel
  halo included, and is no wider than those taps reach; the widest window
  fits a block's shared-memory budget;
* a numpy emulation of the kernels' windowed upsample, in their FMA order
  (taps k = 0..3 from 0, scales summed in order, then x 1/S), equals the
  plain ``imresize_average`` within 1e-6 * max(1, |U|) (f32 sums of the same
  taps in another order; the emulation rounds each FMA from f64) and the
  JAX ``imresize_average`` within 1e-5 (tests/test_torch_imresize.py's
  tolerance).

The shapes are those chip_smoke.py gives K1 (COCO 1 and 3 scales with gaps
0.15 and 0.3, MPI 0.9/0.1, small, ragged 13x17), at the estimator's input
layout: the 18-channel slice of a 57-channel NHWC map.
"""

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu_torch.ops import imresize as t_imresize
from caffe_rtpose_tpu_torch.ops import nms_cuda

CASES = [  # S, start, gap, h, w, factor
    (1, 1.0, 0.3, 46, 82, 8),
    (3, 1.0, 0.15, 46, 82, 8),
    (3, 1.0, 0.3, 46, 82, 8),
    (3, 0.9, 0.1, 46, 82, 8),
    (1, 1.0, 0.3, 12, 16, 8),
    (3, 0.9, 0.1, 12, 16, 8),
    (1, 1.0, 0.3, 13, 17, 8),
    (3, 0.9, 0.1, 13, 17, 8),
]
TY, TX = nms_cuda.TILE_Y, nms_cuda.TILE_X


def _slice_view(rs, s, h, w, c=18):
    """The estimator's ``low[..., :18]`` of a 57-channel NHWC map."""
    full = torch.from_numpy(rs.rand(s, h, w, 57).astype(np.float32) * 2 - 1)
    return full[..., :c]


@pytest.mark.parametrize("s,start,gap,h,w,f", CASES)
def test_windows_cover_every_tap_and_fit_shared_memory(s, start, gap, h, w, f):
    th, tw = h * f, w * f
    geo = nms_cuda.tile_geometry(h, w, th, tw, s, start, gap)
    for idx, wgt, win, n_out, tile in ((geo.ytap_idx, geo.ytap_w, geo.ywin, th, TY),
                                       (geo.xtap_idx, geo.xtap_w, geo.xwin, tw, TX)):
        assert win.shape == (s, -(-n_out // tile), 2)
        for t in range(win.shape[1]):
            lo, hi = max(t * tile - 1, 0), min((t + 1) * tile + 1, n_out)
            for sc in range(s):
                first, count = win[sc, t]
                reach = idx[sc, lo:hi][wgt[sc, lo:hi] != 0]
                assert count >= 1 and reach.size
                assert reach.min() == first and reach.max() == first + count - 1
        assert win[..., 1].max() == (geo.wh if tile == TY else geo.ww)
    assert geo.smem == nms_cuda._smem_bytes(s, geo.wh, geo.ww) <= nms_cuda.SMEM_BUDGET
    if (h, w) == (46, 82):  # COCO width: a few low-res pixels a tile, not the 82 columns
        assert geo.wh <= 10 and geo.ww <= 14


def test_window_loads_follow_the_strides():
    """16-byte window loads only where the layout allows them; the
    estimator's slice view and channel-major storage take scalar loads."""
    rs = np.random.RandomState(0)
    assert not nms_cuda.vec4_loads(_slice_view(rs, 1, 46, 82))
    chan_major = torch.from_numpy(rs.rand(1, 18, 46, 82).astype(np.float32)).permute(0, 2, 3, 1)
    assert chan_major.stride()[3] != 1 and not nms_cuda.vec4_loads(chan_major)
    assert nms_cuda.vec4_loads(torch.zeros(3, 46, 82, 20))
    assert not nms_cuda.vec4_loads(torch.zeros(1, 46, 82, 18))  # pixel stride 18


def _fma(a, b, c):
    """f32 fmaf, from an exact f64 product (both factors are f32)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_windowed_upsample(low: np.ndarray, th: int, tw: int, start: float, gap: float):
    """(S, h, w, C) -> (C, th, tw): bicubic_tile.cuh's stage_tile and
    upsample_channel, tile by tile, from the windows and tap tables of
    tile_geometry."""
    s, h, w, c = low.shape
    geo = nms_cuda.tile_geometry(h, w, th, tw, s, start, gap)
    out = np.zeros((c, th, tw), np.float32)
    ext_y, ext_x = TY + 2, TX + 2
    for ty in range(geo.ywin.shape[1]):
        for tx in range(geo.xwin.shape[1]):
            y = ty * TY - 1 + np.arange(ext_y)
            x = tx * TX - 1 + np.arange(ext_x)
            y_in, x_in = (y >= 0) & (y < th), (x >= 0) & (x < tw)
            acc = np.zeros((c, ext_y, ext_x), np.float32)
            for sc in range(s):
                (wy0, wyl), (wx0, wxl) = geo.ywin[sc, ty], geo.xwin[sc, tx]
                win = low[sc, wy0 : wy0 + wyl, wx0 : wx0 + wxl].transpose(2, 0, 1)  # (C, wyl, wxl)
                yc, xc = np.clip(y, 0, th - 1), np.clip(x, 0, tw - 1)
                yi = np.clip(geo.ytap_idx[sc, yc] - wy0, 0, wyl - 1)  # (ext_y, 4), relative
                yw = np.where(y_in[:, None], geo.ytap_w[sc, yc], 0).astype(np.float32)
                xi = np.clip(geo.xtap_idx[sc, xc] - wx0, 0, wxl - 1)
                xw = np.where(x_in[:, None], geo.xtap_w[sc, xc], 0).astype(np.float32)
                v = np.zeros((c, ext_y, wxl), np.float32)  # vertical pass, window columns only
                for k in range(4):
                    v = _fma(yw[None, :, k, None], win[:, yi[:, k], :], v)
                v[:, ~y_in] = 0.0
                u = np.zeros((c, ext_y, ext_x), np.float32)
                for k in range(4):
                    u = _fma(xw[None, None, :, k], v[:, :, xi[:, k]], u)
                acc = (acc + np.where(x_in[None, None, :], u, 0)).astype(np.float32)
            acc = (acc * np.float32(1.0 / s)).astype(np.float32)
            ys, xs = ty * TY, tx * TX
            ye, xe = min(ys + TY, th), min(xs + TX, tw)
            out[:, ys:ye, xs:xe] = acc[:, 1 : 1 + ye - ys, 1 : 1 + xe - xs]
    return out


@pytest.mark.parametrize("s,start,gap,h,w,f", CASES[:1] + CASES[2:4] + CASES[7:])
def test_windowed_upsample_equals_imresize(s, start, gap, h, w, f):
    import jax.numpy as jnp

    from caffe_rtpose_tpu.ops.imresize import imresize_average as j_imresize_average

    rs = np.random.RandomState(h * w + s)
    view = _slice_view(rs, s, h, w)
    low = np.ascontiguousarray(view.numpy())
    th, tw = h * f, w * f
    got = emulate_windowed_upsample(low, th, tw, start, gap)
    ref = t_imresize.imresize_average(view, th, tw, start, gap)[0].permute(2, 0, 1).numpy()
    assert got.shape == ref.shape == (18, th, tw)
    err = np.abs(got - ref)
    assert (err <= 1e-6 * np.maximum(1.0, np.abs(ref))).all(), float(err.max())
    jx = np.asarray(j_imresize_average(jnp.asarray(low), th, tw, start, gap))[0].transpose(2, 0, 1)
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-5)
