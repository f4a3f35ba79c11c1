"""What the host computes for the upsample-keys kernel K3
(csrc/upsample_peak_keys.cu), checked on the CPU:

* the tiling: the tile height R (ops/nms_cuda.keys_tile_rows) computes the
  fewest rows; each 32-column x R-row tile's window (per scale, rows and
  columns) covers every nonzero tap of its outputs and halo; the tap tables
  hold the clamped window-relative offsets the kernel reads; a block's
  shared memory fits the budget;
* the store geometry: the two TMA maps' dims, 16-byte strides and boxes,
  which widths take the TMA path and which the direct one, and a shape the
  kernel cannot take is refused, naming it;
* a numpy emulation of the kernel at its tiling, from those tables, in its
  FMA order (taps k = 0..3 from 0, scales summed in order, then x 1/S; the
  lane walk of the key pass with the halo columns) against the plain
  ``imresize_average`` within 1e-6 * max(1, |U|) (f32 sums of the same taps
  in another order; the emulation rounds each FMA from f64), its keys
  against the plain version's up to near-ties, and against the JAX Pallas
  kernel in interpret mode (heat within 1e-5, tests/test_torch_upsample_
  keys.py's tolerance).
"""

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu_torch.ops import nms_cuda
from caffe_rtpose_tpu_torch.ops.imresize import imresize_average

CASES = [  # S, start, gap, h, w, factor: chip_smoke.py's K3 shapes
    (1, 1.0, 0.3, 46, 82, 8),
    (3, 1.0, 0.3, 46, 82, 8),
    (3, 0.9, 0.1, 46, 82, 8),
    (1, 1.0, 0.3, 12, 16, 8),
    (3, 0.9, 0.1, 13, 17, 8),
]
TX = nms_cuda.KEYS_TILE_X


def test_tile_rows_compute_the_fewest_rows():
    assert nms_cuda.keys_tile_rows(368) == 46  # 8 tiles of 48 computed rows, against 13 x 32
    assert nms_cuda.keys_tile_rows(104) == 30  # 4 x 32, against 3 x 48
    for th in (8, 96, 101, 104, 368, 736, 1000):
        r = nms_cuda.keys_tile_rows(th)
        cost = lambda rr: -(-th // rr) * (rr + 2)  # noqa: E731
        assert r in nms_cuda.KEYS_ROWS and (r + 2) % 16 == 0
        assert cost(r) == min(cost(rr) for rr in nms_cuda.KEYS_ROWS)


@pytest.mark.parametrize("s,start,gap,h,w,f", CASES)
def test_windows_and_tap_tables(s, start, gap, h, w, f):
    th, tw = h * f, w * f
    geo = nms_cuda.keys_geometry(h, w, th, tw, s, start, gap)
    dense = nms_cuda.tile_geometry(h, w, th, tw, s, start, gap)  # K1's taps: one source of truth
    r, r2 = geo.rows, geo.rows + 2
    assert (geo.tiles_y, geo.tiles_x) == (-(-th // r), -(-tw // TX))
    for idx, wgt, win, tab_w, tab_off, n_out, tile, outs, pitch in (
            (dense.ytap_idx, dense.ytap_w, geo.ywin, geo.ytap_w, geo.ytap_off, th, r,
             lambda t: t * r - 1 + np.arange(r2), geo.wp),
            (dense.xtap_idx, dense.xtap_w, geo.xwin, geo.xtap_w, geo.xtap_off, tw, TX,
             lambda t: t * TX + np.r_[np.arange(TX), -1, TX], r + 6)):
        assert win.shape == (s, -(-n_out // tile), 2)
        for t in range(win.shape[1]):
            for sc in range(s):
                first, count = win[sc, t]
                for e, o in enumerate(outs(t)):
                    if not 0 <= o < n_out:  # outside the map: zero weights, as the pad taps
                        assert (tab_w[sc, t, e] == 0).all()
                        continue
                    nz = wgt[sc, o] != 0
                    assert (idx[sc, o][nz] >= first).all() and (idx[sc, o][nz] < first + count).all()
                    np.testing.assert_array_equal(tab_w[sc, t, e], wgt[sc, o])
                    rel = np.clip(idx[sc, o] - first, 0, count - 1)
                    np.testing.assert_array_equal(tab_off[sc, t, e], rel * pitch)
    assert geo.wh == geo.ywin[..., 1].max()
    assert geo.wp % 4 == 0 and 0 <= geo.wp - geo.xwin[..., 1].max() < 4  # 16-byte window rows
    assert geo.smem == nms_cuda._keys_smem_bytes(s, r, geo.wh, geo.wp) <= nms_cuda.SMEM_BUDGET
    if (h, w, s) == (46, 82, 1):  # COCO: 6 blocks (24 warps) an SM of 228 KB, 1 KB each reserved
        assert 6 * (geo.smem + 1024) <= 228 * 1024


def test_store_geometry_and_paths():
    maps = nms_cuda.keys_tensor_maps(368, 656, 57, 18, 46)
    assert maps["heat"] == ((656, 368, 57), (2624, 965632), (32, 46, 1))
    assert maps["keys"] == ((328, 368, 18), (1312, 482816), (16, 46, 1))
    for dims, strides, box in maps.values():
        assert all(st % 16 == 0 for st in strides) and box[0] * 4 % 16 == 0
        assert max(box) <= 256
    for th, tw in ((368, 656), (104, 136), (96, 128), (101, 8)):
        assert nms_cuda.keys_store_path(th, tw) == "tma"
    for th, tw in ((101, 134), (96, 132), (96, 129), (13, 17)):  # a row of f32 or int32 pairs
        assert nms_cuda.keys_store_path(th, tw) == "direct"       # no multiple of 16 bytes
    with pytest.raises(ValueError, match="multiple of 16"):
        nms_cuda.keys_geometry(46, 82, 368, 656, 1, 1.0, 0.3, rows=32)


def test_a_window_too_wide_for_shared_memory_is_refused():
    """A target smaller than the map (factor 1/4) needs ~130-column windows."""
    with pytest.raises(ValueError, match=r"100x250 from 400x1000 .* shared memory"):
        nms_cuda._device_keys_geometry(400, 1000, 100, 250, 1, 1.0, 0.3, torch.device("cpu"))


def _fma(a, b, c):
    """f32 fmaf, from an exact f64 product (both factors are f32)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_kernel(low: np.ndarray, th: int, tw: int, start: float, gap: float, thr: float,
                   kc: int):
    """(S, h, w, C) -> heat (C, th, tw), keys (kc, th*(tw//2)): the kernel's
    steps on each 32 x R tile, all channels at once, from keys_geometry's
    tables: the windows, Vt from the row taps, the horizontal pass and the
    halo columns from the column taps into the (R+2) x 34 box, the scale
    sum (the first scale stored as it is), x 1/S where S > 1, and the key
    pass over the box with its halo columns."""
    s, h, w, c = low.shape
    geo = nms_cuda.keys_geometry(h, w, th, tw, s, start, gap)
    r, r2, wp, vtp = geo.rows, geo.rows + 2, geo.wp, geo.rows + 6
    heat = np.zeros((c, th, tw), np.float32)
    keys = np.zeros((kc, th, tw // 2), np.int32)
    rows, cols = np.arange(r2), np.arange(wp)
    for ty in range(geo.tiles_y):
        for tx in range(geo.tiles_x):
            box = np.zeros((c, r2, TX + 2), np.float32)  # the 32 columns, then x0-1, x0+32
            for sc in range(s):
                (fy, cy), (fx, cx) = geo.ywin[sc, ty], geo.xwin[sc, tx]
                win = np.zeros((c, geo.wh, wp), np.float32)
                win[:, :cy, :cx] = low[sc, fy : fy + cy, fx : fx + cx].transpose(2, 0, 1)
                flat = win.reshape(c, -1)
                yw, yo = geo.ytap_w[sc, ty], geo.ytap_off[sc, ty]  # (R+2, 4)
                v = np.zeros((c, r2, wp), np.float32)
                for k in range(4):
                    v = _fma(yw[None, :, k, None], flat[:, yo[:, k, None] + cols[None]], v)
                v[:, :, cx:] = np.nan  # columns past this tile's window: never to be read
                vt = np.zeros((c, wp, vtp), np.float32)  # Vt: column-major, pitch R+6
                vt[:, :, :r2] = v.transpose(0, 2, 1)
                vt = vt.reshape(c, -1)
                xw, xo = geo.xtap_w[sc, tx], geo.xtap_off[sc, tx]  # (34, 4)
                u = np.zeros((c, r2, TX + 2), np.float32)
                for k in range(4):
                    u = _fma(xw[None, None, :, k], vt[:, xo[None, :, k] + rows[:, None]], u)
                box = u if sc == 0 else (box + u).astype(np.float32)
            if s > 1:
                box = (box * np.float32(1.0 / s)).astype(np.float32)
            y0, x0 = ty * r, tx * TX
            ye, xe = min(y0 + r, th), min(x0 + TX, tw)
            heat[:, y0:ye, x0:xe] = box[:, 1 : 1 + ye - y0, : xe - x0]
            ext = np.concatenate([box[:kc, :, TX:TX + 1], box[:kc, :, :TX],
                                  box[:kc, :, TX + 1:]], axis=2)  # columns x0-1 .. x0+32
            mid = ext[:, 1:-1, 1:-1]
            n8 = np.max([ext[:, 1 + dy : r2 - 1 + dy, 1 + dx : TX + 1 + dx]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx], axis=0)
            y = y0 + np.arange(r)[:, None]
            x = x0 + np.arange(TX)[None]
            inside = (y >= 1) & (y <= th - 2) & (x >= 1) & (x <= tw - 2)
            peak = inside & (mid > thr) & (mid > n8)  # (kc, R, 32)
            pos = y * tw + x
            key = np.where(peak[..., 0::2], th * tw - pos[:, 0::2],
                           np.where(peak[..., 1::2], th * tw - pos[:, 0::2] - 1, 0))
            kx = min(TX // 2, tw // 2 - x0 // 2)
            keys[:, y0:ye, x0 // 2 : x0 // 2 + kx] = key[:, : ye - y0, :kx]
    return heat, keys.reshape(kc, -1)


def _near_tie_ok(got, ref, heat, thr):
    """Per channel, the nonzero keys hold the same positions, except at a
    near-tie of ``heat`` (|U - thr| or |U - max8| within 1e-5 * max(1, |U|))."""
    hw = heat.shape[1] * heat.shape[2]
    for c in range(got.shape[0]):
        for pos in set(hw - got[c][got[c] > 0]) ^ set(hw - ref[c][ref[c] > 0]):
            y, x = divmod(int(pos), heat.shape[2])
            u = float(heat[c, y, x])
            nb = heat[c, y - 1 : y + 2, x - 1 : x + 2].astype(np.float64).copy()
            nb[1, 1] = -np.inf
            tol = 1e-5 * max(1.0, abs(u))
            assert abs(u - thr) <= tol or abs(u - nb.max()) <= tol, (c, pos)


@pytest.mark.parametrize("s,start,gap,h,w,f,c,kc", [
    (1, 1.0, 0.3, 46, 82, 8, 6, 4), (3, 0.9, 0.1, 46, 82, 8, 4, 4),
    (3, 0.9, 0.1, 13, 17, 8, 8, 5)])
def test_emulated_kernel_equals_the_plain_version(s, start, gap, h, w, f, c, kc):
    rs = np.random.RandomState(7 * h + s)
    low = rs.rand(s, h, w, c).astype(np.float32) * 2 - 1
    th, tw, thr = h * f, w * f, 0.1
    heat, keys = emulate_kernel(low, th, tw, start, gap, thr, kc)
    ref = imresize_average(torch.from_numpy(low), th, tw, start, gap)[0].permute(2, 0, 1).numpy()
    err = np.abs(heat - ref)
    assert (err <= 1e-6 * np.maximum(1.0, np.abs(ref))).all(), float(err.max())
    r_heat, r_keys = nms_cuda.upsample_peak_keys_reference(torch.from_numpy(low), (th, tw), start,
                                                           gap, thr, kc)
    r_keys = r_keys.numpy()
    assert keys.shape == r_keys.shape and (r_keys > 0).sum() > kc
    _near_tie_ok(keys, r_keys, r_heat.numpy(), thr)


@pytest.mark.parametrize("s,start,gap", [(1, 1.0, 0.3), (3, 0.9, 0.1)])
def test_emulated_kernel_equals_jax_pallas_interpret(s, start, gap):
    import jax.numpy as jnp

    from caffe_rtpose_tpu.ops.nms_pallas import upsample_peak_keys as j_upsample

    rs = np.random.RandomState(30 + s)
    low = rs.rand(s, 12, 16, 7).astype(np.float32) * 2 - 1
    th, tw, thr = 96, 128, 0.1
    j_heat, j_kb = j_upsample(jnp.asarray(low), (th, tw), start, gap, jnp.float32(thr),
                              interpret=True)
    j_heat, j_kb = np.asarray(j_heat), np.asarray(j_kb)
    heat, keys = emulate_kernel(low, th, tw, start, gap, thr, 7)
    np.testing.assert_allclose(heat, j_heat, rtol=0, atol=1e-5)
    assert (j_kb > 0).sum() > 7
    _near_tie_ok(keys, j_kb, j_heat, thr)
