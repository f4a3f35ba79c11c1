"""The port's ImResize (ops/imresize.py) against the JAX package's: the
numpy matrix builders bit for bit, the torch ops within 1e-5 (f32, summed
in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from caffe_rtpose_tpu.ops import imresize as J
from caffe_rtpose_tpu_torch.ops import imresize as T

SCALES = [(1, 1.0, 0.3), (3, 1.0, 0.3), (3, 0.9, 0.1), (3, 1.0, 0.15)]


@pytest.mark.parametrize("h,w,f", [(12, 16, 8), (13, 17, 8), (46, 82, 8)])
@pytest.mark.parametrize("s,start,gap", SCALES)
def test_matrices_bit_identical(h, w, f, s, start, gap):
    ay_t, ax_t = T._matrices(h, w, h * f, w * f, s, start, gap)
    ay_j, ax_j = J._matrices(h, w, h * f, w * f, s, start, gap)
    assert ay_t.dtype == ay_j.dtype == np.float32
    np.testing.assert_array_equal(ay_t, ay_j)
    np.testing.assert_array_equal(ax_t, ax_j)
    for n in range(s):
        assert T.scale_pads(h, w, n, start, gap) == J.scale_pads(h, w, n, start, gap)


@pytest.mark.parametrize("s,start,gap", SCALES)
def test_imresize_average_matches_jax(s, start, gap):
    rs = np.random.RandomState(s * 10 + int(gap * 100))
    low = rs.rand(s, 12, 16, 5).astype(np.float32) * 2 - 1
    ref = np.asarray(J.imresize_average(jnp.asarray(low), 96, 128, start, gap))
    got = T.imresize_average(torch.from_numpy(low), 96, 128, start, gap).numpy()
    assert got.shape == ref.shape == (1, 96, 128, 5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("s,start,gap", SCALES)
def test_axis_weights_dense_matches_jax(s, start, gap):
    h, w, th, tw = 12, 16, 96, 128
    coords = np.arange(-2, tw + 2, dtype=np.int32)
    for n in range(s):
        padh, padw = J.scale_pads(h, w, n, start, gap)
        for src, pad, tgt in ((h, padh, th), (w, padw, tw)):
            ref = np.asarray(J.axis_weights_dense(jnp.asarray(coords), src, pad, tgt))
            got = T.axis_weights_dense(torch.from_numpy(coords), src, pad, tgt).numpy()
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
            # in range, the dense rows are the numpy matrix's rows
            inr = (coords >= 0) & (coords < tgt)
            np.testing.assert_allclose(got[inr], J._axis_matrix(src, pad, tgt), atol=1e-5)
