"""K4's weight packing (ops/conv1_cuda.Conv1Weights.pack) on the CPU: the
layouts the kernel's wgmma descriptors and its im2col read.

* conv1_2: per tap (ky, kx) a 64 (c_out) x 64 (c_in) K-major bf16 tile in
  the 128-byte swizzle (row n's 16-byte chunk c stored at chunk c ^ (n % 8));
  it unpacks to the (576, 64) GEMM operand exactly;
* conv1_1: K = 27 (ky, kx, c) padded with zeros to the kernel's 32 (and to
  64 columns of storage), same swizzle; applied by a plain matmul over an
  im2col of the padded input, it equals F.conv2d with the bf16-valued
  weights, within f32 summation order (1e-5 absolute at these magnitudes).
"""

import numpy as np
import torch
import torch.nn.functional as F

from caffe_rtpose_tpu_torch.ops import conv1_cuda


def _weights(seed):
    rs = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (t(rs.randn(64, 3, 3, 3) * 0.1), t(rs.randn(64) * 0.1),
            t(rs.randn(64, 64, 3, 3) * 0.05), t(rs.randn(64) * 0.1))


def test_w2_layout_is_the_swizzled_k_major_tile_and_unpacks_exactly():
    w1, b1, w2, b2 = _weights(0)
    cw = conv1_cuda.Conv1Weights.pack(w1, b1, w2, b2)
    assert cw.w2_p.shape == (9, 64, 64) and cw.w2_p.dtype == torch.bfloat16
    assert cw.w2_p.is_contiguous()
    w2b = w2.to(torch.bfloat16)
    n, k = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        col = ((k // 8) ^ (n % 8)) * 8 + k % 8  # where (c_out n, c_in k) is stored
        assert torch.equal(cw.w2_p[tap][torch.from_numpy(n), torch.from_numpy(col)],
                           w2b[:, :, ky, kx])
    expect = w2b.permute(2, 3, 1, 0).reshape(576, 64)  # rows (ky, kx, c_in)
    assert torch.equal(cw.w2_matrix(), expect)


def test_w1_padded_to_32_applied_over_im2col_equals_conv2d():
    w1, b1, w2, b2 = _weights(1)
    cw = conv1_cuda.Conv1Weights.pack(w1, b1, w2, b2)
    assert cw.w1_p.shape == (64, 64) and cw.w1_p.dtype == torch.bfloat16
    k1 = conv1_cuda._sw128(cw.w1_p)  # unswizzled: (c_out, K of 64)
    assert not k1[:, 27:].any()  # the zero rows the kernel's K = 32 reads, and the rest
    m = cw.w1_matrix()
    assert m.shape == (32, 64) and m.dtype == torch.float32
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.rand(2, 3, 20, 28).astype(np.float32) - 0.5)
    x = x.to(torch.bfloat16).float()
    xp = F.pad(x, (1, 1, 1, 1))
    cols = torch.stack([xp[:, c, ky : ky + 20, kx : kx + 28]
                        for ky in range(3) for kx in range(3) for c in range(3)], -1)
    cols = F.pad(cols, (0, 5))  # K = 27 -> 32
    got = cols @ m + b1
    ref = F.conv2d(x, w1.to(torch.bfloat16).float(), b1, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_swizzle_is_its_own_inverse():
    a = torch.arange(3 * 16 * 64, dtype=torch.float32).reshape(3, 16, 64).to(torch.bfloat16)
    assert torch.equal(conv1_cuda._sw128(conv1_cuda._sw128(a)), a)
    assert not torch.equal(conv1_cuda._sw128(a), a)
