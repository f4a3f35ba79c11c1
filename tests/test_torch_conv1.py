"""K4, the fused conv1 block (ops/conv1_cuda.py): its plain PyTorch version
against the JAX package's Pallas kernel (run in interpret mode, as
tests/test_conv1_pallas.py runs it on the CPU) and against the JAX XLA
chain (ops/nn.py conv2d + reduce_window max pool); the kernel's weight
packing against F.conv2d; on a CUDA card, the hand-written kernel against
the plain version.

Tolerance, as tests/test_conv1_pallas.py holds the Pallas kernel to the XLA
chain: two bf16 ulps relative to each element's magnitude, 2^-7 * max(|a|,
|b|), with an absolute floor of 2^-13 for near-zero post-ReLU values.  The
two sides take the same f32 sums of the same exact bf16 products in other
orders: one ulp comes from the order, one more where the f32 sums straddle a
bf16 rounding boundary (in conv1_1's output, which conv1_2 then reads).

The CUDA case imports no jax (the card's machine has none; run it there with
``python -m pytest --noconftest -m cuda tests/test_torch_conv1.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from caffe_rtpose_tpu_torch.ops import conv1_cuda

SHAPES = [(2, 64, 96), (1, 32, 656), (3, 48, 64)]


def _close(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    tol = np.maximum(np.maximum(np.abs(a), np.abs(b)) * 2 ** -7, 2 ** -13)
    bad = np.abs(a - b) > tol
    assert not bad.any(), f"{int(bad.sum())} elements beyond 2 bf16 ulps, max {np.abs(a - b).max()}"
    return float(np.abs(a - b).max())


def _inputs(shape, seed, const=None):
    """x (B, H, W, 3) f32 holding bf16 values, HWIO weights and biases in
    the draws of tests/test_conv1_pallas.py."""
    B, H, W = shape
    rs = np.random.RandomState(seed)
    if const is None:
        x = rs.rand(B, H, W, 3).astype(np.float32) - 0.5
    else:
        x = np.full((B, H, W, 3), const, np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    w1 = rs.randn(3, 3, 3, 64).astype(np.float32) * 0.1
    b1 = rs.randn(64).astype(np.float32) * 0.1
    w2 = rs.randn(3, 3, 64, 64).astype(np.float32) * 0.05
    b2 = rs.randn(64).astype(np.float32) * 0.1
    if const is not None:
        b1, b2 = np.zeros_like(b1), np.zeros_like(b2)
    return x, w1, b1, w2, b2


def _port(x, w1, b1, w2, b2, device="cpu"):
    """numpy NHWC/HWIO -> the port's (B, 3, H, W) bf16 channels_last input
    and packed weights."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(device, torch.bfloat16)
    xt = xt.contiguous(memory_format=torch.channels_last)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    cw = conv1_cuda.Conv1Weights.pack(t(w1.transpose(3, 2, 0, 1)), t(b1),
                                      t(w2.transpose(3, 2, 0, 1)), t(b2))
    return xt, cw


def _nhwc(y):
    return y.float().permute(0, 2, 3, 1).cpu().numpy()


def _jax(x, w1, b1, w2, b2):
    """(Pallas kernel in interpret mode, XLA chain) on the same inputs."""
    import jax
    import jax.numpy as jnp

    from caffe_rtpose_tpu.ops.conv1_pallas import conv1_block_pallas
    from caffe_rtpose_tpu.ops.nn import conv2d

    xj = jnp.asarray(x, jnp.bfloat16)
    args = [jnp.asarray(a) for a in (w1, b1, w2, b2)]
    pallas = conv1_block_pallas(xj, *args, interpret=True)
    h = jnp.maximum(conv2d(xj, args[0], args[1], stride=(1, 1), pad=(1, 1)), 0)
    h = jnp.maximum(conv2d(h, args[2], args[3], stride=(1, 1), pad=(1, 1)), 0)
    xla = jax.lax.reduce_window(h, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    return np.asarray(pallas, np.float32), np.asarray(xla, np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_pallas_and_xla_chain(shape):
    args = _inputs(shape, sum(shape))
    pallas, xla = _jax(*args)
    xt, cw = _port(*args)
    got = conv1_cuda.conv1_block_reference(xt, cw)
    B, H, W = shape
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, 64, H // 2, W // 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert (pallas > 0).mean() > 0.2  # ReLU leaves enough nonzero values to compare
    _close(_nhwc(got), pallas)
    _close(_nhwc(got), xla)


def test_reference_edge_rows_are_padding_not_garbage():
    """A constant image makes halo mistakes visible: conv1_2's padding is
    zero, not conv1_1 of the padding (tests/test_conv1_pallas.py:53-69)."""
    args = _inputs((1, 32, 64), 3, const=0.25)
    pallas, xla = _jax(*args)
    xt, cw = _port(*args)
    got = _nhwc(conv1_cuda.conv1_block_reference(xt, cw))
    _close(got, pallas)
    _close(got, xla)
    assert not np.allclose(got[0, 0], got[0, 5])  # the border rows do differ


def _packed_gemm(x, cw):
    """The kernel's arithmetic in torch, from the packed weights and in its
    index order: conv1_1 from w1_k rows (ky, kx, c), conv1_2 as a GEMM with
    K = (ky, kx, c_in) against w2_k, then the 2x2 max before + b2 and ReLU."""
    B, _, H, W = x.shape
    xp = F.pad(x.float(), (2, 2, 2, 2))
    taps = torch.stack([xp[:, c, ky : ky + H + 2, kx : kx + W + 2]
                        for ky in range(3) for kx in range(3) for c in range(3)], -1)
    h1 = (taps @ cw.w1_k + cw.b1).relu()  # (B, H+2, W+2, 64), a 1-pixel halo
    inside = torch.zeros(H + 2, W + 2, 1)
    inside[1:-1, 1:-1] = 1
    h1 = (h1 * inside).to(torch.bfloat16).float()
    a = torch.cat([h1[:, ky : ky + H, kx : kx + W] for ky in range(3) for kx in range(3)], -1)
    acc = a @ cw.w2_k.float()  # (B, H, W, 64)
    pooled = acc.reshape(B, H // 2, 2, W // 2, 2, 64).amax((2, 4))
    return (pooled + cw.b2).relu().to(torch.bfloat16)


def test_packed_weights_compute_the_block():
    args = _inputs((2, 16, 40), 7)
    xt, cw = _port(*args)
    assert cw.w1_k.shape == (27, 64) and cw.w1_k.dtype == torch.float32
    assert cw.w2_k.shape == (576, 64) and cw.w2_k.dtype == torch.bfloat16
    assert torch.equal(cw.w1_k, cw.w1_k.to(torch.bfloat16).float())  # bf16 values
    _close(_packed_gemm(xt, cw).float().numpy(), _nhwc(conv1_cuda.conv1_block_reference(xt, cw)))


def test_cpu_wrapper_runs_the_plain_version_and_checks_its_input():
    args = _inputs((1, 8, 12), 1)
    xt, cw = _port(*args)
    before = conv1_cuda.launches
    assert torch.equal(conv1_cuda.conv1_block(xt, cw), conv1_cuda.conv1_block_reference(xt, cw))
    assert conv1_cuda.launches == before
    with pytest.raises(ValueError):
        conv1_cuda.conv1_block(xt[:, :, :7], cw)  # odd H
    with pytest.raises(ValueError):
        conv1_cuda.conv1_block(xt[..., :11], cw)  # odd W
    with pytest.raises(TypeError):
        conv1_cuda.conv1_block(xt.float(), cw)
    with pytest.raises(ValueError):
        conv1_cuda.conv1_block(xt[:, :2], cw)
    with pytest.raises(ValueError):
        conv1_cuda.Conv1Weights.pack(cw.w2, cw.b2, cw.w2, cw.b2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(1, 368, 656), (3, 368, 656), (1, 34, 50)])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_kernel_matches_reference_on_cuda(cuda_device, shape, layout):
    args = _inputs(shape, sum(shape) + 1)
    xt, cw = _port(*args, device=cuda_device)
    if layout == "nchw":
        xt = xt.contiguous()
    before = conv1_cuda.launches
    got = conv1_cuda.conv1_block(xt, cw)
    torch.cuda.synchronize()
    assert conv1_cuda.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(_nhwc(got), _nhwc(conv1_cuda.conv1_block_reference(xt, cw)))
