"""The peak-mask kernel's plain PyTorch version (ops/nms_cuda.py) against
the JAX package's Pallas kernel (run in interpret mode, as the JAX tests run
it on the CPU) and against the JAX XLA chain; on a CUDA card, the
hand-written kernel against the plain version.

Equality rule: the masks must be equal, except at a pixel that is a
near-tie, where the two sides' f32 sums (taken in different orders) may
fall on either side of a strict comparison.  A pixel is a near-tie when,
with U the JAX upsampled value there and max8 the largest of its 8
neighbours, |U - thr| <= 1e-5 * max(1, |U|) or |U - max8| <= 1e-5 * max(1, |U|).

The CUDA case imports no jax (the card's machine has none; run it there with
``python -m pytest --noconftest -m cuda tests/test_torch_peak_mask.py``) and
takes U from the plain version instead.
"""

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu_torch.ops import imresize as t_imresize
from caffe_rtpose_tpu_torch.ops import nms_cuda


def _jax_heat(low, th, tw, start, gap):
    import jax.numpy as jnp

    from caffe_rtpose_tpu.ops.imresize import imresize_average

    return np.asarray(jnp.transpose(imresize_average(jnp.asarray(low), th, tw, start, gap)[0], (2, 0, 1)))


def assert_masks_equal_up_to_ties(got, ref, heat, thr):
    got, ref = np.asarray(got, bool), np.asarray(ref, bool)
    assert got.shape == ref.shape == heat.shape
    for c, y, x in zip(*np.nonzero(got != ref)):
        assert 1 <= y < heat.shape[1] - 1 and 1 <= x < heat.shape[2] - 1, "border pixel differs"
        u = float(heat[c, y, x])
        nb = heat[c, y - 1 : y + 2, x - 1 : x + 2].astype(np.float64).copy()
        nb[1, 1] = -np.inf
        tol = 1e-5 * max(1.0, abs(u))
        assert abs(u - thr) <= tol or abs(u - nb.max()) <= tol, (
            f"pixel {(c, y, x)} differs and is no near-tie: U={u}, thr={thr}, max8={nb.max()}")
    return int((got != ref).sum())


CASES = [
    # (scales, start, gap, h, w, factor, channels)
    (1, 1.0, 0.3, 12, 16, 8, 6),
    (3, 0.9, 0.1, 12, 16, 8, 6),
    (3, 1.0, 0.15, 12, 16, 8, 6),
    (1, 1.0, 0.3, 13, 17, 8, 5),
    (3, 0.9, 0.1, 13, 17, 8, 5),
]


@pytest.mark.parametrize("s,start,gap", [(1, 1.0, 0.3), (3, 0.9, 0.1)])
def test_reference_matches_jax_pallas_interpret(s, start, gap):
    """The plain version == the JAX Pallas kernel (K1, whole-frame form)
    run in interpret mode, as tests/test_optimized_path.py runs it."""
    import jax.numpy as jnp

    from caffe_rtpose_tpu.ops.nms_pallas import peak_mask_fused as j_peak_mask

    rs = np.random.RandomState(5)
    low = rs.rand(s, 12, 16, 6).astype(np.float32) * 2 - 1
    thr = 0.2
    ref = np.asarray(j_peak_mask(jnp.asarray(low), (96, 128), start, gap,
                                 jnp.float32(thr), interpret=True))
    got = nms_cuda.peak_mask_fused(torch.from_numpy(low), (96, 128), start, gap, thr)
    assert got.dtype == torch.bool and got.shape == (6, 96, 128)
    assert ref.sum() > 0
    assert_masks_equal_up_to_ties(got.numpy(), ref, _jax_heat(low, 96, 128, start, gap), thr)


@pytest.mark.parametrize("s,start,gap,h,w,f,c", CASES)
def test_reference_matches_jax_xla_chain(s, start, gap, h, w, f, c):
    """The plain version == find_peaks_mask(imresize_average(...)) in JAX,
    including a ragged shape (13x17 -> 104x136)."""
    import jax.numpy as jnp

    from caffe_rtpose_tpu.ops.nms import find_peaks_mask as j_find_peaks

    rs = np.random.RandomState(h * w + s)
    low = rs.rand(s, h, w, c).astype(np.float32) * 2 - 1
    th, tw = h * f, w * f
    thr = 0.1
    heat = _jax_heat(low, th, tw, start, gap)
    ref = np.asarray(j_find_peaks(jnp.asarray(heat), jnp.float32(thr)))
    got = nms_cuda.peak_mask_fused(torch.from_numpy(low), (th, tw), start, gap, thr).numpy()
    assert ref.sum() > 0
    assert_masks_equal_up_to_ties(got, ref, heat, thr)


def test_cpu_tensor_never_counts_a_launch():
    before = nms_cuda.launches
    low = torch.zeros(1, 6, 8, 2)
    assert not nms_cuda.peak_mask_fused(low, (48, 64), 1.0, 0.3, 0.0).any()
    assert nms_cuda.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,start,gap,h,w,f,c", CASES + [
    (1, 1.0, 0.3, 46, 82, 8, 18), (3, 1.0, 0.15, 46, 82, 8, 18),
    (3, 1.0, 0.3, 46, 82, 8, 18), (3, 0.9, 0.1, 46, 82, 8, 15)])
def test_kernel_matches_reference_on_cuda(cuda_device, s, start, gap, h, w, f, c):
    rs = np.random.RandomState(c * 100 + s)
    low = torch.from_numpy(rs.rand(s, h, w, c).astype(np.float32) * 2 - 1).to(cuda_device)
    th, tw = h * f, w * f
    thr = 0.1
    before = nms_cuda.launches
    got = nms_cuda.peak_mask_fused(low, (th, tw), start, gap, thr)
    torch.cuda.synchronize()
    assert nms_cuda.launches == before + 1
    ref = nms_cuda.peak_mask_fused_reference(low, (th, tw), start, gap, thr)
    heat = t_imresize.imresize_average(low.cpu(), th, tw, start, gap)[0].permute(2, 0, 1).numpy()
    assert_masks_equal_up_to_ties(got.cpu().numpy(), ref.cpu().numpy(), heat, thr)
