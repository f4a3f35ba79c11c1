"""The upsample + peak-key kernel's plain PyTorch version
(ops/nms_cuda.upsample_peak_keys_reference) against the JAX package's Pallas
kernel ``upsample_peak_keys`` (run in interpret mode, as
tests/test_optimized_path.py runs it on the CPU) and against the JAX XLA
chain; on a CUDA card, the hand-written kernel against the plain version.

Tolerances: heat within 1e-5 absolute (the two sides sum the same bicubic
taps in other orders).  Keys: the JAX kernel keeps a 2x2 block max per
128-tile, the port the horizontal-pair layout, so the per-channel sets of
nonzero keys (``H*W - raster position`` of each strict peak) are compared.
They must be equal, except at a near-tie: a pixel where the two sides' f32
sums may fall on either side of a strict comparison.  A pixel is a near-tie
when, with U the JAX upsampled value there and max8 the largest of its 8
neighbours, |U - thr| <= 1e-5 * max(1, |U|) or |U - max8| <= 1e-5 * max(1, |U|).

The CUDA case imports no jax (run it on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_upsample_keys.py``)
and takes U from the plain version instead.
"""

import numpy as np
import pytest
import torch

from caffe_rtpose_tpu_torch.ops import nms as t_nms
from caffe_rtpose_tpu_torch.ops import nms_cuda


def _near_tie(heat, c, pos, thr):
    y, x = divmod(int(pos), heat.shape[2])
    u = float(heat[c, y, x])
    nb = heat[c, y - 1 : y + 2, x - 1 : x + 2].astype(np.float64).copy()
    nb[1, 1] = -np.inf
    tol = 1e-5 * max(1.0, abs(u))
    return abs(u - thr) <= tol or abs(u - nb.max()) <= tol


def assert_key_sets_equal_up_to_ties(got, ref, heat, thr):
    """Per channel, the nonzero keys of ``got`` and ``ref`` (any layouts)
    hold the same positions, except at near-ties of ``heat``."""
    hw = heat.shape[1] * heat.shape[2]
    n_diff = 0
    for c in range(got.shape[0]):
        a = set(hw - got[c][got[c] > 0].astype(np.int64))
        b = set(hw - ref[c][ref[c] > 0].astype(np.int64))
        assert len(a) == int((got[c] > 0).sum()), "a peak position appears twice"
        for pos in a ^ b:
            assert _near_tie(heat, c, pos, thr), f"channel {c} position {pos} differs, no near-tie"
        n_diff += len(a ^ b)
    return n_diff


@pytest.mark.parametrize("s,start,gap,thr", [(1, 1.0, 0.3, 0.2), (3, 0.9, 0.1, 0.1)])
def test_reference_matches_jax_pallas_interpret(s, start, gap, thr):
    """Heat and key sets against JAX K3 at 12x16 -> 96x128, C=7; and the
    ordered compaction of the port's keys against JAX's top_k compaction of
    K3's keys."""
    import jax.numpy as jnp

    from caffe_rtpose_tpu.ops.nms import peaks_from_keys as j_peaks_from_keys
    from caffe_rtpose_tpu.ops.nms_pallas import upsample_peak_keys as j_upsample

    rs = np.random.RandomState(3 + s)
    low = rs.rand(s, 12, 16, 7).astype(np.float32) * 2 - 1
    th, tw = 96, 128
    j_heat, j_kb = j_upsample(jnp.asarray(low), (th, tw), start, gap, jnp.float32(thr),
                              interpret=True)
    j_heat, j_kb = np.asarray(j_heat), np.asarray(j_kb)
    heat, kb = nms_cuda.upsample_peak_keys(torch.from_numpy(low), (th, tw), start, gap, thr)
    assert heat.shape == (7, th, tw) and heat.dtype == torch.float32 and heat.is_contiguous()
    assert kb.shape == (7, th * (tw // 2)) and kb.dtype == torch.int32
    np.testing.assert_allclose(heat.numpy(), j_heat, rtol=0, atol=1e-5)
    assert (j_kb > 0).sum() > 7
    assert_key_sets_equal_up_to_ties(kb.numpy(), j_kb, j_heat, thr)

    ref = np.asarray(j_peaks_from_keys(jnp.asarray(j_heat), jnp.asarray(j_kb), 10))
    got = t_nms.peaks_from_keys(heat, kb, 10, ordered=True).numpy()
    np.testing.assert_array_equal(got[:, 0, 0], ref[:, 0, 0])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("s,start,gap", [(1, 1.0, 0.3), (3, 0.9, 0.1)])
def test_reference_matches_jax_xla_chain_ragged_key_subset(s, start, gap):
    """A ragged shape (13x17 -> 104x136) with keys for 5 of 8 channels,
    against imresize_average + find_peaks_mask + block_keys in JAX: the same
    layout, so the keys compare slot for slot."""
    import jax.numpy as jnp

    from caffe_rtpose_tpu.ops.imresize import imresize_average
    from caffe_rtpose_tpu.ops.nms import block_keys, find_peaks_mask

    rs = np.random.RandomState(13 + s)
    low = rs.rand(s, 13, 17, 8).astype(np.float32) * 2 - 1
    th, tw, thr, kc = 104, 136, 0.1, 5
    j_heat = jnp.transpose(imresize_average(jnp.asarray(low), th, tw, start, gap)[0], (2, 0, 1))
    j_kb = np.asarray(block_keys(find_peaks_mask(j_heat[:kc], jnp.float32(thr)), th, tw))
    j_heat = np.asarray(j_heat)
    heat, kb = nms_cuda.upsample_peak_keys(torch.from_numpy(low), (th, tw), start, gap, thr,
                                           key_channels=kc)
    assert kb.shape == j_kb.shape == (kc, th * (tw // 2))
    np.testing.assert_allclose(heat.numpy(), j_heat, rtol=0, atol=1e-5)
    assert (j_kb > 0).sum() > kc
    kb = kb.numpy()
    for c, slot in zip(*np.nonzero(kb != j_kb)):
        pos = th * tw - max(int(kb[c, slot]), int(j_kb[c, slot]))
        assert _near_tie(j_heat, c, pos, thr), f"key slot {(c, slot)} differs, no near-tie"


def test_key_channels_bounds_and_cpu_counts_no_launch():
    low = torch.zeros(1, 6, 8, 3)
    before = nms_cuda.upsample_launches
    heat, kb = nms_cuda.upsample_peak_keys(low, (48, 64), 1.0, 0.3, 0.0, key_channels=0)
    assert heat.shape == (3, 48, 64) and kb.shape == (0, 48 * 32)
    assert nms_cuda.upsample_launches == before
    for kc in (-1, 4):
        with pytest.raises(ValueError):
            nms_cuda.upsample_peak_keys(low, (48, 64), 1.0, 0.3, 0.0, key_channels=kc)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,start,gap,h,w,f,c,kc", [
    (1, 1.0, 0.3, 12, 16, 8, 7, 7), (3, 0.9, 0.1, 13, 17, 8, 8, 5),
    (1, 1.0, 0.3, 46, 82, 8, 57, 18), (3, 1.0, 0.3, 46, 82, 8, 57, 18),
    (3, 0.9, 0.1, 46, 82, 8, 44, 15)])
def test_kernel_matches_reference_on_cuda(cuda_device, s, start, gap, h, w, f, c, kc):
    rs = np.random.RandomState(c * 100 + s)
    low = torch.from_numpy(rs.rand(s, h, w, c).astype(np.float32) * 2 - 1).to(cuda_device)
    th, tw, thr = h * f, w * f, 0.1
    before = nms_cuda.upsample_launches
    heat, kb = nms_cuda.upsample_peak_keys(low, (th, tw), start, gap, thr, key_channels=kc)
    torch.cuda.synchronize()
    assert nms_cuda.upsample_launches == before + 1
    r_heat, r_kb = nms_cuda.upsample_peak_keys_reference(low, (th, tw), start, gap, thr, kc)
    r_heat = r_heat.cpu().numpy()
    tol = 1e-5 * np.maximum(1.0, np.abs(r_heat))
    assert (np.abs(heat.cpu().numpy() - r_heat) <= tol).all()
    assert_key_sets_equal_up_to_ties(kb.cpu().numpy(), r_kb.cpu().numpy(), r_heat, thr)
