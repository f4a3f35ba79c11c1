"""The port's losses (``caffe_rtpose_tpu_torch/ops/losses.py``) against the
JAX package's (``caffe_rtpose_tpu/ops/losses.py``) on the same numpy inputs.

Tolerance: relative 1e-5 and absolute 1e-6 (two f32 reductions of the same
terms in different orders); integer-valued results (accuracy) exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.ops import losses as J
from caffe_rtpose_tpu_torch.ops import losses as P

RTOL, ATOL = 1e-5, 1e-6


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float64),
                               np.asarray(ref, np.float64), rtol=RTOL, atol=ATOL)


def _both(*arrays):
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


def test_euclidean():
    rs = np.random.RandomState(0)
    (a, b), (ja, jb) = _both(rs.randn(3, 5, 4, 6).astype(np.float32),
                             rs.randn(3, 5, 4, 6).astype(np.float32))
    _close(P.euclidean(a, b), J.euclidean(ja, jb))


def test_euclidean_residual_in_f32():
    """bf16 inputs: the residual is taken after the cast to f32, as JAX does."""
    rs = np.random.RandomState(1)
    a = torch.from_numpy(rs.randn(2, 3, 4, 4).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rs.randn(2, 3, 4, 4).astype(np.float32)).to(torch.bfloat16)
    assert P.euclidean(a, b).dtype == torch.float32
    assert torch.equal(P.euclidean(a, b), P.euclidean(a.float(), b.float()))
    ref = J.euclidean(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(b.float().numpy()).astype(jnp.bfloat16))
    _close(P.euclidean(a, b), ref)


@pytest.mark.parametrize("channel_axis", [1, 3])
def test_euclidean_masked(channel_axis):
    rs = np.random.RandomState(2)
    shape = (3, 7, 5, 4) if channel_axis == 1 else (3, 5, 4, 7)
    pred, target = rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)
    mask = (rs.rand(3, 7) > 0.5).astype(np.float32)
    mask[:, -1] = 0  # the background channel counts whatever the mask says
    (a, b, m), (ja, jb, jm) = _both(pred, target, mask)
    _close(P.euclidean_masked(a, b, m, channel_axis), J.euclidean_masked(ja, jb, jm, channel_axis))


@pytest.mark.parametrize("ignore,norm", [(None, "VALID"), (2, "VALID"), (None, "FULL"),
                                         (2, "NONE"), (None, "BATCH_SIZE")])
def test_softmax_cross_entropy(ignore, norm):
    rs = np.random.RandomState(3)
    logits = rs.randn(12, 5).astype(np.float32) * 3
    labels = rs.randint(0, 5, 12).astype(np.int32)
    (x, y), (jx, jy) = _both(logits, labels)
    _close(P.softmax_cross_entropy(x, y, ignore, norm, batch_size=3),
           J.softmax_cross_entropy(jx, jy, ignore, norm, batch_size=3))


def test_sigmoid_cross_entropy():
    rs = np.random.RandomState(4)
    (x, t), (jx, jt) = _both(rs.randn(4, 6).astype(np.float32) * 4,
                             rs.rand(4, 6).astype(np.float32))
    _close(P.sigmoid_cross_entropy(x, t), J.sigmoid_cross_entropy(jx, jt))


@pytest.mark.parametrize("top_k,ignore", [(1, None), (3, None), (1, 0), (2, 4)])
def test_accuracy(top_k, ignore):
    rs = np.random.RandomState(5)
    (x, y), (jx, jy) = _both(rs.randn(20, 6).astype(np.float32), rs.randint(0, 6, 20).astype(np.int32))
    assert float(P.accuracy(x, y, top_k, ignore)) == float(J.accuracy(jx, jy, top_k, ignore))
    np.testing.assert_array_equal(P.accuracy_per_class(x, y, top_k, ignore).numpy(),
                                  np.asarray(J.accuracy_per_class(jx, jy, top_k, ignore)))


@pytest.mark.parametrize("norm", ["L1", "L2"])
def test_hinge(norm):
    rs = np.random.RandomState(6)
    (x, y), (jx, jy) = _both(rs.randn(8, 5).astype(np.float32), rs.randint(0, 5, 8).astype(np.int32))
    _close(P.hinge(x, y, norm), J.hinge(jx, jy, norm))


def test_multinomial_logistic():
    rs = np.random.RandomState(7)
    probs = rs.rand(8, 5).astype(np.float32)
    probs[0, :] = 0.0  # the clamp at 1e-20
    (p, y), (jp, jy) = _both(probs, rs.randint(0, 5, 8).astype(np.int32))
    _close(P.multinomial_logistic(p, y), J.multinomial_logistic(jp, jy))


@pytest.mark.parametrize("legacy", [False, True])
def test_contrastive(legacy):
    rs = np.random.RandomState(8)
    (a, b, y), (ja, jb, jy) = _both(rs.randn(6, 4).astype(np.float32),
                                    rs.randn(6, 4).astype(np.float32),
                                    rs.randint(0, 2, 6).astype(np.float32))
    _close(P.contrastive(a, b, y, 2.0, legacy), J.contrastive(ja, jb, jy, 2.0, legacy))


def test_infogain():
    rs = np.random.RandomState(9)
    (p, y, h), (jp, jy, jh) = _both(rs.rand(8, 4).astype(np.float32),
                                    rs.randint(0, 4, 8).astype(np.int32),
                                    rs.rand(4, 4).astype(np.float32))
    _close(P.infogain(p, y, h), J.infogain(jp, jy, jh))


def test_euclidean_gradient_matches_jax():
    """The loss is differentiable by autograd; its gradient is JAX's."""
    import jax

    rs = np.random.RandomState(10)
    pred, target = rs.randn(2, 4, 3, 3).astype(np.float32), rs.randn(2, 4, 3, 3).astype(np.float32)
    mask = (rs.rand(2, 4) > 0.5).astype(np.float32)
    x = torch.from_numpy(pred).requires_grad_(True)
    P.euclidean_masked(x, torch.from_numpy(target), torch.from_numpy(mask)).backward()
    ref = jax.grad(lambda p: J.euclidean_masked(p, jnp.asarray(target), jnp.asarray(mask), 1))(
        jnp.asarray(pred))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
