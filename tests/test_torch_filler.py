"""The port's fillers (``caffe_rtpose_tpu_torch/core/filler.py``) against the
JAX package's (``caffe_rtpose_tpu/core/filler.py``).

``constant`` and ``bilinear`` are deterministic: equal bit for bit.  The
random fillers cannot reproduce ``jax.random``'s bits: both sides are held
to the filler's distribution on 18,432 draws, each moment within five
standard errors of its expected value (mean: std/sqrt(n); std: 2 % of it)."""

import math

import jax
import numpy as np
import pytest
import torch

from caffe_rtpose_tpu.core.filler import fill as jfill
from caffe_rtpose_tpu.proto import caffe_pb as jpb
from caffe_rtpose_tpu_torch.core.filler import fill

SHAPE = (64, 32, 3, 3)  # fan_in 288, fan_out 576
N = int(np.prod(SHAPE))


def _both(spec, shape=SHAPE, seed=0):
    port = fill(torch.Generator().manual_seed(seed), shape, spec).numpy()
    ref = np.asarray(jfill(jax.random.PRNGKey(seed), shape, jpb.view(dict(spec), "FillerParameter")))
    return port, ref


@pytest.mark.parametrize("spec", [{"type": "constant", "value": 0.25}, {"type": "constant"},
                                  {}])
def test_constant_exact(spec):
    port, ref = _both(spec)
    assert port.dtype == ref.dtype == np.float32 and port.shape == ref.shape == SHAPE
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("k", [2, 3, 4, 7])
def test_bilinear_exact(k):
    port, ref = _both({"type": "bilinear"}, shape=(3, 1, k, k))
    np.testing.assert_array_equal(port, ref)


def _expected(spec):
    """(mean, std) the filler draws from, by its definition."""
    fan_in, fan_out = N // SHAPE[0], N // SHAPE[1]
    norm = {0: fan_in, 1: fan_out, 2: (fan_in + fan_out) / 2.0}[spec.get("variance_norm", 0)]
    kind = spec["type"]
    if kind == "uniform":
        lo, hi = spec["min"], spec["max"]
        return (lo + hi) / 2, (hi - lo) / math.sqrt(12)
    if kind == "gaussian":
        return spec["mean"], spec["std"]
    if kind == "xavier":
        return 0.0, math.sqrt(3.0 / norm) * 2 / math.sqrt(12)
    if kind == "msra":
        return 0.0, math.sqrt(2.0 / norm)
    raise ValueError(kind)


@pytest.mark.parametrize("spec", [
    {"type": "uniform", "min": -0.5, "max": 1.5},
    {"type": "gaussian", "mean": 0.5, "std": 0.1},
    {"type": "xavier"},
    {"type": "xavier", "variance_norm": 1},
    {"type": "msra"},
    {"type": "msra", "variance_norm": 2},
])
def test_random_fillers_moments(spec):
    port, ref = _both(spec)
    mean, std = _expected(spec)
    for x in (port, ref):
        assert x.dtype == np.float32 and x.shape == SHAPE
        assert abs(x.mean() - mean) <= 5 * std / math.sqrt(N)
        assert abs(x.std() - std) <= 5 * 0.02 * std / math.sqrt(N / 1000)


def test_positive_unitball():
    port, ref = _both({"type": "positive_unitball"})
    for x in (port, ref):
        assert x.shape == SHAPE and (x >= 0).all()
        np.testing.assert_allclose(x.reshape(SHAPE[0], -1).sum(1), 1.0, rtol=1e-5)
    assert abs(port.mean() - ref.mean()) < 1e-6  # each row sums to 1: equal means


def test_seeded_and_device_independent():
    """Same seed, same draws; another seed, other draws."""
    spec = {"type": "gaussian", "std": 0.01}
    a = fill(torch.Generator().manual_seed(3), SHAPE, spec)
    b = fill(torch.Generator().manual_seed(3), SHAPE, spec)
    c = fill(torch.Generator().manual_seed(4), SHAPE, spec)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_net_init_params_goes_through_the_fillers():
    """Net.init_params fills from each layer's prototxt fillers (the pose
    nets: gaussian std 0.01 weights, constant 0 biases), drawn from the
    seed's generator in layer order."""
    from caffe_rtpose_tpu_torch.core.net import Net
    from caffe_rtpose_tpu_torch.models.cpm import make_pose_train_net

    proto = make_pose_train_net(batch=1, crop=16, stages=1)
    a = Net(proto, phase="TRAIN", device="cpu", seed=5).export_weights()
    b = Net(proto, phase="TRAIN", device="cpu", seed=5).export_weights()
    c = Net(proto, phase="TRAIN", device="cpu", seed=6).export_weights()
    w = np.concatenate([v[0].ravel() for v in a.values()])
    assert abs(w.std() - 0.01) < 5 * 0.01 / math.sqrt(w.size / 2) and abs(w.mean()) < 1e-4
    assert all(not v[1].any() for v in a.values())
    assert all(np.array_equal(x, y) for k in a for x, y in zip(a[k], b[k]))
    assert not np.array_equal(a["conv1_1"][0], c["conv1_1"][0])
    gen = torch.Generator().manual_seed(5)
    np.testing.assert_array_equal(a["conv1_1"][0], fill(gen, (64, 3, 3, 3), {
        "type": "gaussian", "std": 0.01}).numpy())
