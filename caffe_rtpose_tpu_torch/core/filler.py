"""Weight initializers with Caffe Filler semantics (reference
include/caffe/filler.hpp).

Counterpart of ``caffe_rtpose_tpu/core/filler.py``.  Fillers work on
Caffe-layout shapes (a convolution's OIHW), so fan-in and fan-out are the
reference's.  Random fillers draw from an explicit ``torch.Generator`` on
the CPU: the same seed gives the same weights on every device.  The bits of
``jax.random`` cannot be reproduced, so the random fillers match JAX in
shape, dtype and moments; constant and bilinear match it exactly.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..proto import caffe_pb

FillerSpec = Union[None, Mapping[str, Any], caffe_pb.View]


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    count = int(np.prod(shape))
    num = shape[0] if len(shape) >= 1 else 1
    channels = shape[1] if len(shape) >= 2 else 1
    return count // max(num, 1), count // max(channels, 1)


def _norm(shape: Sequence[int], variance_norm: int) -> float:
    """FillerParameter.variance_norm: FAN_IN (0), FAN_OUT (1), AVERAGE (2)."""
    fan_in, fan_out = _fans(shape)
    if variance_norm == 0:
        return fan_in
    return fan_out if variance_norm == 1 else (fan_in + fan_out) / 2.0


def fill(gen: Optional[torch.Generator], shape: Sequence[int], filler: FillerSpec) -> torch.Tensor:
    """A Caffe-layout f32 CPU tensor of ``shape`` as the FillerParameter
    ``filler`` (a dict or a View; None is constant 0) makes it, drawing
    from ``gen``."""
    shape = tuple(int(d) for d in shape)
    f = filler if isinstance(filler, caffe_pb.View) else caffe_pb.view(
        dict(filler or {}), "FillerParameter")
    kind = f.type
    if kind == "constant":
        return torch.full(shape, float(f.value), dtype=torch.float32)
    if kind == "uniform":
        return torch.empty(shape).uniform_(float(f.min), float(f.max), generator=gen)
    if kind == "gaussian":
        # sparse gaussian (sparse >= 0) is not supported, as in JAX: no
        # shipped model uses it
        return float(f.mean) + float(f.std) * torch.randn(shape, generator=gen)
    if kind == "xavier":
        scale = math.sqrt(3.0 / _norm(shape, int(f.variance_norm)))
        return torch.empty(shape).uniform_(-scale, scale, generator=gen)
    if kind == "msra":
        std = math.sqrt(2.0 / _norm(shape, int(f.variance_norm)))
        return std * torch.randn(shape, generator=gen)
    if kind == "positive_unitball":
        x = torch.rand(shape, generator=gen)
        flat = x.reshape(shape[0], -1)
        return (flat / flat.sum(dim=1, keepdim=True)).reshape(shape)
    if kind == "bilinear":
        # the deconvolution upsampling kernel (filler.hpp BilinearFiller)
        if len(shape) != 4 or shape[2] != shape[3]:
            raise ValueError("bilinear filler needs square 4-D kernels")
        k = shape[3]
        fk = int(math.ceil(k / 2.0))
        c = (2 * fk - 1 - fk % 2) / (2.0 * fk)
        w1d = 1 - np.abs(np.arange(k) / fk - c)
        kern = torch.from_numpy(np.outer(w1d, w1d).astype(np.float32))
        return kern.expand(shape).clone()
    raise ValueError(f"unknown filler type {kind!r}")
