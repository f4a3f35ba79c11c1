"""Neuron functions with Caffe layer semantics (reference
src/caffe/layers/*_layer.cpp, the neuron family).

Counterpart of ``caffe_rtpose_tpu/ops/elementwise.py``, in plain torch and
differentiable by autograd.  Dropout draws its mask from an explicit
``torch.Generator`` on the tensor's device and scales the kept values by
1/(1-p), as Caffe does at train time.
"""

from __future__ import annotations

from typing import Optional

import torch


def relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    if negative_slope == 0.0:
        return torch.relu(x)
    return torch.where(x > 0, x, x * negative_slope)


def prelu(x: torch.Tensor, slopes: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
    """One slope, or one a channel along ``channel_axis``."""
    if slopes.numel() == 1:
        slope = slopes.reshape(())
    else:
        shape = [1] * x.dim()
        shape[channel_axis] = x.shape[channel_axis]
        slope = slopes.reshape(shape)
    return torch.where(x > 0, x, x * slope)


def elu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * (torch.exp(torch.clamp(x, max=0)) - 1))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def absval(x: torch.Tensor) -> torch.Tensor:
    return torch.abs(x)


def bnll(x: torch.Tensor) -> torch.Tensor:
    """BNLL: x > 0 ? x + log(1 + exp(-x)) : log(1 + exp(x)), as one stable
    softplus."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def power(x: torch.Tensor, power_: float, scale: float, shift: float) -> torch.Tensor:
    y = scale * x + shift
    if power_ == 1.0:
        return y
    return torch.pow(y, power_)


def exp(x: torch.Tensor, base: float, scale: float, shift: float) -> torch.Tensor:
    """base^(scale x + shift); base -1 means e (exp_layer.cpp)."""
    inner = scale * x + shift
    if base == -1.0:
        return torch.exp(inner)
    return torch.exp(inner * torch.log(torch.tensor(base, dtype=torch.float32)).item())


def log(x: torch.Tensor, base: float, scale: float, shift: float) -> torch.Tensor:
    y = torch.log(scale * x + shift)
    if base != -1.0:
        y = y / torch.log(torch.tensor(base, dtype=torch.float32)).item()
    return y


def threshold(x: torch.Tensor, t: float) -> torch.Tensor:
    return (x > t).to(x.dtype)


def scale_op(x: torch.Tensor, gamma: torch.Tensor, bias: Optional[torch.Tensor],
             axis: int) -> torch.Tensor:
    """The Scale layer: ``gamma``'s dims laid along ``x``'s from ``axis``."""
    shape = [1] * x.dim()
    for i, d in enumerate(gamma.shape):
        shape[axis + i] = d
    y = x * gamma.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


def dropout(x: torch.Tensor, ratio: float, generator: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """Train: each element kept with probability 1 - ratio (a uniform draw
    on ``x``'s device from ``generator``) and scaled by 1/(1 - ratio);
    otherwise the identity."""
    if not training or ratio == 0.0:
        return x
    keep = 1.0 - ratio
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
