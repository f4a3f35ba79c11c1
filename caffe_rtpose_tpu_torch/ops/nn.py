"""Dense ops of the deploy CNN: convolution, max pooling, ReLU.

Counterpart of ``caffe_rtpose_tpu/ops/nn.py``.  Tensors are logically NCHW
(Caffe layout) and kept in ``torch.channels_last`` memory by the graph
runtime; weights are OIHW, as Caffe stores them.  The JAX package's
convolutions were plain XLA convolutions, not Pallas kernels, so here they
are ``torch.nn.functional.conv2d``, in f32 or bf16.  ReLU and MAX pooling
are exact in either.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    stride: Tuple[int, int],
    pad: Tuple[int, int],
    dilation: Tuple[int, int] = (1, 1),
    groups: int = 1,
) -> torch.Tensor:
    """Caffe Convolution forward. x: (N, Cin, H, W); w: (Cout, Cin/groups, kh, kw).

    Output spatial dim = floor((in + 2p - dilated_k)/stride) + 1, matching
    reference base_conv_layer.cpp compute_output_shape.

    In bf16 the caller passes bf16 ``w`` and ``b`` (``F.conv2d`` takes one
    dtype; on the card this is cuDNN with f32 accumulation).  The bias is
    then rounded to bf16 before it is added, where the JAX package adds the
    f32 bias to the f32 sum and rounds once (``caffe_rtpose_tpu/ops/nn.py::
    conv2d``): outputs differ by about one bf16 ulp (2^-8 relative), measured
    on the CPU at ~2^-7 for a 64->64 conv.  The port keeps that rather than
    spend an f32 pass over every activation on the card to emulate it.
    """
    return F.conv2d(x, w, b, stride=stride, padding=pad, dilation=dilation, groups=groups)


def pooled_size(in_size: int, k: int, s: int, p: int) -> int:
    """Caffe pooling output size: ceil mode with clip (pooling_layer.cpp)."""
    out = int(math.ceil((in_size + 2 * p - k) / float(s))) + 1
    if p > 0 and (out - 1) * s >= in_size + p:
        out -= 1
    return out


def max_pool2d(x: torch.Tensor, k: Tuple[int, int], s: Tuple[int, int],
               p: Tuple[int, int]) -> torch.Tensor:
    """Caffe MAX pooling on (N, C, H, W): -inf padding of ``p`` on the
    top/left and as much as the ceil-and-clip output size needs on the
    bottom/right, so the last window may hang over the input."""
    n, c, h, w = x.shape
    oh = pooled_size(h, k[0], s[0], p[0])
    ow = pooled_size(w, k[1], s[1], p[1])
    pad_h = (p[0], max(0, (oh - 1) * s[0] + k[0] - h - p[0]))
    pad_w = (p[1], max(0, (ow - 1) * s[1] + k[1] - w - p[1]))
    if any(pad_h + pad_w):
        x = F.pad(x, (pad_w[0], pad_w[1], pad_h[0], pad_h[1]), value=-math.inf)
    y = F.max_pool2d(x, kernel_size=k, stride=s)
    return y[:, :, :oh, :ow]


def relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    if negative_slope == 0.0:
        return torch.relu(x)
    return torch.where(x > 0, x, x * negative_slope)
