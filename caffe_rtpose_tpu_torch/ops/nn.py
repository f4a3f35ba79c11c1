"""Dense ops: convolution, deconvolution, pooling (MAX, AVE, STOCHASTIC),
LRN, inner product, batch norm, MVN, im2col and ReLU.

Counterpart of ``caffe_rtpose_tpu/ops/nn.py``.  Tensors are logically NCHW
(Caffe layout) and kept in ``torch.channels_last`` memory by the graph
runtime; weights are in Caffe's layout (convolution OIHW, deconvolution
(Cin, Cout/g, kh, kw), inner product (N, K)).  The JAX package's ops here
were plain XLA ops, not Pallas kernels, so here they are
``torch.nn.functional`` calls (cuDNN and cuBLAS on the card), in f32 or
bf16.  ReLU and MAX pooling are exact in either.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

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
    cudnn: bool = True,
) -> torch.Tensor:
    """Caffe Convolution forward. x: (N, Cin, H, W); w: (Cout, Cin/groups, kh, kw).

    Output spatial dim = floor((in + 2p - dilated_k)/stride) + 1, matching
    reference base_conv_layer.cpp compute_output_shape.

    Inference in bf16: the caller passes bf16 ``w`` and ``b`` (copies made at
    load; ``F.conv2d`` takes one dtype; on the card this is cuDNN with f32
    accumulation).  The bias is then rounded to bf16 before it is added,
    where the JAX package adds the f32 bias to the f32 sum and rounds once
    (``caffe_rtpose_tpu/ops/nn.py::conv2d``): outputs differ by about one
    bf16 ulp (2^-8 relative), measured on the CPU at ~2^-7 for a 64->64 conv.
    The port keeps that rather than spend an f32 pass over every activation
    on the card to emulate it.

    Mixed precision (bf16 ``x`` with the f32 parameters themselves, as a
    bf16 TRAIN net passes them): :func:`_mixed`.  ``cudnn=False`` on CUDA:
    forward and backward outside cuDNN (:class:`_OutsideCudnn`).
    """
    if w.dtype != x.dtype:
        return _mixed(lambda ww: F.conv2d(x, ww, None, stride=stride, padding=pad,
                                          dilation=dilation, groups=groups), x, w, b)
    if not cudnn and x.is_cuda:
        return _OutsideCudnn.apply(x, w, b, stride, pad, dilation, groups, False)
    return F.conv2d(x, w, b, stride=stride, padding=pad, dilation=dilation, groups=groups)


def _cudnn_off():
    """cuDNN disabled, its other flags as they are."""
    cd = torch.backends.cudnn
    return cd.flags(enabled=False, benchmark=cd.benchmark, deterministic=cd.deterministic,
                    allow_tf32=cd.allow_tf32)


class _OutsideCudnn(torch.autograd.Function):
    """A (transposed) convolution whose forward and backward both run
    outside cuDNN, in ATen's own CUDA convolutions (im2col and cuBLAS).
    An f32 TRAIN net on the card takes it: cuDNN's f32 backward (TF32 off)
    puts the VGG trunk's bias gradients of the CPM train net 0.41-0.45
    relative L2 from an f64 run at batch 10, crop 368, where this path stays
    within 6.5e-4 for ~18 % more time (scripts/torch_f32_grad_witness.py;
    H100 80GB HBM3, 700 W).  The backward is ``convolution_backward`` itself,
    what autograd calls for ``F.conv2d``; only the engine differs."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pad, dilation, groups, transposed):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad, dilation, groups, transposed,
                    None if b is None else list(b.shape))
        op = F.conv_transpose2d if transposed else F.conv2d
        with _cudnn_off():
            return op(x, w, b, stride=stride, padding=pad, dilation=dilation, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, pad, dilation, groups, transposed, bias_sizes = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                bias_sizes is not None and ctx.needs_input_grad[2]]
        with _cudnn_off():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, w, bias_sizes, list(stride), list(pad), list(dilation), transposed,
                [0, 0], groups, mask)
        return gx, gw, gb, None, None, None, None, None


def _mixed(conv, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """JAX's mixed-precision convolution (``caffe_rtpose_tpu/ops/nn.py``
    ``_conv_call`` and ``conv2d``): the f32 weight cast to ``x``'s dtype
    inside the forward, the products summed in f32 (cuDNN's bf16 engines;
    the sum comes back rounded to bf16, where JAX keeps it in f32 for the
    bias: at most one more bf16 rounding), the f32 bias added in f32 and the
    result rounded to ``x``'s dtype.

    Autograd of this forward already gives JAX's gradients, so there is no
    ``torch.autograd.Function`` here: the incoming bf16 cotangent is cast to
    f32 by the final cast's backward, the bias gradient is its f32 sum, the
    ``.float()``'s backward casts the cotangent to bf16 (JAX's custom VJP
    casts ``g.astype(x.dtype)``), the convolution's input and weight
    gradients are bf16 convolutions, and the weight cast's backward hands
    the f32 parameter an f32 gradient.  The cast sits under autograd, so a
    solver's update reaches the next forward (no stale bf16 copy)."""
    y = conv(w.to(x.dtype))
    if b is None:
        return y
    return (y.float() + b.float().reshape(1, -1, 1, 1)).to(x.dtype)


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


def deconv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
             stride: Tuple[int, int], pad: Tuple[int, int],
             dilation: Tuple[int, int] = (1, 1), groups: int = 1,
             cudnn: bool = True) -> torch.Tensor:
    """Caffe Deconvolution forward; ``w`` is Caffe's blob (Cin, Cout/g, kh,
    kw), which is ``conv_transpose2d``'s layout.  Output dim =
    stride * (in - 1) + dilated_k - 2 pad (deconv_layer.cpp).  With a bf16
    ``x`` and the f32 parameters: JAX's mixed precision (:func:`_mixed`);
    ``cudnn=False`` on CUDA: outside cuDNN, as :func:`conv2d`."""
    if w.dtype != x.dtype:
        return _mixed(lambda ww: F.conv_transpose2d(x, ww, None, stride=stride, padding=pad,
                                                    dilation=dilation, groups=groups), x, w, b)
    if not cudnn and x.is_cuda:
        return _OutsideCudnn.apply(x, w, b, stride, pad, dilation, groups, True)
    return F.conv_transpose2d(x, w, b, stride=stride, padding=pad, dilation=dilation,
                              groups=groups)


def _ceil_pads(h: int, w: int, k, s, p) -> Tuple[int, int, Tuple[int, int], Tuple[int, int]]:
    oh, ow = pooled_size(h, k[0], s[0], p[0]), pooled_size(w, k[1], s[1], p[1])
    pad_h = (p[0], max(0, (oh - 1) * s[0] + k[0] - h - p[0]))
    pad_w = (p[1], max(0, (ow - 1) * s[1] + k[1] - w - p[1]))
    return oh, ow, pad_h, pad_w


def _window_counts(size: int, k: int, s: int, p: int, out: int) -> np.ndarray:
    """AVE pooling's divisor along one axis: the window clipped to the
    padded bounds [-p, size + p) (pooling_layer.cpp)."""
    counts = np.empty(out, np.float32)
    for i in range(out):
        start = i * s - p
        counts[i] = min(start + k, size + p) - start
    return counts


def avg_pool2d(x: torch.Tensor, k: Tuple[int, int], s: Tuple[int, int],
               p: Tuple[int, int], rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Caffe AVE pooling: window sums over zero padding, each divided by its
    window clipped to the padded bounds, so a border window that hangs past
    the pad divides by fewer than kh*kw.  ``F.avg_pool2d``'s
    ``count_include_pad`` and ``ceil_mode`` give another divisor there.

    ``rows`` = (H, lo, hi): ``x`` holds exactly the input rows output rows
    [lo, hi) of an H-row input read, its padding rows already zeros (a slab
    of rows with its halo, ``parallel/sp.py``)."""
    n, c, h, w = x.shape
    oh, ow, pad_h, pad_w = _ceil_pads(h, w, k, s, p if rows is None else (0, p[1]))
    xf = x.to(torch.float32)
    if any(pad_h + pad_w):
        xf = F.pad(xf, (pad_w[0], pad_w[1], pad_h[0], pad_h[1]))
    sums = F.avg_pool2d(xf, kernel_size=k, stride=s, divisor_override=1)[:, :, :oh, :ow]
    if rows is None:
        div_h = _window_counts(h, k[0], s[0], p[0], oh)
    else:
        full, lo, hi = rows
        div_h = _window_counts(full, k[0], s[0], p[0], hi)[lo:]
    div = np.outer(div_h, _window_counts(w, k[1], s[1], p[1], ow))
    return (sums / torch.from_numpy(div).to(x.device)).to(x.dtype)


def _window_patches(x: torch.Tensor, k: Tuple[int, int], s: Tuple[int, int]):
    """(N, C, kh*kw, oh, ow) windows of unpadded ceil-mode pooling, in the
    row-major scan order of pooling_layer.cu, zero-padded bottom/right (a
    zero adds nothing to a window's running sum)."""
    n, c, h, w = x.shape
    oh, ow, pad_h, pad_w = _ceil_pads(h, w, k, s, (0, 0))
    xp = F.pad(x, (0, pad_w[1], 0, pad_h[1]))
    pats = torch.stack([xp[:, :, dh: dh + (oh - 1) * s[0] + 1: s[0],
                           dw: dw + (ow - 1) * s[1] + 1: s[1]]
                        for dh in range(k[0]) for dw in range(k[1])], dim=2)
    return pats


def stochastic_pool2d(x: torch.Tensor, k: Tuple[int, int], s: Tuple[int, int],
                      generator: Optional[torch.Generator], training: bool) -> torch.Tensor:
    """Caffe STOCHASTIC pooling (pooling_layer.cu:83-155), no padding.

    Train: one uniform draw r an output on ``x``'s device; the output is the
    first window element (row-major) whose running sum reaches r times the
    window's sum, as a gather, so the gradient goes to the sampled element
    as in StoPoolBackward.  Test: sum(x^2) / (FLT_MIN + sum(x))."""
    pats = _window_patches(x, k, s)
    if training:
        cum = torch.cumsum(pats.to(torch.float32), dim=2)
        total = cum[:, :, -1:]
        r = torch.rand(total.shape, generator=generator, device=x.device)
        idx = (cum >= r * total).to(torch.float32).argmax(dim=2, keepdim=True)
        return torch.gather(pats, 2, idx)[:, :, 0]
    pf = pats.to(torch.float32)
    ssum = pf.sum(dim=2)
    ssq = (pf * pf).sum(dim=2)
    return (ssq / (float(np.finfo(np.float32).tiny) + ssum)).to(x.dtype)


def inner_product(x2d: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  transpose: bool = False) -> torch.Tensor:
    """x2d (M, K) against Caffe's weight (N, K), or (K, N) with
    ``transpose``."""
    w = w.to(x2d.dtype)
    b = None if b is None else b.to(x2d.dtype)
    if transpose:
        y = x2d @ w
        return y if b is None else y + b
    return F.linear(x2d, w, b)


def _channel_window_sum(sq: torch.Tensor, size: int) -> torch.Tensor:
    """Sum over a window of ``size`` channels centred at each channel, zero
    past the ends: half = (size - 1) / 2 before, the rest after."""
    half = (size - 1) // 2
    c = sq.shape[1]
    padded = F.pad(sq, (0, 0, 0, 0, half, size - 1 - half))
    out = padded.narrow(1, 0, c)
    for i in range(1, size):
        out = out + padded.narrow(1, i, c)
    return out


def lrn_across_channels(x: torch.Tensor, local_size: int, alpha: float, beta: float,
                        k: float) -> torch.Tensor:
    """LRN ACROSS_CHANNELS: x * (k + alpha/n * sum of x^2 over n channels)^-beta."""
    sq = (x * x).to(torch.float32)
    scale = k + (alpha / local_size) * _channel_window_sum(sq, local_size)
    return x * torch.pow(scale, -beta).to(x.dtype)


def lrn_within_channel(x: torch.Tensor, local_size: int, alpha: float, beta: float,
                       k: float, rows: bool = False) -> torch.Tensor:
    """LRN WITHIN_CHANNEL: the window is local_size^2 pixels, zero-padded.
    ``rows``: ``x`` already holds (local_size - 1) / 2 rows of padding (or
    of the neighbours' rows) above and below; the result has those rows
    fewer."""
    half = (local_size - 1) // 2
    sq = (x * x).to(torch.float32)
    pad_h = (0, 0) if rows else (half, local_size - 1 - half)
    sq = F.pad(sq, (half, local_size - 1 - half) + pad_h)
    ssum = F.avg_pool2d(sq, local_size, stride=1, divisor_override=1)
    scale = k + (alpha / (local_size * local_size)) * ssum
    if rows:
        x = x.narrow(2, half, ssum.shape[2])
    return x * torch.pow(scale, -beta).to(x.dtype)


def _channel_shape(x: torch.Tensor, channel_axis: int):
    shape = [1] * x.dim()
    shape[channel_axis] = x.shape[channel_axis]
    return shape


def batch_norm_inference(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                         scale_factor: torch.Tensor, eps: float,
                         channel_axis: int = 1) -> torch.Tensor:
    """BatchNorm with stored statistics (TEST / use_global_stats): the blobs
    are unscaled accumulators, divided by the scale factor first
    (batch_norm_layer.cpp)."""
    sf = torch.where(scale_factor == 0, torch.ones_like(scale_factor), scale_factor)
    shape = _channel_shape(x, channel_axis)
    m = (mean / sf).to(torch.float32).reshape(shape)
    v = (var / sf).to(torch.float32).reshape(shape)
    return ((x.to(torch.float32) - m) * torch.rsqrt(v + eps)).to(x.dtype)


def batch_norm_training(x: torch.Tensor, eps: float, channel_axis: int = 1, reduce=None):
    """(normalized x, batch mean, batch variance): the biased (1/m) variance
    of the centred activations, as Caffe; the solver rolls the running
    statistics from the mean and variance.  ``reduce(t) -> t``: the sum of
    a per-channel tensor over the ranks holding the rest of the batch (None:
    this is the whole batch)."""
    axes = tuple(i for i in range(x.dim()) if i != channel_axis)
    shape = _channel_shape(x, channel_axis)
    xf = x.to(torch.float32)
    if reduce is None:
        m = torch.mean(xf, dim=axes)
        v = torch.mean(torch.square(xf - m.reshape(shape)), dim=axes)
    else:
        count = reduce(torch.full((1,), xf.numel() / xf.shape[channel_axis],
                                  dtype=torch.float32, device=x.device))
        m = reduce(xf.sum(dim=axes)) / count
        v = reduce(torch.square(xf - m.reshape(shape)).sum(dim=axes)) / count
    y = (xf - m.reshape(shape)) * torch.rsqrt(v.reshape(shape) + eps)
    return y.to(x.dtype), m, v


def mvn(x: torch.Tensor, normalize_variance: bool, across_channels: bool,
        eps: float) -> torch.Tensor:
    """MVN (mvn_layer.cpp): per sample over H, W (and C when
    ``across_channels``); the deviation as sqrt(E[x^2] - E[x]^2) + eps."""
    if x.dim() == 4:
        axes = (1, 2, 3) if across_channels else (2, 3)
    else:
        axes = tuple(range(1, x.dim()))
    xf = x.to(torch.float32)
    m = torch.mean(xf, dim=axes, keepdim=True)
    y = xf - m
    if normalize_variance:
        var = torch.mean(torch.square(xf), dim=axes, keepdim=True) - torch.square(m)
        y = y / (torch.sqrt(var) + eps)
    return y.to(x.dtype)


def im2col(x: torch.Tensor, k: Tuple[int, int], s: Tuple[int, int],
           p: Tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) -> (N, C*kh*kw, oh, ow), channel slowest then kernel row
    and column (im2col_layer.cpp)."""
    n, c, h, w = x.shape
    oh = (h + 2 * p[0] - k[0]) // s[0] + 1
    ow = (w + 2 * p[1] - k[1]) // s[1] + 1
    cols = F.unfold(x, k, padding=p, stride=s)
    return cols.reshape(n, c * k[0] * k[1], oh, ow)
