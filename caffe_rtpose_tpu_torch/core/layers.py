"""Layer registry: Caffe layer type -> an ``nn.Module`` built for its shapes.

Counterpart of ``caffe_rtpose_tpu/core/layers.py`` (which replaces Caffe's
``Layer::Forward`` dispatch, reference include/caffe/layer.hpp).  ``Net``
calls :func:`build` once a prototxt layer; the builder reads the layer's
parameters, checks and computes its top shapes from its bottoms' (Caffe
NCHW shapes) and returns a :class:`LayerModule`.  ``LayerModule.run(bots,
ctx)`` maps the bottom tensors to the top tensors; autograd is the
backward.  One registry (:data:`REGISTRY`, :func:`register`) holds every
type, those of ``core/layers_extra.py`` too: ``Net`` has no other dispatch.

Tensors are logically NCHW, so a flatten or reshape reads them in Caffe's
order whatever their memory format (``.reshape``, never ``.view``: the net
keeps 4-D activations ``channels_last``).  Parameter blobs are kept in
Caffe's layout (convolution OIHW, deconvolution (Cin, Cout/g, kh, kw), inner
product (N, K) or (K, N) with ``transpose``), so a ``.caffemodel`` loads
and saves without a transpose.  ``Input`` builds nothing: ``Net`` binds its
tops as inputs, as it binds the data layers' (``core/data_layers.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import elementwise as ew
from ..ops import losses as op_losses
from ..ops import nn as nn_ops
from ..proto import caffe_pb
from ..proto.caffe_pb import (ELTWISE_OP, HINGE_NORM, LOSS_NORMALIZATION, NORM_REGION,
                              POOL_METHOD, REDUCTION_OP, View)

Shape = Tuple[int, ...]

# types whose tops are losses: loss_weight defaults to 1 (layer.hpp SetLossWeights)
LOSS_TYPES = {"SoftmaxWithLoss", "EuclideanLoss", "EuclideanmaskLoss",
              "SigmoidCrossEntropyLoss", "HingeLoss", "MultinomialLogisticLoss",
              "ContrastiveLoss", "InfogainLoss"}


@dataclass
class Layer:
    """One prototxt layer as ``Net`` keeps it."""

    name: str
    type: str
    bottoms: List[str]
    tops: List[str]
    param: Dict[str, Any] = field(default_factory=dict)  # the layer's *_param, raw
    loss_weights: List[float] = field(default_factory=list)  # one per top; 0 = none
    specs: List[View] = field(default_factory=list, repr=False)  # ParamSpecs
    lv: Optional[View] = field(default=None, repr=False, compare=False)


@dataclass
class BuildCtx:
    layer: Layer
    bshapes: List[Shape]
    phase: str  # 'TRAIN' | 'TEST'

    @property
    def lv(self) -> View:
        return self.layer.lv

    @property
    def train(self) -> bool:
        return self.phase == "TRAIN"

    def require_bottoms(self, n: int) -> None:
        if len(self.bshapes) != n:
            raise ValueError(f"layer {self.layer.name}: expected {n} bottoms, "
                             f"got {len(self.bshapes)}")


@dataclass
class RunCtx:
    """What a forward hands each layer: the convolutions' operands
    (``Net.operands``), the phase flag, the generator random layers draw from
    (on the net's device), the net's device, runtime knobs (``switch_index``)
    and, when not None, a dict that collects BatchNorm's
    batch statistics by layer name for the solver's roll.  ``shard``: the
    layout of a forward run on one rank of several (``parallel/``): it
    convolves (a slab of rows with its halo, or a share of the filters),
    hands a window layer the rows it reads (``row_window``), sums batch
    statistics over the ranks and turns a loss's local normalizer into the
    global one."""

    ops: Mapping[str, torch.Tensor] = field(default_factory=dict)
    training: bool = False
    generator: Optional[torch.Generator] = None
    knobs: Optional[Mapping[str, Any]] = None
    aux: Optional[Dict[str, Any]] = None
    device: torch.device = torch.device("cpu")  # where sources put their tops
    shard: Optional[Any] = None


REGISTRY: Dict[str, Callable[[BuildCtx], "LayerModule"]] = {}


def register(type_name: str):
    def deco(fn):
        REGISTRY[type_name] = fn
        return fn

    return deco


def build(ctx: BuildCtx) -> "LayerModule":
    t = ctx.layer.type
    if t not in REGISTRY:
        raise NotImplementedError(f"layer type {t!r} (layer {ctx.layer.name!r}) not implemented")
    return REGISTRY[t](ctx)


# ----------------------------------------------------------------- helpers


def ints(v) -> List[int]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)]


def hw(p: Mapping[str, Any], key: str, default: Optional[int],
       prefix: Optional[str] = None) -> Tuple[int, int]:
    """Caffe's geometry fields: ``<prefix>_h``/``<prefix>_w`` when given,
    else the repeated (or scalar) ``key``."""
    prefix = prefix or key
    if f"{prefix}_h" in p or f"{prefix}_w" in p:
        return int(p.get(f"{prefix}_h", 0)), int(p.get(f"{prefix}_w", 0))
    vals = ints(p.get(key))
    if not vals:
        if default is None:
            raise ValueError(f"{key} unset")
        return default, default
    return (vals[0], vals[0]) if len(vals) == 1 else (vals[0], vals[1])


def enum(v, table: Mapping[str, int]) -> int:
    return table[v] if isinstance(v, str) else int(v)


def filler_view(v: View, name: str, default: Mapping[str, Any]) -> View:
    return getattr(v, name) if v.has(name) else caffe_pb.view(dict(default), "FillerParameter")


def _axis(axis: int, ndim: int) -> int:
    return axis + ndim if axis < 0 else axis


def flatten_logits(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N*H*W, C) for the softmax family (Caffe treats each
    position as a prediction); 2-D stays; others (N, rest)."""
    if x.dim() == 4:
        return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    if x.dim() == 2:
        return x
    return x.reshape(x.shape[0], -1)


class LayerModule(nn.Module):
    """A built layer: its top shapes and its parameter blobs in Caffe's
    order and layout, each with ``lr_mult``/``decay_mult`` from its
    ParamSpec and the filler ``Net.init_params`` fills it with (None: not
    filled, as BatchNorm's statistics).  A blob requires a gradient in a
    TRAIN net unless its ``lr_mult`` is 0 (Caffe computes no diff then).

    ``rows`` says how the layer reads the rows (axis 2) of its 4-D bottoms,
    which a forward split over rows (``parallel/sp.py``) plans by:
    ``"local"``, each output row from the same input row (elementwise
    layers, channel concat, the positionwise losses); ``"window"``, each
    output row from a window of input rows (``window`` = (kernel, stride,
    pad, dilation) along H; ``transposed`` for a deconvolution), read
    through ``RunCtx.shard.row_window``; ``"whole"`` (the default), any
    other layer: it gets whole bottoms."""

    rows = "whole"
    window: Optional[Tuple[int, int, int, int]] = None
    transposed = False

    def __init__(self, ctx: BuildCtx, top_shapes: Sequence[Shape] = ()):
        super().__init__()
        self.name = ctx.layer.name
        self.type = ctx.layer.type
        self.top_shapes: List[Shape] = [tuple(int(d) for d in s) for s in top_shapes]
        self.lr_mult: List[float] = []
        self.decay_mult: List[float] = []
        self.fillers: List[Any] = []
        self._blob_names: List[str] = []

    def add_blob(self, ctx: BuildCtx, attr: str, shape: Shape, filler,
                 mults: Optional[Tuple[float, float]] = None) -> nn.Parameter:
        i = len(self._blob_names)
        specs = ctx.layer.specs
        if mults is None:
            mults = ((float(specs[i].lr_mult), float(specs[i].decay_mult)) if i < len(specs)
                     else (1.0, 1.0))
        blob = nn.Parameter(torch.zeros(tuple(int(d) for d in shape)),
                            requires_grad=ctx.train and mults[0] != 0.0)
        setattr(self, attr, blob)
        self._blob_names.append(attr)
        self.lr_mult.append(mults[0])
        self.decay_mult.append(mults[1])
        self.fillers.append(filler)
        return blob

    def blobs(self) -> List[nn.Parameter]:
        return [getattr(self, n) for n in self._blob_names]

    def run(self, bots: List[torch.Tensor], ctx: RunCtx) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError


class FnLayer(LayerModule):
    """A layer without parameters: ``fn(bots, ctx) -> tops``."""

    def __init__(self, ctx: BuildCtx, top_shapes, fn):
        super().__init__(ctx, top_shapes)
        self.fn = fn

    def run(self, bots, ctx):
        return tuple(self.fn(bots, ctx))


def _local(mod: LayerModule, local: bool = True) -> LayerModule:
    """``mod`` marked row-local (``LayerModule.rows``) when ``local``."""
    if local:
        mod.rows = "local"
    return mod


def _same(ctx: BuildCtx, fn) -> FnLayer:
    """A one-bottom elementwise layer: its top has the bottom's shape."""
    return _local(FnLayer(ctx, [ctx.bshapes[0]], lambda b, c: (fn(b[0]),)))


def _not_h(axis: int, shape: Shape) -> bool:
    """Whether ``axis`` of a ``shape`` blob is not the rows of a 4-D blob."""
    return len(shape) != 4 or axis != 2


def rows_of(ctx: RunCtx, mod: LayerModule, x: torch.Tensor, fill: float = 0.0):
    """(the input rows ``mod`` reads, their placement): all of ``x`` and
    None on one device, else the layout's window (``row_window``)."""
    return (x, None) if ctx.shard is None else ctx.shard.row_window(mod, x, fill)


# -------------------------------------------------------------------- conv


def conv_operands(weight: torch.Tensor, bias: Optional[torch.Tensor],
                  dtype: torch.dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A convolution's operands from its f32 parameters (OIHW weight in the
    net's layout): the parameters themselves in f32, else copies in
    ``dtype``, the weight channels_last.  A bf16 TRAIN net asks for f32: its
    convolutions cast the parameters inside the forward
    (``ops/nn.py::conv2d``), where a copy made at load would be stale after
    each update and carry no gradient."""
    if dtype == torch.float32:
        return weight, bias
    return (weight.detach().to(dtype).contiguous(memory_format=torch.channels_last),
            None if bias is None else bias.detach().to(dtype))


def f32_training(ctx: RunCtx, x: torch.Tensor, *operands: Optional[torch.Tensor]) -> bool:
    """An f32 convolution that autograd may differentiate, which runs outside
    cuDNN (``ops/nn.py::_OutsideCudnn``: cuDNN's f32 backward moves
    gradients, ROADMAP C1 and C2): any TRAIN forward, and any forward under
    grad mode whose input or operands require a gradient (``Net.backward``
    of a deploy or TEST net).  A forward under ``no_grad`` or
    ``inference_mode`` outside TRAIN stays on cuDNN."""
    if x.dtype != torch.float32:
        return False
    return ctx.training or (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, *operands)))


class Convolution(LayerModule):
    """Caffe Convolution with an OIHW weight and an optional bias.  Its
    forward convolves with operands handed in (its own ``_operands``, or a
    device program's inputs, ``Net.operands``)."""

    def __init__(self, ctx: BuildCtx):
        p = ctx.layer.param
        n, cin, h, w = ctx.bshapes[0]
        self.cout = int(p["num_output"])
        self.kernel = hw(p, "kernel_size", None, "kernel")
        self.stride = hw(p, "stride", 1)
        self.pad = hw(p, "pad", 0)
        dil = ints(p.get("dilation"))
        self.dilation = (1, 1) if not dil else (dil[0], dil[-1])
        self.groups = int(p.get("group", 1))
        if cin % self.groups or self.cout % self.groups:
            raise ValueError(f"channels {cin}->{self.cout} not divisible by group {self.groups}")
        super().__init__(ctx, [(n, self.cout) + self.out_hw(h, w)])
        self.rows = "window"
        self.window = (self.kernel[0], self.stride[0], self.pad[0], self.dilation[0])
        cp = ctx.lv.convolution_param
        self.add_blob(ctx, "weight", (self.cout, cin // self.groups, *self.kernel),
                      cp.weight_filler)
        self.bias = None
        if cp.bias_term:
            self.add_blob(ctx, "bias", (self.cout,), cp.bias_filler)
        self.compute_weights(torch.float32)

    def compute_weights(self, dtype: torch.dtype) -> None:
        """Make the operands ``forward`` convolves with (:func:`conv_operands`,
        once per load); a tuple, so they are not registered twice."""
        self._operands = conv_operands(self.weight, self.bias, dtype)

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        dims = []
        for size, k, s, pd, d in zip((h, w), self.kernel, self.stride, self.pad, self.dilation):
            dims.append((size + 2 * pd - (d * (k - 1) + 1)) // s + 1)
        return dims[0], dims[1]

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor], cudnn: bool = True) -> torch.Tensor:
        return nn_ops.conv2d(x, w, b, stride=self.stride, pad=self.pad,
                             dilation=self.dilation, groups=self.groups, cudnn=cudnn)

    def run(self, bots, ctx):
        w = ctx.ops.get(f"{self.name}::w")
        if w is None:
            w, b = self._operands
        else:
            b = ctx.ops.get(f"{self.name}::b")
        cudnn = not f32_training(ctx, bots[0], w, b)
        if ctx.shard is not None:
            return (ctx.shard.conv(self, bots[0], w, b, cudnn),)
        return (self(bots[0], w, b, cudnn=cudnn),)

    def is_3x3_same(self, cin: int, cout: int) -> bool:
        """A 3x3, stride 1, pad 1, ungrouped, undilated conv cin -> cout
        with bias."""
        return (tuple(self.weight.shape) == (cout, cin, 3, 3) and self.stride == (1, 1)
                and self.pad == (1, 1) and self.dilation == (1, 1) and self.groups == 1
                and self.bias is not None)


register("Convolution")(Convolution)


class Deconvolution(LayerModule):
    def __init__(self, ctx: BuildCtx):
        p = ctx.layer.param
        n, cin, h, w = ctx.bshapes[0]
        cout = int(p["num_output"])
        self.kernel = hw(p, "kernel_size", None, "kernel")
        self.stride = hw(p, "stride", 1)
        self.pad = hw(p, "pad", 0)
        dil = ints(p.get("dilation"))
        self.dilation = (1, 1) if not dil else (dil[0], dil[-1])
        self.groups = int(p.get("group", 1))
        out = [s * (i - 1) + d * (k - 1) + 1 - 2 * pd for i, k, s, pd, d in
               zip((h, w), self.kernel, self.stride, self.pad, self.dilation)]
        super().__init__(ctx, [(n, cout, out[0], out[1])])
        self.rows, self.transposed = "window", True
        self.window = (self.kernel[0], self.stride[0], self.pad[0], self.dilation[0])
        cp = ctx.lv.convolution_param
        # Caffe's deconvolution blob: (Cin, Cout/g, kh, kw)
        self.add_blob(ctx, "weight", (cin, cout // self.groups, *self.kernel), cp.weight_filler)
        self.bias = self.add_blob(ctx, "bias", (cout,), cp.bias_filler) if cp.bias_term else None

    def run(self, bots, ctx):
        # the f32 parameters: in bf16, deconv2d casts inside the forward
        cudnn = not f32_training(ctx, bots[0], self.weight, self.bias)
        x, rows = rows_of(ctx, self, bots[0])
        if rows is None:
            return (nn_ops.deconv2d(x, self.weight, self.bias, stride=self.stride, pad=self.pad,
                                    dilation=self.dilation, groups=self.groups, cudnn=cudnn),)
        # input rows [a, ...) make output rows from a * s - p on: keep [lo, hi)
        _, lo, hi, a = rows
        y = nn_ops.deconv2d(x, self.weight, None, stride=self.stride, pad=(0, self.pad[1]),
                            dilation=self.dilation, groups=self.groups, cudnn=cudnn)
        off = lo - (a * self.stride[0] - self.pad[0])
        short = off + hi - lo - y.shape[2]
        if short > 0:  # rows no input reaches (a kernel shorter than the stride)
            y = torch.nn.functional.pad(y, (0, 0, 0, short))
        y = y.narrow(2, off, hi - lo)
        return (y if self.bias is None else y + self.bias.to(y.dtype).reshape(1, -1, 1, 1),)


register("Deconvolution")(Deconvolution)


class Pooling(LayerModule):
    def __init__(self, ctx: BuildCtx):
        p = ctx.layer.param
        n, c, h, w = ctx.bshapes[0]
        self.method = enum(p.get("pool", 0), POOL_METHOD)
        if p.get("global_pooling"):
            self.k, self.s, self.p = (h, w), (1, 1), (0, 0)
        else:
            self.k = hw(p, "kernel_size", None, "kernel")
            self.s = hw(p, "stride", 1)
            self.p = hw(p, "pad", 0)
        if self.method == POOL_METHOD["STOCHASTIC"] and any(self.p):
            # pooling_layer.cpp:36-41: padding only for AVE and MAX
            raise ValueError("Padding implemented only for average and max pooling.")
        self.sample = self.method == POOL_METHOD["STOCHASTIC"] and ctx.train
        super().__init__(ctx, [(n, c, nn_ops.pooled_size(h, self.k[0], self.s[0], self.p[0]),
                                nn_ops.pooled_size(w, self.k[1], self.s[1], self.p[1]))])
        if not p.get("global_pooling"):
            self.rows = "window"
            self.window = (self.k[0], self.s[0], self.p[0], 1)

    def is_max_2x2(self) -> bool:
        return (self.method == POOL_METHOD["MAX"] and self.k == (2, 2) and self.s == (2, 2)
                and self.p == (0, 0))

    def run(self, bots, ctx):
        is_max = self.method == POOL_METHOD["MAX"]
        # a max pool's padding never wins; the others' adds nothing
        x, rows = rows_of(ctx, self, bots[0], -float("inf") if is_max else 0.0)
        if is_max:
            return (nn_ops.max_pool2d(x, self.k, self.s,
                                      self.p if rows is None else (0, self.p[1])),)
        if self.method == POOL_METHOD["AVE"]:
            return (nn_ops.avg_pool2d(x, self.k, self.s, self.p,
                                      None if rows is None else rows[:3]),)
        # samples only when both the build phase and the run say train
        return (nn_ops.stochastic_pool2d(x, self.k, self.s, ctx.generator,
                                         self.sample and ctx.training),)


register("Pooling")(Pooling)


class InnerProduct(LayerModule):
    def __init__(self, ctx: BuildCtx):
        ip = ctx.lv.inner_product_param
        shape = ctx.bshapes[0]
        self.axis = _axis(int(ip.axis), len(shape))
        self.m = int(np.prod(shape[: self.axis])) if self.axis > 0 else 1
        self.k = int(np.prod(shape[self.axis:]))
        n_out = int(ip.num_output)
        self.transpose = bool(ip.transpose)
        super().__init__(ctx, [tuple(shape[: self.axis]) + (n_out,)])
        self.add_blob(ctx, "weight", (self.k, n_out) if self.transpose else (n_out, self.k),
                      ip.weight_filler)
        self.bias = self.add_blob(ctx, "bias", (n_out,), ip.bias_filler) if ip.bias_term else None

    def run(self, bots, ctx):
        # the batch as fed, which a rank of a data-parallel step holds a share of
        lead = tuple(bots[0].shape[: self.axis])
        x = bots[0].reshape(-1, self.k)
        if ctx.shard is not None:
            return (ctx.shard.inner_product(self, x).reshape(lead + (-1,)),)
        y = nn_ops.inner_product(x, self.weight, self.bias, self.transpose)
        return (y.reshape(lead + (-1,)),)


register("InnerProduct")(InnerProduct)


# -------------------------------------------------------------- activations


@register("ReLU")
class ReLU(LayerModule):
    rows = "local"

    def __init__(self, ctx: BuildCtx):
        super().__init__(ctx, [ctx.bshapes[0]])
        self.slope = float(ctx.lv.relu_param.negative_slope)

    def run(self, bots, ctx):
        return (ew.relu(bots[0], self.slope),)


@register("Sigmoid")
def build_sigmoid(ctx):
    return _same(ctx, ew.sigmoid)


@register("TanH")
def build_tanh(ctx):
    return _same(ctx, ew.tanh)


@register("AbsVal")
def build_absval(ctx):
    return _same(ctx, ew.absval)


@register("BNLL")
def build_bnll(ctx):
    return _same(ctx, ew.bnll)


@register("ELU")
def build_elu(ctx):
    alpha = float(ctx.lv.elu_param.alpha)
    return _same(ctx, lambda x: ew.elu(x, alpha))


@register("Power")
def build_power(ctx):
    pp = ctx.lv.power_param
    return _same(ctx, lambda x: ew.power(x, float(pp.power), float(pp.scale), float(pp.shift)))


@register("Exp")
def build_exp(ctx):
    pp = ctx.lv.exp_param
    return _same(ctx, lambda x: ew.exp(x, float(pp.base), float(pp.scale), float(pp.shift)))


@register("Log")
def build_log(ctx):
    pp = ctx.lv.log_param
    return _same(ctx, lambda x: ew.log(x, float(pp.base), float(pp.scale), float(pp.shift)))


@register("Threshold")
def build_threshold(ctx):
    t = float(ctx.lv.threshold_param.threshold)
    return _same(ctx, lambda x: ew.threshold(x, t))


@register("PReLU")
class PReLU(LayerModule):
    rows = "local"

    def __init__(self, ctx: BuildCtx):
        super().__init__(ctx, [ctx.bshapes[0]])
        pp = ctx.lv.prelu_param
        shape = ctx.bshapes[0]
        n_slopes = 1 if pp.channel_shared else shape[1]
        self.channel_axis = 1 if len(shape) > 1 else 0
        self.add_blob(ctx, "slopes", (n_slopes,),
                      filler_view(pp, "filler", {"type": "constant", "value": 0.25}))

    def run(self, bots, ctx):
        return (ew.prelu(bots[0], self.slopes.to(bots[0].dtype), self.channel_axis),)


@register("Dropout")
class Dropout(LayerModule):
    """Drops in a TRAIN net only (the build phase decides, as in JAX)."""

    rows = "local"

    def __init__(self, ctx: BuildCtx):
        super().__init__(ctx, [ctx.bshapes[0]])
        self.ratio = float(ctx.lv.dropout_param.dropout_ratio)
        self.active = ctx.train

    def run(self, bots, ctx):
        return (ew.dropout(bots[0], self.ratio, ctx.generator, self.active),)


# ----------------------------------------------------------- normalization


@register("LRN")
class LRN(LayerModule):
    def __init__(self, ctx: BuildCtx):
        super().__init__(ctx, [ctx.bshapes[0]])
        pp = ctx.lv.lrn_param
        self.size = int(pp.local_size)
        self.alpha, self.beta, self.k = float(pp.alpha), float(pp.beta), float(pp.k)
        self.across = enum(pp.norm_region, NORM_REGION) == NORM_REGION["ACROSS_CHANNELS"]
        if self.across:
            self.rows = "local"
        else:
            self.rows = "window"
            self.window = (self.size, 1, (self.size - 1) // 2, 1)

    def run(self, bots, ctx):
        if self.across:
            return (nn_ops.lrn_across_channels(bots[0], self.size, self.alpha, self.beta,
                                               self.k),)
        x, rows = rows_of(ctx, self, bots[0])
        return (nn_ops.lrn_within_channel(x, self.size, self.alpha, self.beta, self.k,
                                          rows is not None),)


@register("BatchNorm")
class BatchNorm(LayerModule):
    """Three non-learnable blobs: the mean and variance accumulators and
    their scale factor.  With ``use_global_stats`` (default in TEST) it
    normalizes by them; otherwise by the batch's statistics, which it leaves
    in ``ctx.aux`` for the solver to roll (``Solver._bn_roll``).  On one
    rank of several they are the whole batch's: the sums are added up over
    the ranks that hold other samples or rows (``RunCtx.shard.stat_axes``)."""

    rows = "local"

    def __init__(self, ctx: BuildCtx):
        super().__init__(ctx, [ctx.bshapes[0]])
        bp = ctx.lv.batch_norm_param
        shape = ctx.bshapes[0]
        c = shape[1]
        self.eps = float(bp.eps)
        self.use_global = (bool(bp.use_global_stats) if bp.has("use_global_stats")
                           else not ctx.train)
        for attr, s in (("mean", (c,)), ("variance", (c,)), ("scale_factor", (1,))):
            self.add_blob(ctx, attr, s, None, mults=(0.0, 0.0))
        self.maf = float(bp.moving_average_fraction)
        # the per-channel element count m = N*H*W
        self.count = int(np.prod([d for i, d in enumerate(shape) if i != 1]))

    def run(self, bots, ctx):
        x = bots[0]
        if self.use_global:
            return (nn_ops.batch_norm_inference(x, self.mean, self.variance,
                                                self.scale_factor[0], self.eps),)
        reduce = None
        if ctx.shard is not None and ctx.shard.stat_axes(self.name):
            reduce = lambda t: ctx.shard.sum_stats(self.name, t)  # noqa: E731
        y, mu, var = nn_ops.batch_norm_training(x, self.eps, reduce=reduce)
        if ctx.aux is not None:
            ctx.aux[self.name] = (mu.detach(), var.detach())
        return (y,)


def _gshape(ctx: BuildCtx, axis: int, num_axes: int) -> Shape:
    if len(ctx.bshapes) == 2:
        return tuple(ctx.bshapes[1])
    shape = ctx.bshapes[0]
    return tuple(shape[axis: axis + num_axes]) if num_axes >= 0 else tuple(shape[axis:])


@register("Scale")
class Scale(LayerModule):
    def __init__(self, ctx: BuildCtx):
        super().__init__(ctx, [ctx.bshapes[0]])
        sp = ctx.lv.scale_param
        self.axis = _axis(int(sp.axis), len(ctx.bshapes[0]))
        self.two = len(ctx.bshapes) == 2
        gshape = _gshape(ctx, self.axis, int(sp.num_axes))
        _local(self, not self.two and (len(ctx.bshapes[0]) != 4 or self.axis + len(gshape) <= 2))
        if not self.two:
            self.add_blob(ctx, "gamma", gshape,
                          filler_view(sp, "filler", {"type": "constant", "value": 1.0}))
        self.beta = None
        if sp.bias_term:
            self.add_blob(ctx, "beta", gshape,
                          filler_view(sp, "bias_filler", {"type": "constant", "value": 0.0}))

    def run(self, bots, ctx):
        x = bots[0]
        g = bots[1] if self.two else self.gamma.to(x.dtype)
        b = None if self.beta is None else self.beta.to(x.dtype)
        return (ew.scale_op(x, g, b, self.axis),)


@register("Bias")
class Bias(LayerModule):
    def __init__(self, ctx: BuildCtx):
        super().__init__(ctx, [ctx.bshapes[0]])
        bp = ctx.lv.bias_param
        self.axis = _axis(int(bp.axis), len(ctx.bshapes[0]))
        self.two = len(ctx.bshapes) == 2
        gshape = _gshape(ctx, self.axis, int(bp.num_axes))
        _local(self, not self.two and (len(ctx.bshapes[0]) != 4 or self.axis + len(gshape) <= 2))
        if not self.two:
            self.add_blob(ctx, "beta", gshape,
                          filler_view(bp, "filler", {"type": "constant", "value": 0.0}))

    def run(self, bots, ctx):
        x = bots[0]
        g = bots[1] if self.two else self.beta.to(x.dtype)
        shape = [1] * x.dim()
        for i, d in enumerate(g.shape):
            shape[self.axis + i] = d
        return (x + g.reshape(shape),)


@register("MVN")
def build_mvn(ctx):
    pp = ctx.lv.mvn_param
    nv, ac, eps = bool(pp.normalize_variance), bool(pp.across_channels), float(pp.eps)
    return _same(ctx, lambda x: nn_ops.mvn(x, nv, ac, eps))


# --------------------------------------------------------------- shape ops


@register("Concat")
class Concat(LayerModule):
    def __init__(self, ctx: BuildCtx):
        p = ctx.layer.param
        shape = ctx.bshapes[0]
        self.axis = _axis(int(p.get("axis", p.get("concat_dim", 1))), len(shape))
        out = list(shape)
        out[self.axis] = sum(s[self.axis] for s in ctx.bshapes)
        super().__init__(ctx, [tuple(out)])
        _local(self, _not_h(self.axis, shape))

    def run(self, bots, ctx):
        return (torch.cat(bots, dim=self.axis),)


@register("Slice")
class Slice(LayerModule):
    def __init__(self, ctx: BuildCtx):
        p = ctx.layer.param
        shape = ctx.bshapes[0]
        self.axis = _axis(int(p.get("axis", 1)), len(shape))
        total, n_tops = shape[self.axis], len(ctx.layer.tops)
        points = ints(p.get("slice_point"))
        if not points:
            points = [total // n_tops * (i + 1) for i in range(n_tops - 1)]
        self.bounds = [0] + points + [total]
        if len(self.bounds) != n_tops + 1 or any(a > b for a, b in zip(self.bounds,
                                                                     self.bounds[1:])):
            raise ValueError(f"layer {ctx.layer.name}: slice points {points} for {n_tops} "
                             f"tops of {total}")
        outs = []
        for a, b in zip(self.bounds, self.bounds[1:]):
            out = list(shape)
            out[self.axis] = b - a
            outs.append(tuple(out))
        super().__init__(ctx, outs)
        _local(self, _not_h(self.axis, shape))

    def run(self, bots, ctx):
        b = self.bounds
        return tuple(bots[0].narrow(self.axis, b[j], b[j + 1] - b[j]) for j in range(len(b) - 1))


@register("Split")
def build_split(ctx):
    n = len(ctx.layer.tops)
    return _local(FnLayer(ctx, [ctx.bshapes[0]] * n, lambda b, c: (b[0],) * n))


@register("Silence")
def build_silence(ctx):
    return _local(FnLayer(ctx, [], lambda b, c: ()))


def _reshaped(ctx: BuildCtx, out_shape: Shape) -> FnLayer:
    return FnLayer(ctx, [out_shape], lambda b, c: (b[0].reshape(out_shape),))


@register("Flatten")
def build_flatten(ctx):
    fp = ctx.lv.flatten_param
    cs = ctx.bshapes[0]
    axis, end = _axis(int(fp.axis), len(cs)), _axis(int(fp.end_axis), len(cs))
    out = tuple(cs[:axis]) + (int(np.prod(cs[axis: end + 1])),) + tuple(cs[end + 1:])
    return _reshaped(ctx, out)


@register("Reshape")
def build_reshape(ctx):
    rp = ctx.lv.reshape_param
    cs = ctx.bshapes[0]
    axis = _axis(int(rp.axis), len(cs))
    end = len(cs) if int(rp.num_axes) == -1 else axis + int(rp.num_axes)
    mid = [cs[axis + i] if int(d) == 0 else int(d) for i, d in enumerate(rp.shape.dim)]
    fixed = int(np.prod([d for d in mid if d != -1]))
    src = int(np.prod(cs[axis:end])) if end > axis else 1
    mid = [src // max(fixed, 1) if d == -1 else d for d in mid]
    return _reshaped(ctx, tuple(cs[:axis]) + tuple(mid) + tuple(cs[end:]))


@register("Crop")
class Crop(LayerModule):
    def __init__(self, ctx: BuildCtx):
        ctx.require_bottoms(2)
        cp = ctx.lv.crop_param
        a, b = ctx.bshapes
        axis = _axis(int(cp.axis), len(a))
        offsets = [int(o) for o in cp.offset]
        self.starts, sizes = [], []
        for i in range(len(a)):
            if i < axis:
                self.starts.append(0)
                sizes.append(a[i])
            else:
                j = i - axis
                self.starts.append(offsets[j] if j < len(offsets)
                                   else (offsets[0] if len(offsets) == 1 else 0))
                sizes.append(b[i])
        super().__init__(ctx, [tuple(sizes)])

    def run(self, bots, ctx):
        y = bots[0]
        for d, (st, n) in enumerate(zip(self.starts, self.top_shapes[0])):
            if st or n != y.shape[d]:
                y = y.narrow(d, st, n)
        return (y,)


@register("Eltwise")
class Eltwise(LayerModule):
    def __init__(self, ctx: BuildCtx):
        p = ctx.layer.param
        bshape = ctx.bshapes
        self.op = enum(p.get("operation", ELTWISE_OP["SUM"]), ELTWISE_OP)
        coeffs = p.get("coeff")
        self.coeffs = ([float(x) for x in (coeffs if isinstance(coeffs, (list, tuple))
                                           else [coeffs])] if coeffs is not None
                       else [1.0] * len(bshape))
        if len(self.coeffs) != len(bshape):
            # eltwise_layer.cpp: one coefficient per bottom
            raise ValueError(f"layer {ctx.layer.name}: Eltwise takes one coefficient per bottom "
                             f"({len(self.coeffs)} coeffs vs {len(bshape)} bottoms)")
        if any(s != bshape[0] for s in bshape):
            raise ValueError(f"layer {ctx.layer.name}: Eltwise bottoms differ in shape {bshape}")
        super().__init__(ctx, [bshape[0]])
        self.rows = "local"

    def run(self, bots, ctx):
        if self.op == ELTWISE_OP["PROD"]:
            y = bots[0]
            for x in bots[1:]:
                y = y * x
        elif self.op == ELTWISE_OP["SUM"]:
            y = self.coeffs[0] * bots[0]
            for cf, x in zip(self.coeffs[1:], bots[1:]):
                y = y + cf * x
        else:  # MAX
            y = bots[0]
            for x in bots[1:]:
                y = torch.maximum(y, x)
        return (y,)


@register("Tile")
def build_tile(ctx):
    tp = ctx.lv.tile_param
    shape = list(ctx.bshapes[0])
    axis, tiles = _axis(int(tp.axis), len(shape)), int(tp.tiles)
    reps = [1] * len(shape)
    reps[axis] = tiles
    shape[axis] *= tiles
    return _local(FnLayer(ctx, [tuple(shape)], lambda b, c: (b[0].repeat(*reps),)),
                  _not_h(axis, ctx.bshapes[0]))


@register("ArgMax")
def build_argmax(ctx):
    ap = ctx.lv.argmax_param
    cs = ctx.bshapes[0]
    out_max_val, k = bool(ap.out_max_val), int(ap.top_k)
    if ap.has("axis"):
        axis = _axis(int(ap.axis), len(cs))
        out = list(cs)
        out[axis] = k

        def fn(b, c):
            vals, idx = torch.topk(torch.movedim(b[0], axis, -1), k, dim=-1)
            res = vals if out_max_val else idx.to(torch.float32)
            return (torch.movedim(res, -1, axis),)

        return _local(FnLayer(ctx, [tuple(out)], fn), _not_h(axis, cs))

    def fn_flat(b, c):
        vals, idx = torch.topk(b[0].reshape(cs[0], -1), k, dim=-1)
        if out_max_val:
            return (torch.stack([idx.to(vals.dtype), vals], dim=1),)
        return (idx.to(torch.float32)[:, None, :],)

    return FnLayer(ctx, [(cs[0], 2 if out_max_val else 1, k)], fn_flat)


@register("Reduction")
def build_reduction(ctx):
    rp = ctx.lv.reduction_param
    cs = ctx.bshapes[0]
    op, coeff = enum(rp.operation, REDUCTION_OP), float(rp.coeff)
    axis = _axis(int(rp.axis), len(cs))

    def fn(b, c):
        flat = b[0].reshape(tuple(cs[:axis]) + (-1,))
        if op == REDUCTION_OP["SUM"]:
            y = flat.sum(dim=-1)
        elif op == REDUCTION_OP["ASUM"]:
            y = flat.abs().sum(dim=-1)
        elif op == REDUCTION_OP["SUMSQ"]:
            y = (flat * flat).sum(dim=-1)
        else:  # MEAN
            y = flat.mean(dim=-1)
        return (coeff * y,)

    return FnLayer(ctx, [tuple(cs[:axis])], fn)


@register("Softmax")
def build_softmax(ctx):
    axis = _axis(int(ctx.lv.softmax_param.axis), len(ctx.bshapes[0]))
    mod = _same(ctx, lambda x: torch.softmax(x.to(torch.float32), dim=axis).to(x.dtype))
    mod.rows = "local" if _not_h(axis, ctx.bshapes[0]) else "whole"
    return mod


@register("Embed")
class Embed(LayerModule):
    def __init__(self, ctx: BuildCtx):
        ep = ctx.lv.embed_param
        n_out, k = int(ep.num_output), int(ep.input_dim)
        super().__init__(ctx, [tuple(ctx.bshapes[0]) + (n_out,)])
        self.add_blob(ctx, "weight", (k, n_out), ep.weight_filler)
        self.bias = self.add_blob(ctx, "bias", (n_out,), ep.bias_filler) if ep.bias_term else None

    def run(self, bots, ctx):
        y = self.weight[bots[0].to(torch.int64)]
        return (y if self.bias is None else y + self.bias,)


# ------------------------------------------------------------------ losses


def _loss(ctx: BuildCtx, fn, den=None, local: bool = True) -> FnLayer:
    """A loss layer.  ``den(bottoms) -> (normalizer, kind)`` names what
    ``fn`` divides by (None: a plain sum): on one rank of a sharded step the
    loss is rescaled to the global normalizer (``shard.normalizer``), so the
    ranks' losses add up to the loss of the whole batch.  ``kind`` is
    ``"batch"`` for a count of samples, ``"count"`` for a count of
    positions (samples times rows).  ``local``: a sum over positions, which
    a slab of rows computes its share of (``LayerModule.rows``)."""

    def run(b, c):
        loss = fn(b)
        if c.shard is None or den is None:
            return (loss,)
        local, kind = den(b)
        local = torch.as_tensor(local, dtype=torch.float32, device=loss.device)
        return (loss * local / c.shard.normalizer(local, kind),)

    return _local(FnLayer(ctx, [()], run), local)


def _batch(b):
    return b[0].shape[0], "batch"


@register("SoftmaxWithLoss")
def build_softmax_loss(ctx):
    lp = ctx.lv.loss_param
    ignore = int(lp.ignore_label) if lp.has("ignore_label") else None
    normalization = {v: k for k, v in LOSS_NORMALIZATION.items()}[
        enum(lp.normalization, LOSS_NORMALIZATION)]
    if lp.has("normalize") and not lp.normalize:
        normalization = "BATCH_SIZE"

    def den(b):
        if normalization == "BATCH_SIZE":
            return b[0].shape[0], "batch"
        if normalization == "VALID" and ignore is not None:
            return torch.clamp((b[1] != ignore).sum(), min=1), "count"
        return b[1].numel(), "count"

    # outer_num_: the batch as fed (softmax_loss_layer.cpp Reshape)
    return _loss(ctx, lambda b: op_losses.softmax_cross_entropy(
        flatten_logits(b[0]), b[1].reshape(-1), ignore, normalization, int(b[0].shape[0])),
        None if normalization == "NONE" else den)


@register("EuclideanLoss")
def build_euclidean_loss(ctx):
    return _loss(ctx, lambda b: op_losses.euclidean(b[0], b[1]), _batch)


@register("EuclideanmaskLoss")
def build_euclidean_mask_loss(ctx):
    """CPM masked L2 loss (euclideanmask_loss_layer.cpp)."""
    return _loss(ctx, lambda b: op_losses.euclidean_masked(
        b[0], b[1], b[2].reshape(b[2].shape[0], -1)), _batch)


@register("SigmoidCrossEntropyLoss")
def build_sce_loss(ctx):
    return _loss(ctx, lambda b: op_losses.sigmoid_cross_entropy(b[0], b[1]), _batch)


@register("Accuracy")
def build_accuracy(ctx):
    ap = ctx.lv.accuracy_param
    top_k = int(ap.top_k)
    ignore = int(ap.ignore_label) if ap.has("ignore_label") else None
    # an optional second top: per-class accuracy (accuracy_layer.cpp:38-44)
    per_class = len(ctx.layer.tops) > 1
    classes = ctx.bshapes[0][1] if len(ctx.bshapes[0]) > 1 else 1

    def fn(b, c):
        logits, labels = flatten_logits(b[0]), b[1].reshape(-1)
        acc = op_losses.accuracy(logits, labels, top_k, ignore)
        if per_class:
            return (acc, op_losses.accuracy_per_class(logits, labels, top_k, ignore))
        return (acc,)

    return FnLayer(ctx, [()] + ([(classes,)] if per_class else []), fn)


@register("HingeLoss")
def build_hinge_loss(ctx):
    norm = {v: k for k, v in HINGE_NORM.items()}[
        enum(ctx.lv.hinge_loss_param.norm, HINGE_NORM)]
    return _loss(ctx, lambda b: op_losses.hinge(flatten_logits(b[0]), b[1].reshape(-1), norm),
                 lambda b: (flatten_logits(b[0]).shape[0], "count"))


@register("MultinomialLogisticLoss")
def build_mll(ctx):
    return _loss(ctx, lambda b: op_losses.multinomial_logistic(flatten_logits(b[0]),
                                                               b[1].reshape(-1)),
                 lambda b: (flatten_logits(b[0]).shape[0], "count"))


@register("ContrastiveLoss")
def build_contrastive(ctx):
    cp = ctx.lv.contrastive_loss_param
    margin, legacy = float(cp.margin), bool(cp.legacy_version)
    return _loss(ctx, lambda b: op_losses.contrastive(
        b[0].reshape(b[0].shape[0], -1), b[1].reshape(b[1].shape[0], -1), b[2], margin, legacy),
        _batch, local=False)


# ------------------------------------------------------------ CPM specials


@register("ImResize")
class ImResize(LayerModule):
    """The scales' bicubic resize and average (imresize_layer.cpp), when a
    generic forward reaches it: the estimator computes its post segment
    from the low-res maps itself.  ``Net.set_imresize`` changes the scales
    and the target (SetStartScale, SetScaleGap, setTargetDimenions)."""

    def __init__(self, ctx: BuildCtx):
        ip = ctx.lv.imresize_param
        s, c, h, w = ctx.bshapes[0]
        factor = float(ip.factor)
        if factor > 0:
            self.target = (int(h * factor), int(w * factor))
        else:
            self.target = (int(ip.target_spatial_height), int(ip.target_spatial_width))
        self.start_scale, self.scale_gap = float(ip.start_scale), float(ip.scale_gap)
        super().__init__(ctx, [(1, c) + self.target])

    def run(self, bots, ctx):
        from ..ops.imresize import imresize_average

        y = imresize_average(bots[0].permute(0, 2, 3, 1), *self.target, self.start_scale,
                             self.scale_gap)
        return (y.permute(0, 3, 1, 2),)


@register("Nms")
class Nms(LayerModule):
    """Peaks of the first ``num_parts`` channels (nms_layer.cu): (1, P,
    max_peaks + 1, 3), row 0 the count."""

    def __init__(self, ctx: BuildCtx):
        nv = ctx.lv.nms_param
        self.threshold = float(nv.threshold)
        self.max_peaks = int(nv.max_peaks)
        self.num_parts = int(nv.num_parts)
        super().__init__(ctx, [(1, self.num_parts, self.max_peaks + 1, 3)])

    def run(self, bots, ctx):
        from ..ops.nms import nms_peaks

        # the estimator's runtime threshold (knob ``nms_threshold``), as JAX's
        thr = (ctx.knobs or {}).get("nms_threshold", self.threshold)
        return (nms_peaks(bots[0][0], thr, self.max_peaks, self.num_parts)[None],)


@register("Maximum")
def build_maximum(ctx):
    """Legacy CPM head: each channel's spatial argmax as (x, y, value), top
    (n, c, 1, 3) (maximum_layer.cpp)."""
    n, c, h, w = ctx.bshapes[0]

    def fn(b, cx):
        flat = b[0].reshape(n, c, h * w)
        val, idx = torch.max(flat, dim=-1)
        px, py = (idx % w).to(torch.float32), (idx // w).to(torch.float32)
        return (torch.stack([px, py, val.to(torch.float32)], dim=-1).reshape(n, c, 1, 3),)

    return FnLayer(ctx, [(n, c, 1, 3)], fn)


# ------------------------------------------------------------ input layers


@register("Input")
def build_input(ctx):
    # a source: Net binds its tops as inputs and never runs it
    def fn(b, c):
        raise RuntimeError("Input layers are sources; the runtime binds them")

    return FnLayer(ctx, [], fn)


from . import layers_extra  # noqa: E402,F401  (registers the remaining types)
