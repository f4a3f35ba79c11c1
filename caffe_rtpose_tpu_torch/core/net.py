"""Net: a NetParameter dict as an ``nn.Module``.

Counterpart of ``caffe_rtpose_tpu/core/net.py`` (which replaces Caffe's Net,
reference src/caffe/net.cpp), limited to the layer types of the pose deploy
and CPM train graphs: Input, Convolution, ReLU, Pooling (MAX), Concat,
Slice, Eltwise (PROD, SUM with coefficients, MAX), EuclideanLoss,
EuclideanmaskLoss and Silence.  ImResize and Nms layers are recorded in
:attr:`Net.post_layers` but not run: the estimator computes them from the
low-res maps (``pose/estimator.py``).  Any other layer type that
phase/stage/level filtering keeps raises ``NotImplementedError``.

On CUDA a Net turns TF32 off (``utils/device.disable_tf32``): f32 is IEEE
f32 there, training included.

Training (``phase="TRAIN"``): each convolution's weight and bias are
``nn.Parameter``s that require a gradient unless their ``param`` spec's
``lr_mult`` is 0 (Caffe computes no diff for those); ``lr_mult`` and
``decay_mult`` ride on the module for the solver.  :meth:`Net.loss` returns
the total weighted loss and the output blobs of one forward, and autograd is
the backward: no layer of the train path has a kernel of its own.  In f32
the convolutions read the parameters themselves, so a forward after an
update sees the new weights.

As in JAX, the graph comes as a prototxt path, prototxt text or a parsed
NetParameter dict; a legacy V0/V1 ``layers`` net runs the upgrade chain
(``proto/upgrade.py``) on a copy; weights load from a ``.caffemodel`` path or
a ``{layer: [OIHW, bias]}`` dict and save back as a ``.caffemodel``.

Convolutions live in an ``nn.ModuleDict`` keyed by Caffe layer name, with
OIHW weights as Caffe stores them.  Activations are logically NCHW (Caffe
layout, so blobs come out as ``Net.forward`` gives them in the JAX package)
and physically ``torch.channels_last``, except in an f32 TRAIN net, whose
activations and parameters are contiguous NCHW (:attr:`Net.memory_format`).

``dtype=torch.bfloat16`` is the JAX package's bf16 mode: parameters stay f32
as loaded, the convolutions run on bf16 copies made when weights are filled
or loaded, inputs are cast to bf16 and every activation is bf16 (ReLU, MAX
pooling and Concat are exact in it).  There the VGG conv1 block, found by
its structure, runs through the hand-written kernel ``ops/conv1_cuda.py``
(K4) when ``conv1_kernel`` is on.
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..ops import conv1_cuda, losses
from ..ops import nn as nn_ops
from ..proto import caffe_pb, caffemodel, prototxt
from ..proto.upgrade import upgrade_net_as_needed
from ..utils.device import disable_tf32, resolve_device
from .filler import fill

log = logging.getLogger(__name__)

POOL_MAX = (0, "MAX")
ESTIMATOR_TYPES = ("ImResize", "Nms")
DTYPES = (torch.float32, torch.bfloat16)
# the layer types the port runs -> the LayerParameter field of their params
PARAM_KEYS = {"Convolution": "convolution_param", "ReLU": "relu_param",
              "Pooling": "pooling_param", "Concat": "concat_param", "Slice": "slice_param",
              "Eltwise": "eltwise_param", "EuclideanLoss": "loss_param",
              "EuclideanmaskLoss": "loss_param", "Silence": "loss_param",
              "ImResize": "imresize_param", "Nms": "nms_param"}
LOSS_TYPES = ("EuclideanLoss", "EuclideanmaskLoss")


@dataclass
class Layer:
    name: str
    type: str
    bottoms: List[str]
    tops: List[str]
    param: Dict[str, Any] = field(default_factory=dict)  # the layer's *_param
    loss_weights: List[float] = field(default_factory=list)  # one per top; 0 = none
    specs: List[caffe_pb.View] = field(default_factory=list, repr=False)  # ParamSpecs


def _rule_matches(rule: caffe_pb.View, phase: int, stages: Sequence[str], level: int) -> bool:
    """One NetStateRule against the net's state (net.cpp StateMeetsRule)."""
    if rule.has("phase") and rule.phase != phase:
        return False
    if rule.has("min_level") and level < rule.min_level:
        return False
    if rule.has("max_level") and level > rule.max_level:
        return False
    if any(s not in stages for s in rule.stage):
        return False
    return not any(s in stages for s in rule.not_stage)


def _layer_included(lv: caffe_pb.View, phase: int, stages: Sequence[str], level: int) -> bool:
    """Net::FilterNet (net.cpp:287): any ``include`` rule that matches keeps
    a layer; without include rules, any ``exclude`` rule that matches drops it."""
    if lv.include:
        return any(_rule_matches(r, phase, stages, level) for r in lv.include)
    return not any(_rule_matches(r, phase, stages, level) for r in lv.exclude)


def _net_parameter(proto: Union[str, Mapping[str, Any]]) -> Dict[str, Any]:
    """A prototxt path, prototxt text or a NetParameter dict -> the dict,
    with a legacy V0/V1 ``layers`` net upgraded on a deep copy (the upgrade
    pops fields out of nested dicts and must not touch the caller's)."""
    if isinstance(proto, str):
        text = "\n" in proto or "{" in proto
        net_param = prototxt.parse(proto) if text else prototxt.parse_file(proto)
    elif isinstance(proto, Mapping):
        net_param = proto
    else:
        raise TypeError(f"proto: a path, prototxt text or a NetParameter dict, got {type(proto)}")
    if net_param.get("layers"):
        net_param = upgrade_net_as_needed(copy.deepcopy(dict(net_param)))
    return net_param


def _ints(v) -> List[int]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)]


def _floats(v) -> List[float]:
    if v is None:
        return []
    return [float(x) for x in (v if isinstance(v, (list, tuple)) else [v])]


def _hw(p: Mapping[str, Any], key: str, default: Optional[int],
        prefix: Optional[str] = None) -> Tuple[int, int]:
    """Caffe's geometry fields: ``<prefix>_h``/``<prefix>_w`` when given,
    else the repeated (or scalar) ``key``."""
    prefix = prefix or key
    if f"{prefix}_h" in p or f"{prefix}_w" in p:
        return int(p.get(f"{prefix}_h", 0)), int(p.get(f"{prefix}_w", 0))
    vals = _ints(p.get(key))
    if not vals:
        if default is None:
            raise ValueError(f"{key} unset")
        return default, default
    return (vals[0], vals[0]) if len(vals) == 1 else (vals[0], vals[1])


def conv_operands(weight: torch.Tensor, bias: Optional[torch.Tensor],
                  dtype: torch.dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A convolution's operands from its f32 parameters (OIHW weight in the
    net's ``channels_last`` layout, :func:`param_tensor`): the parameters
    themselves in f32, else copies in ``dtype``, the weight channels_last."""
    if dtype == torch.float32:
        return weight, bias
    return (weight.detach().to(dtype).contiguous(memory_format=torch.channels_last),
            None if bias is None else bias.detach().to(dtype))


def param_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """An f32 parameter from numpy, laid out as :class:`Net` keeps its
    parameters: on ``device``, a 4-D weight ``channels_last``."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    if t.dim() == 4:
        return t.to(device, memory_format=torch.channels_last)
    return t.to(device)


def derive_operands(params: Mapping[str, Sequence[torch.Tensor]], dtype: torch.dtype,
                    conv1_blocks: Mapping[str, Sequence[str]]) -> Dict[str, torch.Tensor]:
    """What :meth:`Net.forward` reads, from f32 parameters ``{layer:
    [weight, bias]}`` (:func:`param_tensor`): ``"<layer>::w"`` and
    ``"<layer>::b"`` by :func:`conv_operands`, and for each conv1 block that
    runs through the kernel (``{first layer: (conv1_1, conv1_2)}``) its
    :meth:`~..ops.conv1_cuda.Conv1Weights.pack` as
    ``"<first layer>::conv1_block::<field>"``.  The same functions make
    :meth:`Net.operands`."""
    ops: Dict[str, torch.Tensor] = {}
    for name, blobs in params.items():
        w, b = conv_operands(blobs[0], blobs[1] if len(blobs) > 1 else None, dtype)
        ops.update(_conv_entries(name, w, b))
    for first, (n1, n2) in conv1_blocks.items():
        ops.update(_block_entries(first, conv1_cuda.Conv1Weights.pack(*params[n1], *params[n2])))
    return ops


def _conv_entries(name: str, w: torch.Tensor, b: Optional[torch.Tensor]):
    return {f"{name}::w": w, **({} if b is None else {f"{name}::b": b})}


def _block_entries(first: str, cw: conv1_cuda.Conv1Weights):
    return {f"{first}::conv1_block::{k}": getattr(cw, k) for k in conv1_cuda.PACKED}


class Convolution(nn.Module):
    """Caffe Convolution with OIHW weight and optional bias."""

    def __init__(self, cin: int, p: Mapping[str, Any],
                 specs: Sequence[caffe_pb.View] = (), train: bool = False):
        super().__init__()
        self.cout = int(p["num_output"])
        self.kernel = _hw(p, "kernel_size", None, "kernel")
        self.stride = _hw(p, "stride", 1)
        self.pad = _hw(p, "pad", 0)
        dil = _ints(p.get("dilation"))
        self.dilation = (1, 1) if not dil else (dil[0], dil[-1])
        self.groups = int(p.get("group", 1))
        if cin % self.groups or self.cout % self.groups:
            raise ValueError(f"channels {cin}->{self.cout} not divisible by group {self.groups}")
        n_params = 2 if p.get("bias_term", True) else 1
        # ParamSpec lr_mult / decay_mult per blob (layer.hpp), 1 when unset
        self.lr_mult = [float(specs[i].lr_mult) if i < len(specs) else 1.0
                        for i in range(n_params)]
        self.decay_mult = [float(specs[i].decay_mult) if i < len(specs) else 1.0
                           for i in range(n_params)]
        grads = [train and lr != 0.0 for lr in self.lr_mult]
        self.weight = nn.Parameter(
            torch.zeros(self.cout, cin // self.groups, *self.kernel), requires_grad=grads[0])
        self.bias = (nn.Parameter(torch.zeros(self.cout), requires_grad=grads[1])
                     if n_params == 2 else None)
        self.fillers = (dict(p.get("weight_filler", {})), dict(p.get("bias_filler", {})))
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
                b: Optional[torch.Tensor]) -> torch.Tensor:
        """Convolve ``x`` with the operands ``w``, ``b`` (its own
        ``_operands``, or a device program's inputs)."""
        return nn_ops.conv2d(x, w, b, stride=self.stride, pad=self.pad,
                             dilation=self.dilation, groups=self.groups)

    def is_3x3_same(self, cin: int, cout: int) -> bool:
        """A 3x3, stride 1, pad 1, ungrouped, undilated conv cin -> cout
        with bias."""
        return (tuple(self.weight.shape) == (cout, cin, 3, 3) and self.stride == (1, 1)
                and self.pad == (1, 1) and self.dilation == (1, 1) and self.groups == 1
                and self.bias is not None)


def params_from_jax(params: Mapping[str, Sequence[Any]]) -> Dict[str, List[np.ndarray]]:
    """The JAX ``Net.params`` ({layer: [HWIO weight, bias]}, any array type
    numpy accepts) -> the port's ``{layer: [OIHW weight, bias]}`` numpy.
    Also maps one slot of a JAX solver history (same tree)."""
    out: Dict[str, List[np.ndarray]] = {}
    for name, blobs in params.items():
        conv = []
        for a in blobs:
            a = np.asarray(a, np.float32)
            conv.append(np.ascontiguousarray(a.transpose(3, 2, 0, 1)) if a.ndim == 4 else a)
        out[name] = conv
    return out


def params_to_jax(params: Mapping[str, Sequence[Any]]) -> Dict[str, List[np.ndarray]]:
    """The inverse of :func:`params_from_jax`: ``{layer: [OIHW, bias]}``
    (numpy or tensors) -> ``{layer: [HWIO, bias]}`` numpy."""
    out: Dict[str, List[np.ndarray]] = {}
    for name, blobs in params.items():
        conv = []
        for a in blobs:
            a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float32)
            conv.append(np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a)
        out[name] = conv
    return out


def history_from_jax(history: Mapping[str, Mapping[str, Sequence[Any]]]):
    """A JAX solver history ``{"h0": params tree, ...}`` -> the port's
    ``{"h0": {layer: [OIHW, bias]}, ...}`` numpy."""
    return {k: params_from_jax(v) for k, v in history.items()}


def history_to_jax(history: Mapping[str, Mapping[str, Sequence[Any]]]):
    """The inverse of :func:`history_from_jax`."""
    return {k: params_to_jax(v) for k, v in history.items()}


@dataclass
class Conv1Block:
    """conv1_1 -> ReLU -> conv1_2 -> ReLU -> 2x2/2 MAX pool, as found in a
    graph: the five layers' names, the input and output blobs, the blobs in
    between (a forward that asks for one of them runs the layers one by one)
    and the kernel's packed weights."""

    names: Tuple[str, ...]
    bottom: str
    top: str
    inner: frozenset
    weights: Optional[conv1_cuda.Conv1Weights] = None


class Net(nn.Module):
    """Parameters
    ----------
    proto: a prototxt path, prototxt text or a parsed NetParameter dict
        (e.g. ``models.cpm.make_pose_deploy_net()``).
    phase, stages, level: the NetState layers are filtered by (Net::FilterNet);
        the file's ``state`` merges under them: its stages come first, and its
        level counts where ``level`` is None (JAX ``core/net.py``).
    input_shapes: optional {blob: caffe shape} overriding declared input dims
        (the rtpose warmup reshape, rtpose.cpp:188-191).
    overrides: optional {layer: {"<param_msg>.<field>": value}} merged into
        layer params before building (ImResize start_scale/scale_gap).
    seed: numpy seed for the weight fillers; real weights come through
        :meth:`load_weights`.
    dtype: float32, or bfloat16 for activations and conv operands (module
        docstring).
    conv1_kernel: in bf16, run the conv1 block through
        ``conv1_cuda.conv1_block`` (the hand-written kernel on the card, its
        plain version on the CPU) instead of layer by layer.  Default: on for
        CUDA.  Ignored in f32, where the block stays cuDNN, as in JAX.
    """

    def __init__(
        self,
        proto: Union[str, Mapping[str, Any]],
        phase: str = "TEST",
        input_shapes: Optional[Mapping[str, Sequence[int]]] = None,
        overrides: Optional[Mapping[str, Mapping[str, Any]]] = None,
        stages: Sequence[str] = (),
        level: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        conv1_kernel: Optional[bool] = None,
    ):
        super().__init__()
        proto = _net_parameter(proto)
        if dtype not in DTYPES:
            raise NotImplementedError(f"dtype {dtype} is not ported (float32, bfloat16)")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.dtype = dtype
        # f32 training runs NCHW: cuDNN's f32 NHWC convolutions (forward,
        # data and weight gradients) are its slow FFMA engines on the H100
        self.memory_format = (torch.contiguous_format
                              if phase == "TRAIN" and dtype == torch.float32
                              else torch.channels_last)
        if conv1_kernel is None:
            conv1_kernel = self.device.type == "cuda"
        self.conv1_kernel = bool(conv1_kernel) and dtype == torch.bfloat16
        self.name = caffe_pb.view(proto, "NetParameter").name
        state = proto.get("state")
        if state:
            stages = list(state.get("stage", [])) + list(stages)
            if level is None:
                level = int(state.get("level", 0))
        level = 0 if level is None else int(level)
        phase_i = caffe_pb.PHASE[phase]

        shapes: Dict[str, Tuple[int, ...]] = {}
        names = list(proto.get("input", []))
        if proto.get("input_shape"):
            dims = [tuple(int(d) for d in s["dim"]) for s in proto["input_shape"]]
        else:
            flat = _ints(proto.get("input_dim"))
            dims = [tuple(flat[i : i + 4]) for i in range(0, len(flat), 4)]
        shapes.update(zip(names, dims))

        overrides = overrides or {}
        self.layers: List[Layer] = []
        self.post_layers: Dict[str, Layer] = {}
        self.convs = nn.ModuleDict()
        for raw in proto.get("layer", []):
            if not _layer_included(caffe_pb.view(raw, "LayerParameter"), phase_i, stages, level):
                continue
            raw = dict(raw)
            for k, v in overrides.get(raw.get("name"), {}).items():
                sub, fld = k.split(".", 1) if "." in k else (None, k)
                if sub is None:
                    raw[fld] = v
                else:
                    raw[sub] = {**raw.get(sub, {}), fld: v}
            ltype = raw["type"]
            if ltype == "Input":
                ishapes = raw.get("input_param", {}).get("shape", [])
                for i, t in enumerate(raw["top"]):
                    shapes[t] = tuple(int(d) for d in ishapes[min(i, len(ishapes) - 1)]["dim"])
                continue
            pkey = PARAM_KEYS.get(ltype)
            if pkey is None:
                raise NotImplementedError(f"layer {raw.get('name')}: type {ltype!r} is not ported")
            lv = caffe_pb.view(raw, "LayerParameter")
            tops = list(raw.get("top", []))
            weights = [float(x) for x in lv.loss_weight]
            if ltype in LOSS_TYPES and not weights:
                weights = [1.0]  # a loss layer's default (layer.hpp SetLossWeights)
            layer = Layer(raw["name"], ltype, list(raw.get("bottom", [])), tops,
                          dict(raw.get(pkey, {})), weights + [0.0] * (len(tops) - len(weights)),
                          lv.param)
            if ltype in ESTIMATOR_TYPES:
                self.post_layers[layer.name] = layer
            else:
                self.layers.append(layer)
        for k, v in (input_shapes or {}).items():
            shapes[k] = tuple(int(d) for d in v)
        self.input_names: List[str] = list(shapes)

        # shape inference in Caffe (N, C, H, W) layout; builds the convs
        self.blob_shapes: Dict[str, Tuple[int, ...]] = dict(shapes)
        for layer in self.layers:
            for b in layer.bottoms:
                if b not in self.blob_shapes:
                    raise ValueError(f"layer {layer.name}: unknown bottom blob {b!r}")
            bshape = [self.blob_shapes[b] for b in layer.bottoms]
            outs = self._infer(layer, bshape, phase == "TRAIN")
            for t, out in zip(layer.tops, outs):
                self.blob_shapes[t] = out
        self.conv1_blocks: Dict[str, Conv1Block] = self._find_conv1_blocks()
        self.to(self.device, memory_format=self.memory_format)
        self.init_params(seed)

    def _infer(self, layer: Layer, bshape: List[Tuple[int, ...]],
               train: bool) -> List[Tuple[int, ...]]:
        """The layer's top shapes from its bottoms'; turns ``layer.param``
        into what :meth:`forward` reads and builds the convolutions."""
        p = layer.param
        if layer.type in ("Convolution", "Pooling"):
            n, c, h, w = bshape[0]
        if layer.type == "Convolution":
            conv = Convolution(c, p, layer.specs, train)
            self.convs[layer.name] = conv
            return [(n, conv.cout) + conv.out_hw(h, w)]
        if layer.type == "Pooling":
            if p.get("pool", 0) not in POOL_MAX or p.get("global_pooling"):
                raise NotImplementedError(f"layer {layer.name}: only MAX pooling is ported")
            kh, kw = _hw(p, "kernel_size", None, "kernel")
            sh, sw = _hw(p, "stride", 1)
            ph, pw = _hw(p, "pad", 0)
            layer.param = dict(k=(kh, kw), s=(sh, sw), p=(ph, pw))
            return [(n, c, nn_ops.pooled_size(h, kh, sh, ph), nn_ops.pooled_size(w, kw, sw, pw))]
        if layer.type == "Concat":
            axis = int(p.get("axis", p.get("concat_dim", 1)))
            axis = axis + len(bshape[0]) if axis < 0 else axis
            layer.param = dict(axis=axis)
            out = list(bshape[0])
            out[axis] = sum(s[axis] for s in bshape)
            return [tuple(out)]
        if layer.type == "Slice":
            axis = int(p.get("axis", 1))
            axis = axis + len(bshape[0]) if axis < 0 else axis
            total, n_tops = bshape[0][axis], len(layer.tops)
            points = _ints(p.get("slice_point"))
            if not points:
                points = [total // n_tops * (i + 1) for i in range(n_tops - 1)]
            bounds = [0] + points + [total]
            if len(bounds) != n_tops + 1 or any(a > b for a, b in zip(bounds, bounds[1:])):
                raise ValueError(f"layer {layer.name}: slice points {points} for {n_tops} "
                                 f"tops of {total}")
            layer.param = dict(axis=axis, bounds=bounds)
            outs = []
            for a, b in zip(bounds, bounds[1:]):
                out = list(bshape[0])
                out[axis] = b - a
                outs.append(tuple(out))
            return outs
        if layer.type == "Eltwise":
            op = p.get("operation", caffe_pb.ELTWISE_OP["SUM"])
            op = caffe_pb.ELTWISE_OP[op] if isinstance(op, str) else int(op)
            coeffs = _floats(p.get("coeff")) or [1.0] * len(bshape)
            if len(coeffs) != len(bshape):
                # eltwise_layer.cpp: one coefficient per bottom
                raise ValueError(f"layer {layer.name}: Eltwise takes one coefficient per bottom "
                                 f"({len(coeffs)} coeffs vs {len(bshape)} bottoms)")
            if any(s != bshape[0] for s in bshape):
                raise ValueError(f"layer {layer.name}: Eltwise bottoms differ in shape {bshape}")
            layer.param = dict(op=op, coeffs=coeffs)
            return [bshape[0]]
        if layer.type in LOSS_TYPES:
            return [()]
        if layer.type == "Silence":
            return []
        layer.param = dict(slope=float(p.get("negative_slope", 0.0)))  # ReLU
        return [bshape[0]]

    def _find_conv1_blocks(self) -> Dict[str, Conv1Block]:
        """The conv1 blocks of the graph, by structure: Convolution 3->64
        3x3 s1 p1 -> ReLU -> Convolution 64->64 3x3 s1 p1 -> ReLU -> MAX
        Pooling 2x2 s2 p0, consecutive, each layer reading the one before,
        and no other layer reading the blobs in between.  Keyed by the
        first layer's name."""
        blocks: Dict[str, Conv1Block] = {}
        L = self.layers
        types = ["Convolution", "ReLU", "Convolution", "ReLU", "Pooling"]
        for i in range(len(L) - 4):
            chain = L[i : i + 5]
            c1, r1, c2, r2, pool = chain
            if ([l.type for l in chain] != types
                    or any(len(l.bottoms) != 1 or len(l.tops) != 1 for l in chain)
                    or any(b.bottoms[0] != a.tops[0] for a, b in zip(chain, chain[1:]))
                    or not self.convs[c1.name].is_3x3_same(3, 64)
                    or not self.convs[c2.name].is_3x3_same(64, 64)
                    or r1.param["slope"] != 0.0 or r2.param["slope"] != 0.0
                    or pool.param != dict(k=(2, 2), s=(2, 2), p=(0, 0))):
                continue
            inner = frozenset(l.tops[0] for l in chain[:4])
            if any(b in inner for l in L if l not in chain for b in l.bottoms):
                continue
            blocks[c1.name] = Conv1Block(tuple(l.name for l in chain), c1.bottoms[0],
                                         pool.tops[0], inner)
        return blocks

    # ------------------------------------------------------------- params

    def init_params(self, seed: int = 0) -> None:
        """Fill every conv from its prototxt fillers (``core/filler.py``),
        drawn in layer order from one CPU ``torch.Generator`` seeded with
        ``seed``: the same weights on every device."""
        gen = torch.Generator().manual_seed(int(seed))
        for conv in self.convs.values():
            wf, bf = conv.fillers
            with torch.no_grad():
                conv.weight.copy_(fill(gen, tuple(conv.weight.shape), wf))
                if conv.bias is not None:
                    conv.bias.copy_(fill(gen, (conv.cout,), bf))
        self.params_changed()

    def params_changed(self) -> None:
        """Rebuild what is derived from the parameters (the compute copies in
        bf16, the conv1 kernel's packed weights) after they changed in place:
        a load, a fill, a solver's update.  In f32 a forward reads the
        parameters themselves."""
        for conv in self.convs.values():
            conv.compute_weights(self.dtype)
        for blk in self.conv1_blocks.values():
            c1, c2 = self.convs[blk.names[0]], self.convs[blk.names[2]]
            blk.weights = conv1_cuda.Conv1Weights.pack(c1.weight, c1.bias, c2.weight, c2.bias)

    def learnable(self) -> List[Tuple[str, int, nn.Parameter, float, float]]:
        """Every parameter blob in Caffe's order (layers, then blobs):
        ``(layer, index, parameter, lr_mult, decay_mult)``."""
        out = []
        for name, conv in self.convs.items():
            blobs = [conv.weight] + ([conv.bias] if conv.bias is not None else [])
            for i, prm in enumerate(blobs):
                out.append((name, i, prm, conv.lr_mult[i], conv.decay_mult[i]))
        return out

    def load_weights(self, weights: Union[str, Mapping[str, Sequence[np.ndarray]]]) -> int:
        """Copy a ``.caffemodel`` path or ``{layer_name: [OIHW weight,
        bias]}`` by layer name with Caffe's checks on param count and size
        (net.cpp:750-806).  Returns the number of layers copied; names the
        net lacks are ignored, as Caffe does."""
        if isinstance(weights, str):
            weights = caffemodel.load_weights(weights)
        copied = 0
        for name, blobs in weights.items():
            conv = self.convs[name] if name in self.convs else None
            if conv is None:
                log.info("Ignoring source layer %s", name)
                continue
            targets = [conv.weight] + ([conv.bias] if conv.bias is not None else [])
            if len(blobs) != len(targets):
                raise ValueError(
                    f"layer {name}: incompatible param count {len(blobs)} vs {len(targets)}")
            for t, arr in zip(targets, blobs):
                arr = np.array(arr, np.float32)  # a writable copy
                if arr.size != t.numel():
                    raise ValueError(
                        f"layer {name}: param size mismatch {arr.shape} vs caffe shape {tuple(t.shape)}")
                with torch.no_grad():
                    t.copy_(torch.from_numpy(arr.reshape(tuple(t.shape))))
            copied += 1
        self.params_changed()
        return copied

    def operands(self) -> Dict[str, torch.Tensor]:
        """The operands :meth:`forward` runs on, as :func:`derive_operands`
        names them: each convolution's, and the packed weights of each conv1
        block when ``conv1_kernel`` is on.  Made once per load; a device
        program takes them as inputs (``serving.py``)."""
        ops: Dict[str, torch.Tensor] = {}
        for name, conv in self.convs.items():
            ops.update(_conv_entries(name, *conv._operands))
        if self.conv1_kernel:
            for first, blk in self.conv1_blocks.items():
                ops.update(_block_entries(first, blk.weights))
        return ops

    def kernel_blocks(self) -> Dict[str, Tuple[str, str]]:
        """``{first layer: (conv1_1, conv1_2)}`` of the conv1 blocks that run
        through the kernel (none unless ``conv1_kernel``)."""
        if not self.conv1_kernel:
            return {}
        return {first: (blk.names[0], blk.names[2]) for first, blk in self.conv1_blocks.items()}

    def export_weights(self) -> Dict[str, List[np.ndarray]]:
        """``{layer: [OIHW weight, bias]}`` f32 numpy copies, in layer order."""
        return {name: [p.detach().cpu().numpy().copy() for p in (conv.weight, conv.bias)
                       if p is not None]
                for name, conv in self.convs.items()}

    def save_caffemodel(self, path: str) -> None:
        """The weights as a binary NetParameter (``.caffemodel``), as the JAX
        ``Net.save_caffemodel`` writes it."""
        layers = [{"name": name, "type": "Convolution",
                   "blobs": [caffemodel.array_to_blob(b) for b in blobs]}
                  for name, blobs in self.export_weights().items()]
        caffemodel.save_net_parameter({"name": self.name, "layer": layers}, path)

    # ------------------------------------------------------------ forward

    def prune_for(self, outputs: Sequence[str]) -> List[Layer]:
        """Dead-layer elimination: the layers needed to produce ``outputs``
        (keeps in-place chains intact by blob-name dependency)."""
        needed = set(outputs)
        keep: List[Layer] = []
        for layer in reversed(self.layers):
            if any(t in needed for t in layer.tops):
                keep.append(layer)
                needed |= set(layer.bottoms)
        keep.reverse()
        return keep

    def output_names(self) -> List[str]:
        """Blobs the runnable layers produce and no runnable layer consumes."""
        consumed = set()
        for layer in self.layers:
            consumed |= set(layer.bottoms) - set(layer.tops)
        names = []
        for layer in self.layers:
            for t in layer.tops:
                if t not in consumed and t not in names:
                    names.append(t)
        return names

    def forward(self, inputs: Mapping[str, torch.Tensor],
                outputs: Optional[Sequence[str]] = None,
                layers: Optional[Sequence[Layer]] = None,
                operands: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``inputs``: {blob: (N, C, H, W) tensor on the net's device, cast
        to the net's dtype here} -> {blob: tensor} for ``outputs`` (default
        :meth:`output_names`).  ``operands``: what the layers run on, as
        :meth:`operands` names them (default: the net's own); a device
        program passes them as its inputs.

        With ``conv1_kernel`` on, a conv1 block whose five layers appear in
        order in ``layers`` runs as one ``conv1_cuda.conv1_block_packed`` call,
        unless ``outputs`` names a blob inside it or its input's H or W is
        odd (Caffe's ceil-mode pooling then differs from the kernel's)."""
        blobs: Dict[str, torch.Tensor] = {
            k: v.to(self.dtype).contiguous(memory_format=self.memory_format) if v.dim() == 4 else v
            for k, v in inputs.items()}
        outputs = list(outputs or self.output_names())
        layers = self.layers if layers is None else list(layers)
        ops = self.operands() if operands is None else operands
        i = 0
        while i < len(layers):
            layer = layers[i]
            blk = self.conv1_blocks.get(layer.name) if self.conv1_kernel else None
            if (blk is not None and tuple(l.name for l in layers[i : i + 5]) == blk.names
                    and blk.inner.isdisjoint(outputs)
                    and blobs[blk.bottom].shape[2] % 2 == 0 and blobs[blk.bottom].shape[3] % 2 == 0):
                blobs[blk.top] = conv1_cuda.conv1_block_packed(
                    blobs[blk.bottom], *(ops[f"{layer.name}::conv1_block::{k}"]
                                         for k in conv1_cuda.PACKED))
                i += 5
                continue
            i += 1
            bots = [blobs[b] for b in layer.bottoms]
            for t, top in zip(layer.tops, self._run_layer(layer, bots, ops)):
                blobs[t] = top
        return {k: blobs[k] for k in outputs}

    def _run_layer(self, layer: Layer, bots: List[torch.Tensor],
                   ops: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """One layer's tops from its bottoms."""
        p = layer.param
        if layer.type == "Convolution":
            return (self.convs[layer.name](bots[0], ops[f"{layer.name}::w"],
                                           ops.get(f"{layer.name}::b")),)
        if layer.type == "ReLU":
            return (nn_ops.relu(bots[0], p["slope"]),)
        if layer.type == "Pooling":
            return (nn_ops.max_pool2d(bots[0], p["k"], p["s"], p["p"]),)
        if layer.type == "Concat":
            return (torch.cat(bots, dim=p["axis"]),)
        if layer.type == "Slice":
            b = p["bounds"]
            return tuple(bots[0].narrow(p["axis"], b[j], b[j + 1] - b[j])
                         for j in range(len(b) - 1))
        if layer.type == "Eltwise":
            if p["op"] == caffe_pb.ELTWISE_OP["PROD"]:
                y = bots[0]
                for x in bots[1:]:
                    y = y * x
            elif p["op"] == caffe_pb.ELTWISE_OP["SUM"]:
                y = p["coeffs"][0] * bots[0]
                for cf, x in zip(p["coeffs"][1:], bots[1:]):
                    y = y + cf * x
            else:  # MAX
                y = bots[0]
                for x in bots[1:]:
                    y = torch.maximum(y, x)
            return (y,)
        if layer.type == "EuclideanLoss":
            return (losses.euclidean(bots[0], bots[1]),)
        if layer.type == "EuclideanmaskLoss":
            mask = bots[2]
            return (losses.euclidean_masked(bots[0], bots[1], mask.reshape(mask.shape[0], -1)),)
        return ()  # Silence

    # --------------------------------------------------------------- loss

    def loss_tops(self) -> List[Tuple[str, float]]:
        """``(top, loss_weight)`` of every top with a nonzero loss weight, in
        layer order."""
        return [(t, w) for layer in self.layers for t, w in zip(layer.tops, layer.loss_weights)
                if w]

    def loss(self, inputs: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One forward -> (the total weighted loss, sum over loss tops of
        weight times the top's sum; the net's output blobs from the same
        forward), as JAX's ``Net.make_loss_fn(with_outputs=True)``.
        ``loss.backward()`` fills the parameters' gradients."""
        tops = self.loss_tops()
        if not tops:
            raise ValueError("net has no loss tops")
        names = self.output_names()
        blobs = self.forward(inputs, outputs=list(dict.fromkeys(names + [t for t, _ in tops])))
        total = sum(w * blobs[t].sum() for t, w in tops)
        return total, {k: blobs[k] for k in names}
