"""Net: a deploy NetParameter dict as an ``nn.Module``.

Counterpart of ``caffe_rtpose_tpu/core/net.py`` (which replaces Caffe's Net,
reference src/caffe/net.cpp), limited to the layer types of the pose deploy
graphs: Input, Convolution, ReLU, Pooling (MAX) and Concat.  ImResize and
Nms layers are recorded in :attr:`Net.post_layers` but not run: the
estimator computes them from the low-res maps (``pose/estimator.py``).  Any
other layer type that phase/stage/level filtering keeps raises
``NotImplementedError``.

As in JAX, the graph comes as a prototxt path, prototxt text or a parsed
NetParameter dict; a legacy V0/V1 ``layers`` net runs the upgrade chain
(``proto/upgrade.py``) on a copy; weights load from a ``.caffemodel`` path or
a ``{layer: [OIHW, bias]}`` dict and save back as a ``.caffemodel``.

Convolutions live in an ``nn.ModuleDict`` keyed by Caffe layer name, with
OIHW weights as Caffe stores them.  Activations are logically NCHW (Caffe
layout, so blobs come out as ``Net.forward`` gives them in the JAX package)
and physically ``torch.channels_last``.

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

from ..ops import conv1_cuda
from ..ops import nn as nn_ops
from ..proto import caffe_pb, caffemodel, prototxt
from ..proto.upgrade import upgrade_net_as_needed
from ..utils.device import resolve_device

log = logging.getLogger(__name__)

POOL_MAX = (0, "MAX")
ESTIMATOR_TYPES = ("ImResize", "Nms")
DTYPES = (torch.float32, torch.bfloat16)


@dataclass
class Layer:
    name: str
    type: str
    bottoms: List[str]
    tops: List[str]
    param: Dict[str, Any] = field(default_factory=dict)  # the layer's *_param


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

    def __init__(self, cin: int, p: Mapping[str, Any]):
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
        self.weight = nn.Parameter(
            torch.zeros(self.cout, cin // self.groups, *self.kernel), requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(self.cout), requires_grad=False)
                     if p.get("bias_term", True) else None)
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


def _fill(rs: np.random.RandomState, shape, filler: Mapping[str, Any]) -> np.ndarray:
    kind = filler.get("type", "constant")
    if kind == "constant":
        return np.full(shape, float(filler.get("value", 0.0)), np.float32)
    if kind == "gaussian":
        return (float(filler.get("mean", 0.0))
                + float(filler.get("std", 1.0)) * rs.randn(*shape)).astype(np.float32)
    raise NotImplementedError(f"filler type {kind!r} is not ported")


def params_from_jax(params: Mapping[str, Sequence[Any]]) -> Dict[str, List[np.ndarray]]:
    """The JAX ``Net.params`` ({layer: [HWIO weight, bias]}, any array type
    numpy accepts) -> the port's ``{layer: [OIHW weight, bias]}`` numpy."""
    out: Dict[str, List[np.ndarray]] = {}
    for name, blobs in params.items():
        conv = []
        for a in blobs:
            a = np.asarray(a, np.float32)
            conv.append(np.ascontiguousarray(a.transpose(3, 2, 0, 1)) if a.ndim == 4 else a)
        out[name] = conv
    return out


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
        self.dtype = dtype
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
            pkey = {"Convolution": "convolution_param", "ReLU": "relu_param",
                    "Pooling": "pooling_param", "Concat": "concat_param",
                    "ImResize": "imresize_param", "Nms": "nms_param"}.get(ltype)
            if pkey is None:
                raise NotImplementedError(f"layer {raw.get('name')}: type {ltype!r} is not ported")
            layer = Layer(raw["name"], ltype, list(raw.get("bottom", [])),
                          list(raw.get("top", [])), dict(raw.get(pkey, {})))
            if ltype in ESTIMATOR_TYPES:
                self.post_layers[layer.name] = layer
            else:
                self.layers.append(layer)
        for k, v in (input_shapes or {}).items():
            shapes[k] = tuple(int(d) for d in v)

        # shape inference in Caffe (N, C, H, W) layout; builds the convs
        self.blob_shapes: Dict[str, Tuple[int, ...]] = dict(shapes)
        for layer in self.layers:
            for b in layer.bottoms:
                if b not in self.blob_shapes:
                    raise ValueError(f"layer {layer.name}: unknown bottom blob {b!r}")
            bshape = [self.blob_shapes[b] for b in layer.bottoms]
            n, c, h, w = bshape[0]
            p = layer.param
            if layer.type == "Convolution":
                conv = Convolution(c, p)
                self.convs[layer.name] = conv
                out = (n, conv.cout) + conv.out_hw(h, w)
            elif layer.type == "Pooling":
                if p.get("pool", 0) not in POOL_MAX or p.get("global_pooling"):
                    raise NotImplementedError(f"layer {layer.name}: only MAX pooling is ported")
                kh, kw = _hw(p, "kernel_size", None, "kernel")
                sh, sw = _hw(p, "stride", 1)
                ph, pw = _hw(p, "pad", 0)
                layer.param = dict(k=(kh, kw), s=(sh, sw), p=(ph, pw))
                out = (n, c, nn_ops.pooled_size(h, kh, sh, ph), nn_ops.pooled_size(w, kw, sw, pw))
            elif layer.type == "Concat":
                axis = int(p.get("axis", p.get("concat_dim", 1)))
                axis = axis + 4 if axis < 0 else axis
                layer.param = dict(axis=axis)
                out = list(bshape[0])
                out[axis] = sum(s[axis] for s in bshape)
                out = tuple(out)
            else:  # ReLU
                layer.param = dict(slope=float(p.get("negative_slope", 0.0)))
                out = bshape[0]
            for t in layer.tops:
                self.blob_shapes[t] = out
        self.conv1_blocks: Dict[str, Conv1Block] = self._find_conv1_blocks()
        self.to(self.device, memory_format=torch.channels_last)
        self.init_params(seed)

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

    def _refresh(self) -> None:
        """Rebuild the compute copies of the weights after they changed."""
        for conv in self.convs.values():
            conv.compute_weights(self.dtype)
        for blk in self.conv1_blocks.values():
            c1, c2 = self.convs[blk.names[0]], self.convs[blk.names[2]]
            blk.weights = conv1_cuda.Conv1Weights.pack(c1.weight, c1.bias, c2.weight, c2.bias)

    # ------------------------------------------------------------- params

    def init_params(self, seed: int = 0) -> None:
        """Fill every conv from its prototxt fillers with numpy draws."""
        rs = np.random.RandomState(seed)
        for conv in self.convs.values():
            wf, bf = conv.fillers
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(_fill(rs, tuple(conv.weight.shape), wf)))
                if conv.bias is not None:
                    conv.bias.copy_(torch.from_numpy(_fill(rs, (conv.cout,), bf)))
        self._refresh()

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
        self._refresh()
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
            k: v.to(self.dtype).contiguous(memory_format=torch.channels_last) if v.dim() == 4 else v
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
            p = layer.param
            if layer.type == "Convolution":
                top = self.convs[layer.name](bots[0], ops[f"{layer.name}::w"],
                                             ops.get(f"{layer.name}::b"))
            elif layer.type == "ReLU":
                top = nn_ops.relu(bots[0], p["slope"])
            elif layer.type == "Pooling":
                top = nn_ops.max_pool2d(bots[0], p["k"], p["s"], p["p"])
            else:  # Concat
                top = torch.cat(bots, dim=p["axis"])
            for t in layer.tops:
                blobs[t] = top
        return {k: blobs[k] for k in outputs}
