"""Net: a NetParameter dict as an ``nn.Module``.

Counterpart of ``caffe_rtpose_tpu/core/net.py`` (which replaces Caffe's Net,
reference src/caffe/net.cpp).  Every layer goes through the one registry of
``core/layers.py`` (and ``core/layers_extra.py``): the net builds each
layer's module for its bottoms' shapes in prototxt order and runs the
modules in that order.  ``Input`` layers and the deprecated ``input`` fields
declare inputs; data layers (``core/data_layers.py``: Data, ImageData,
MemoryData, HDF5Data, WindowData, CPMData) are host sources whose tops are
inputs too, pulled by :meth:`Net.forward` when the caller does not feed
them.  ImResize and Nms layers run when a forward asks for their tops; they
are also kept in :attr:`Net.post_layers`, whose parameters the estimator
reads to compute its post segment from the low-res maps itself
(``pose/estimator.py``).

On CUDA a Net turns TF32 off (``utils/device.disable_tf32``): f32 is IEEE
f32 there, training included.  An f32 convolution that a gradient is taken
through (a TRAIN net's, and any net's under :meth:`backward`) runs outside
cuDNN on the card (``ops/nn.py::_OutsideCudnn``, ``layers.f32_training``):
cuDNN's f32 backward moved the CPM trunk's bias gradients by up to 0.45
relative L2 from f64.  A forward under ``no_grad`` outside TRAIN keeps
cuDNN.  ``shard`` (:meth:`forward`, :meth:`loss`) runs the net as one rank
of a sharded forward (``parallel/``).

Training (``phase="TRAIN"``): each parameter blob is an ``nn.Parameter``
that requires a gradient unless its ``param`` spec's ``lr_mult`` is 0
(Caffe computes no diff for those); ``lr_mult`` and ``decay_mult`` ride on
the layer's module for the solver.  :meth:`Net.loss` returns the total
weighted loss and the output blobs of one forward, and autograd is the
backward.  :meth:`Net.backward` takes diffs for any tops and returns the
diffs of the inputs and of every parameter blob, as Caffe's backward with
``force_backward`` (the NetParameter field itself changes nothing here).  Random layers (Dropout, STOCHASTIC pooling) draw from
the net's ``torch.Generator`` on its device.

As in JAX, the graph comes as a prototxt path, prototxt text or a parsed
NetParameter dict; a legacy V0/V1 ``layers`` net runs the upgrade chain
(``proto/upgrade.py``) on a copy; weights load from a ``.caffemodel`` (or
HDF5) path or a ``{layer: [blob, ...]}`` dict in Caffe's layout and save
back the same way.

Activations are logically NCHW (Caffe layout, so blobs come out as
``Net.forward`` gives them in the JAX package) and physically
``torch.channels_last``, except in an f32 TRAIN net, whose activations and
parameters are contiguous NCHW (:attr:`Net.memory_format`).

``dtype=torch.bfloat16`` is the JAX package's bf16 mode: parameters stay f32
as loaded, the convolutions run on bf16 copies made when weights are filled
or loaded, inputs are cast to bf16 and every activation is bf16 (ReLU, MAX
pooling and Concat are exact in it).  There the VGG conv1 block, found by
its structure, runs through the hand-written kernel ``ops/conv1_cuda.py``
(K4) when ``conv1_kernel`` is on.  A bf16 TRAIN net is JAX's mixed-precision
training: the convolutions cast the f32 parameters to bf16 inside the
forward, under autograd (``ops/nn.py::_mixed``), so the parameters, their
gradients and a solver's update stay f32; inputs and labels are cast to
bf16 and the losses keep their residuals in f32 (``ops/losses.py``).  It
never runs the conv1 kernel, which has no backward (JAX trains through XLA
convolutions).

``remat="convs"`` (TRAIN only) wraps each Convolution and Deconvolution in
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` around the same
layers): what the layer saves for the backward is recomputed there.
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import conv1_cuda
from ..proto import caffe_pb, caffemodel, prototxt
from ..proto.upgrade import upgrade_net_as_needed
from ..utils import hdf5
from ..utils.device import disable_tf32, resolve_device
from . import layers as L
from .data_layers import DATA_LAYER_TYPES
from .filler import fill
from .layers import Convolution, Layer, RunCtx, conv_operands  # noqa: F401

log = logging.getLogger(__name__)

ESTIMATOR_TYPES = ("ImResize", "Nms")
DTYPES = (torch.float32, torch.bfloat16)
# the types that read their raw *_param dict (Layer.param); the rest read views
PARAM_KEYS = {"Convolution": "convolution_param", "Deconvolution": "convolution_param",
              "Im2col": "convolution_param", "Pooling": "pooling_param",
              "Concat": "concat_param", "Slice": "slice_param", "Eltwise": "eltwise_param",
              "ReLU": "relu_param", "ImResize": "imresize_param", "Nms": "nms_param"}


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
    (numpy or tensors) -> ``{layer: [HWIO, bias]}`` numpy, always copies
    (a JAX array made from one may share its buffer, and the port's solver
    updates its tensors in place)."""
    out: Dict[str, List[np.ndarray]] = {}
    for name, blobs in params.items():
        conv = []
        for a in blobs:
            a = np.array(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float32)
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
    seed: seed of the weight fillers (a CPU generator, so the same weights
        on every device) and of the net's device generator (Dropout,
        STOCHASTIC pooling); real weights come through :meth:`load_weights`.
    dtype: float32, or bfloat16 for activations and conv operands (module
        docstring).
    conv1_kernel: in bf16, run the conv1 block through
        ``conv1_cuda.conv1_block`` (the hand-written kernel on the card, its
        plain version on the CPU) instead of layer by layer.  Default: on for
        CUDA outside TRAIN.  Ignored in f32, where the block stays cuDNN, as
        in JAX.  A TRAIN net refuses it (the kernel has no backward).
    remat: ``"none"`` or ``"convs"`` (module docstring); ``ValueError`` on
        any other value, as in JAX.
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
        remat: str = "none",
    ):
        super().__init__()
        proto = _net_parameter(proto)
        if dtype not in DTYPES:
            raise NotImplementedError(f"dtype {dtype} is not ported (float32, bfloat16)")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.dtype = dtype
        self.phase = phase
        # f32 training runs NCHW: cuDNN's f32 NHWC convolutions (forward,
        # data and weight gradients) are its slow FFMA engines on the H100
        self.memory_format = (torch.contiguous_format
                              if phase == "TRAIN" and dtype == torch.float32
                              else torch.channels_last)
        if remat not in ("none", "convs"):
            raise ValueError(f"unknown remat policy {remat!r}")
        self.remat = remat
        if phase == "TRAIN" and conv1_kernel:
            raise ValueError("a TRAIN net cannot run the conv1 block kernel (it has no "
                             "backward); leave conv1_kernel unset or False")
        if conv1_kernel is None:
            conv1_kernel = self.device.type == "cuda" and phase != "TRAIN"
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
            flat = L.ints(proto.get("input_dim"))
            dims = [tuple(flat[i : i + 4]) for i in range(0, len(flat), 4)]
        shapes.update(zip(names, dims))

        overrides = overrides or {}
        self.layers: List[Layer] = []
        self.post_layers: Dict[str, Layer] = {}
        self.data_layers: List[Any] = []
        self._data_top_to_layer: Dict[str, Any] = {}
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
            lv = caffe_pb.view(raw, "LayerParameter")
            ltype = raw["type"]
            if ltype == "Input":
                ishapes = raw.get("input_param", {}).get("shape", [])
                for i, t in enumerate(raw["top"]):
                    shapes[t] = tuple(int(d) for d in ishapes[min(i, len(ishapes) - 1)]["dim"])
                continue
            if ltype in DATA_LAYER_TYPES:
                from . import data_layers

                dl = data_layers.build(lv, phase)
                self.data_layers.append(dl)
                for t in dl.tops:
                    shapes[t] = dl.top_shapes[t]
                    self._data_top_to_layer[t] = dl
                continue
            tops = list(raw.get("top", []))
            weights = [float(x) for x in lv.loss_weight]
            if ltype in L.LOSS_TYPES and not weights:
                weights = [1.0]  # a loss layer's default (layer.hpp SetLossWeights)
            layer = Layer(raw["name"], ltype, list(raw.get("bottom", [])), tops,
                          dict(raw.get(PARAM_KEYS.get(ltype, ""), {})),
                          weights + [0.0] * (len(tops) - len(weights)), lv.param, lv)
            self.layers.append(layer)
            if ltype in ESTIMATOR_TYPES:
                self.post_layers[layer.name] = layer
        for k, v in (input_shapes or {}).items():
            shapes[k] = tuple(int(d) for d in v)
        self.input_names: List[str] = list(shapes)

        # shape inference in Caffe (N, C, H, W) layout; builds the modules
        self.blob_shapes: Dict[str, Tuple[int, ...]] = dict(shapes)
        mods = []
        for layer in self.layers:
            for b in layer.bottoms:
                if b not in self.blob_shapes:
                    raise ValueError(f"layer {layer.name}: unknown bottom blob {b!r}")
            mod = L.build(L.BuildCtx(layer, [self.blob_shapes[b] for b in layer.bottoms], phase))
            if len(mod.top_shapes) != len(layer.tops):
                raise ValueError(f"layer {layer.name} ({layer.type}): {len(layer.tops)} tops, "
                                 f"the type makes {len(mod.top_shapes)}")
            for t, out in zip(layer.tops, mod.top_shapes):
                self.blob_shapes[t] = out
            mods.append(mod)
        self.layer_modules = nn.ModuleList(mods)
        self.mods: Dict[str, L.LayerModule] = {l.name: m for l, m in zip(self.layers, mods)}
        self.conv1_blocks: Dict[str, Conv1Block] = self._find_conv1_blocks()
        self.to(self.device, memory_format=self.memory_format)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.init_params(seed)

    @property
    def convs(self) -> Dict[str, Convolution]:
        """The Convolution layers' modules by layer name, in layer order."""
        return {k: m for k, m in self.mods.items() if isinstance(m, Convolution)}

    def _find_conv1_blocks(self) -> Dict[str, Conv1Block]:
        """The conv1 blocks of the graph, by structure: Convolution 3->64
        3x3 s1 p1 -> ReLU -> Convolution 64->64 3x3 s1 p1 -> ReLU -> MAX
        Pooling 2x2 s2 p0, consecutive, each layer reading the one before,
        and no other layer reading the blobs in between.  Keyed by the
        first layer's name."""
        blocks: Dict[str, Conv1Block] = {}
        lays = self.layers
        types = ["Convolution", "ReLU", "Convolution", "ReLU", "Pooling"]
        for i in range(len(lays) - 4):
            chain = lays[i : i + 5]
            c1, r1, c2, r2, pool = (self.mods[l.name] for l in chain)
            if ([l.type for l in chain] != types
                    or any(len(l.bottoms) != 1 or len(l.tops) != 1 for l in chain)
                    or any(b.bottoms[0] != a.tops[0] for a, b in zip(chain, chain[1:]))
                    or not c1.is_3x3_same(3, 64) or not c2.is_3x3_same(64, 64)
                    or r1.slope != 0.0 or r2.slope != 0.0 or not pool.is_max_2x2()):
                continue
            inner = frozenset(l.tops[0] for l in chain[:4])
            if any(b in inner for l in lays if l not in chain for b in l.bottoms):
                continue
            blocks[chain[0].name] = Conv1Block(tuple(l.name for l in chain), chain[0].bottoms[0],
                                               chain[4].tops[0], inner)
        return blocks

    # ------------------------------------------------------------- params

    def init_params(self, seed: int = 0) -> None:
        """Fill every parameter blob from its prototxt filler
        (``core/filler.py``), drawn in layer order from one CPU
        ``torch.Generator`` seeded with ``seed``: the same weights on every
        device.  Blobs without a filler (BatchNorm's statistics) are zero."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.layer_modules:
                for blob, filler in zip(mod.blobs(), mod.fillers):
                    blob.copy_(torch.zeros(blob.shape) if filler is None
                               else fill(gen, tuple(blob.shape), filler))
        self.params_changed()

    def params_changed(self) -> None:
        """Rebuild what is derived from the parameters (the compute copies in
        bf16, the conv1 kernel's packed weights) after they changed in place:
        a load, a fill, a solver's update.  In f32, and in any TRAIN net, a
        forward reads the parameters themselves."""
        # a TRAIN net's convolutions cast the parameters inside the forward
        op_dtype = torch.float32 if self.phase == "TRAIN" else self.dtype
        for conv in self.convs.values():
            conv.compute_weights(op_dtype)
        for blk in self.conv1_blocks.values():
            c1, c2 = self.mods[blk.names[0]], self.mods[blk.names[2]]
            blk.weights = conv1_cuda.Conv1Weights.pack(c1.weight, c1.bias, c2.weight, c2.bias)

    def layer_blobs(self) -> Dict[str, List[nn.Parameter]]:
        """``{layer: [blob, ...]}`` of every layer with parameter blobs, in
        layer order, in Caffe's layout."""
        return {l.name: self.mods[l.name].blobs() for l in self.layers if self.mods[l.name].blobs()}

    def learnable(self) -> List[Tuple[str, int, nn.Parameter, float, float]]:
        """Every parameter blob in Caffe's order (layers, then blobs):
        ``(layer, index, parameter, lr_mult, decay_mult)``."""
        out = []
        for name, blobs in self.layer_blobs().items():
            mod = self.mods[name]
            for i, prm in enumerate(blobs):
                out.append((name, i, prm, mod.lr_mult[i], mod.decay_mult[i]))
        return out

    def load_weights(self, weights: Union[str, Mapping[str, Sequence[np.ndarray]]]) -> int:
        """Copy a ``.caffemodel`` (or ``.h5``) path or ``{layer_name: [blob,
        ...]}`` in Caffe's layout by layer name with Caffe's checks on param
        count and size (net.cpp:750-806).  Returns the number of layers
        copied; names the net lacks are ignored, as Caffe does."""
        if isinstance(weights, str):
            if weights.endswith((".h5", ".hdf5")):
                return self.load_hdf5(weights)
            weights = caffemodel.load_weights(weights)
        own = self.layer_blobs()
        copied = 0
        for name, blobs in weights.items():
            targets = own.get(name)
            if targets is None:
                log.info("Ignoring source layer %s", name)
                continue
            if len(blobs) != len(targets):
                raise ValueError(
                    f"layer {name}: incompatible param count {len(blobs)} vs {len(targets)}")
            for t, arr in zip(targets, blobs):
                arr = np.array(arr.detach().cpu() if isinstance(arr, torch.Tensor) else arr,
                               np.float32)  # a writable copy
                if arr.size != t.numel():
                    raise ValueError(f"layer {name}: param size mismatch {arr.shape} vs caffe "
                                     f"shape {tuple(t.shape)}")
                with torch.no_grad():
                    t.copy_(torch.from_numpy(arr.reshape(tuple(t.shape))))
            copied += 1
        self.params_changed()
        return copied

    def share_with(self, other: "Net") -> int:
        """Net::ShareTrainedLayersWith: adopt ``other``'s parameter blobs
        (the tensors themselves) for the layers of the same name and blob
        shapes.  Returns the number of layers shared."""
        theirs = other.layer_blobs()
        shared = 0
        for name, blobs in self.layer_blobs().items():
            src = theirs.get(name)
            if src is None or [b.shape for b in src] != [b.shape for b in blobs]:
                continue
            mod = self.mods[name]
            for attr, t in zip(mod._blob_names, src):
                setattr(mod, attr, t)
            shared += 1
        self.params_changed()
        return shared

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
        """``{layer: [blob, ...]}`` f32 numpy copies in Caffe's layout, in
        layer order."""
        return {name: [b.detach().cpu().numpy().copy() for b in blobs]
                for name, blobs in self.layer_blobs().items()}

    def save_caffemodel(self, path: str) -> None:
        """The weights as a binary NetParameter (``.caffemodel``), as the JAX
        ``Net.save_caffemodel`` writes it."""
        layers = [{"name": name, "type": self.mods[name].type,
                   "blobs": [caffemodel.array_to_blob(b) for b in blobs]}
                  for name, blobs in self.export_weights().items()]
        caffemodel.save_net_parameter({"name": self.name, "layer": layers}, path)

    def save_hdf5(self, path: str) -> None:
        """Net::ToHDF5: group ``data``, one group a layer, datasets ``0``,
        ``1``, ... in Caffe's layout (``utils/hdf5.py``, the port's codec)."""
        with hdf5.File(path, "w") as f:
            grp = f.create_group("data")
            for name, blobs in self.export_weights().items():
                lg = grp.create_group(name)
                for i, arr in enumerate(blobs):
                    lg.create_dataset(str(i), data=arr)

    def load_hdf5(self, path: str) -> int:
        """Net::CopyTrainedLayersFromHDF5: groups matched by layer name."""
        with hdf5.File(path, "r") as f:
            weights = {name: [np.asarray(lg[str(i)]) for i in range(len(lg))]
                       for name, lg in f["data"].items()}
        return self.load_weights(weights)

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

    def output_names(self, post_layers: bool = False) -> List[str]:
        """The blobs no layer consumes (an in-place layer does not consume
        its own top), inputs first, then tops in layer order: Caffe's net
        outputs, as JAX orders them.  Unless ``post_layers``, the ImResize
        and Nms layers do not count: the estimator computes the post segment
        itself, so a pose graph's default outputs are its low-res maps.  The
        facade counts them, as JAX's and pycaffe's nets do."""
        layers = (self.layers if post_layers
                  else [l for l in self.layers if l.type not in ESTIMATOR_TYPES])
        consumed = set()
        for layer in layers:
            consumed |= set(layer.bottoms) - set(layer.tops)
        names: List[str] = []
        for b in list(self.input_names) + [t for layer in layers for t in layer.tops]:
            if b not in consumed and b not in names:
                names.append(b)
        return names

    def run_ctx(self, ops: Optional[Mapping[str, torch.Tensor]] = None,
                knobs: Optional[Mapping[str, Any]] = None,
                aux: Optional[Dict[str, Any]] = None, shard: Any = None) -> RunCtx:
        return RunCtx(ops=self.operands() if ops is None else ops,
                      training=self.phase == "TRAIN", generator=self.generator,
                      knobs=knobs, aux=aux, device=self.device, shard=shard)

    def pull_data(self) -> Dict[str, torch.Tensor]:
        """One batch from each data layer (one pull a layer, shared by its
        tops), on the net's device."""
        out: Dict[str, torch.Tensor] = {}
        for dl in self.data_layers:
            for k, v in dl.next_batch().items():
                out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
        return out

    def forward(self, inputs: Mapping[str, torch.Tensor],
                outputs: Optional[Sequence[str]] = None,
                layers: Optional[Sequence[Layer]] = None,
                operands: Optional[Mapping[str, torch.Tensor]] = None, *,
                knobs: Optional[Mapping[str, Any]] = None,
                aux: Optional[Dict[str, Any]] = None, shard: Any = None
                ) -> Dict[str, torch.Tensor]:
        """``inputs``: {blob: (N, C, H, W) tensor on the net's device, cast
        to the net's dtype here} -> {blob: tensor} for ``outputs`` (default
        :meth:`output_names`).  Data-layer tops the caller does not feed are
        pulled (:meth:`pull_data`).  ``operands``: what the convolutions run
        on, as :meth:`operands` names them (default: the net's own); a device
        program passes them as its inputs.  ``knobs``: ``switch_index``;
        ``aux``: a dict BatchNorm leaves its batch statistics in (TRAIN).
        Random layers draw from the net's :attr:`generator`.  ``shard``: the
        layout of one rank of a sharded forward (``RunCtx.shard``; the conv1
        kernel then stays off): it sees the forward begin and hands each
        layer its bottoms (``parallel/dp.DataShard``).

        With ``conv1_kernel`` on, a conv1 block whose five layers appear in
        order in ``layers`` runs as one ``conv1_cuda.conv1_block_packed`` call,
        unless ``outputs`` names a blob inside it or its input's H or W is
        odd (Caffe's ceil-mode pooling then differs from the kernel's)."""
        inputs = dict(inputs)
        if self.data_layers and any(t not in inputs for t in self._data_top_to_layer):
            inputs.update({k: v for k, v in self.pull_data().items() if k not in inputs})
        blobs: Dict[str, torch.Tensor] = {
            k: v.to(self.dtype).contiguous(memory_format=self.memory_format) if v.dim() == 4 else v
            for k, v in inputs.items()}
        outputs = list(outputs or self.output_names())
        if layers is None:
            layers = self.layers
            if self.post_layers:  # they run only when the outputs need them
                needed = {l.name for l in self.prune_for(outputs)}
                layers = [l for l in layers if l.type not in ESTIMATOR_TYPES or l.name in needed]
        layers = list(layers)
        ctx = self.run_ctx(operands, knobs, aux, shard)
        if shard is not None:
            shard.begin(self, ctx)
        ops = ctx.ops
        remat_types = (("Convolution", "Deconvolution")
                       if self.remat == "convs" and self.phase == "TRAIN" else ())
        i = 0
        while i < len(layers):
            layer = layers[i]
            blk = (self.conv1_blocks.get(layer.name)
                   if self.conv1_kernel and shard is None else None)
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
            if shard is not None:  # the bottoms as the layout gives them to this layer
                bots = shard.enter(layer, self.mods[layer.name], bots, ctx)
            if layer.type in remat_types and torch.is_grad_enabled():
                # a convolution draws no random numbers: no RNG state to replay
                tops = checkpoint(self._run_layer, layer, bots, ops, ctx,
                                  use_reentrant=False, preserve_rng_state=False)
            else:
                tops = self._run_layer(layer, bots, ops, ctx)
            for t, top in zip(layer.tops, tops):
                blobs[t] = top
        return {k: blobs[k] for k in outputs}

    def _run_layer(self, layer: Layer, bots: List[torch.Tensor],
                   ops: Mapping[str, torch.Tensor],
                   ctx: Optional[RunCtx] = None) -> Tuple[torch.Tensor, ...]:
        """One layer's tops from its bottoms, through its registered module."""
        return self.mods[layer.name].run(bots, ctx or self.run_ctx(ops))

    def set_imresize(self, start_scale: Optional[float] = None,
                     scale_gap: Optional[float] = None,
                     target: Optional[Tuple[int, int]] = None) -> None:
        """The ImResize layers' runtime knobs (imresize_layer.hpp:23-28:
        SetStartScale, SetScaleGap, setTargetDimenions); ``target`` is
        (height, width) and also reshapes the layers' tops."""
        for layer in self.layers:
            mod = self.mods[layer.name]
            if layer.type != "ImResize":
                continue
            if start_scale is not None:
                mod.start_scale = float(start_scale)
            if scale_gap is not None:
                mod.scale_gap = float(scale_gap)
            if target is not None:
                mod.target = (int(target[0]), int(target[1]))
                n, c = mod.top_shapes[0][:2]
                mod.top_shapes[0] = (n, c) + mod.target
                self.blob_shapes[layer.tops[0]] = mod.top_shapes[0]

    def set_input_arrays(self, data: np.ndarray, labels: Optional[np.ndarray] = None) -> None:
        """Bind arrays to the net's MemoryData layer (pycaffe
        Net.set_input_arrays, memory_data_layer.cpp Reset)."""
        from .data_layers import MemoryDataLayer

        for dl in self.data_layers:
            if isinstance(dl, MemoryDataLayer):
                dl.set_arrays(data, labels)
                return
        raise ValueError("net has no MemoryData layer")

    def update_bn_stats(self, next_batch: Callable[[int], Mapping[str, Any]],
                        n_batches: int = 10) -> int:
        """Recompute BatchNorm's statistics from data, front to back (each
        layer's after every upstream one has its own): ``n_batches``
        forwards, each BatchNorm bottom's batch mean and variance averaged
        (f64 on the host) and written with scale factor 1.  For nets trained
        outside :class:`~..training.solver.Solver` (which rolls them every
        step) or imported without statistics.  ``next_batch(i) -> {input:
        array}``.  Returns the number of BatchNorm layers updated."""
        bn = [l for l in self.layers if l.type == "BatchNorm"]
        for layer in bn:
            b = layer.bottoms[0]
            s = sq = 0.0
            for it in range(n_batches):
                feed = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                        for k, v in next_batch(it).items()}
                with torch.no_grad():
                    arr = self.forward(feed, outputs=[b])[b].double().cpu().numpy()
                axes = tuple(d for d in range(arr.ndim) if d != 1)
                s = s + arr.mean(axis=axes)
                sq = sq + (arr ** 2).mean(axis=axes)
            mean = s / n_batches
            var = np.maximum(sq / n_batches - mean ** 2, 0.0)
            mod = self.mods[layer.name]
            with torch.no_grad():
                mod.mean.copy_(torch.from_numpy(mean.astype(np.float32)))
                mod.variance.copy_(torch.from_numpy(var.astype(np.float32)))
                mod.scale_factor.fill_(1.0)
        return len(bn)

    # --------------------------------------------------------------- loss

    def loss_tops(self) -> List[Tuple[str, float]]:
        """``(top, loss_weight)`` of every top with a nonzero loss weight, in
        layer order."""
        return [(t, w) for layer in self.layers for t, w in zip(layer.tops, layer.loss_weights)
                if w]

    def loss(self, inputs: Mapping[str, torch.Tensor], aux: Optional[Dict[str, Any]] = None,
             shard: Any = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One forward -> (the total weighted loss, sum over loss tops of
        weight times the top's sum; the net's output blobs from the same
        forward), as JAX's ``Net.make_loss_fn(with_outputs=True)``.
        ``loss.backward()`` fills the parameters' gradients; ``aux`` collects
        BatchNorm's batch statistics; ``shard``: one rank's layout
        (:meth:`forward`), whose loss is this rank's share of the whole
        batch's."""
        tops = self.loss_tops()
        if not tops:
            raise ValueError("net has no loss tops")
        fed = set(inputs) | set(self._data_top_to_layer)
        # an input nothing feeds (read only by a layer the phase dropped) is
        # no output of this forward
        names = [n for n in self.output_names() if n not in self.input_names or n in fed]
        blobs = self.forward(inputs, outputs=list(dict.fromkeys(names + [t for t, _ in tops])),
                             aux=aux, shard=shard)
        total = sum(w * (blobs[t].sum() if shard is None else
                         shard.loss_share(t, blobs[t].sum())) for t, w in tops)
        return total, {k: blobs[k] for k in names}

    def backward(self, inputs: Mapping[str, torch.Tensor],
                 top_diffs: Mapping[str, Any]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[torch.Tensor]]]:
        """Backward from given top diffs: the gradients of sum over tops of
        top * diff with respect to every floating input and every parameter
        blob (zeros where a blob does not reach the tops), as Caffe's
        backward with ``force_backward``.  Returns ``({input: diff},
        {layer: [blob diff, ...]})`` in Caffe's layout."""
        feed = {k: torch.as_tensor(v).to(self.device) for k, v in inputs.items()}
        leaves = {k: v.detach().float().requires_grad_(True) for k, v in feed.items()
                  if v.is_floating_point()}
        feed.update(leaves)
        params = self.layer_blobs()
        flat = [p for blobs in params.values() for p in blobs]
        flags = [p.requires_grad for p in flat]
        try:
            for p in flat:
                p.requires_grad_(True)
            with torch.enable_grad():
                blobs = self.forward(feed, outputs=list(top_diffs))
                total = sum(torch.sum(blobs[k].float() * torch.as_tensor(
                    np.asarray(d, np.float32) if not isinstance(d, torch.Tensor) else d,
                    dtype=torch.float32, device=self.device).expand_as(blobs[k]))
                    for k, d in top_diffs.items())
                wrt = list(leaves.values()) + flat
                grads = torch.autograd.grad(total, wrt, allow_unused=True)
        finally:
            for p, f in zip(flat, flags):
                p.requires_grad_(f)
        grads = [torch.zeros_like(w) if g is None else g for g, w in zip(grads, wrt)]
        in_diffs = dict(zip(leaves, grads[: len(leaves)]))
        it = iter(grads[len(leaves):])
        param_diffs = {name: [next(it) for _ in blobs] for name, blobs in params.items()}
        return in_diffs, param_diffs
