"""NetSpec: programmatic prototxt construction (pycaffe net_spec.py parity,
reference python/caffe/net_spec.py).  A copy of
``caffe_rtpose_tpu/core/net_spec.py`` (pure dict code).

Usage:
    n = NetSpec()
    n.data = L.Input(shape=dict(dim=[1, 3, 368, 656]))
    n.conv1 = L.Convolution(n.data, num_output=64, kernel_size=3, pad=1)
    n.relu1 = L.ReLU(n.conv1, in_place=True)
    net_param = n.to_proto()          # NetParameter dict
    text = n.to_prototxt()            # prototxt text
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..proto import caffe_pb, prototxt

# layer type -> param field name, derived from the LayerParameter schema
_PARAM_FIELD = {}
for _f in caffe_pb.SCHEMA["LayerParameter"].values():
    if _f.name.endswith("_param") and _f.message:
        _PARAM_FIELD[_f.message] = _f.name

_TYPE_TO_PARAM = {
    "Convolution": "convolution_param",
    "Deconvolution": "convolution_param",
    "Pooling": "pooling_param",
    "InnerProduct": "inner_product_param",
    "ReLU": "relu_param",
    "PReLU": "prelu_param",
    "ELU": "elu_param",
    "Sigmoid": "sigmoid_param",
    "TanH": "tanh_param",
    "Power": "power_param",
    "Exp": "exp_param",
    "Log": "log_param",
    "Threshold": "threshold_param",
    "Dropout": "dropout_param",
    "LRN": "lrn_param",
    "BatchNorm": "batch_norm_param",
    "Scale": "scale_param",
    "Bias": "bias_param",
    "MVN": "mvn_param",
    "Concat": "concat_param",
    "Slice": "slice_param",
    "Flatten": "flatten_param",
    "Reshape": "reshape_param",
    "Crop": "crop_param",
    "Eltwise": "eltwise_param",
    "Tile": "tile_param",
    "ArgMax": "argmax_param",
    "Reduction": "reduction_param",
    "Softmax": "softmax_param",
    "SoftmaxWithLoss": "softmax_param",
    "Accuracy": "accuracy_param",
    "HingeLoss": "hinge_loss_param",
    "InfogainLoss": "infogain_loss_param",
    "ContrastiveLoss": "contrastive_loss_param",
    "Embed": "embed_param",
    "Input": "input_param",
    "Data": "data_param",
    "ImageData": "image_data_param",
    "HDF5Data": "hdf5_data_param",
    "HDF5Output": "hdf5_output_param",
    "MemoryData": "memory_data_param",
    "DummyData": "dummy_data_param",
    "WindowData": "window_data_param",
    "Python": "python_param",
    "SPP": "spp_param",
    "Recurrent": "recurrent_param",
    "RNN": "recurrent_param",
    "LSTM": "recurrent_param",
    "ImResize": "imresize_param",
    "Nms": "nms_param",
}

# fields that live directly on LayerParameter, not in the typed sub-message
_TOP_LEVEL = {"name", "type", "bottom", "top", "loss_weight", "param",
              "include", "exclude", "phase", "propagate_down",
              "transform_param", "loss_param"}


class Top:
    """A named output of a layer (a blob)."""

    def __init__(self, layer: "_Layer", index: int = 0):
        self.layer = layer
        self.index = index


class _Layer:
    def __init__(self, type_name: str, inputs, params: Dict[str, Any]):
        self.type_name = type_name
        self.inputs = list(inputs)
        self.in_place = params.pop("in_place", False)
        self.ntop = params.pop("ntop", 1)
        self.params = params
        self.tops = [Top(self, i) for i in range(self.ntop)]


class _LayerFactory:
    def __getattr__(self, type_name: str):
        def make(*inputs, **params):
            layer = _Layer(type_name, inputs, params)
            if layer.ntop == 0:
                # pycaffe returns the function itself for ntop=0 layers
                # (e.g. Silence); assigning it to a NetSpec attribute
                # registers the layer without any top
                return layer
            return layer.tops[0] if layer.ntop == 1 else tuple(layer.tops)

        return make


L = _LayerFactory()


class NetSpec:
    def __init__(self, name: str = ""):
        object.__setattr__(self, "_tops", {})
        object.__setattr__(self, "_name", name)

    def __setattr__(self, key: str, value):
        if isinstance(value, tuple):
            for i, v in enumerate(value):
                self._tops[f"{key}{i if i else ''}"] = v
        else:
            self._tops[key] = value

    def __getattr__(self, key: str):
        try:
            return self._tops[key]
        except KeyError:
            raise AttributeError(key)

    def to_proto(self) -> Dict[str, Any]:
        # assign blob names: a top takes the NetSpec attribute name
        top_names: Dict[Top, str] = {}
        layer_attr_names: Dict[int, str] = {}
        layers: List[_Layer] = []
        seen = set()
        for name, top in self._tops.items():
            if isinstance(top, _Layer):  # ntop=0 layer (e.g. Silence)
                layer = top
            else:
                top_names[top] = name
                layer = top.layer
            if id(layer) not in seen:
                seen.add(id(layer))
                layer_attr_names[id(layer)] = name
                layers.append(layer)
        # order: as assigned (dict preserves insertion)
        out_layers = []
        autogen = [0]

        def blob_name(top: Top) -> str:
            if top in top_names:
                return top_names[top]
            autogen[0] += 1
            nm = f"_auto{autogen[0]}"
            top_names[top] = nm
            return nm

        # rendered blob name per Top: downstream bottoms must use the
        # PRODUCING layer's actual top (pycaffe: layers[inp.fn].top[inp.n]),
        # which for in-place layers is the bottom's name, not the attribute
        rendered: Dict[Top, str] = {}
        for layer in layers:
            bottoms = [rendered.get(t, blob_name(t)) for t in layer.inputs]
            if layer.in_place and bottoms:
                tops = bottoms[: layer.ntop]
            else:
                tops = [blob_name(t) for t in layer.tops]
            for t, nm in zip(layer.tops, tops):
                rendered[t] = nm
            if layer.tops:
                lname = top_names.get(layer.tops[0], tops[0])
            else:
                lname = layer_attr_names.get(id(layer), f"_auto{autogen[0]}")
            msg: Dict[str, Any] = {"name": lname, "type": layer.type_name}
            if bottoms:
                msg["bottom"] = bottoms
            msg["top"] = tops
            sub: Dict[str, Any] = {}
            for k, v in layer.params.items():
                if k in _TOP_LEVEL:
                    msg[k] = v if isinstance(v, (list, dict)) else (
                        [v] if k in ("bottom", "top", "loss_weight") else v
                    )
                else:
                    sub[k] = v
            if sub:
                pf = _TYPE_TO_PARAM.get(layer.type_name)
                if pf is None:
                    raise ValueError(f"no param field known for {layer.type_name}")
                msg[pf] = _normalize(pf, sub)
            out_layers.append(msg)
        net: Dict[str, Any] = {"layer": out_layers}
        if self._name:
            net["name"] = self._name
        return net

    def to_prototxt(self) -> str:
        return prototxt.dumps(self.to_proto())


def _normalize(param_field: str, sub: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce python values into schema shapes (repeated fields to lists)."""
    msg_name = None
    for f in caffe_pb.SCHEMA["LayerParameter"].values():
        if f.name == param_field:
            msg_name = f.message
            break
    fields = caffe_pb._BY_NAME[msg_name]
    out = {}
    for k, v in sub.items():
        fld = fields.get(k)
        if fld is None:
            raise ValueError(f"{msg_name} has no field {k}")
        if fld.repeated and not isinstance(v, list):
            v = [v]
        if fld.kind == "enum" and isinstance(v, str):
            v = fld.enum_values[v]
        out[k] = v
    return out


class _MsgEnums:
    """Enum namespace of one parameter message: P.Pooling.MAX -> 0."""

    def __init__(self, msg_name: str):
        self._vals: Dict[str, int] = {}
        for f in caffe_pb.SCHEMA.get(msg_name, {}).values():
            if f.kind == "enum" and f.enum_values:
                self._vals.update(f.enum_values)

    def __getattr__(self, name: str) -> int:
        try:
            return self._vals[name]
        except KeyError:
            raise AttributeError(name)


class _Params:
    """pycaffe ``caffe.params`` (P): enum values by parameter message —
    P.Pooling.MAX, P.Eltwise.SUM, ... (net_spec.py parameter_enum there)."""

    def __getattr__(self, name: str) -> _MsgEnums:
        for suffix in ("Parameter", "ParameterV2", ""):
            if name + suffix in caffe_pb.SCHEMA:
                return _MsgEnums(name + suffix)
        raise AttributeError(f"no parameter message for {name!r}")


params = _Params()
P = params
