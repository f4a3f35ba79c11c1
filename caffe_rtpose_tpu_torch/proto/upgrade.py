"""Legacy NetParameter upgrade chain (reference src/caffe/util/upgrade_proto.cpp).

Mirrors ``UpgradeNetAsNeeded`` (:20-76): V0LayerParameter nets (padding-layer
dissolution + per-type param routing), the deprecated in-data-param transform
fields, V1->V2 layer conversion, and input-field-to-Input-layer upgrade.
Operates on the decoded message dicts of :mod:`caffe_rtpose_tpu_torch.proto`.
A copy of ``caffe_rtpose_tpu/proto/upgrade.py`` (that package imports jax).
"""

from __future__ import annotations

import sys
from typing import Any, Dict

# V0 string type -> V1 enum name (UpgradeV0LayerType, upgrade_proto.cpp:543-597)
V0_TO_V1_TYPE = {
    "accuracy": "ACCURACY", "bnll": "BNLL", "concat": "CONCAT",
    "conv": "CONVOLUTION", "data": "DATA", "dropout": "DROPOUT",
    "euclidean_loss": "EUCLIDEAN_LOSS", "flatten": "FLATTEN",
    "hdf5_data": "HDF5_DATA", "hdf5_output": "HDF5_OUTPUT",
    "im2col": "IM2COL", "images": "IMAGE_DATA",
    "infogain_loss": "INFOGAIN_LOSS", "innerproduct": "INNER_PRODUCT",
    "lrn": "LRN", "multinomial_logistic_loss": "MULTINOMIAL_LOGISTIC_LOSS",
    "pool": "POOLING", "relu": "RELU", "sigmoid": "SIGMOID",
    "softmax": "SOFTMAX", "softmax_loss": "SOFTMAX_LOSS", "split": "SPLIT",
    "tanh": "TANH", "window_data": "WINDOW_DATA",
}


def _warn(msg: str):
    print(f"upgrade_proto: {msg}", file=sys.stderr)


def net_needs_v0_upgrade(net: Dict[str, Any]) -> bool:
    """NetNeedsV0ToV1Upgrade (:93-100): any 'layers' entry carrying 'layer'."""
    return any("layer" in l for l in net.get("layers", []))


def net_needs_v1_upgrade(net: Dict[str, Any]) -> bool:
    return bool(net.get("layers"))


def upgrade_v0_padding_layers(net: Dict[str, Any]) -> Dict[str, Any]:
    """UpgradeV0PaddingLayers (:131-189): drop 'padding' layers, push their
    pad into the consuming conv/pool layer and rewire its bottom."""
    out = {k: v for k, v in net.items() if k != "layers"}
    out["layers"] = []
    last_top: Dict[str, int] = {name: -1 for name in net.get("input", [])}
    layers = net.get("layers", [])
    for i, conn in enumerate(layers):
        lp = conn.get("layer", {})
        if lp.get("type") != "padding":
            out["layers"].append({k: (v.copy() if isinstance(v, dict) else
                                      list(v) if isinstance(v, list) else v)
                                  for k, v in conn.items()})
            out["layers"][-1]["layer"] = dict(lp)
        for j, blob in enumerate(conn.get("bottom", [])):
            if blob not in last_top:
                # report the layer's index (reference upgrade_proto.cpp
                # logs the layer number, not the bottom index)
                raise ValueError(f"Unknown blob input {blob} to layer {i}")
            top_idx = last_top[blob]
            if top_idx == -1:
                continue
            src = layers[top_idx]
            if src.get("layer", {}).get("type") == "padding":
                if lp.get("type") not in ("conv", "pool"):
                    raise ValueError(
                        "Padding layer input to non-convolutional / "
                        f"non-pooling layer type {lp.get('type')}")
                if len(conn.get("bottom", [])) != 1 or \
                        len(src.get("bottom", [])) != 1 or \
                        len(src.get("top", [])) != 1:
                    raise ValueError("padding layer fan-in/out must be 1")
                tgt = out["layers"][-1]
                tgt["layer"]["pad"] = src["layer"].get("pad", 0)
                tgt["bottom"] = list(tgt["bottom"])
                tgt["bottom"][j] = src["bottom"][0]
        for blob in conn.get("top", []):
            last_top[blob] = i
    return out


def _route(v1: Dict[str, Any], param_key: str, field: str, value,
           repeated: bool = False):
    p = v1.setdefault(param_key, {})
    if repeated:
        p.setdefault(field, []).append(value)
    else:
        p[field] = value


def upgrade_v0_layer(conn: Dict[str, Any]) -> Dict[str, Any]:
    """UpgradeV0LayerParameter (:191-541): V0 flat knobs -> V1 sub-messages.
    Returns a V1LayerParameter dict (enum 'type' as int)."""
    from . import caffe_pb

    v1: Dict[str, Any] = {}
    if "bottom" in conn:
        v1["bottom"] = list(conn["bottom"])
    if "top" in conn:
        v1["top"] = list(conn["top"])
    v0 = conn.get("layer")
    if v0 is None:
        return v1
    if "name" in v0:
        v1["name"] = v0["name"]
    t = v0.get("type", "")
    if "type" in v0:
        if t not in V0_TO_V1_TYPE:
            raise ValueError(f"Unknown layer name: {t}")
        v1["type"] = caffe_pb.V1_LAYER_TYPE[V0_TO_V1_TYPE[t]]
    for k in ("blobs", "blobs_lr", "weight_decay"):
        if k in v0:
            v1[k] = list(v0[k])

    def incompat(field):
        _warn(f"Unknown parameter {field} for layer type {t}")

    # type-routed scalars (:222-418); the (field, {type: (param, name,
    # repeated)}) table is the reference's if/else chains flattened
    routing = {
        "num_output": {"conv": ("convolution_param", "num_output", False),
                       "innerproduct": ("inner_product_param", "num_output",
                                        False)},
        "biasterm": {"conv": ("convolution_param", "bias_term", False),
                     "innerproduct": ("inner_product_param", "bias_term",
                                      False)},
        "weight_filler": {"conv": ("convolution_param", "weight_filler",
                                   False),
                          "innerproduct": ("inner_product_param",
                                           "weight_filler", False)},
        "bias_filler": {"conv": ("convolution_param", "bias_filler", False),
                        "innerproduct": ("inner_product_param", "bias_filler",
                                         False)},
        "pad": {"conv": ("convolution_param", "pad", True),
                "pool": ("pooling_param", "pad", False)},
        "kernelsize": {"conv": ("convolution_param", "kernel_size", True),
                       "pool": ("pooling_param", "kernel_size", False)},
        "group": {"conv": ("convolution_param", "group", False)},
        "stride": {"conv": ("convolution_param", "stride", True),
                   "pool": ("pooling_param", "stride", False)},
        "pool": {"pool": ("pooling_param", "pool", False)},
        "dropout_ratio": {"dropout": ("dropout_param", "dropout_ratio",
                                      False)},
        "local_size": {"lrn": ("lrn_param", "local_size", False)},
        "alpha": {"lrn": ("lrn_param", "alpha", False)},
        "beta": {"lrn": ("lrn_param", "beta", False)},
        "k": {"lrn": ("lrn_param", "k", False)},
        "source": {"data": ("data_param", "source", False),
                   "hdf5_data": ("hdf5_data_param", "source", False),
                   "images": ("image_data_param", "source", False),
                   "window_data": ("window_data_param", "source", False),
                   "infogain_loss": ("infogain_loss_param", "source", False)},
        "batchsize": {"data": ("data_param", "batch_size", False),
                      "hdf5_data": ("hdf5_data_param", "batch_size", False),
                      "images": ("image_data_param", "batch_size", False),
                      "window_data": ("window_data_param", "batch_size",
                                      False)},
        "rand_skip": {"data": ("data_param", "rand_skip", False),
                      "images": ("image_data_param", "rand_skip", False)},
        "shuffle_images": {"images": ("image_data_param", "shuffle", False)},
        "new_height": {"images": ("image_data_param", "new_height", False)},
        "new_width": {"images": ("image_data_param", "new_width", False)},
        "concat_dim": {"concat": ("concat_param", "concat_dim", False)},
        "det_fg_threshold": {"window_data": ("window_data_param",
                                             "fg_threshold", False)},
        "det_bg_threshold": {"window_data": ("window_data_param",
                                             "bg_threshold", False)},
        "det_fg_fraction": {"window_data": ("window_data_param",
                                            "fg_fraction", False)},
        "det_context_pad": {"window_data": ("window_data_param",
                                            "context_pad", False)},
        "det_crop_mode": {"window_data": ("window_data_param", "crop_mode",
                                          False)},
        "hdf5_output_param": {"hdf5_output": ("hdf5_output_param", None,
                                              False)},
    }
    for field, table in routing.items():
        if field not in v0:
            continue
        if t in table:
            param_key, name, repeated = table[t]
            if name is None:  # whole-message copy
                v1[param_key] = dict(v0[field])
            else:
                _route(v1, param_key, name, v0[field], repeated)
        else:
            incompat(field)
    # transform fields route unconditionally (:399-429)
    if "scale" in v0:
        _route(v1, "transform_param", "scale", v0["scale"])
    if "meanfile" in v0:
        _route(v1, "transform_param", "mean_file", v0["meanfile"])
    if "cropsize" in v0:
        _route(v1, "transform_param", "crop_size", v0["cropsize"])
    if "mirror" in v0:
        _route(v1, "transform_param", "mirror", v0["mirror"])
    return v1


def upgrade_v0_net(net: Dict[str, Any]) -> Dict[str, Any]:
    """UpgradeV0Net (:102-129): padding dissolution then per-layer upgrade.
    Output still uses 'layers' (V1) — chain with the V1->V2 step."""
    depadded = upgrade_v0_padding_layers(net)
    out = {}
    if "name" in depadded:
        out["name"] = depadded["name"]
    out["layers"] = [upgrade_v0_layer(c) for c in depadded.get("layers", [])]
    for k in ("input", "input_dim"):
        if k in depadded:
            out[k] = list(depadded[k])
    if "force_backward" in depadded:
        out["force_backward"] = depadded["force_backward"]
    return out


_DATA_LAYER_PARAMS = {  # V1 enum name -> param key (NetNeedsDataUpgrade :599)
    "DATA": "data_param",
    "IMAGE_DATA": "image_data_param",
    "WINDOW_DATA": "window_data_param",
}


def net_needs_data_upgrade(net: Dict[str, Any]) -> bool:
    from . import caffe_pb

    by_val = {v: k for k, v in caffe_pb.V1_LAYER_TYPE.items()}
    for l in net.get("layers", []):
        key = _DATA_LAYER_PARAMS.get(by_val.get(l.get("type"), ""))
        if key and any(f in l.get(key, {})
                       for f in ("scale", "mean_file", "crop_size", "mirror")):
            return True
    return False


def upgrade_net_data_transformation(net: Dict[str, Any]) -> None:
    """UpgradeNetDataTransformation (:645-651): hoist scale/mean_file/
    crop_size/mirror out of data params into transform_param (in place)."""
    from . import caffe_pb

    by_val = {v: k for k, v in caffe_pb.V1_LAYER_TYPE.items()}
    for l in net.get("layers", []):
        key = _DATA_LAYER_PARAMS.get(by_val.get(l.get("type"), ""))
        if not key or key not in l:
            continue
        p = l[key]
        for f in ("scale", "mean_file", "crop_size", "mirror"):
            if f in p:
                l.setdefault("transform_param", {})[f] = p.pop(f)


def net_needs_input_upgrade(net: Dict[str, Any]) -> bool:
    return bool(net.get("input"))


def upgrade_net_input(net: Dict[str, Any]) -> None:
    """UpgradeNetInput: input/input_shape/input_dim fields -> one leading
    Input layer (in place)."""
    inputs = net.pop("input", [])
    shapes = net.pop("input_shape", [])
    dims = net.pop("input_dim", [])
    if not inputs:
        return
    param: Dict[str, Any] = {}
    if shapes:
        param["shape"] = shapes
    elif dims:
        if len(dims) != 4 * len(inputs):  # UpgradeNetInput CHECKs this
            raise ValueError(
                f"{len(inputs)} inputs need {4 * len(inputs)} input_dim "
                f"values, got {len(dims)}")
        param["shape"] = [{"dim": dims[4 * i : 4 * i + 4]}
                          for i in range(len(inputs))]
    layer = {"name": "input", "type": "Input", "top": list(inputs)}
    if param:
        layer["input_param"] = param
    net.setdefault("layer", []).insert(0, layer)


def upgrade_net_as_needed(net: Dict[str, Any],
                          upgrade_input: bool = False) -> Dict[str, Any]:
    """Full UpgradeNetAsNeeded chain (:20-76).  ``upgrade_input`` converts
    input fields to an Input layer (our Net accepts both forms natively, so
    the loader leaves them; the upgrade tools normalize)."""
    from .caffemodel import _upgrade_v1_layer

    if net_needs_v0_upgrade(net):
        net = upgrade_v0_net(net)
    if net_needs_data_upgrade(net):
        upgrade_net_data_transformation(net)
    if net_needs_v1_upgrade(net):
        if net.get("layer"):
            raise ValueError(
                "Refusing to upgrade inconsistent NetParameter input; the "
                "definition includes both 'layer' and 'layers' fields.")
        net["layer"] = [_upgrade_v1_layer(l) for l in net.pop("layers")]
    if upgrade_input and net_needs_input_upgrade(net):
        upgrade_net_input(net)
    return net
