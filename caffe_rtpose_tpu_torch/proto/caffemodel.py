"""Binary ``.caffemodel`` / ``.solverstate`` IO built on the wire codec.

A copy of ``caffe_rtpose_tpu/proto/caffemodel.py`` (that package imports jax).

Weight flow being matched: ``Net::CopyTrainedLayersFromBinaryProto``
(reference ``src/caffe/net.cpp:750-806``) loads a binary ``NetParameter`` and
matches layer params **by layer name**, shape-checked.  Legacy V1-format
models (``NetParameter.layers``, field 2) are upgraded on the fly, like
``UpgradeNetAsNeeded`` (reference ``src/caffe/util/upgrade_proto.cpp``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from . import caffe_pb, wire


def blob_to_array(blob: Dict[str, Any]) -> np.ndarray:
    """BlobProto dict -> float32 ndarray with its proto shape."""
    v = caffe_pb.view(blob, "BlobProto")
    if v.has("double_data") and len(v.double_data):
        data = np.asarray(v.double_data, dtype=np.float64).astype(np.float32)
    else:
        data = np.asarray(v.data, dtype=np.float32)
    if v.has("shape"):
        shape = tuple(int(d) for d in v.shape.dim)
    else:
        # legacy 4-D fields (reference blob.cpp legacy shape path)
        shape = tuple(int(x) for x in (v.num, v.channels, v.height, v.width))
        # strip leading singleton dims the way legacy blobs were often stored
        while len(shape) > 1 and shape[0] == 0:
            shape = shape[1:]
    size = int(np.prod(shape)) if shape else data.size
    if size != data.size:
        # legacy blobs sometimes carry 1x1xCxK shapes for biases etc.
        raise ValueError(f"blob shape {shape} does not match data size {data.size}")
    return np.asarray(data, dtype=np.float32).reshape(shape)


def array_to_blob(arr: np.ndarray) -> Dict[str, Any]:
    arr = np.asarray(arr, dtype=np.float32)
    return {
        "shape": {"dim": [int(d) for d in arr.shape]},
        "data": arr.reshape(-1),
    }


def load_net_parameter(path: str) -> Dict[str, Any]:
    """Read a binary NetParameter, running the full legacy upgrade chain
    (V0 padding/param migration, data-transform hoist, V1->V2)."""
    from .upgrade import upgrade_net_as_needed

    with open(path, "rb") as f:
        buf = f.read()
    msg = wire.decode(buf, caffe_pb.SCHEMA, "NetParameter")
    return upgrade_net_as_needed(msg)


_V1_COPY_FIELDS = (
    "bottom", "top", "name", "blobs", "loss_weight", "include", "exclude",
    "accuracy_param", "argmax_param", "concat_param",
    "contrastive_loss_param", "convolution_param", "data_param",
    "dropout_param", "dummy_data_param", "eltwise_param", "exp_param",
    "hdf5_data_param", "hdf5_output_param", "hinge_loss_param",
    "image_data_param", "infogain_loss_param", "inner_product_param",
    "lrn_param", "memory_data_param", "mvn_param", "pooling_param",
    "power_param", "relu_param", "sigmoid_param", "softmax_param",
    "slice_param", "tanh_param", "threshold_param", "window_data_param",
    "transform_param", "loss_param",
)


def _upgrade_v1_layer(v1: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in _V1_COPY_FIELDS:
        if k in v1:
            out[k] = v1[k]
    t = v1.get("type")
    out["type"] = caffe_pb.V1_TO_V2_TYPE.get(t, str(t)) if t is not None else ""
    # param names / share modes / lr & decay mults merge positionally into
    # ParamSpec entries (upgrade_proto.cpp:705-735)
    specs: list = []

    def spec(i):
        while len(specs) <= i:
            specs.append({})
        return specs[i]

    for i, name in enumerate(v1.get("param", [])):
        spec(i)["name"] = name
    for i, mode in enumerate(v1.get("blob_share_mode", [])):
        spec(i)["share_mode"] = mode
    for i, lr in enumerate(v1.get("blobs_lr", [])):
        spec(i)["lr_mult"] = lr
    for i, wd in enumerate(v1.get("weight_decay", [])):
        spec(i)["decay_mult"] = wd
    if specs:
        out["param"] = specs
    return out


def load_weights(path: str) -> Dict[str, List[np.ndarray]]:
    """.caffemodel -> {layer_name: [param arrays in Caffe order/layout]}.

    Convolution weights stay OIHW, which is also the port's own layout
    (``caffe_rtpose_tpu_torch.core.net``).  Packed float payloads decode as
    read-only views of the file's buffer: copy before ``torch.from_numpy``.
    """
    msg = load_net_parameter(path)
    out: Dict[str, List[np.ndarray]] = {}
    for layer in msg.get("layer", []):
        blobs = layer.get("blobs", [])
        if not blobs:
            continue
        name = layer.get("name", "")
        out[name] = [blob_to_array(b) for b in blobs]
    return out


def save_net_parameter(msg: Dict[str, Any], path: str) -> None:
    with open(path, "wb") as f:
        f.write(wire.encode(msg, caffe_pb.SCHEMA, "NetParameter"))


def load_solver_state(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return wire.decode(f.read(), caffe_pb.SCHEMA, "SolverState")


def save_solver_state(msg: Dict[str, Any], path: str) -> None:
    with open(path, "wb") as f:
        f.write(wire.encode(msg, caffe_pb.SCHEMA, "SolverState"))
