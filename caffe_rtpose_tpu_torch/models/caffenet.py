"""BVLC reference CaffeNet (the AlexNet variant the reference's own
performance docs benchmark: the reference's docs/performance_hardware.md:18
— "Training: 26.5 secs / 20 iterations (5,120 images)" on a K40, batch
256).  The rtpose fork strips the models/ zoo, so the classic topology is
regenerated here.  A copy of ``caffe_rtpose_tpu/models/caffenet.py`` with
:func:`make_caffenet_train_val`, the public train_val form that feeds
itself through ``Data`` layers.

Architecture (public BVLC reference_caffenet): conv1 96@11/4 - LRN - pool,
conv2 256@5 g2 - LRN - pool, conv3 384@3, conv4 384@3 g2, conv5 256@3 g2 -
pool, fc6/fc7 4096 + dropout, fc8 1000, softmax loss.
"""

from typing import Any, Dict, List


def _conv(name, bottom, num_output, kernel, stride=1, pad=0, group=1):
    p = {"num_output": num_output, "kernel_size": [kernel],
         "weight_filler": {"type": "gaussian", "std": 0.01},
         "bias_filler": {"type": "constant", "value": 0.1}}
    if stride != 1:
        p["stride"] = [stride]
    if pad:
        p["pad"] = [pad]
    if group != 1:
        p["group"] = group
    return {"name": name, "type": "Convolution", "bottom": [bottom],
            "top": [name],
            "param": [{"lr_mult": 1.0, "decay_mult": 1.0},
                      {"lr_mult": 2.0, "decay_mult": 0.0}],
            "convolution_param": p}


def _relu(name, blob):
    return {"name": name, "type": "ReLU", "bottom": [blob], "top": [blob]}


def _pool(name, bottom):
    return {"name": name, "type": "Pooling", "bottom": [bottom],
            "top": [name],
            "pooling_param": {"pool": 0, "kernel_size": 3, "stride": 2}}


def _lrn(name, bottom):
    return {"name": name, "type": "LRN", "bottom": [bottom], "top": [name],
            "lrn_param": {"local_size": 5, "alpha": 0.0001, "beta": 0.75}}


def _fc(name, bottom, num_output, std=0.005):
    return {"name": name, "type": "InnerProduct", "bottom": [bottom],
            "top": [name],
            "param": [{"lr_mult": 1.0, "decay_mult": 1.0},
                      {"lr_mult": 2.0, "decay_mult": 0.0}],
            "inner_product_param": {
                "num_output": num_output,
                "weight_filler": {"type": "gaussian", "std": std},
                "bias_filler": {"type": "constant", "value": 0.1}}}


def make_caffenet(batch: int = 256, crop: int = 227,
                  num_classes: int = 1000,
                  phase: str = "TRAIN") -> Dict[str, Any]:
    """NetParameter dict for CaffeNet; TRAIN nets take (data, label)
    inputs and end in SoftmaxWithLoss (+ Accuracy in TEST)."""
    layers: List[Dict[str, Any]] = []
    layers.append(_conv("conv1", "data", 96, 11, stride=4))
    layers.append(_relu("relu1", "conv1"))
    layers.append(_pool("pool1", "conv1"))
    layers.append(_lrn("norm1", "pool1"))
    layers.append(_conv("conv2", "norm1", 256, 5, pad=2, group=2))
    layers.append(_relu("relu2", "conv2"))
    layers.append(_pool("pool2", "conv2"))
    layers.append(_lrn("norm2", "pool2"))
    layers.append(_conv("conv3", "norm2", 384, 3, pad=1))
    layers.append(_relu("relu3", "conv3"))
    layers.append(_conv("conv4", "conv3", 384, 3, pad=1, group=2))
    layers.append(_relu("relu4", "conv4"))
    layers.append(_conv("conv5", "conv4", 256, 3, pad=1, group=2))
    layers.append(_relu("relu5", "conv5"))
    layers.append(_pool("pool5", "conv5"))
    layers.append(_fc("fc6", "pool5", 4096))
    layers.append(_relu("relu6", "fc6"))
    layers.append({"name": "drop6", "type": "Dropout", "bottom": ["fc6"],
                   "top": ["fc6"],
                   "dropout_param": {"dropout_ratio": 0.5}})
    layers.append(_fc("fc7", "fc6", 4096))
    layers.append(_relu("relu7", "fc7"))
    layers.append({"name": "drop7", "type": "Dropout", "bottom": ["fc7"],
                   "top": ["fc7"],
                   "dropout_param": {"dropout_ratio": 0.5}})
    layers.append(_fc("fc8", "fc7", num_classes, std=0.01))
    layers.append({"name": "loss", "type": "SoftmaxWithLoss",
                   "bottom": ["fc8", "label"], "top": ["loss"]})
    if phase == "TEST":
        layers.append({"name": "accuracy", "type": "Accuracy",
                       "bottom": ["fc8", "label"], "top": ["accuracy"],
                       "include": [{"phase": 1}]})
    return {
        "name": "CaffeNet",
        "input": ["data", "label"],
        "input_shape": [{"dim": [batch, 3, crop, crop]},
                        {"dim": [batch]}],
        "layer": layers,
    }


def make_caffenet_deploy(batch: int = 10, crop: int = 227,
                         num_classes: int = 1000) -> Dict[str, Any]:
    """Deploy-phase CaffeNet: data input only, ends in a Softmax ``prob``
    top — the surface of the public bvlc_reference_caffenet
    deploy.prototxt that the reference's matlab/demo/classification_demo.m
    loads (:76).  Default batch 10 matches the demo's 10-crop
    oversampling."""
    net = make_caffenet(batch=batch, crop=crop, num_classes=num_classes,
                        phase="TEST")
    layers = [l for l in net["layer"]
              if l["type"] not in ("SoftmaxWithLoss", "Accuracy")]
    layers.append({"name": "prob", "type": "Softmax",
                   "bottom": ["fc8"], "top": ["prob"]})
    return {
        "name": "CaffeNet",
        "input": ["data"],
        "input_shape": [{"dim": [batch, 3, crop, crop]}],
        "layer": layers,
    }


def _data_layer(phase: int, source: str, batch: int, crop: int, mean_file: str,
                mirror: bool, backend: int) -> Dict[str, Any]:
    return {"name": "data", "type": "Data", "top": ["data", "label"],
            "include": [{"phase": phase}],
            "transform_param": {"mirror": mirror, "crop_size": crop, "mean_file": mean_file},
            "data_param": {"source": source, "batch_size": batch, "backend": backend}}


def make_caffenet_train_val(train_source: str, test_source: str, mean_file: str,
                            batch: int = 256, test_batch: int = 50, crop: int = 227,
                            num_classes: int = 1000, backend: int = 0) -> Dict[str, Any]:
    """The public bvlc_reference_caffenet train_val.prototxt: ``Data``
    layers (TRAIN: ``train_source``, mirrored random crops; TEST:
    ``test_source``, centre crops), both with ``mean_file``; the CaffeNet
    body; SoftmaxWithLoss, and Accuracy in TEST.  ``backend`` 0 is LEVELDB
    (any key-value DB the port opens), 1 LMDB."""
    body = make_caffenet(batch=batch, crop=crop, num_classes=num_classes, phase="TEST")
    layers = [_data_layer(0, train_source, batch, crop, mean_file, True, backend),
              _data_layer(1, test_source, test_batch, crop, mean_file, False, backend)]
    return {"name": "CaffeNet", "layer": layers + body["layer"]}
