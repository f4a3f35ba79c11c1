"""CPM/PAF deploy- and train-graph builders.

Generates NetParameter dicts structurally identical to the shipped deploy
prototxts (reference model/coco/pose_deploy_linevec.prototxt,
model/mpi/pose_deploy_linevec.prototxt: VGG-19 prefix + conv4_*_CPM feature
head + 6 dual-branch stages), so weights loaded by layer name interchange
with our generated graphs; plus the training graph (per-stage masked L2
losses over sliced label weights, the classic CPM train topology).  A copy of
the JAX package's builders (``caffe_rtpose_tpu/models/cpm.py``), which cannot
be imported without jax.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

_GAUSS = {"type": "gaussian", "std": 0.01}
_CONST = {"type": "constant"}


def _conv(name, bottom, num_output, kernel, pad, lr=(1.0, 2.0), top=None):
    return {
        "name": name,
        "type": "Convolution",
        "bottom": [bottom],
        "top": [top or name],
        "param": [
            {"lr_mult": lr[0], "decay_mult": 1.0},
            {"lr_mult": lr[1], "decay_mult": 0.0},
        ],
        "convolution_param": {
            "num_output": num_output,
            "pad": [pad],
            "kernel_size": [kernel],
            "weight_filler": dict(_GAUSS),
            "bias_filler": dict(_CONST),
        },
    }


def _relu(name, blob):
    return {"name": name, "type": "ReLU", "bottom": [blob], "top": [blob]}


def _pool(name, bottom, top=None):
    return {
        "name": name,
        "type": "Pooling",
        "bottom": [bottom],
        "top": [top or name],
        "pooling_param": {"pool": 0, "kernel_size": 2, "stride": 2},
    }


def make_trunk(layers: List[Dict[str, Any]], bottom: str = "image") -> str:
    """VGG-19 prefix + CPM feature head -> returns the feature blob name."""
    spec = [
        ("conv1_1", 64), ("conv1_2", 64), ("pool1_stage1", None),
        ("conv2_1", 128), ("conv2_2", 128), ("pool2_stage1", None),
        ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
        ("pool3_stage1", None),
        ("conv4_1", 512), ("conv4_2", 512),
        ("conv4_3_CPM", 256), ("conv4_4_CPM", 128),
    ]
    prev = bottom
    for name, ch in spec:
        if ch is None:
            layers.append(_pool(name, prev))
            prev = name
        else:
            layers.append(_conv(name, prev, ch, 3, 1))
            layers.append(_relu("relu" + name[4:], name))
            prev = name
    return prev


def make_stages(
    layers: List[Dict[str, Any]],
    feat: str,
    n_paf: int,
    n_heat: int,
    stages: int = 6,
    per_stage=None,
    final_concat: bool = True,
) -> str:
    """Dual-branch stages; returns the final concat blob name (or the last
    stage's L1 prediction when ``final_concat=False``).  ``per_stage(t,
    {"L1": blob, "L2": blob})`` is invoked after each stage's prediction
    convs — the train builder attaches per-stage losses through it."""
    # stage 1
    prev = {"L1": feat, "L2": feat}
    for i in range(1, 4):
        for br in ("L1", "L2"):
            name = f"conv5_{i}_CPM_{br}"
            layers.append(_conv(name, prev[br], 128, 3, 1))
            layers.append(_relu(f"relu5_{i}_CPM_{br}", name))
            prev[br] = name
    for br in ("L1", "L2"):
        name = f"conv5_4_CPM_{br}"
        layers.append(_conv(name, prev[br], 512, 1, 0))
        layers.append(_relu(f"relu5_4_CPM_{br}", name))
        prev[br] = name
    for br, nout in (("L1", n_paf), ("L2", n_heat)):
        name = f"conv5_5_CPM_{br}"
        layers.append(_conv(name, prev[br], nout, 1, 0))
        prev[br] = name
    if per_stage is not None:
        per_stage(1, dict(prev))

    last = None
    for t in range(2, stages + 1):
        cat = f"concat_stage{t}"
        layers.append({
            "name": cat, "type": "Concat",
            "bottom": [prev["L1"], prev["L2"], feat],
            "top": [cat], "concat_param": {"axis": 1},
        })
        b = {"L1": cat, "L2": cat}
        for i in range(1, 6):
            for br in ("L1", "L2"):
                name = f"Mconv{i}_stage{t}_{br}"
                layers.append(_conv(name, b[br], 128, 7, 3, lr=(4.0, 8.0)))
                layers.append(_relu(f"Mrelu{i}_stage{t}_{br}", name))
                b[br] = name
        for br in ("L1", "L2"):
            name = f"Mconv6_stage{t}_{br}"
            layers.append(_conv(name, b[br], 128, 1, 0, lr=(4.0, 8.0)))
            layers.append(_relu(f"Mrelu6_stage{t}_{br}", name))
            b[br] = name
        for br, nout in (("L1", n_paf), ("L2", n_heat)):
            name = f"Mconv7_stage{t}_{br}"
            layers.append(_conv(name, b[br], nout, 1, 0, lr=(4.0, 8.0)))
            b[br] = name
        if per_stage is not None:
            per_stage(t, dict(b))
        prev = b
        last = t
    if not final_concat:
        return prev["L1"]
    final = f"concat_stage{(last or 1) + 1}"
    layers.append({
        "name": final, "type": "Concat",
        "bottom": [prev["L2"], prev["L1"]],  # heatmaps first (deploy file order)
        "top": [final], "concat_param": {"axis": 1},
    })
    return final


def make_pose_deploy_net(
    variant: str = "COCO",
    stages: int = 6,
    input_dim=(1, 3, 368, 656),
    factor: float = 8.0,
    start_scale: float = 1.0,
    scale_gap: float = 0.3,
    nms_threshold: Optional[float] = None,
    max_peaks: Optional[int] = None,
) -> Dict[str, Any]:
    """Deploy graph equivalent to pose_deploy_linevec.prototxt."""
    if variant.upper() == "COCO":
        n_paf, n_heat, num_parts = 38, 19, 18
        nms_threshold = 0.05 if nms_threshold is None else nms_threshold
        max_peaks = 64 if max_peaks is None else max_peaks
    elif variant.upper() == "MPI":
        n_paf, n_heat, num_parts = 28, 16, 15
        nms_threshold = 0.6 if nms_threshold is None else nms_threshold
        max_peaks = 20 if max_peaks is None else max_peaks
        if start_scale == 1.0 and scale_gap == 0.3:
            start_scale, scale_gap = 0.9, 0.1
    else:
        raise ValueError(f"unknown variant {variant}")

    layers: List[Dict[str, Any]] = []
    feat = make_trunk(layers)
    final = make_stages(layers, feat, n_paf, n_heat, stages)
    layers.append({
        "name": "resize", "type": "ImResize", "bottom": [final], "top": ["resized_map"],
        "imresize_param": {"factor": factor, "start_scale": start_scale, "scale_gap": scale_gap},
    })
    layers.append({
        "name": "nms", "type": "Nms", "bottom": ["resized_map"], "top": ["joints"],
        "propagate_down": [False],
        "nms_param": {"threshold": nms_threshold, "max_peaks": max_peaks, "num_parts": num_parts},
    })
    return {
        "input": ["image"],
        "input_dim": list(input_dim),
        "layer": layers,
    }


def make_pose_train_net(
    batch: int = 10,
    crop: int = 368,
    stride: int = 8,
    stages: int = 6,
    n_paf: int = 38,
    n_heat: int = 19,
) -> Dict[str, Any]:
    """Training graph: trunk + stages, label sliced into (vec_weight,
    heat_weight, vec_label, heat_label), per-stage per-branch weighted
    EuclideanLoss (the classic CPM train topology over the transformer's
    label layout: weights [0, np], targets [np+1, 2np+1])."""
    np_ = n_paf + n_heat - 1  # 56 for COCO
    grid = crop // stride
    layers: List[Dict[str, Any]] = []
    feat = make_trunk(layers, bottom="data")

    layers.append({
        "name": "slice_label", "type": "Slice",
        "bottom": ["label"],
        "top": ["vec_weight", "heat_weight", "vec_label", "heat_label"],
        "slice_param": {"axis": 1, "slice_point": [n_paf, n_paf + n_heat, 2 * n_paf + n_heat]},
    })

    def add_losses(stage: int, pred: Dict[str, str]):
        for br, weight, label in (("L1", "vec_weight", "vec_label"),
                                  ("L2", "heat_weight", "heat_label")):
            wp = f"weight_stage{stage}_{br}"
            wl = f"label_stage{stage}_{br}"
            layers.append({"name": wp, "type": "Eltwise",
                           "bottom": [pred[br], weight], "top": [wp],
                           "eltwise_param": {"operation": 0}})
            layers.append({"name": wl, "type": "Eltwise",
                           "bottom": [label, weight], "top": [wl],
                           "eltwise_param": {"operation": 0}})
            layers.append({"name": f"loss_stage{stage}_{br}", "type": "EuclideanLoss",
                           "bottom": [wp, wl], "top": [f"loss_stage{stage}_{br}"]})

    # identical stage topology to the deploy graph (same layer names, so
    # train/deploy weights interchange); losses attach via the callback
    make_stages(layers, feat, n_paf, n_heat, stages,
                per_stage=add_losses, final_concat=False)

    return {
        "name": "pose_train",
        "input": ["data", "label"],
        "input_shape": [
            {"dim": [batch, 3, crop, crop]},
            {"dim": [batch, 2 * (np_ + 1), grid, grid]},
        ],
        "layer": layers,
    }
