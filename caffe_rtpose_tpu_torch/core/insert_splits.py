"""NetParameter Split-layer insertion.

A copy of ``caffe_rtpose_tpu/core/insert_splits.py`` (pure dict code).

Behavioral parity with ``InsertSplits`` (reference util/insert_splits.cpp):
any top blob consumed as a bottom (or as a weighted loss) more than once is
rewired through an explicit Split layer with the reference's generated
names (``<blob>_<layer>_<idx>_split`` / ``..._split_<k>``).

The graph runtime does NOT need this — a tensor can be read any number
of times — but the rewrite is part of the prototxt tooling
surface: pycaffe's ``draw`` renders the split topology, and nets round-
tripped through Caffe tooling carry the generated names.  Usable standalone
on NetParameter dicts (the rewritten net builds and runs identically under
the graph runtime — Split is a registered layer type).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List


def split_layer_name(layer_name: str, blob_name: str, blob_idx: int) -> str:
    return f"{blob_name}_{layer_name}_{blob_idx}_split"


def split_blob_name(layer_name: str, blob_name: str, blob_idx: int, split_idx: int) -> str:
    return f"{blob_name}_{layer_name}_{blob_idx}_split_{split_idx}"


def insert_splits(net_param: Dict[str, Any]) -> Dict[str, Any]:
    """Return a new NetParameter dict with Split layers inserted."""
    out = {k: copy.deepcopy(v) for k, v in net_param.items() if k != "layer"}
    layers: List[Dict[str, Any]] = [dict(l) for l in net_param.get("layer", [])]

    # graph inputs count as top index (-1, j)
    blob_to_last_top: Dict[str, tuple] = {}
    for j, iname in enumerate(net_param.get("input", [])):
        blob_to_last_top[iname] = (-1, j)
    bottom_to_source_top: Dict[tuple, tuple] = {}
    top_bottom_count: Dict[tuple, int] = {}
    top_loss_weight: Dict[tuple, float] = {}
    top_split_idx: Dict[tuple, int] = {}
    layer_names: Dict[int, str] = {-1: "input"}

    for i, lv in enumerate(layers):
        layer_names[i] = lv.get("name", f"layer{i}")
        for j, b in enumerate(lv.get("bottom", [])):
            if b not in blob_to_last_top:
                raise ValueError(f"Unknown bottom blob {b!r} (layer "
                                 f"{layer_names[i]!r}, bottom index {j})")
            top_idx = blob_to_last_top[b]
            bottom_to_source_top[(i, j)] = top_idx
            top_bottom_count[top_idx] = top_bottom_count.get(top_idx, 0) + 1
        for j, t in enumerate(lv.get("top", [])):
            blob_to_last_top[t] = (i, j)
        lw = lv.get("loss_weight", [])
        for j in range(min(len(lw), len(lv.get("top", [])))):
            top_idx = blob_to_last_top[lv["top"][j]]
            top_loss_weight[top_idx] = float(lw[j])
            if lw[j]:
                top_bottom_count[top_idx] = top_bottom_count.get(top_idx, 0) + 1

    new_layers: List[Dict[str, Any]] = []

    def make_split(layer_name, blob_name, blob_idx, count, loss_weight):
        sl: Dict[str, Any] = {
            "name": split_layer_name(layer_name, blob_name, blob_idx),
            "type": "Split",
            "bottom": [blob_name],
            "top": [split_blob_name(layer_name, blob_name, blob_idx, k)
                    for k in range(count)],
        }
        if loss_weight:
            sl["loss_weight"] = [loss_weight] + [0.0] * (count - 1)
        return sl

    # input-blob splits come first (reference handles them as tops of a
    # virtual input layer)
    for j, iname in enumerate(net_param.get("input", [])):
        top_idx = (-1, j)
        if top_bottom_count.get(top_idx, 0) > 1:
            new_layers.append(make_split("input", iname, j,
                                         top_bottom_count[top_idx],
                                         top_loss_weight.get(top_idx, 0.0)))

    for i, lv in enumerate(layers):
        lv = dict(lv)
        bottoms = list(lv.get("bottom", []))
        for j in range(len(bottoms)):
            top_idx = bottom_to_source_top[(i, j)]
            if top_bottom_count.get(top_idx, 0) > 1:
                src_layer = layer_names[top_idx[0]]
                k = top_split_idx.get(top_idx, 0)
                top_split_idx[top_idx] = k + 1
                bottoms[j] = split_blob_name(src_layer, bottoms[j], top_idx[1], k)
        if bottoms:
            lv["bottom"] = bottoms
        new_layers.append(lv)
        for j, t in enumerate(lv.get("top", [])):
            top_idx = (i, j)
            if top_bottom_count.get(top_idx, 0) > 1:
                loss_weight = top_loss_weight.get(top_idx, 0.0)
                new_layers.append(make_split(layer_names[i], t, j,
                                             top_bottom_count[top_idx], loss_weight))
                if loss_weight:
                    lv.pop("loss_weight", None)
                    top_split_idx[top_idx] = top_split_idx.get(top_idx, 0) + 1

    out["layer"] = new_layers
    return out
