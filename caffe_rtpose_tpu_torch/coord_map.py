"""Induced coordinate mapping between blobs.

Parity with pycaffe's ``caffe.coord_map`` (reference python/caffe/coord_map.py):
for a pair of blobs connected through conv/pool/deconv/crop/resize chains,
compute the affine map ``x_source = a * x_target + b`` per spatial axis —
used for aligning crops in FCN-style net surgery.

API: :func:`coord_map_from_to(net, top, bottom)` -> (a, b), and
:func:`crop_params` for the offset a Crop layer needs.  The port of
``caffe_rtpose_tpu/coord_map.py``: it walks ``core.net.Net.layers`` (or an
``api.Net``'s core net).
"""

from __future__ import annotations

from typing import Optional, Tuple

from .proto import caffe_pb


def _geom(repeated, single, default):
    if single:
        return int(single)
    vals = list(repeated)
    return int(vals[0]) if vals else default


def layer_coord_map(lv: caffe_pb.View) -> Optional[Tuple[float, float]]:
    """(a, b) such that x_bottom = a * x_top + b, or None for layers with no
    single spatial mapping (reference coord_map(fn), coord_map.py:14-45)."""
    t = lv.type
    if t in ("Convolution", "Pooling", "Im2col"):
        p = lv.convolution_param if t != "Pooling" else lv.pooling_param
        if t == "Pooling":
            # scalar fields; kernel_h/stride_h/pad_h take effect when the
            # plain field is unset (pooling_param semantics)
            k = int(p.kernel_size or 0) if p.has("kernel_size") else 0
            k = k or (int(p.kernel_h or 0) if p.has("kernel_h") else 0) or 1
            s = int(p.stride) if p.has("stride") else (
                int(p.stride_h or 0) if p.has("stride_h") else 0) or 1
            pad = (int(p.pad) if p.has("pad") else 0) or (
                int(p.pad_h or 0) if p.has("pad_h") else 0)
            d = 1
        else:
            k = _geom(p.kernel_size, getattr(p, "kernel_h", 0), 1)
            s = _geom(p.stride, getattr(p, "stride_h", 0), 1)
            pad = _geom(p.pad, getattr(p, "pad_h", 0), 0)
            d = _geom(p.dilation, 0, 1)
        k_eff = d * (k - 1) + 1
        return float(s), (k_eff - 1) / 2.0 - pad
    if t == "Deconvolution":
        p = lv.convolution_param
        k = _geom(p.kernel_size, getattr(p, "kernel_h", 0), 1)
        s = _geom(p.stride, getattr(p, "stride_h", 0), 1)
        pad = _geom(p.pad, getattr(p, "pad_h", 0), 0)
        d = _geom(p.dilation, 0, 1)
        k_eff = d * (k - 1) + 1
        # inverse of the conv map
        return 1.0 / s, (pad - (k_eff - 1) / 2.0) / s
    if t == "ImResize":
        f = float(lv.imresize_param.factor) if lv.has("imresize_param") else 0.0
        if f > 0:
            return 1.0 / f, 0.0
        return None
    if t == "Crop":
        offset = list(lv.crop_param.offset) if lv.has("crop_param") else [0]
        off = float(offset[0]) if offset else 0.0
        return 1.0, off
    # pointwise / channel-only layers: identity (coord_map.py PASS_THROUGH)
    if t in (
        "ReLU", "PReLU", "ELU", "Sigmoid", "TanH", "BNLL", "AbsVal", "Power",
        "Exp", "Log", "Threshold", "Dropout", "Scale", "Bias", "BatchNorm",
        "LRN", "MVN", "Eltwise", "Concat", "Split", "Softmax", "Maximum",
        "EuclideanLoss", "Silence", "Switch",
    ):
        return 1.0, 0.0
    return None


def _compose(base: Tuple[float, float], nxt: Tuple[float, float]) -> Tuple[float, float]:
    """x_src = a1*(a2*x + b2) + b1."""
    a1, b1 = base
    a2, b2 = nxt
    return a1 * a2, a1 * b2 + b1


def coord_map_from_to(net, top: str, bottom: str) -> Tuple[float, float]:
    """Affine (a, b) with x_bottom = a * x_top + b, walking producer links
    from ``top`` back to ``bottom`` (coord_map.py:coord_map_from_to)."""
    a, b = 1.0, 0.0
    blob = top
    if not hasattr(net, "blob_shapes"):  # api.Net facade -> core net
        net = net._net
    # scan layers in reverse topological (= prototxt) order so in-place
    # chains (ReLU top == bottom) unwind correctly
    for lv in reversed([layer.lv for layer in net.layers]):
        if blob == bottom:
            break
        if blob not in list(lv.top) or not list(lv.bottom):
            continue
        m = layer_coord_map(lv)
        if m is None:
            raise RuntimeError(
                f"layer {lv.name!r} ({lv.type}) has no coordinate mapping")
        a, b = _compose(m, (a, b))
        blob = lv.bottom[0]
    if blob != bottom:
        raise RuntimeError(f"no path from {top!r} back to {bottom!r}")
    return a, b


def crop_params(net, top: str, bottom: str) -> Tuple[int, int]:
    """(axis-uniform integer offset, scale) a Crop layer would need to align
    ``top`` onto ``bottom`` (coord_map.py:crop)."""
    a, b = coord_map_from_to(net, top, bottom)
    if a != 1:
        raise RuntimeError(f"scale mismatch {a} — cannot crop-align")
    if b != int(b) or b < 0:
        raise RuntimeError(f"non-integer or negative offset {b}")
    return int(b), int(a)
