"""Tensor (channel) model parallelism: the weights sharded over a ``model``
axis.

Counterpart of ``caffe_rtpose_tpu/parallel/tp.py``.  There the conv kernels
and FC matrices are placed split on their output-feature axis and XLA
inserts the all-gathers.  Here each rank keeps only its share of each
weight (:func:`shard_params_channelwise`, by :func:`channel_spec`'s rule),
convolves with its share of the filters and all-gathers the channels, so
the next layer sees its whole input (:class:`ChannelShard`, the forward's
``RunCtx.shard``).  A weight whose output count does not divide over the
ranks (the 19-channel heatmap head over two) stays whole on every rank and
runs whole there.  Biases are small and stay whole; a rank adds its slice.
A grouped convolution's share of filters reads only the input channels of
the groups it covers: the rank slices them and convolves those groups (one
convolution a group where its share covers part of one).

:func:`tp_estimator_fn` runs the estimator's net so and then its own post
segment (``sp.post``: the peak-mask kernel K1 on the card, or with
``keep_heatmap`` the upsample-keys kernel K3) on every rank, replicated.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from .dp import DataShard, Mesh
from .sp import _frames, _require_kernel, lowres_to_post, post


def channel_spec(mesh: Mesh, a: torch.Tensor, axis: str = "model") -> Tuple:
    """The placement of one weight, as a ``PartitionSpec``-like tuple over
    its axes: axis 0 (the output features of an OIHW kernel and of an
    InnerProduct weight) split over ``axis`` when it divides evenly there,
    else ``()``: replicated.  1-D blobs (biases) stay replicated."""
    n = mesh.n(axis)
    if a.dim() >= 2 and a.shape[0] % n == 0 and a.shape[0] >= n:
        return (axis,) + (None,) * (a.dim() - 1)
    return ()


def _share(mesh: Mesh, a: torch.Tensor, axis: str) -> torch.Tensor:
    if not channel_spec(mesh, a, axis):
        return a
    k = a.shape[0] // mesh.n(axis)
    i = mesh.index(axis)
    # a copy: the rank keeps 1/n of the bytes, not a view of the whole
    return a.detach()[i * k : (i + 1) * k].clone()


def shard_params_channelwise(mesh: Mesh, params, axis: str = "model"):
    """This rank's share of a parameter tree (``{layer: [weight, bias]}``)
    or of an operand dict (``Net.operands()``: ``{"<layer>::w": weight,
    ...}``): each weight's slice of output features by
    :func:`channel_spec`, everything else whole."""
    out = {}
    for k, v in params.items():
        if isinstance(v, (list, tuple)):
            out[k] = [_share(mesh, t, axis) for t in v]
        else:
            out[k] = _share(mesh, v, axis)
    return out


def share_bytes(tree) -> int:
    """The bytes a parameter tree or operand dict holds."""
    leaves = [t for v in tree.values() for t in (v if isinstance(v, (list, tuple)) else [v])]
    return sum(t.numel() * t.element_size() for t in leaves)


class ChannelShard(DataShard):
    """``RunCtx.shard`` of a forward with channel-sharded weights over
    ``axis`` (module docstring).  A weight whose output count equals the
    layer's is whole and runs whole."""

    def __init__(self, mesh: Mesh, axis: str = "model", batch_axes: Sequence[str] = ()):
        super().__init__(mesh, batch_axes)
        self.axis = axis
        self.weights: Dict[str, torch.Tensor] = {}  # InnerProduct weights by layer

    def _gather(self, y: torch.Tensor) -> torch.Tensor:
        return torch.cat(self.mesh.all_gather(y.contiguous(), self.axis), dim=1)

    def _bias(self, b: Optional[torch.Tensor], k: int) -> Optional[torch.Tensor]:
        i = self.mesh.index(self.axis)
        return None if b is None else b[i * k : (i + 1) * k]

    def conv(self, mod, x, w, b, cudnn):
        if w.shape[0] == mod.cout:
            return mod(x, w, b, cudnn=cudnn)
        b = self._bias(b, w.shape[0])
        if mod.groups == 1:
            return self._gather(mod(x, w, b, cudnn=cudnn))
        return self._gather(self._grouped(mod, x, w, b, cudnn))

    def _grouped(self, mod, x, w, b, cudnn):
        """This rank's filters [o0, o0 + k) of a grouped convolution on the
        input channels of the groups they read."""
        from ..ops import nn as nn_ops

        og, ig = mod.cout // mod.groups, x.shape[1] // mod.groups
        k = w.shape[0]
        o0 = self.mesh.index(self.axis) * k

        def conv(xs, ws, bs, groups):
            return nn_ops.conv2d(xs, ws, bs, stride=mod.stride, pad=mod.pad,
                                 dilation=mod.dilation, groups=groups, cudnn=cudnn)

        if o0 % og == 0 and k % og == 0:  # whole groups: one grouped convolution
            g0 = o0 // og
            return conv(x.narrow(1, g0 * ig, k // og * ig), w, b, k // og)
        pieces = []
        for g in range(o0 // og, (o0 + k - 1) // og + 1):
            lo, hi = max(o0, g * og) - o0, min(o0 + k, (g + 1) * og) - o0
            pieces.append(conv(x.narrow(1, g * ig, ig), w[lo:hi],
                               None if b is None else b[lo:hi], 1))
        return torch.cat(pieces, dim=1)

    def inner_product(self, mod, x):
        from ..ops import nn as nn_ops

        w = self.weights.get(mod.name, mod.weight)
        if mod.transpose or w.shape[0] == mod.top_shapes[0][-1]:
            return nn_ops.inner_product(x, w, mod.bias, mod.transpose)
        return self._gather(nn_ops.inner_product(x, w, self._bias(mod.bias, w.shape[0]), False))


def make_tp_forward(mesh: Mesh, net, outputs: Sequence[str], axis: str = "model"):
    """``fn(params, inputs) -> {output: tensor}``: ``net`` forward with its
    convolutions and inner products on ``params`` (this rank's share, from
    :func:`shard_params_channelwise` of ``net.layer_blobs()``, or the whole
    tree, sharded here), inputs replicated, outputs whole on every rank."""
    layers = net.prune_for(outputs)
    shard = ChannelShard(mesh, axis)

    def fn(params, inputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        ops: Dict[str, torch.Tensor] = {}
        for name, blobs in params.items():
            mod = net.mods[name]
            # a whole weight is sharded here; a share passes as it is
            whole = blobs[0].shape[0] == mod.top_shapes[0][1 if mod.type == "Convolution" else -1]
            w = _share(mesh, blobs[0], axis) if whole else blobs[0]
            if mod.type == "Convolution":
                ops[f"{name}::w"] = w
                if len(blobs) > 1:
                    ops[f"{name}::b"] = blobs[1]
            elif mod.type == "InnerProduct":
                # a transposed weight's rows are its inputs: it stays whole
                shard.weights[name] = blobs[0] if mod.transpose else w
        feed = {k: v.to(mesh.device) for k, v in inputs.items()}
        return net.forward(feed, outputs=list(outputs), layers=layers, operands=ops or None,
                           shard=shard)

    return fn


def tp_estimator_fn(mesh: Mesh, estimator, axis: str = "model"):
    """The estimator's device program with channel-sharded weights:
    ``fn(weights, net_input, nms_thr, inter_thr)`` -> what ``run_device``
    returns (``sp.post``), replicated on every rank.  ``weights``: this
    rank's share of the net's operands (:func:`shard_params_channelwise` of
    ``Net.operands()``)."""
    est = estimator
    _require_kernel(est)
    shard = ChannelShard(mesh, axis)

    def fn(weights, net_input, nms_thr=None, inter_thr=None):
        with torch.inference_mode():
            low = est.net({"image": est._canvases(_frames(est, net_input))},
                          outputs=[est.lowres_blob], layers=est._layers, operands=weights,
                          shard=shard)[est.lowres_blob]
            return post(est, lowres_to_post(est, low), nms_thr, inter_thr)

    return fn
