"""Spatial model parallelism: the conv trunk and the estimator sharded over H.

Counterpart of ``caffe_rtpose_tpu/parallel/sp.py``.  There XLA's SPMD
partitioner inserts the convolutions' halo exchanges from a sharding
annotation on the input.  Here each rank holds a slab of rows and
:class:`RowShard` (the forward's ``RunCtx.shard``) trades them itself:
before every convolution with row padding p, a rank takes p rows from each
neighbour (one all-gather of every rank's first and last p rows over the
``spatial`` group), zeros beyond the image's edge as the convolution's own
padding, and convolves without row padding.  :class:`_Halo` is an
``autograd.Function``: its backward sends the halo rows' gradients back,
added into the neighbours' boundary rows, so a sharded step trains
(``mesh2d.make_dp_sp_train_step``).

Rows are split at the coarsest resolution (H/8 for the CPM trunk:
:func:`slab_bounds`) and scaled up by the pooling factor, so every 2x2/2
max pool stays inside its slab and uneven splits work: 46 rows at 1/8 of
368 over 4 ranks are 12, 12, 11, 11.  The trunk's other layers (ReLU,
Concat and Slice over channels, Eltwise, the L2 losses) are row-local;
:func:`check_row_local` refuses a net with any other kind.

:func:`spatial_estimator_fn` runs the estimator's net on a slab of each
canvas, all-gathers the 57-channel low-res map over the ranks and runs the
estimator's own post segment on it on every rank (``PoseEstimator._post``:
the hand-written peak-mask kernel K1 on the card), so the outputs are
replicated, as JAX's are.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .dp import DataShard, Mesh, row_split

ROW_LOCAL = {"Convolution", "Pooling", "ReLU", "Concat", "Slice", "Split", "Eltwise",
             "EuclideanLoss", "EuclideanmaskLoss", "Power", "Sigmoid", "TanH", "AbsVal",
             "Silence"}


def check_row_local(net, layers) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``layers`` runs
    on a slab of rows: a type of :data:`ROW_LOCAL`, channels-only Concat and
    Slice, convolutions of stride 1 over rows with kernel 2p+1 (pad p), and
    pools whose row window is their stride, unpadded."""
    for layer in layers:
        mod = net.mods[layer.name]
        bad = layer.type not in ROW_LOCAL
        if layer.type in ("Concat", "Slice"):
            bad = int(layer.param.get("axis", layer.param.get("concat_dim",
                                                              layer.param.get("slice_dim", 1)))) != 1
        elif layer.type == "Convolution":
            bad = (mod.stride[0] != 1 or mod.kernel[0] != 2 * mod.pad[0] + 1
                   or (mod.dilation[0] != 1 and mod.kernel[0] > 1))
        elif layer.type == "Pooling":
            bad = mod.k[0] != mod.s[0] or mod.p[0] != 0
        if bad:
            raise NotImplementedError(f"layer {layer.name} ({layer.type}) does not run on a "
                                      "slab of rows")


def slab_bounds(rows: int, coarse: int, n: int, i: int) -> Tuple[int, int]:
    """Rank ``i`` of ``n``'s rows of a blob with ``rows`` rows, split at
    ``coarse`` rows (the coarsest resolution) and scaled up."""
    if rows % coarse:
        raise ValueError(f"{rows} rows are not a multiple of the coarsest {coarse}")
    k = rows // coarse
    lo, hi = row_split(coarse, n)[i]
    return lo * k, hi * k


def slab_counts(rows: int, coarse: int, n: int) -> List[int]:
    k = rows // coarse
    return [(hi - lo) * k for lo, hi in row_split(coarse, n)]


class _Halo(torch.autograd.Function):
    """(N, C, h, W) slab -> (N, C, h + 2p, W): p rows of each neighbour
    above and below (zeros past the image's edge).  Backward: the halo rows'
    gradients go back to the neighbours, added into their boundary rows."""

    @staticmethod
    def forward(ctx, x, p, mesh, axis):
        n, i = mesh.n(axis), mesh.index(axis)
        if x.shape[2] < p:
            raise ValueError(f"a slab of {x.shape[2]} rows cannot lend a halo of {p}")
        ctx.conf = (p, mesh, axis)
        edges = mesh.all_gather(torch.stack([x[:, :, :p], x[:, :, -p:]]), axis)
        zero = torch.zeros_like(x[:, :, :p])
        up = edges[i - 1][1] if i > 0 else zero
        down = edges[i + 1][0] if i < n - 1 else zero
        return torch.cat([up, x, down], dim=2)

    @staticmethod
    def backward(ctx, g):
        p, mesh, axis = ctx.conf
        n, i = mesh.n(axis), mesh.index(axis)
        edges = mesh.all_gather(torch.stack([g[:, :, :p], g[:, :, -p:]]).contiguous(), axis)
        gx = g[:, :, p:-p].clone()
        if i > 0:  # the rank above lent its last rows as this one's upper halo
            gx[:, :, :p] += edges[i - 1][1]
        if i < n - 1:
            gx[:, :, -p:] += edges[i + 1][0]
        return gx, None, None, None


def halo(x: torch.Tensor, p: int, mesh: Mesh, axis: str = "spatial") -> torch.Tensor:
    return _Halo.apply(x, p, mesh, axis) if p else x


class RowShard(DataShard):
    """``RunCtx.shard`` of a forward on a slab of rows over ``axis``
    (module docstring); the batch may be split over ``batch_axes`` too."""

    def __init__(self, mesh: Mesh, axis: str = "spatial", batch_axes: Sequence[str] = ()):
        super().__init__(mesh, batch_axes, (axis,))
        self.axis = axis

    def conv(self, mod, x, w, b, cudnn):
        from ..ops import nn as nn_ops

        return nn_ops.conv2d(halo(x, mod.pad[0], self.mesh, self.axis), w, b, stride=mod.stride,
                             pad=(0, mod.pad[1]), dilation=mod.dilation, groups=mod.groups,
                             cudnn=cudnn)

    def inner_product(self, mod, x):
        raise NotImplementedError(f"InnerProduct {mod.name} does not run on a slab of rows")


def make_spatial_forward(mesh: Mesh, net, outputs: Sequence[str], axis: str = "spatial"):
    """``fn({input: whole (N, C, H, W) tensor}) -> {output: whole tensor}``
    with the rows split over ``axis``: each rank runs ``net`` on its slab of
    every 4-D input (others whole) and the 4-D outputs are all-gathered, so
    every rank returns the whole outputs.  Parameters replicated."""
    layers = net.prune_for(outputs)
    check_row_local(net, layers)
    n, i = mesh.n(axis), mesh.index(axis)
    shard = RowShard(mesh, axis)

    def fn(inputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        four = [k for k, v in inputs.items() if v.dim() == 4]
        coarse = min([inputs[k].shape[2] for k in four]
                     + [net.blob_shapes[o][2] for o in outputs if len(net.blob_shapes[o]) == 4])
        local = {}
        for k, v in inputs.items():
            if v.dim() == 4:
                lo, hi = slab_bounds(v.shape[2], coarse, n, i)
                v = v[:, :, lo:hi]
            local[k] = v.to(mesh.device)
        out = net.forward(local, outputs=list(outputs), layers=layers, shard=shard)
        return {k: (mesh.gather_rows(v.contiguous(), axis,
                                     slab_counts(net.blob_shapes[k][2], coarse, n))
                    if v.dim() == 4 else v) for k, v in out.items()}

    return fn


def _require_kernel(est) -> None:
    if est.device.type == "cuda" and not est.peak_kernel:
        raise ValueError("a sharded estimator on a card runs the peak-mask kernel: "
                         "build the estimator with peak_kernel on")
    if est.keep_heatmap:
        raise NotImplementedError("the sharded estimators run the packed path")


def _frames(est, x) -> torch.Tensor:
    """The estimator's input (one frame, or ``batch`` frames) as a
    (F, *input_shape) tensor on its device."""
    t = torch.as_tensor(np.ascontiguousarray(x) if not isinstance(x, torch.Tensor) else x)
    if tuple(t.shape) == tuple(est.input_shape()):
        t = t[None]
    return t.to(est.device)


def _packed(est, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"packed": rows[0] if est.batch == 1 and rows.shape[0] == 1 else rows}


def lowres_to_post(est, low: torch.Tensor) -> torch.Tensor:
    """The net's (F*S, C, h, w) low-res blob -> ``_post``'s (F, S, h, w, C)
    f32 maps."""
    low = low.permute(0, 2, 3, 1).to(torch.float32)
    return low.reshape(-1, est.num_scales, *low.shape[1:])


def thresholds(est, nms_thr, inter_thr):
    from ..ops import nms_cuda

    p = est.params_connect
    return (nms_cuda.threshold_scalar(float(p.nms_threshold if nms_thr is None else nms_thr),
                                      est.device),
            nms_cuda.threshold_scalar(float(p.inter_threshold if inter_thr is None
                                            else inter_thr), est.device))


def spatial_estimator_fn(mesh: Mesh, estimator, axis: str = "spatial"):
    """The estimator's device program with each canvas H-sharded over
    ``axis``: ``fn(weights, net_input, nms_thr, inter_thr) -> {"packed":
    rows}`` as ``run_device`` returns them, replicated on every rank.
    ``weights``: the net's operands (``Net.operands()``), replicated;
    ``net_input`` in ``input_shape``, with a leading frame axis for a
    batched estimator; the thresholds floats or None (the defaults)."""
    est = estimator
    _require_kernel(est)
    check_row_local(est.net, est._layers)
    n, i = mesh.n(axis), mesh.index(axis)
    shard = RowShard(mesh, axis)
    coarse = est.net.blob_shapes[est.lowres_blob][2]

    def fn(weights, net_input, nms_thr=None, inter_thr=None):
        with torch.inference_mode():
            canv = est._canvases(_frames(est, net_input))
            lo, hi = slab_bounds(canv.shape[2], coarse, n, i)
            low = est.net({"image": canv[:, :, lo:hi]}, outputs=[est.lowres_blob],
                          layers=est._layers, operands=weights, shard=shard)[est.lowres_blob]
            low = mesh.gather_rows(low.contiguous(), axis, slab_counts(coarse, coarse, n))
            return _packed(est, est._post(lowres_to_post(est, low), *thresholds(
                est, nms_thr, inter_thr), est.eff_peaks))

    return fn
