"""Two composed axes on one mesh: data x spatial training and data x model
serving.

Counterpart of ``caffe_rtpose_tpu/parallel/mesh2d.py``.  The mesh is
(n / k) x k ranks, row-major: rank ``d * k + s`` is at ``data`` d and
``spatial`` (or ``model``) s.

* :func:`make_dp_sp_train_step`: the global batch split over ``data`` (or
  replicated there when it does not divide, JAX's fallback) and each
  example's rows over ``spatial``, planned layer by layer by
  ``sp.RowShard``; the losses add up over the slabs and the gradients are
  summed over both axes, or averaged over ``data`` where the batch was
  replicated there, and averaged over ``spatial`` for the layers that ran
  whole on every rank (:func:`reduce_grads`: CaffeNet's fc6-fc8).  An input
  transform (the CPM labels rasterized on the device, ``--fused_labels``)
  runs on the rank's whole examples before the rows split, as the
  one-device step runs it.
* :func:`dp_tp_estimator_fn`: a batch of frames split over ``data``, every
  weight channel-sharded over ``model`` (``tp.ChannelShard``).

:func:`shard_batch_2d` is JAX's placement rule, axis by axis: the batch
split where it divides ``data``, the rows (axis 2 of an NCHW array) where
they divide ``spatial``, else replicated.  The train step splits rows at
the coarsest input's resolution instead (``sp.slab_bounds``), so the
image's and the label's slabs always match, where JAX would replicate the
label and let XLA reshard it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .dp import (DataShard, Mesh, _as_tensor, all_reduce_flat, rank_device, row_split,
                 shard_batch)
from .sp import RowShard, _frames, _require_kernel, lowres_to_post, post
from .tp import ChannelShard


def make_mesh2d(n_devices: Optional[int] = None, spatial: int = 2,
                axes: Tuple[str, str] = ("data", "spatial"),
                device=None) -> Mesh:
    """An (n / spatial) x spatial mesh with named axes (``ValueError`` when
    ``spatial`` does not divide n)."""
    import torch.distributed as dist

    n = dist.get_world_size() if n_devices is None else int(n_devices)
    if spatial < 1 or n % spatial:
        raise ValueError(f"spatial={spatial} must divide device count {n}")
    return Mesh({axes[0]: n // spatial, axes[1]: spatial}, device or rank_device())


def batch_spec_2d(mesh_shape: Mapping[str, int], shape: Sequence[int], row_split_ok: bool = True,
                  data_axis: str = "data", spatial_axis: str = "spatial") -> Tuple:
    """JAX's placement of one array on the 2-axis mesh as a
    ``PartitionSpec``-like tuple over the port's NCHW axes: batch over
    ``data`` where it divides, rows (axis 2) over ``spatial`` where they
    divide and ``row_split_ok``; ``()`` for a scalar."""
    nd = len(shape)
    if nd == 0:
        return ()
    d0 = data_axis if shape[0] % mesh_shape[data_axis] == 0 else None
    if nd >= 4 and row_split_ok and shape[2] % mesh_shape[spatial_axis] == 0:
        return (d0, None, spatial_axis) + (None,) * (nd - 3)
    return (d0,)


def shard_batch_2d(mesh: Mesh, batch: Mapping[str, Any], data_axis: str = "data",
                   spatial_axis: str = "spatial",
                   row_keys: Optional[set] = None) -> Dict[str, torch.Tensor]:
    """This rank's piece of each host array by :func:`batch_spec_2d`
    (``row_keys``, when given, names the arrays whose rows may split: the
    port's arrays are all NCHW, so it stands for JAX's ``nhwc_keys``)."""
    out = {}
    for k, v in batch.items():
        spec = batch_spec_2d(mesh.shape, np.shape(v), row_keys is None or k in row_keys,
                             data_axis, spatial_axis)
        for dim, a in enumerate(spec):
            if a is not None:
                lo, hi = row_split(np.shape(v)[dim], mesh.n(a))[mesh.index(a)]
                v = np.take(v, np.arange(lo, hi), axis=dim) if isinstance(v, np.ndarray) \
                    else v.narrow(dim, lo, hi - lo)
        out[k] = _as_tensor(v, mesh.device)
    return out


def place_batch(mesh: Mesh, batch: Mapping[str, Any], data_axis: str = "data",
                spatial_axis: str = "spatial", transform: Optional[Callable] = None):
    """This rank's piece of a global batch on a ``data`` or data x spatial
    mesh -> (inputs, the layout its forward runs with, the axes its
    gradients and loss are summed over, the axes they are averaged over:
    ``data`` where the batch was replicated there).  ``transform``: a
    function of the rank's examples on its device (the solver's
    ``input_transform``), run before the rows split."""
    if spatial_axis not in mesh.axis_names:
        inputs = shard_batch(mesh, batch, data_axis)
        return ((transform(inputs) if transform else inputs), DataShard(mesh, (data_axis,)),
                [data_axis], [])
    rows = [np.shape(v)[0] for v in batch.values() if np.ndim(v) >= 1]
    split = bool(rows) and all(r % mesh.n(data_axis) == 0 for r in rows)
    inputs = {}
    for k, v in batch.items():
        t = _as_tensor(v, "cpu")
        if split and t.dim() >= 1:
            lo, hi = row_split(t.shape[0], mesh.n(data_axis))[mesh.index(data_axis)]
            t = t[lo:hi]
        inputs[k] = t
    shard = RowShard(mesh, spatial_axis, [data_axis] if split else [])
    if transform is None:  # slabs leave the host
        inputs = {k: v.to(mesh.device) for k, v in shard.place(inputs).items()}
    else:
        inputs = shard.place(transform({k: v.to(mesh.device) for k, v in inputs.items()}))
    return inputs, shard, [spatial_axis] + ([data_axis] if split else []), (
        [] if split else [data_axis])


def reduce_grads(mesh: Mesh, shard, grads: Mapping[str, Sequence[Optional[torch.Tensor]]],
                 extra: Sequence[torch.Tensor], sums: Sequence[str], means: Sequence[str]) -> None:
    """All-reduce a step's gradients ``{layer: [grad, ...]}`` and ``extra``
    (the loss) in place over ``sums`` and ``means``; the gradients of the
    layers a ``sp.RowShard`` ran whole are the same on every rank of its
    axis and averaged there instead of summed."""
    tail = shard.whole_layers if isinstance(shard, RowShard) else set()
    body = [g for k, gs in grads.items() if k not in tail for g in gs if g is not None]
    all_reduce_flat(mesh, body + list(extra), sums, means)
    rest = [g for k, gs in grads.items() if k in tail for g in gs if g is not None]
    if rest:
        all_reduce_flat(mesh, rest, [a for a in sums if a != shard.axis],
                        list(means) + [shard.axis])


def make_dp_sp_train_step(mesh: Mesh, loss_fn: Callable, update_fn: Callable,
                          data_axis: str = "data", spatial_axis: str = "spatial",
                          transform: Optional[Callable] = None):
    """A train step over the 2-axis mesh: ``step(params, history, batch, lr,
    it) -> loss``, ``batch`` the GLOBAL batch (host arrays or tensors, the
    same on every rank), placed by :func:`place_batch` (``transform`` as
    there).  ``loss_fn(inputs, shard) -> loss`` (``dp.net_loss_fn``);
    parameters replicated; the loss returned is the global batch's.
    ``step.shard``: the layout of the last step."""

    def step(params, history, batch, lr, it) -> float:
        inputs, shard, sums, means = place_batch(mesh, batch, data_axis, spatial_axis, transform)
        step.shard = shard
        flat = [p for ps in params.values() for p in ps]
        for p in flat:
            p.grad = None
        loss = loss_fn(inputs, shard)
        loss.backward()
        grads = {k: [p.grad for p in ps] for k, ps in params.items()}
        total = loss.detach().clone().reshape(1)
        reduce_grads(mesh, shard, grads, [total], sums, means)
        update_fn(params, grads, history, lr, it)
        return float(total)

    return step


def dp_tp_estimator_fn(mesh: Mesh, estimator, data_axis: str = "data",
                       model_axis: str = "model"):
    """The estimator on a data x model mesh over F frames: ``fn(weights,
    net_input, nms_thr, inter_thr) -> {"packed": (F, n) rows}``, or with
    ``keep_heatmap`` each output of ``run_device`` with a leading F axis.
    This rank runs its share of the frames (split over ``data``; F must
    divide) with channel-sharded ``weights`` (``tp.shard_params_channelwise``
    of ``Net.operands()`` over ``model``), the post segment on its frames
    (``sp.post``: K1, or K3 once a frame, on the card), and the outputs are
    all-gathered over ``data``: every rank returns all F (JAX leaves them
    batch-sharded)."""
    est = estimator
    _require_kernel(est)
    shard = ChannelShard(mesh, model_axis)
    n, i = mesh.n(data_axis), mesh.index(data_axis)

    def fn(weights, net_input, nms_thr=None, inter_thr=None):
        with torch.inference_mode():
            x = _frames(est, net_input)
            if x.shape[0] % n:
                raise ValueError(f"{x.shape[0]} frames do not split over {n} ranks")
            lo, hi = row_split(x.shape[0], n)[i]
            low = est.net({"image": est._canvases(x[lo:hi])}, outputs=[est.lowres_blob],
                          layers=est._layers, operands=weights, shard=shard)[est.lowres_blob]
            out = post(est, lowres_to_post(est, low), nms_thr, inter_thr, whole_frames=False)
            return {k: torch.cat(mesh.all_gather(v, data_axis)) for k, v in out.items()}

    return fn
