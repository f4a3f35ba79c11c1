"""Spatial model parallelism: any net, and the estimator, sharded over H.

Counterpart of ``caffe_rtpose_tpu/parallel/sp.py``.  There XLA's SPMD
partitioner places every op of a net whose input is annotated H-sharded:
halo exchanges for windows, an all-gather before a layer that mixes rows.
Here :class:`RowShard` (the forward's ``RunCtx.shard``) does the same by
hand, layer by layer, by the kind of each layer (``LayerModule.rows``):

* :meth:`RowShard.place` splits each 4-D input's rows over the ``spatial``
  ranks, at the coarsest input or output resolution that divides the inputs
  (:func:`slab_bounds`), so the CPM trunk's 2x2/2 pools stay inside each
  slab: 46 rows at 1/8 of 368 over 4 ranks are 12, 12, 11, 11;
* a row-local layer (ReLU, Concat over channels, Eltwise, the L2 losses,
  ...) runs on the slabs as they are;
* a window layer (Convolution, Deconvolution, Pooling, WITHIN_CHANNEL LRN,
  Im2col) keeps the output rows whose windows are centred in the rank's
  input rows, and the rank takes the input rows those outputs read -- for
  output rows [lo, hi) of a (k, s, p, d) window, input rows [lo*s - p,
  (hi-1)*s - p + (k-1)*d + 1) -- from whichever ranks own them, in one
  all-gather of the rows each rank lends its neighbours above and below
  (:class:`_Window`; a thin slab's range may span several ranks).  Rows
  past the image's edge are the layer's padding (zeros, -inf for a max
  pool), and the layer runs without row padding, its own output size
  (Caffe's ceil-mode pools) included;
* any other layer (InnerProduct, Reshape, global pooling, SPP, Softmax over
  H, ...) all-gathers its sliced bottoms (:class:`_Gather`) and runs whole;
  from there on the net runs replicated on every rank.

Both exchanges are ``autograd.Function``\\ s: :class:`_Window`'s backward adds
each borrowed row's gradient into its owner's row; :class:`_Gather`'s is
the rank's own rows of the (replicated) gradient.  So a sharded step sums
the gradients of the parameters of sliced layers over ``spatial`` and
averages those of the replicated tail (:attr:`RowShard.whole_layers`;
``mesh2d.reduce_grads``); a loss computed whole counts 1/n on each rank
(:meth:`RowShard.loss_share`) and its normalizer counts each sample once.
Random layers on slabs draw from a generator of the rank; the replicated
tail draws from the net's own, which slabs never touch, so every rank of a
spatial group draws the same Dropout masks there (and a 1 x n mesh the
same as one device).

:func:`spatial_estimator_fn` runs the estimator's net on a slab of each
canvas, all-gathers the 57-channel low-res map and runs the estimator's own
post segment on it on every rank: the packed path's (the peak-mask kernel
K1 on the card), or with ``keep_heatmap`` the heatmap path's (the
upsample-keys kernel K3), so the outputs are replicated, as JAX's are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .dp import DataShard, Mesh, row_split

Bounds = List[Tuple[int, int]]  # each rank's rows [lo, hi) along the axis


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


@dataclass
class Window:
    """The exchange plan of one window layer on the ``spatial`` ranks:
    ``h`` input rows, each rank's input rows (``own``) and output rows
    (``out``), and the input rows [a, b) each rank reads (``need``,
    unclipped: rows outside [0, h) are padding).  Each rank lends the rows
    [lo, ``up``) to the ranks above it and [``down``, hi) to those below;
    ``lu``/``ld`` are the longest of those, ``la``/``lb`` the longest
    borrowed ranges above and below a rank's own rows (the backward)."""

    h: int
    own: Bounds
    out: Bounds
    need: Bounds
    up: List[int]
    down: List[int]
    lu: int
    ld: int
    la: int
    lb: int


def plan_window(own: Bounds, out: Bounds, h: int, k: int, s: int, p: int, d: int,
                transposed: bool = False) -> Window:
    need = []
    for lo, hi in out:
        if transposed:  # input rows i with i*s - p + t*d in [lo, hi), 0 <= t < k
            need.append(((lo + p - (k - 1) * d) // s, (hi - 1 + p) // s + 1))
        else:
            need.append((lo * s - p, (hi - 1) * s - p + (k - 1) * d + 1))
    n = len(own)
    up = [max([lo] + [min(need[i][1], hi) for i in range(j)]) for j, (lo, hi) in enumerate(own)]
    down = [min([hi] + [max(need[i][0], lo) for i in range(j + 1, n)])
            for j, (lo, hi) in enumerate(own)]
    above = [max(0, min(b, lo) - max(a, 0)) for (a, b), (lo, hi) in zip(need, own)]
    below = [max(0, min(b, h) - max(a, hi)) for (a, b), (lo, hi) in zip(need, own)]
    return Window(h, own, out, need, up, down,
                  max(u - lo for u, (lo, _) in zip(up, own)),
                  max(hi - dn for dn, (_, hi) in zip(down, own)), max(above), max(below))


def _rows(x: torch.Tensor, start: int, n: int, pad_to: int) -> torch.Tensor:
    """Rows [start, start + n) of ``x``, zero rows after them up to ``pad_to``."""
    t = x.narrow(2, start, n)
    if pad_to > n:
        t = torch.cat([t, t.new_zeros(t.shape[0], t.shape[1], pad_to - n, t.shape[3])], dim=2)
    return t


class _Window(torch.autograd.Function):
    """This rank's slab (N, C, hi - lo, W) -> the rows [a, b) its window
    layer reads (:class:`Window`), borrowed rows from their owners, padding
    rows ``fill``.  Backward: the borrowed rows' gradients go back to their
    owners, added into their rows."""

    @staticmethod
    def forward(ctx, x, win: Window, mesh: Mesh, axis: str, fill: float):
        ctx.conf = (win, mesh, axis)
        i = mesh.index(axis)
        (lo, hi), (a, b) = win.own[i], win.need[i]
        parts = None
        if win.lu + win.ld:
            parts = mesh.all_gather(torch.cat([_rows(x, 0, win.up[i] - lo, win.lu),
                                               _rows(x, win.down[i] - lo, hi - win.down[i],
                                                     win.ld)], dim=2), axis)
        n, c, _, w = x.shape
        pieces = []
        if a < 0:
            pieces.append(x.new_full((n, c, min(b, 0) - a, w), fill))
        for j, (lj, hj) in enumerate(win.own):
            r0, r1 = max(a, lj, 0), min(b, hj, win.h)
            if r1 <= r0:
                continue
            if j == i:
                pieces.append(x.narrow(2, r0 - lj, r1 - r0))
            elif j > i:  # from the rows j lends the ranks above it
                pieces.append(parts[j].narrow(2, r0 - lj, r1 - r0))
            else:  # from the rows j lends the ranks below it
                pieces.append(parts[j].narrow(2, win.lu + r0 - win.down[j], r1 - r0))
        if b > win.h:
            pieces.append(x.new_full((n, c, b - max(a, win.h), w), fill))
        return torch.cat(pieces, dim=2)

    @staticmethod
    def backward(ctx, g):
        win, mesh, axis = ctx.conf
        i = mesh.index(axis)
        (lo, hi), (a, b) = win.own[i], win.need[i]
        if a <= lo and b >= hi:  # the window holds all the rank's own rows
            gx = g.narrow(2, lo - a, hi - lo).clone()
        else:
            gx = g.new_zeros(g.shape[0], g.shape[1], hi - lo, g.shape[3])
            r0, r1 = max(a, lo), min(b, hi)
            if r1 > r0:
                gx.narrow(2, r0 - lo, r1 - r0).add_(g.narrow(2, r0 - a, r1 - r0))
        if win.la + win.lb:
            top, bot = max(a, 0), max(a, hi)  # the borrowed rows above and below
            parts = mesh.all_gather(torch.cat([
                _rows(g, top - a, max(0, min(b, lo) - top), win.la),
                _rows(g, bot - a, max(0, min(b, win.h) - bot), win.lb)], dim=2), axis)
            for k, ((ak, bk), (lk, hk)) in enumerate(zip(win.need, win.own)):
                if k > i:  # rank k borrowed from the ranks above it
                    r0, r1, off = max(ak, 0, lo), min(bk, lk, hi), -max(ak, 0)
                elif k < i:
                    r0, r1, off = max(ak, hk, lo), min(bk, win.h, hi), win.la - max(ak, hk)
                else:
                    continue
                if r1 > r0:
                    gx.narrow(2, r0 - lo, r1 - r0).add_(parts[k].narrow(2, r0 + off, r1 - r0))
        return gx, None, None, None, None


class _Gather(torch.autograd.Function):
    """Slabs -> the whole tensor on every rank; backward: this rank's rows
    of the gradient (every rank holds the whole gradient of a replicated
    tensor)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str, bounds: Bounds):
        lo, hi = bounds[mesh.index(axis)]
        ctx.conf = (lo, hi)
        return mesh.gather_rows(x.contiguous(), axis, [b - a for a, b in bounds])

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.conf
        return g.narrow(2, lo, hi - lo), None, None, None


class _Slice(torch.autograd.Function):
    """A whole (replicated) tensor -> this rank's rows; backward: the ranks'
    row gradients all-gathered, the whole gradient on every rank."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str, bounds: Bounds):
        ctx.conf = (mesh, axis, bounds)
        lo, hi = bounds[mesh.index(axis)]
        return x.narrow(2, lo, hi - lo)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, bounds = ctx.conf
        return mesh.gather_rows(g.contiguous(), axis, [b - a for a, b in bounds]), None, None, None


class RowShard(DataShard):
    """``RunCtx.shard`` of a forward with each 4-D blob's rows split over
    ``axis`` (module docstring); the batch may be split over ``batch_axes``
    too.  The split of each blob by rank is :attr:`split` (None: whole on
    every rank), planned from the inputs :meth:`place` placed."""

    def __init__(self, mesh: Mesh, axis: str = "spatial", batch_axes=()):
        super().__init__(mesh, batch_axes, (axis,))
        self.axis = axis
        self.n, self.i = mesh.n(axis), mesh.index(axis)
        self.inputs: Dict[str, Bounds] = {}
        self.split: Dict[str, Optional[Bounds]] = {}
        self.height: Dict[str, int] = {}
        self.plans: Dict[str, Window] = {}
        self.whole_layers: set = set()
        self.whole_tops: set = set()
        self.current: Optional[str] = None
        self._gens = (None, None)  # the net's generator, the rank's (slabs)

    # ------------------------------------------------------------ placement

    def place(self, inputs: Mapping[str, torch.Tensor], coarse: Optional[int] = None
              ) -> Dict[str, torch.Tensor]:
        """This rank's slab of each whole 4-D input with at least one row a
        rank (the others whole), split at ``coarse`` rows (default: the
        fewest of those inputs) where the input's rows are a multiple of it,
        else evenly; the split is what the next forward plans from."""
        four = {k: v.shape[2] for k, v in inputs.items() if v.dim() == 4 and v.shape[2] >= self.n}
        coarse = coarse or min(four.values(), default=1)
        self.inputs = {}
        out = {}
        for k, v in inputs.items():
            if k in four:
                h = four[k]
                bounds = ([slab_bounds(h, coarse, self.n, r) for r in range(self.n)]
                          if h % coarse == 0 and coarse >= self.n else row_split(h, self.n))
                self.inputs[k] = bounds
                lo, hi = bounds[self.i]
                v = v[:, :, lo:hi].contiguous()
            out[k] = v
        return out

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Blob ``name`` of the last forward, whole on every rank."""
        bounds = self.split.get(name)
        return t if bounds is None else _Gather.apply(t, self.mesh, self.axis, bounds)

    # ---------------------------------------------------------------- hooks

    def begin(self, net, ctx) -> None:
        self.split = dict(self.inputs)
        self.height = {k: net.blob_shapes[k][2] for k in self.inputs}
        self.whole_layers, self.whole_tops = set(), set()
        # the rank's own generator, made once a net: slabs draw from it
        gens = net.__dict__.setdefault("_row_generators", {})
        key = (self.axis, self.mesh.rank)
        if key not in gens:
            gens[key] = torch.Generator(device=ctx.device).manual_seed(
                ctx.generator.initial_seed() + 1 + self.mesh.rank)
        self._gens = (ctx.generator, gens[key])

    def _out_bounds(self, mod, bounds: Bounds, h_out: int) -> Optional[Bounds]:
        """The output rows of a window layer by rank: those whose window's
        centre lies in the rank's input rows (a same-size convolution keeps
        the split, a 2x2/2 pool halves it), evenly split where that leaves a
        rank none; None when the output has fewer rows than ranks."""
        k, s, p, d = mod.window
        if mod.transposed:
            cut = lambda b: b * s  # noqa: E731
        else:
            cut = lambda b: -(-(b + p - (k - 1) * d // 2) // s)  # noqa: E731
        inner = [min(max(cut(hi), 0), h_out) for _, hi in bounds[:-1]]
        out = list(zip([0] + inner, inner + [h_out]))
        if all(hi > lo for lo, hi in out):
            return out
        return row_split(h_out, self.n) if h_out >= self.n else None

    def enter(self, layer, mod, bots, ctx):
        """The "whole rows" hook: plans ``layer`` from its bottoms' splits,
        slices or gathers bottoms where the plan needs them, records its
        tops' splits and picks the generator it draws from."""
        self.current = layer.name
        sliced = {j: self.split[b] for j, b in enumerate(layer.bottoms)
                  if bots[j].dim() == 4 and self.split.get(b) is not None}
        tops: Dict[str, Bounds] = {}
        slab = False
        if sliced and mod.rows == "local" and len({tuple(v) for v in sliced.values()}) == 1:
            j0, bounds = next(iter(sliced.items()))
            h = self.height[layer.bottoms[j0]]
            if all(t.dim() != 4 or j in sliced or t.shape[2] == h for j, t in enumerate(bots)):
                # whole 4-D bottoms of the same rows: this rank's rows of them
                bots = [_Slice.apply(t, self.mesh, self.axis, bounds)
                        if t.dim() == 4 and j not in sliced else t for j, t in enumerate(bots)]
                tops = {t: bounds for t, sh in zip(layer.tops, mod.top_shapes)
                        if len(sh) == 4 and sh[2] == h}
                slab = True
        elif sliced and mod.rows == "window" and list(sliced) == [0]:
            out = self._out_bounds(mod, sliced[0], mod.top_shapes[0][2])
            if out is not None:
                self.plans[mod.name] = plan_window(sliced[0], out, self.height[layer.bottoms[0]],
                                                   *mod.window, mod.transposed)
                tops = {layer.tops[0]: out}
                slab = True
        if not slab:
            self.plans.pop(mod.name, None)
            bots = [_Gather.apply(t, self.mesh, self.axis, sliced[j]) if j in sliced else t
                    for j, t in enumerate(bots)]
            self.whole_layers.add(layer.name)
            self.whole_tops.update(layer.tops)
        for t, sh in zip(layer.tops, mod.top_shapes):
            self.split[t] = tops.get(t)
            if len(sh) == 4:
                self.height[t] = sh[2]
        ctx.generator = self._gens[1] if slab else self._gens[0]
        return bots

    def row_window(self, mod, x: torch.Tensor, fill: float = 0.0):
        """The "row window" hook: -> (the input rows this rank's output rows
        of ``mod`` read, (input rows, first output row, end output row,
        first input row read)), or (x, None) where ``mod`` runs whole."""
        win = self.plans.get(mod.name)
        if win is None:
            return x, None
        lo, hi = win.out[self.i]
        return _Window.apply(x, win, self.mesh, self.axis, fill), (win.h, lo, hi,
                                                                   win.need[self.i][0])

    def _slab(self) -> bool:
        return self.current not in self.whole_layers

    def stat_axes(self, name: str) -> List[str]:
        return self.batch_axes + (self.row_axes if name not in self.whole_layers else [])

    def normalizer(self, local: torch.Tensor, kind: str) -> torch.Tensor:
        total = local.detach().clone()
        for a in self.batch_axes + (self.row_axes if kind == "count" and self._slab() else []):
            self.mesh.all_reduce(total, a)
        return total

    def loss_share(self, top: str, value: torch.Tensor) -> torch.Tensor:
        """A loss computed whole counts 1/n on each of the n ranks (its
        gradient stays whole: the tail's gradients are averaged)."""
        if top in self.whole_tops and self.n > 1:
            return value + value.detach() * (1.0 / self.n - 1.0)
        return value

    def conv(self, mod, x, w, b, cudnn):
        from ..ops import nn as nn_ops

        x, rows = self.row_window(mod, x)
        if rows is None:
            return mod(x, w, b, cudnn=cudnn)
        return nn_ops.conv2d(x, w, b, stride=mod.stride, pad=(0, mod.pad[1]),
                             dilation=mod.dilation, groups=mod.groups, cudnn=cudnn)


def make_spatial_forward(mesh: Mesh, net, outputs, axis: str = "spatial"):
    """``fn({input: whole (N, C, H, W) tensor}) -> {output: whole tensor}``
    with the rows split over ``axis``: each rank runs ``net`` on its slab of
    every 4-D input (others whole) and the sliced outputs are all-gathered,
    so every rank returns the whole outputs.  Parameters replicated."""
    layers = net.prune_for(outputs)
    shard = RowShard(mesh, axis)

    def fn(inputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        heights = [v.shape[2] for v in inputs.values() if v.dim() == 4]
        # the coarsest output that divides every input: its rows split evenly
        coarse = min([h for h in heights + [net.blob_shapes[o][2] for o in outputs
                                            if len(net.blob_shapes[o]) == 4]
                      if all(x % h == 0 for x in heights)], default=None)
        local = shard.place({k: v.to(mesh.device) for k, v in inputs.items()}, coarse)
        out = net.forward(local, outputs=list(outputs), layers=layers, shard=shard)
        return {k: shard.whole(k, v) for k, v in out.items()}

    return fn


def _require_kernel(est) -> None:
    if est.device.type == "cuda" and not est.peak_kernel:
        raise ValueError("a sharded estimator on a card runs the peak-mask and upsample-keys "
                         "kernels: build the estimator with peak_kernel on")


def _frames(est, x) -> torch.Tensor:
    """The estimator's input (one frame, or ``batch`` frames) as a
    (F, *input_shape) tensor on its device."""
    t = torch.as_tensor(np.ascontiguousarray(x) if not isinstance(x, torch.Tensor) else x)
    if tuple(t.shape) == tuple(est.input_shape()):
        t = t[None]
    return t.to(est.device)


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


def post(est, low: torch.Tensor, nms_thr, inter_thr, whole_frames: bool = True):
    """The estimator's own post segment on (F, S, h, w, C) low-res maps, as
    its device program returns it: ``{"packed": rows}`` (K1 on the card),
    or with ``keep_heatmap`` {"peaks", "pair_score", "pair_count",
    "heatmap"} (K3 on the card, once a frame), each with a leading frame
    axis unless ``whole_frames`` and there is one frame."""
    thr = thresholds(est, nms_thr, inter_thr)
    if not est.keep_heatmap:
        rows = est._post(low, *thr, est.eff_peaks)
        return {"packed": rows[0] if whole_frames and est.batch == 1 and rows.shape[0] == 1
                else rows}
    outs = [est._heatmap_post(f, *thr) for f in low]
    if whole_frames and len(outs) == 1:
        return outs[0]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def spatial_estimator_fn(mesh: Mesh, estimator, axis: str = "spatial"):
    """The estimator's device program with each canvas H-sharded over
    ``axis``: ``fn(weights, net_input, nms_thr, inter_thr)`` -> what
    ``run_device`` returns, replicated on every rank (:func:`post`).
    ``weights``: the net's operands (``Net.operands()``), replicated;
    ``net_input`` in ``input_shape``, with a leading frame axis for a
    batched estimator; the thresholds floats or None (the defaults)."""
    est = estimator
    _require_kernel(est)
    shard = RowShard(mesh, axis)
    coarse = est.net.blob_shapes[est.lowres_blob][2]

    def fn(weights, net_input, nms_thr=None, inter_thr=None):
        with torch.inference_mode():
            local = shard.place({"image": est._canvases(_frames(est, net_input))}, coarse)
            low = est.net(local, outputs=[est.lowres_blob], layers=est._layers, operands=weights,
                          shard=shard)[est.lowres_blob]
            low = shard.whole(est.lowres_blob, low)
            return post(est, lowres_to_post(est, low), nms_thr, inter_thr)

    return fn
