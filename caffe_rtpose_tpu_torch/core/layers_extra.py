"""The remaining Caffe layer types: Switch, BatchReindex, Parameter,
DummyData, HDF5Output, InfogainLoss, Im2col, SPP, the recurrent family
(LSTM, RNN, LSTMUnit), Filter and Python.

Counterpart of ``caffe_rtpose_tpu/core/layers_extra.py``, registered into
the one registry of ``core/layers.py`` (which imports this module).
Recurrent semantics follow reference src/caffe/layers/{recurrent,lstm,rnn}_layer.cpp:
time-major bottoms x (T, N, ...) and cont (T, N); the hidden state resets
where cont == 0; the parameter blobs are in Caffe's unrolled-net order, so
``.caffemodel`` weights interchange.
"""

from __future__ import annotations

import importlib
import math
import threading
from typing import List

import numpy as np
import torch

from ..ops import losses as op_losses
from ..ops import nn as nn_ops
from ..proto import caffe_pb
from ..proto.caffe_pb import POOL_METHOD
from ..utils import hdf5
from .filler import fill
from .layers import BuildCtx, FnLayer, LayerModule, RunCtx, _local, enum, hw, register, rows_of


@register("Switch")
def build_switch(ctx: BuildCtx):
    """One bottom as the top: the last (the deepest stage) unless the knob
    ``switch_index`` picks another.  The reference ships a Switch deploy
    prototxt but never implemented the layer."""
    n = len(ctx.bshapes)

    def fn(b, c: RunCtx):
        if c.knobs and "switch_index" in c.knobs:
            return (b[min(max(int(c.knobs["switch_index"]), 0), n - 1)],)
        return (b[-1],)

    return _local(FnLayer(ctx, [ctx.bshapes[-1]], fn))


@register("BatchReindex")
def build_batch_reindex(ctx: BuildCtx):
    """top = bottom[0][bottom[1]] along axis 0 (batch_reindex_layer.cpp)."""
    n_idx = int(np.prod(ctx.bshapes[1]))
    out = (n_idx,) + tuple(ctx.bshapes[0][1:])
    return _local(FnLayer(ctx, [out], lambda b, c: (
        torch.index_select(b[0], 0, b[1].reshape(-1).to(torch.int64)),)))


@register("Parameter")
class Parameter(LayerModule):
    def __init__(self, ctx: BuildCtx):
        shape = tuple(int(d) for d in ctx.lv.parameter_param.shape.dim)
        super().__init__(ctx, [shape])
        self.add_blob(ctx, "value", shape, caffe_pb.view({"type": "constant"}, "FillerParameter"))

    def run(self, bots, ctx):
        return (self.value,)


@register("DummyData")
class DummyData(LayerModule):
    """Tops filled each forward from their fillers (``core/filler.py``),
    drawing from a CPU generator the net seeds: constant fillers give the
    same blobs on every device."""

    def __init__(self, ctx: BuildCtx):
        dp = ctx.lv.dummy_data_param
        if dp.shape:
            shapes = [tuple(int(d) for d in bs.dim) for bs in dp.shape]
        else:
            shapes = [(int(dp.num[i]), int(dp.channels[i]), int(dp.height[i]), int(dp.width[i]))
                      for i in range(len(dp.num))]
        n_tops = len(ctx.layer.tops)
        while len(shapes) < n_tops:
            shapes.append(shapes[-1])
        self.dummy_fillers = list(dp.data_filler) or [
            caffe_pb.view({"type": "constant"}, "FillerParameter")]
        while len(self.dummy_fillers) < n_tops:
            self.dummy_fillers.append(self.dummy_fillers[-1])
        super().__init__(ctx, shapes[:n_tops])
        self.gen = torch.Generator().manual_seed(0)

    def run(self, bots, ctx):
        return tuple(fill(self.gen, s, f).to(ctx.device)
                     for s, f in zip(self.top_shapes, self.dummy_fillers))


@register("HDF5Output")
class HDF5Output(LayerModule):
    """Appends its bottoms to ``hdf5_output_param.file_name`` each forward
    (hdf5_output_layer.cpp), in place (``utils/hdf5.py``: the new chunks and
    index nodes past the file's old end, the extent rewritten where it is)."""

    def __init__(self, ctx: BuildCtx):
        super().__init__(ctx, [])
        self.file_name = ctx.lv.hdf5_output_param.file_name
        self.bottom_names = list(ctx.layer.bottoms)

    def run(self, bots, ctx):
        with hdf5.File(self.file_name, "a") as f:
            for name, t in zip(self.bottom_names, bots):
                arr = t.detach().float().cpu().numpy()
                if name in f:
                    ds = f[name]
                    n = ds.shape[0]
                    ds.resize(n + arr.shape[0], axis=0)
                    ds[n:] = arr
                else:
                    f.create_dataset(name, data=arr, maxshape=(None,) + arr.shape[1:])
        return ()


@register("InfogainLoss")
class InfogainLoss(LayerModule):
    def __init__(self, ctx: BuildCtx):
        super().__init__(ctx, [()])
        ip = ctx.lv.infogain_loss_param
        source = ip.source if ip.has("source") else None
        if len(ctx.bshapes) < 3 and not source:
            raise ValueError("InfogainLoss needs an H matrix (3rd bottom or source file)")
        self.register_buffer("h_static", None)
        if source and len(ctx.bshapes) < 3:
            if source.endswith(".npy"):
                h = np.load(source)
            else:
                from ..proto import caffemodel, wire

                with open(source, "rb") as f:
                    h = caffemodel.blob_to_array(
                        wire.decode(f.read(), caffe_pb.SCHEMA, "BlobProto")).squeeze()
            self.register_buffer("h_static", torch.from_numpy(np.asarray(h, np.float32)))

    def run(self, bots, ctx):
        probs = bots[0].reshape(bots[0].shape[0], -1)
        h = (self.h_static if self.h_static is not None
             else bots[2].reshape(probs.shape[1], probs.shape[1]))
        loss = op_losses.infogain(probs, bots[1].reshape(-1), h)
        if ctx.shard is None:
            return (loss,)
        # divided by the batch as fed: rescaled to the global batch
        local = torch.full((), float(probs.shape[0]), device=loss.device)
        return (loss * local / ctx.shard.normalizer(local, "batch"),)


@register("Im2col")
def build_im2col(ctx: BuildCtx):
    """Patches (N, C*kh*kw, oh, ow), channel slowest (im2col_layer.cpp)."""
    p = ctx.layer.param
    k = hw(p, "kernel_size", None, "kernel")
    s = hw(p, "stride", 1)
    pad = hw(p, "pad", 0)
    n, c, h, w = ctx.bshapes[0]
    out = (n, c * k[0] * k[1], (h + 2 * pad[0] - k[0]) // s[0] + 1,
           (w + 2 * pad[1] - k[1]) // s[1] + 1)

    def fn(b, cx):
        x, rows = rows_of(cx, mod, b[0])
        return (nn_ops.im2col(x, k, s, pad if rows is None else (0, pad[1])),)

    mod = FnLayer(ctx, [out], fn)
    mod.rows, mod.window = "window", (k[0], s[0], pad[0], 1)
    return mod


@register("SPP")
def build_spp(ctx: BuildCtx):
    """Spatial pyramid pooling (spp_layer.cpp): level i pools to a 2^i x
    2^i grid; the top is the levels flattened and concatenated."""
    sp = ctx.lv.spp_param
    method = enum(sp.pool, POOL_METHOD)
    n, c, h, w = ctx.bshapes[0]
    plans = []
    for i in range(int(sp.pyramid_height)):
        bins = 2 ** i
        kh, kw = int(math.ceil(h / float(bins))), int(math.ceil(w / float(bins)))
        plans.append((bins, kh, kw, int((kh * bins - h + 1) / 2), int((kw * bins - w + 1) / 2)))

    def fn(b, cx):
        outs = []
        for bins, kh, kw, ph, pw in plans:
            pool = nn_ops.max_pool2d if method == POOL_METHOD["MAX"] else nn_ops.avg_pool2d
            y = pool(b[0], (kh, kw), (kh, kw), (ph, pw))[:, :, :bins, :bins]
            outs.append(y.reshape(n, -1))
        return (torch.cat(outs, dim=1),)

    return FnLayer(ctx, [(n, c * sum(p[0] ** 2 for p in plans))], fn)


class _Recurrent(LayerModule):
    """The LSTM and RNN layers' common set-up: bottoms x (T, N, ...), cont
    (T, N) [, x_static (N, ...)] [, the exposed initial state]."""

    n_state = 1

    def __init__(self, ctx: BuildCtx, shapes_fn):
        rp = ctx.lv.recurrent_param
        self.hidden = int(rp.num_output)
        xs = ctx.bshapes[0]
        self.t, self.n = xs[0], xs[1]
        self.d = int(np.prod(xs[2:]))
        self.expose = bool(rp.expose_hidden)
        self.static = len(ctx.bshapes) > 2 + (self.n_state if self.expose else 0)
        self.ds = int(np.prod(ctx.bshapes[2][1:])) if self.static else 0
        tops = [(self.t, self.n, self.hidden)]
        if self.expose:
            tops += [(1, self.n, self.hidden)] * self.n_state
        super().__init__(ctx, tops)
        for name, shape, is_bias in shapes_fn(self):
            self.add_blob(ctx, name, shape, rp.bias_filler if is_bias else rp.weight_filler)

    def inputs(self, bots):
        x = bots[0].reshape(self.t, self.n, self.d).to(torch.float32)
        cont = bots[1].reshape(self.t, self.n).to(torch.float32)
        xs = bots[2].reshape(self.n, self.ds).to(torch.float32) if self.static else None
        return x, cont, xs


@register("LSTM")
class LSTM(_Recurrent):
    """Caffe LSTMLayer (lstm_layer.cpp): params [W_xc (4H, D), b_c (4H)
    [, W_xc_static (4H, Ds)], W_hc (4H, H)]; gates i, f, o, g; cont gates
    both h_{t-1} and c_{t-1}."""

    n_state = 2

    def __init__(self, ctx: BuildCtx):
        def shapes(m):
            h4 = 4 * m.hidden
            return ([("w_xc", (h4, m.d), False), ("b_c", (h4,), True)]
                    + ([("w_xc_static", (h4, m.ds), False)] if m.static else [])
                    + [("w_hc", (h4, m.hidden), False)])

        super().__init__(ctx, shapes)

    def run(self, bots, ctx):
        x, cont, xs = self.inputs(bots)
        H = self.hidden
        xw = torch.einsum("tnd,gd->tng", x, self.w_xc) + self.b_c
        if self.static:
            xw = xw + (xs @ self.w_xc_static.T)[None]
        if self.expose:
            h = bots[-2].reshape(self.n, H).to(torch.float32)
            c = bots[-1].reshape(self.n, H).to(torch.float32)
        else:
            h = c = torch.zeros(self.n, H, device=x.device)
        hs = []
        for t in range(self.t):
            ct = cont[t][:, None]
            gates = xw[t] + (h * ct) @ self.w_hc.T
            i = torch.sigmoid(gates[:, :H])
            f = torch.sigmoid(gates[:, H: 2 * H])
            o = torch.sigmoid(gates[:, 2 * H: 3 * H])
            g = torch.tanh(gates[:, 3 * H:])
            c = f * (c * ct) + i * g
            h = o * torch.tanh(c)
            hs.append(h)
        out = torch.stack(hs).to(bots[0].dtype)
        if self.expose:
            return out, h.reshape(1, self.n, H), c.reshape(1, self.n, H)
        return (out,)


@register("RNN")
class RNN(_Recurrent):
    """Caffe RNNLayer (rnn_layer.cpp): h_t = tanh(W_hh (h_{t-1} cont) +
    W_xh x_t + b_h [+ W_xh_static x_static]), o_t = tanh(W_ho h_t + b_o);
    params [W_xh (H, D), b_h (H) [, W_xh_static (H, Ds)], W_hh (H, H),
    W_ho (H, H), b_o (H)]."""

    def __init__(self, ctx: BuildCtx):
        def shapes(m):
            H = m.hidden
            return ([("w_xh", (H, m.d), False), ("b_h", (H,), True)]
                    + ([("w_xh_static", (H, m.ds), False)] if m.static else [])
                    + [("w_hh", (H, H), False), ("w_ho", (H, H), False), ("b_o", (H,), True)])

        super().__init__(ctx, shapes)

    def run(self, bots, ctx):
        x, cont, xs = self.inputs(bots)
        xw = torch.einsum("tnd,hd->tnh", x, self.w_xh) + self.b_h
        if self.static:
            xw = xw + (xs @ self.w_xh_static.T)[None]
        h = (bots[-1].reshape(self.n, self.hidden).to(torch.float32) if self.expose
             else torch.zeros(self.n, self.hidden, device=x.device))
        os_ = []
        for t in range(self.t):
            h = torch.tanh(xw[t] + (h * cont[t][:, None]) @ self.w_hh.T)
            os_.append(torch.tanh(h @ self.w_ho.T + self.b_o))
        out = torch.stack(os_).to(bots[0].dtype)
        if self.expose:
            return out, h.reshape(1, self.n, self.hidden)
        return (out,)


@register("LSTMUnit")
def build_lstm_unit(ctx: BuildCtx):
    """One timestep's gates (lstm_unit_layer.cpp:43-66): bottoms c_prev (1,
    N, H), X (1, N, 4H) in gate order i, f, o, g, cont (1, N); tops c, h."""
    ctx.require_bottoms(3)

    def fn(b, cx):
        c_prev, X, cont = b
        H = c_prev.shape[-1]
        X = X.to(torch.float32)
        i = torch.sigmoid(X[..., :H])
        f = torch.sigmoid(X[..., H: 2 * H])
        o = torch.sigmoid(X[..., 2 * H: 3 * H])
        g = torch.tanh(X[..., 3 * H:])
        cont_b = cont.reshape(cont.shape[0], cont.shape[1], 1).to(torch.float32)
        c = cont_b * f * c_prev.to(torch.float32) + i * g
        h = o * torch.tanh(c)
        return c.to(c_prev.dtype), h.to(c_prev.dtype)

    return FnLayer(ctx, [ctx.bshapes[0]] * 2, fn)


@register("Filter")
def build_filter(ctx: BuildCtx):
    """Filter (filter_layer.cpp): the last bottom selects items along axis
    0.  The reference's output batch depends on the data; as in JAX the
    kept items come first in their order, the rest of the batch is zeros,
    and the top keeps the bottom's batch (the count is sum(selector != 0))."""

    def fn(b, cx):
        sel = b[-1].reshape(b[-1].shape[0], -1)[:, 0]
        keep = sel != 0
        n = keep.shape[0]
        k = keep.sum()
        order = torch.where(keep, torch.cumsum(keep, 0) - 1, k + torch.cumsum(~keep, 0) - 1)
        idx = torch.empty(n, dtype=torch.int64, device=sel.device).scatter_(
            0, order, torch.arange(n, device=sel.device))
        valid = torch.arange(n, device=sel.device) < k
        outs = []
        for x in b[:-1]:
            g = torch.index_select(x, 0, idx)
            outs.append(torch.where(valid.reshape((n,) + (1,) * (x.dim() - 1)), g,
                                    torch.zeros_like(g)))
        return tuple(outs)

    return FnLayer(ctx, list(ctx.bshapes[:-1]), fn)


class _PyBlob:
    """The numpy blob a user's Python layer sees (python_layer.hpp: .data,
    .diff, .shape, .reshape, .count)."""

    def __init__(self, arr: np.ndarray):
        self.data = np.array(arr, np.float32)
        self.diff = np.zeros_like(self.data)

    @property
    def shape(self):
        return self.data.shape

    def reshape(self, *shape):
        self.data = np.zeros(shape, np.float32)
        self.diff = np.zeros(shape, np.float32)

    def count(self):
        return self.data.size


class _PythonCall(torch.autograd.Function):
    """The user's numpy ``forward`` as the forward and its ``backward`` as
    the vector-Jacobian product (JAX: a ``custom_vjp`` over
    ``pure_callback``)."""

    @staticmethod
    def forward(ctx, layer, *bots):
        ctx.layer = layer
        ctx.save_for_backward(*bots)
        outs = layer.host_forward([b.detach().cpu().numpy() for b in bots])
        return tuple(torch.from_numpy(o).to(bots[0].device) for o in outs)

    @staticmethod
    def backward(ctx, *top_diffs):
        bots = ctx.saved_tensors
        diffs = ctx.layer.host_backward([b.detach().cpu().numpy() for b in bots],
                                        [d.detach().float().cpu().numpy() for d in top_diffs])
        return (None,) + tuple(torch.from_numpy(d).to(b.device).to(b.dtype)
                               for d, b in zip(diffs, bots))


@register("Python")
class Python(LayerModule):
    """``python_param.module``.``python_param.layer`` (python_layer.hpp):
    setup and reshape at build, then its numpy ``forward`` (and
    ``backward``) on the host, the tensors copied from and to the device."""

    def __init__(self, ctx: BuildCtx):
        pp = ctx.lv.python_param
        inst = getattr(importlib.import_module(pp.module), pp.layer)()
        inst.param_str = pp.param_str
        inst.phase = 0 if ctx.train else 1  # caffe.TRAIN == 0, caffe.TEST == 1
        self.caffe_bots = [_PyBlob(np.zeros(s, np.float32)) for s in ctx.bshapes]
        self.caffe_tops = [_PyBlob(np.zeros((1,), np.float32)) for _ in ctx.layer.tops]
        if hasattr(inst, "setup"):
            inst.setup(self.caffe_bots, self.caffe_tops)
        if hasattr(inst, "reshape"):
            inst.reshape(self.caffe_bots, self.caffe_tops)
        super().__init__(ctx, [t.data.shape for t in self.caffe_tops])
        self.inst = inst
        self.lock = threading.Lock()  # user layer instances are stateful

    def host_forward(self, arrays: List[np.ndarray]) -> List[np.ndarray]:
        with self.lock:
            for blob, arr in zip(self.caffe_bots, arrays):
                blob.data = np.asarray(arr, np.float32)
            self.inst.forward(self.caffe_bots, self.caffe_tops)
            return [np.array(t.data, np.float32) for t in self.caffe_tops]

    def host_backward(self, bot_arrays, top_diffs) -> List[np.ndarray]:
        """Forward again for the layer's state, then its backward(top,
        propagate_down, bottom), which fills bottom[i].diff."""
        with self.lock:
            for blob, arr in zip(self.caffe_bots, bot_arrays):
                blob.data = np.asarray(arr, np.float32)
            self.inst.forward(self.caffe_bots, self.caffe_tops)
            for blob, d in zip(self.caffe_tops, top_diffs):
                blob.diff = np.asarray(d, np.float32)
            if hasattr(self.inst, "backward"):
                self.inst.backward(self.caffe_tops, [True] * len(self.caffe_bots), self.caffe_bots)
                return [np.array(b.diff, np.float32) for b in self.caffe_bots]
            return [np.zeros_like(b.data) for b in self.caffe_bots]

    def run(self, bots, ctx):
        if not bots:
            return tuple(torch.from_numpy(o).to(ctx.device) for o in self.host_forward([]))
        return tuple(_PythonCall.apply(self, *[b.to(torch.float32) for b in bots]))
