"""Data-parallel training on ``torch.distributed``, and the mesh and launcher
every parallel mode of the port runs on.

Counterpart of ``caffe_rtpose_tpu/parallel/dp.py``.  There a
``jax.sharding.Mesh`` names devices along axes and XLA inserts the gradient
all-reduce from sharding annotations.  Here every device is one process (a
rank) and the port writes the collectives itself:

* :class:`Mesh` lays the ranks out row-major over named axes (JAX's names:
  ``data``, ``spatial``, ``model``, ``stage``) and holds one process group
  per line of ranks along each axis;
* :func:`spawn` starts N ranks, each on a named device, joined through a
  ``file://`` store in a fresh temporary directory (parallel test workers
  never collide on a port), and returns each rank's result;
* :func:`make_dp_train_step` is Caffe's P2PSync (reference
  src/caffe/parallel.cpp:287-380) without the tree: parameters replicated,
  the global batch split over the ``data`` axis, the gradients all-reduced
  in buckets of one flat buffer each before the update.

The backend is NCCL when every rank has a card of its own, gloo otherwise
(two ranks on one card, or the CPU): NCCL refuses two ranks on one device.
gloo's collectives on CUDA tensors go through pinned host buffers here
(:func:`host_route`), by design: its point-to-point and some collectives
refuse CUDA tensors, and one route for all keeps them alike.

As in JAX the prototxt ``batch_size`` is the GLOBAL batch: a rank's step on
its rows equals the one-rank step on the whole batch.  Each loss layer
divides by the global normalizer (``RunCtx.shard``, ``core/layers.py``:
the batch, or the count of valid labels of a ``SoftmaxWithLoss``), so the
ranks' losses and gradients add up to the whole batch's.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "spatial", "model", "stage")
BUCKET_ELEMS = 1 << 24  # 64 MB of f32 a bucket of the gradient all-reduce


def pick_backend(devices: Sequence[Union[str, torch.device]]) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    cards = [d.index or 0 for d in devs if d.type == "cuda"]
    if devs and len(cards) == len(devs) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def host_route(t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` goes through a host buffer: gloo with a
    CUDA tensor."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


class Mesh:
    """Ranks ``0 .. prod(shape) - 1`` laid out row-major over named axes,
    the port of a ``jax.sharding.Mesh``.  Every rank of the world builds it
    (``dist.new_group`` is collective); a rank outside the mesh has
    ``member`` false.  :meth:`group` is this rank's process group along an
    axis and :meth:`index` its position there."""

    def __init__(self, shape: Mapping[str, int], device: Union[str, torch.device]):
        self.axis_names: Tuple[str, ...] = tuple(shape)
        for a in self.axis_names:
            if a not in AXES:
                raise ValueError(f"unknown mesh axis {a!r} (one of {AXES})")
        self.shape: Dict[str, int] = {a: int(n) for a, n in shape.items()}
        self.size = int(np.prod(list(self.shape.values())))
        world = dist.get_world_size()
        if self.size > world:
            raise ValueError(f"need {self.size} ranks, have {world}")
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.member = self.rank < self.size
        dims = [self.shape[a] for a in self.axis_names]
        self.coords = (dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            self.rank, dims)))) if self.member else {})
        grid = np.arange(self.size).reshape(dims)
        self._groups: Dict[str, Tuple[Any, List[int]]] = {}
        for k, a in enumerate(self.axis_names):
            lines = np.moveaxis(grid, k, -1).reshape(-1, dims[k])
            for line in lines:
                ranks = [int(r) for r in line]
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[a] = (g, ranks)

    def group(self, axis: str):
        return self._groups[axis][0]

    def ranks(self, axis: str) -> List[int]:
        return self._groups[axis][1]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def n(self, axis: str) -> int:
        return self.shape[axis]

    # --------------------------------------------------------- collectives

    def all_reduce(self, t: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced in place over ``axis`` (and returned)."""
        if self.shape[axis] == 1:
            return t
        if host_route(t):
            host = _to_host(t)
            dist.all_reduce(host, op=op, group=self.group(axis))
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=self.group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every rank's ``t`` along ``axis`` (the same shape on each), in
        rank order."""
        n = self.shape[axis]
        if n == 1:
            return [t]
        src = _to_host(t) if host_route(t) else t.contiguous()
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=self.group(axis))
        return [o.to(t.device, non_blocking=True) for o in out] if src is not t else out

    def gather_rows(self, t: torch.Tensor, axis: str, counts: Sequence[int], dim: int = 2
                    ) -> torch.Tensor:
        """Slabs of ``counts[i]`` along ``dim`` from each rank of ``axis`` ->
        the whole tensor (uneven slabs are padded to the largest for the
        all-gather and trimmed)."""
        most = max(counts)
        pad = list(t.shape)
        pad[dim] = most - t.shape[dim]
        if pad[dim]:
            t = torch.cat([t, t.new_zeros(pad)], dim=dim)
        parts = self.all_gather(t, axis)
        return torch.cat([p.narrow(dim, 0, c) for p, c in zip(parts, counts)], dim=dim)

    def send(self, t: torch.Tensor, dst: int) -> None:
        dist.send(_to_host(t) if host_route(t) else t.contiguous(), dst)

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        if host_route(like):
            host = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            dist.recv(host, src)
            return host.to(like.device)
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.recv(out, src)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` from global rank ``src`` to every rank, in place."""
        if host_route(t):
            host = _to_host(t)
            dist.broadcast(host, src)
            t.copy_(host)
        else:
            dist.broadcast(t, src)
        return t


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device: Union[None, str, torch.device] = None) -> Mesh:
    """A one-axis mesh over the first ``n_devices`` ranks (default all).
    ``device``: this rank's device (default :func:`rank_device`)."""
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return Mesh({axis: n}, device or rank_device())


_RANK_DEVICE: Optional[torch.device] = None


def rank_device() -> torch.device:
    """The device :func:`spawn` gave this rank."""
    if _RANK_DEVICE is None:
        raise RuntimeError("no rank device: not a rank of parallel.dp.spawn; pass device=")
    return _RANK_DEVICE


# ------------------------------------------------------------- placement


def row_split(n_rows: int, parts: int) -> List[Tuple[int, int]]:
    """``n_rows`` split into ``parts`` contiguous ranges, the first
    ``n_rows % parts`` one row longer."""
    base, extra = divmod(int(n_rows), int(parts))
    out, lo = [], 0
    for i in range(parts):
        hi = lo + base + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _as_tensor(v, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
    return t.to(device)


def shard_batch(mesh: Mesh, batch: Mapping[str, Any], axis: str = "data"
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of each host array (leading axis split evenly over
    ``axis``; ``ValueError`` when it does not divide, as JAX's placement
    refuses), scalars whole, on the rank's device."""
    n, i = mesh.n(axis), mesh.index(axis)
    out = {}
    for k, v in batch.items():
        if np.ndim(v) >= 1:
            rows = np.shape(v)[0]
            if rows % n:
                raise ValueError(f"{k}: batch {rows} does not split over {n} ranks of {axis!r}")
            lo, hi = row_split(rows, n)[i]
            v = v[lo:hi]
        out[k] = _as_tensor(v, mesh.device)
    return out


def replicate(mesh: Mesh, tree, src: int = 0):
    """``{key: [tensor, ...]}`` (or a list of tensors) made equal on every
    rank: rank ``src``'s values broadcast in place."""
    leaves = ([t for v in tree.values() for t in v] if isinstance(tree, Mapping) else list(tree))
    with torch.no_grad():
        for t in leaves:
            mesh.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src)
    return tree


def all_reduce_flat(mesh: Mesh, tensors: Sequence[torch.Tensor], axes: Sequence[str],
                    mean_axes: Sequence[str] = ()) -> None:
    """Sum ``tensors`` in place over ``axes`` and average them over
    ``mean_axes``: packed into flat buffers of at most
    :data:`BUCKET_ELEMS` elements a collective, as P2PSync packs one
    buffer (parallel.cpp:287-380)."""
    axes = [a for a in axes if mesh.n(a) > 1]
    mean_axes = [a for a in mean_axes if mesh.n(a) > 1]
    if not axes and not mean_axes:
        return
    scale = 1.0 / math.prod(mesh.n(a) for a in mean_axes) if mean_axes else 1.0
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        for a in list(axes) + list(mean_axes):
            mesh.all_reduce(flat, a)
        if scale != 1.0:
            flat.mul_(scale)
        off = 0
        for t in bucket:
            t.copy_(flat[off : off + t.numel()].view_as(t.reshape(-1)).reshape(t.shape))
            off += t.numel()

    for t in tensors:
        if bucket and size + t.numel() > BUCKET_ELEMS:
            flush()
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        flush()


class _AllReduce(torch.autograd.Function):
    """A sum over ranks that autograd goes through: the forward sums ``t``
    over ``axes`` (a copy), the backward sums the gradient likewise (each
    rank's loss is its share of the whole: the ranks' gradients of the
    shared sum add up)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.conf = (mesh, axes)
        out = t.detach().clone()
        for a in axes:
            mesh.all_reduce(out, a)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.conf
        g = g.contiguous().clone()
        for a in axes:
            mesh.all_reduce(g, a)
        return g, None, None


def all_reduce_sum(mesh: Mesh, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``t`` summed over ``axes``, differentiable (:class:`_AllReduce`)."""
    axes = [a for a in axes if mesh.n(a) > 1]
    return _AllReduce.apply(t, mesh, axes) if axes else t


class DataShard:
    """``RunCtx.shard`` of a data-parallel forward: layers run as on one
    device, and a loss's normalizer is summed over the ranks that split the
    batch (``batch_axes``) and, for a count of positions, over those that
    split the rows too (``row_axes``).

    The hooks every layout answers (``core/net.py``, ``core/layers.py``):
    :meth:`begin` at the start of a forward, :meth:`enter` before each layer
    (the "whole rows" hook: the bottoms the layer gets), :meth:`row_window`
    in each layer that reads a window of rows, :meth:`stat_axes` for
    BatchNorm's batch statistics, :meth:`loss_share` for each loss top.
    Here they change nothing: the subclasses that split rows
    (``sp.RowShard``) or filters (``tp.ChannelShard``) override them."""

    def __init__(self, mesh: Mesh, batch_axes: Sequence[str] = ("data",),
                 row_axes: Sequence[str] = ()):
        self.mesh = mesh
        self.batch_axes = [a for a in batch_axes if mesh.n(a) > 1]
        self.row_axes = [a for a in row_axes if mesh.n(a) > 1]

    def begin(self, net, ctx) -> None:
        pass

    def enter(self, layer, mod, bots: List[torch.Tensor], ctx) -> List[torch.Tensor]:
        return bots

    def row_window(self, mod, x: torch.Tensor, fill: float = 0.0):
        """-> (the rows ``mod`` reads, None): on one device, all of ``x``."""
        return x, None

    def stat_axes(self, name: str) -> List[str]:
        """The axes whose ranks hold other samples or rows of layer
        ``name``'s bottom: its batch statistics are summed over them."""
        return self.batch_axes + self.row_axes

    def sum_stats(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over :meth:`stat_axes`, differentiable."""
        return all_reduce_sum(self.mesh, t, self.stat_axes(name))

    def loss_share(self, top: str, value: torch.Tensor) -> torch.Tensor:
        """This rank's share of loss top ``top`` in the loss it reports."""
        return value

    def normalizer(self, local: torch.Tensor, kind: str) -> torch.Tensor:
        total = local.detach().clone()
        for a in self.batch_axes + (self.row_axes if kind == "count" else []):
            self.mesh.all_reduce(total, a)
        return total

    def conv(self, mod, x, w, b, cudnn):
        return mod(x, w, b, cudnn=cudnn)

    def inner_product(self, mod, x):
        from ..ops import nn as nn_ops

        return nn_ops.inner_product(x, mod.weight, mod.bias, mod.transpose)


def net_loss_fn(net):
    """``loss_fn(inputs, shard) -> loss`` of a :class:`~..core.net.Net`
    (its summed weighted loss tops), for :func:`make_dp_train_step`."""
    return lambda inputs, shard: net.loss(inputs, shard=shard)[0]


def make_dp_train_step(mesh: Mesh, loss_fn: Callable, update_fn: Callable,
                       axis: str = "data"):
    """A train step with parameters replicated and the batch split over
    ``axis``: ``step(params, history, inputs, lr, it) -> loss``.

    ``loss_fn(inputs, shard) -> loss`` runs this rank's rows with
    ``shard`` (:class:`DataShard`), so the loss is this rank's share of the
    global batch's; ``update_fn(params, grads, history, lr, it)`` is
    ``training.solver.make_update_fn``'s, applied in place.  ``params``:
    ``{layer: [tensor, ...]}``, the tensors ``loss_fn`` reads.  The
    gradients are summed over ``axis`` in flat buckets before the update,
    the loss likewise; the returned loss is the global batch's (a float)."""
    shard = DataShard(mesh, (axis,))

    def step(params, history, inputs, lr, it) -> float:
        flat = [p for ps in params.values() for p in ps]
        for p in flat:
            p.grad = None
        loss = loss_fn(inputs, shard)
        loss.backward()
        grads = {k: [p.grad for p in ps] for k, ps in params.items()}
        all_reduce_flat(mesh, [g for gs in grads.values() for g in gs if g is not None], [axis])
        total = mesh.all_reduce(loss.detach().clone().reshape(1), axis)
        update_fn(params, grads, history, lr, it)
        return float(total)

    return step


# ---------------------------------------------------------------- launcher


def _rank_main(fn, rank, world, init_method, devices, args, results, threads, timeout):
    global _RANK_DEVICE
    try:
        torch.set_num_threads(threads)
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: {dev} asked for, and no card is visible")
            torch.cuda.set_device(dev)
        _RANK_DEVICE = dev
        backend = pick_backend(devices)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            results.put((rank, "ok", fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # the parent raises it with the rank's traceback
        results.put((rank, "error", traceback.format_exc()))


def spawn(fn: Callable, world_size: int, devices: Optional[Sequence[str]] = None,
          args: Sequence[Any] = (), timeout: float = 600.0, threads: int = 1) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` new processes, rank ``i`` on
    ``devices[i]`` (default ``cuda:i``; a repeated card puts several ranks
    on it over gloo), and return each rank's result in rank order.

    ``fn`` must be importable by name (a module-level function); inside it
    ``torch.distributed`` is initialized and :func:`rank_device` is the
    rank's device.  Raises ``RuntimeError`` with the rank's traceback when a
    rank fails, and ``TimeoutError`` (after killing every rank) when they
    have not all finished within ``timeout`` seconds."""
    devices = [str(d) for d in (devices or [f"cuda:{i}" for i in range(world_size)])]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    print(f"spawn: {world_size} ranks of {fn.__name__} on {', '.join(devices)}, backend "
          f"{pick_backend(devices)}", flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="crt_dist_")
    init_method = "file://" + os.path.join(store, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_method, devices, tuple(args), results,
                               threads, timeout))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        out: Dict[int, Any] = {}
        errors = []
        deadline = time.monotonic() + timeout
        while len(out) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__}: "
                                   f"{world_size - len(out)} not done after {timeout:.0f} s")
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"rank process exited with {dead[0].exitcode} "
                                       f"before reporting ({fn.__name__})")
                continue
            if status == "ok":
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break  # the others may wait on it forever
        if errors:
            raise RuntimeError(f"{fn.__name__} failed on {len(errors)} rank(s):\n"
                               + "\n".join(errors))
        for p in procs:
            p.join(timeout=30)
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
