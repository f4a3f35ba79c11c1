"""Solvers with Caffe-exact update rules (reference src/caffe/solvers/*.cpp,
src/caffe/solver.cpp).

The port of ``caffe_rtpose_tpu/training/solver.py``.  The gradient comes
from autograd (:meth:`Net.loss` then ``backward``); the update is applied in
place to the net's ``nn.Parameter``s under ``torch.no_grad``, in the JAX
function's order, which is Caffe's:

1. the diffs of ``lr_mult == 0`` parameters are zero (Caffe never computes
   them), so they do not count in the clip norm;
2. ``clip_gradients``: the raw accumulated diffs scaled to that global L2
   norm;
3. the division by ``iter_size`` (Normalize);
4. L2 or L1 regularization with each parameter's ``decay_mult``;
5. the SGD, Nesterov, AdaGrad, RMSProp, AdaDelta or Adam rule, the rate
   scaled by ``lr_mult``.

The learning-rate policy is evaluated on the host (``learning_rate``), and
rounded to f32 as the JAX update receives it.  History is a tree like the
JAX one, ``{"h0": {layer: [weight, bias]}, ...}`` (OIHW weights), so
``core.net.history_from_jax`` maps one onto the other, and snapshots write
it in Caffe's order (slots, then layers, then blobs) into the same
``.solverstate`` the JAX solver writes.

Test nets (Solver::TestAll, solver.cpp:328-380) share the train net's
parameter blobs by layer name (``Net.share_with``) and average their output
blobs over ``test_iter`` forwards every ``test_interval`` iterations
(``test_initialization`` tests at iteration 0).  A BatchNorm layer in a
TRAIN net leaves its batch statistics with the step, which rolls its
running averages as the reference's forward does (batch_norm_layer.cpp:
120-136): scale = scale * maf + 1, mean = mu + maf * mean, variance =
m/(m-1) var_batch + maf * variance, once a forward.

A bf16 net (``Net(dtype=torch.bfloat16, phase="TRAIN")``) trains in JAX's
mixed precision: the parameters, their gradients as accumulated, the
history and the update stay f32; the net casts inputs and labels to bf16
and its convolutions cast the parameters inside the forward.

``mesh`` (a ``parallel.dp.Mesh``, on every rank of a
``torch.distributed`` job): data parallelism, replacing P2PSync
(parallel.cpp), as JAX's ``Solver(mesh=)``: every rank's ``next_batch``
gives the same GLOBAL batch, each rank runs its rows (and, on a mesh with a
``spatial`` axis, its slab of rows, any layer type: ``parallel/sp.py``,
``parallel/mesh2d.py``), each loss is normalized by the global batch, and
the gradients are summed over the ranks in flat buckets before the update
(averaged over ``spatial`` for the layers every rank ran whole), so every
rank applies the same update (``parallel/dp.py``).  An ``input_transform``
runs on the rank's examples before their rows split.  The parameters
start from rank 0's.  Only rank 0 snapshots.
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..proto import caffe_pb, caffemodel, prototxt
from ..proto.caffe_pb import View
from ..utils import hdf5
from .datasets import StagedBatch

HISTORY_SLOTS = {"SGD": 1, "Nesterov": 1, "AdaGrad": 1, "RMSProp": 1, "AdaDelta": 2, "Adam": 2}

Tree = Dict[str, List[torch.Tensor]]


def learning_rate(sp: View, it: int) -> float:
    """Solver::GetLearningRate (sgd_solver.cpp:27-70)."""
    policy = sp.lr_policy
    base = float(sp.base_lr)
    if policy == "fixed":
        return base
    if policy == "step":
        return base * float(sp.gamma) ** (it // int(sp.stepsize))
    if policy == "exp":
        return base * float(sp.gamma) ** it
    if policy == "inv":
        return base * (1.0 + float(sp.gamma) * it) ** (-float(sp.power))
    if policy == "multistep":
        return base * float(sp.gamma) ** sum(1 for sv in sp.stepvalue if it >= sv)
    if policy == "poly":
        return base * (1.0 - it / float(sp.max_iter)) ** float(sp.power)
    if policy == "sigmoid":
        return base * (1.0 / (1.0 + math.exp(-float(sp.gamma) * (it - float(sp.stepsize)))))
    raise ValueError(f"unknown lr policy {policy!r}")


def init_history(solver_type: str, params: Tree) -> Dict[str, Tree]:
    """Zeroed history slots ``{"h0": tree, ...}`` shaped like ``params``."""
    return {f"h{i}": {k: [torch.zeros_like(p) for p in v] for k, v in params.items()}
            for i in range(HISTORY_SLOTS[solver_type])}


def make_update_fn(solver_type: str, sp: View, lr_mults: Dict[str, List[float]],
                   decay_mults: Dict[str, List[float]]):
    """``update(params, grads, history, lr, it)``: applies one iteration's
    update to the ``params`` and ``history`` trees in place.  ``grads``
    holds each parameter's accumulated diff (None where there is none)."""
    if solver_type not in HISTORY_SLOTS:
        raise ValueError(f"unknown solver type {solver_type!r}")
    momentum = float(sp.momentum) if sp.has("momentum") else 0.0
    momentum2 = float(sp.momentum2)
    delta = float(sp.delta)
    rms_decay = float(sp.rms_decay) if sp.has("rms_decay") else 0.99
    weight_decay = float(sp.weight_decay) if sp.has("weight_decay") else 0.0
    reg_type = sp.regularization_type
    clip = float(sp.clip_gradients)
    iter_size = int(sp.iter_size)

    @torch.no_grad()
    def update(params: Tree, grads: Dict[str, List[Optional[torch.Tensor]]],
               history: Dict[str, Tree], lr: float, it: int) -> None:
        lr32 = np.float32(lr)
        g_all = {name: [g if (g is not None and lm) else torch.zeros_like(p)
                        for p, g, lm in zip(params[name], grads[name], lr_mults[name])]
                 for name in params}
        if clip > 0:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for gs in g_all.values() for g in gs))
            scale = torch.where(gnorm > clip, clip / gnorm, torch.ones_like(gnorm))
        if solver_type == "Adam":
            t = torch.tensor(it + 1, dtype=torch.float32)
            m1, m2 = torch.tensor(momentum), torch.tensor(momentum2)
            correction = float(torch.sqrt(1.0 - m2 ** t) / (1.0 - m1 ** t))
        for name, ps in params.items():
            for i, p in enumerate(ps):
                g = g_all[name][i]
                if clip > 0:
                    g = g * scale
                if iter_size != 1:
                    g = g / iter_size
                wd = weight_decay * decay_mults[name][i]
                if reg_type == "L2":
                    g = g + wd * p
                elif reg_type == "L1":
                    g = g + wd * torch.sign(p)
                rate = float(lr32 * np.float32(lr_mults[name][i]))
                h = history["h0"][name][i]
                if solver_type == "SGD":
                    v = momentum * h + rate * g
                    p.sub_(v)
                    h.copy_(v)
                elif solver_type == "Nesterov":
                    v = momentum * h + rate * g
                    p.sub_((1 + momentum) * v - momentum * h)
                    h.copy_(v)
                elif solver_type == "AdaGrad":
                    h.add_(g * g)
                    p.sub_(rate * g / (torch.sqrt(h) + delta))
                elif solver_type == "RMSProp":
                    h.copy_(rms_decay * h + (1 - rms_decay) * g * g)
                    p.sub_(rate * g / (torch.sqrt(h) + delta))
                elif solver_type == "AdaDelta":
                    # momentum is the decay; Caffe accumulates the update's
                    # square before the rate
                    h2 = history["h1"][name][i]
                    h.copy_(momentum * h + (1 - momentum) * g * g)
                    raw = g * torch.sqrt((h2 + delta) / (h + delta))
                    h2.copy_(momentum * h2 + (1 - momentum) * raw * raw)
                    p.sub_(rate * raw)
                else:  # Adam
                    v2 = history["h1"][name][i]
                    h.copy_(momentum * h + (1 - momentum) * g)
                    v2.copy_(momentum2 * v2 + (1 - momentum2) * g * g)
                    step_rate = float(np.float32(rate) * np.float32(correction))
                    p.sub_(step_rate * h / (torch.sqrt(v2) + delta))

    return update


def _parse_solver(solver_param) -> Dict[str, Any]:
    if isinstance(solver_param, str):
        if "\n" in solver_param or ":" in solver_param:
            return prototxt.parse(solver_param, "SolverParameter")
        return prototxt.parse_file(solver_param, "SolverParameter")
    return dict(solver_param)


class Solver:
    """The training loop: Step, test nets, snapshot and restore
    (Solver::Step, solver.cpp:194-327).  ``next_batch(it) -> {blob: numpy
    array or tensor}`` feeds it, or a :class:`~.datasets.StagedBatch`
    already on the device; a net with data layers feeds itself from ``{}``.

    ``test_nets``: ``[(net, data_fn or None, test_iter), ...]``, a TEST net
    each; ``data_fn(it) -> {blob: array}`` feeds one that has no data
    layers of its own.

    ``input_transform``: ``fn({blob: tensor}) -> {blob: tensor}`` run on the
    device inside each step before the net, e.g. the CPM labels rasterized
    from augmented joints (``labels_device.make_input_transform``)."""

    def __init__(self, solver_param, net, next_batch: Callable[[int], Dict[str, Any]],
                 test_nets: Optional[List] = None,
                 input_transform: Optional[Callable] = None, mesh=None):
        self.sp_msg = _parse_solver(solver_param)
        self.sp = caffe_pb.view(self.sp_msg, "SolverParameter")
        if mesh is not None:
            from ..parallel.dp import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh: a parallel.dp.Mesh, got {type(mesh).__name__}")
        self.mesh = mesh
        self.net = net
        self.next_batch = next_batch
        self.input_transform = input_transform
        self.type = self.sp.type if self.sp.has("type") else "SGD"
        self.it = 0
        self.current_step = 0
        self.params: Tree = {}
        self.lr_mults: Dict[str, List[float]] = {}
        self.decay_mults: Dict[str, List[float]] = {}
        for name, _, prm, lr, dm in net.learnable():
            self.params.setdefault(name, []).append(prm)
            self.lr_mults.setdefault(name, []).append(lr)
            self.decay_mults.setdefault(name, []).append(dm)
        if mesh is not None:
            from ..parallel.dp import replicate

            replicate(mesh, self.params)
            net.params_changed()
        self.history = init_history(self.type, self.params)
        self.test_nets: List[Tuple[Any, Optional[Callable], int]] = list(test_nets or [])
        # BatchNorm layers that normalize by the batch: (maf, m) for the roll
        self._bn = {name: (mod.maf, mod.count) for name, mod in net.mods.items()
                    if mod.type == "BatchNorm" and not mod.use_global}
        self._update = make_update_fn(self.type, self.sp, self.lr_mults, self.decay_mults)
        # output blobs of the most recent training forward (Solver::Step's
        # display, pycaffe's read-after-step)
        self.last_outputs: Dict[str, torch.Tensor] = {}
        self.smoothed_losses: List[float] = []

    def _inputs(self, batch) -> Tuple[Dict[str, torch.Tensor], Any]:
        """One batch on the device, through the input transform, and the
        sharded layout its forward runs with (None on one device)."""
        if isinstance(batch, StagedBatch):
            if self.mesh is not None:
                raise ValueError("stage_batches targets a single device; use the plain "
                                 "prefetch ring with a mesh (the step places the batch)")
            inputs = dict(batch.wait())
        elif self.mesh is not None:
            return self._place(batch)
        else:
            dev = self.net.device
            inputs = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
                      .to(dev) for k, v in batch.items()}
        return (inputs if self.input_transform is None else self.input_transform(inputs)), None

    def _place(self, batch):
        """This rank's piece of the global batch and its layout
        (``mesh2d.place_batch``); keeps the layout and the axes its
        gradients reduce over."""
        from ..parallel.mesh2d import place_batch

        inputs, self._shard, self._sums, self._means = place_batch(self.mesh, {
            k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in batch.items()},
            transform=self.input_transform)
        return inputs, self._shard

    def step(self, iters: int = 1, callback=None) -> float:
        """Run ``iters`` iterations; returns the last loss."""
        loss_val = float("nan")
        iter_size = int(self.sp.iter_size)
        interval = int(self.sp.test_interval) if self.sp.has("test_interval") else 0
        for _ in range(iters):
            if (self.test_nets and interval and self.it % interval == 0
                    and (self.it > 0 or bool(self.sp.test_initialization))):
                self.test_all()
            lr = learning_rate(self.sp, self.it)
            for ps in self.params.values():
                for p in ps:
                    p.grad = None
            total = None
            for _sub in range(iter_size):
                inputs, shard = self._inputs(self.next_batch(self.it))
                aux = {} if self._bn else None
                loss, outs = self.net.loss(inputs, aux=aux, shard=shard)
                loss.backward()  # diffs accumulate over iter_size, as Caffe's
                if aux:
                    self._bn_roll(aux)
                self.last_outputs = {k: v.detach() for k, v in outs.items()}
                total = loss.detach() if total is None else total + loss.detach()
            grads = {name: [p.grad for p in ps] for name, ps in self.params.items()}
            if self.mesh is not None:
                from ..parallel.mesh2d import reduce_grads

                total = total.reshape(1).clone()
                reduce_grads(self.mesh, self._shard, grads, [total], self._sums, self._means)
            self._update(self.params, grads, self.history, lr, self.it)
            self.net.params_changed()
            loss_val = float(total) / iter_size
            self.smoothed_losses.append(loss_val)
            if len(self.smoothed_losses) > int(self.sp.average_loss):
                self.smoothed_losses.pop(0)
            self.it += 1
            if callback is not None:
                callback(self)
            if (self.sp.snapshot and self.it % int(self.sp.snapshot) == 0
                    and self.sp.snapshot_prefix and (self.mesh is None or self.mesh.rank == 0)):
                self.snapshot()
        return loss_val

    @torch.no_grad()
    def _bn_roll(self, stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> None:
        """Roll each BatchNorm layer's running statistics with one forward's
        batch mean and variance, as the JAX ``Solver._bn_roll``."""
        blobs = self.net.layer_blobs()
        for name, (mu, var) in stats.items():
            maf, m = self._bn[name]
            mean_b, var_b, scale_b = blobs[name]
            corr = m / (m - 1) if m > 1 else 1.0
            mean_b.copy_(mu + maf * mean_b)
            var_b.copy_(corr * var + maf * var_b)
            scale_b.copy_(scale_b * maf + 1.0)

    def test_all(self) -> Dict[str, float]:
        """Run every test net (Solver::TestAll); returns ``{blob: mean}`` of
        the last."""
        scores: Dict[str, float] = {}
        for i in range(len(self.test_nets)):
            scores = self.test(i)
        return scores

    @torch.no_grad()
    def test(self, test_net_id: int = 0) -> Dict[str, float]:
        """Solver::Test (solver.cpp:337-380): the train net's blobs shared by
        layer name, each output blob's mean averaged over ``test_iter``
        forwards."""
        net, data_fn, test_iter = self.test_nets[test_net_id]
        print(f"Iteration {self.it}, Testing net (#{test_net_id})")
        net.share_with(self.net)
        n = max(1, int(test_iter))
        totals: Dict[str, float] = {}
        for _ in range(n):
            inputs = data_fn(self.it) if data_fn is not None else {}
            feed = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                    .to(net.device) for k, v in inputs.items()}
            for k, v in net.forward(feed).items():
                totals[k] = totals.get(k, 0.0) + float(v.float().mean())
        means = {k: v / n for k, v in totals.items()}
        for j, (k, v) in enumerate(sorted(means.items())):
            print(f"    Test net output #{j}: {k} = {v:.6g}")
        return means

    def train_outputs(self) -> Dict[str, np.ndarray]:
        """Output blobs of the last training forward as numpy (Caffe
        layout), without another forward."""
        return {k: v.float().cpu().numpy() for k, v in self.last_outputs.items()}

    def display_outputs(self) -> None:
        """The reference's per-display result lines (solver.cpp:250-261):
        one a blob element, with ``(* w = contribution loss)`` for
        loss-weighted tops."""
        weights = dict(self.net.loss_tops())
        outs = self.train_outputs()
        j = 0
        for name in self.net.output_names():
            if name not in outs:
                continue
            w = weights.get(name, 0.0)
            for v in np.asarray(outs[name], np.float32).reshape(-1)[:8]:
                suffix = f" (* {w:g} = {w * float(v):g} loss)" if w else ""
                print(f"    Train net output #{j}: {name} = {float(v):g}{suffix}")
                j += 1

    @property
    def iter(self) -> int:
        return self.it

    def solve(self) -> None:
        """Run to max_iter (Solver::Solve, solver.cpp:279)."""
        max_iter = int(self.sp.max_iter) if self.sp.has("max_iter") else 0
        while self.it < max_iter:
            self.step(1)

    @property
    def smoothed_loss(self) -> float:
        return float(np.mean(self.smoothed_losses)) if self.smoothed_losses else float("nan")

    # --------------------------------------------------- snapshot/restore

    def _history_arrays(self) -> List[np.ndarray]:
        """History in Caffe's order (slots, layers, blobs), Caffe layout."""
        return [h.detach().cpu().numpy() for key in sorted(self.history)
                for hs in self.history[key].values() for h in hs]

    def _load_history_arrays(self, blobs: List[np.ndarray]) -> None:
        arrays = iter(blobs)
        with torch.no_grad():
            for key in sorted(self.history):
                for hs in self.history[key].values():
                    for h in hs:
                        h.copy_(torch.from_numpy(
                            np.array(next(arrays), np.float32).reshape(tuple(h.shape))))

    def snapshot(self, prefix: Optional[str] = None) -> Tuple[str, str]:
        """Write ``<prefix>_iter_<it>.caffemodel`` and ``.solverstate``
        (Solver::Snapshot, solver.cpp:412), or with ``snapshot_format: HDF5``
        the ``.h5`` pair (sgd_solver.cpp:246-279).  Each file is written
        to a temporary name and renamed, so a crash leaves no torn file."""
        prefix = prefix or self.sp.snapshot_prefix
        if int(self.sp.snapshot_format) == 0:  # HDF5
            return self._snapshot_hdf5(prefix)
        model_path = f"{prefix}_iter_{self.it}.caffemodel"
        state_path = f"{prefix}_iter_{self.it}.solverstate"
        self.net.save_caffemodel(model_path + ".tmp")
        os.replace(model_path + ".tmp", model_path)
        caffemodel.save_solver_state(
            {"iter": self.it, "learned_net": model_path,
             "history": [caffemodel.array_to_blob(a) for a in self._history_arrays()],
             "current_step": self.current_step},
            state_path + ".tmp")
        os.replace(state_path + ".tmp", state_path)
        return model_path, state_path

    def restore(self, state_path: str) -> None:
        """Resume from a ``.solverstate`` (or ``.solverstate.h5``): the
        iteration, the weights of its ``learned_net`` and the history."""
        if state_path.endswith((".h5", ".hdf5")):
            return self._restore_hdf5(state_path)
        st = caffemodel.load_solver_state(state_path)
        sv = caffe_pb.view(st, "SolverState")
        self.it = int(sv.iter)
        self.current_step = int(sv.current_step)
        if sv.has("learned_net"):
            self.net.load_weights(sv.learned_net)
        self._load_history_arrays([caffemodel.blob_to_array(b) for b in st.get("history", [])])

    def _snapshot_hdf5(self, prefix: str) -> Tuple[str, str]:
        model_path = f"{prefix}_iter_{self.it}.caffemodel.h5"
        state_path = f"{prefix}_iter_{self.it}.solverstate.h5"
        self.net.save_hdf5(model_path + ".tmp")
        os.replace(model_path + ".tmp", model_path)
        with hdf5.File(state_path + ".tmp", "w") as f:
            f["iter"] = np.int64(self.it)
            f["learned_net"] = model_path
            f["current_step"] = np.int64(self.current_step)
            hist = f.create_group("history")
            for i, arr in enumerate(self._history_arrays()):
                hist[str(i)] = arr.astype(np.float32)
        os.replace(state_path + ".tmp", state_path)
        return model_path, state_path

    def _restore_hdf5(self, state_path: str) -> None:
        """JAX's and h5py's form (int64 scalars, a variable-length UTF-8
        ``learned_net``) or Caffe's C++ one (int32 of dims [1], a fixed-length
        null-terminated string)."""
        with hdf5.File(state_path, "r") as f:
            self.it = int(np.asarray(f["iter"]).item())
            self.current_step = int(np.asarray(f["current_step"]).item())
            learned = f["learned_net"][()]
            if isinstance(learned, bytes):
                learned = learned.decode()
            blobs = [np.asarray(f["history"][str(i)]) for i in range(len(f["history"]))]
        if learned:
            self.net.load_hdf5(learned)
        self._load_history_arrays(blobs)
