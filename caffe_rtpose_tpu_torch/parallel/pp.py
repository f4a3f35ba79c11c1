"""Pipeline parallelism over the CPM refinement stages (GPipe).

Counterpart of ``caffe_rtpose_tpu/parallel/pp.py``.  Stages 2..K of the CPM
net are the same dual-branch block with different weights, so the stage
weights stack over a leading ``stage`` axis and rank d of the ``stage``
axis holds stage d's weights alone.  Microbatches flow rank to rank by
point-to-point sends (JAX: ``ppermute``) on the static GPipe schedule:
step t, rank d works on microbatch t - d, so M microbatches drain in
M + S - 1 steps.  The trunk features travel with the activations, as in
JAX.

:func:`make_pp_train_step` adds the backward schedule (the activations'
gradients flow back rank d -> d - 1; JAX gets it from ``jax.grad`` through
``ppermute``) and a plain SGD update of each rank's own stage, with no
gradient collective: the stages' weights are disjoint.  The updated stack
is all-gathered so every rank returns it whole, as JAX's replicated output.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .dp import Mesh

OUTPUTS = ("Mconv7_L1", "Mconv7_L2")


def make_refine_stage_net(n_paf: int = 38, n_heat: int = 19, hw: Tuple[int, int] = (46, 82),
                          feat_ch: int = 128, width: int = 128, device="cuda"):
    """One generic refinement stage as its own Net: inputs ``prev_L1``,
    ``prev_L2``, ``feat``; outputs ``Mconv7_L1``, ``Mconv7_L2``.  Layer
    names are the full net's without ``_stage{t}``, so a stage's parameters
    map by name; ``width`` narrows the convolutions for small tests."""
    from ..core.net import Net
    from ..models.cpm import _conv, _relu

    h, w = hw
    layers: List[Dict[str, Any]] = [{
        "name": "concat", "type": "Concat", "bottom": ["prev_L1", "prev_L2", "feat"],
        "top": ["concat"], "concat_param": {"axis": 1},
    }]
    b = {"L1": "concat", "L2": "concat"}
    for i in range(1, 6):
        for br in ("L1", "L2"):
            name = f"Mconv{i}_{br}"
            layers.append(_conv(name, b[br], width, 7, 3))
            layers.append(_relu(f"Mrelu{i}_{br}", name))
            b[br] = name
    for br in ("L1", "L2"):
        name = f"Mconv6_{br}"
        layers.append(_conv(name, b[br], width, 1, 0))
        layers.append(_relu(f"Mrelu6_{br}", name))
        b[br] = name
    for br, nout in (("L1", n_paf), ("L2", n_heat)):
        layers.append(_conv(f"Mconv7_{br}", b[br], nout, 1, 0))
    net_param = {
        "input": ["prev_L1", "prev_L2", "feat"],
        "input_shape": [{"dim": [1, n_paf, h, w]}, {"dim": [1, n_heat, h, w]},
                        {"dim": [1, feat_ch, h, w]}],
        "layer": layers,
    }
    return Net(net_param, phase="TEST", seed=0, device=device)


def stack_stage_params(full_params: Mapping[str, Sequence[Any]], stages: Sequence[int]
                       ) -> Dict[str, List[np.ndarray]]:
    """The full net's per-stage weights (``{layer: [OIHW, bias]}``, numpy or
    tensors) stacked over a leading stage axis, keyed by the generic layer
    names (numpy)."""
    out: Dict[str, List[np.ndarray]] = {}
    for i in range(1, 8):
        for br in ("L1", "L2"):
            per = [full_params[f"Mconv{i}_stage{t}_{br}"] for t in stages]
            out[f"Mconv{i}_{br}"] = [np.stack([_np(p[j]) for p in per]) for j in range(len(per[0]))]
    return out


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _stage_ops(p: Mapping[str, Sequence[torch.Tensor]]) -> Dict[str, torch.Tensor]:
    ops = {}
    for k, (w, b) in p.items():
        ops[f"{k}::w"], ops[f"{k}::b"] = w, b
    return ops


def _apply(stage_net, p, l1, l2, feat):
    out = stage_net.forward({"prev_L1": l1, "prev_L2": l2, "feat": feat},
                            outputs=list(OUTPUTS), operands=_stage_ops(p))
    return out[OUTPUTS[0]], out[OUTPUTS[1]]


def _own_stage(stacked, d: int, device, grad: bool) -> Dict[str, List[torch.Tensor]]:
    return {k: [torch.as_tensor(_np(a)[d]).to(device).requires_grad_(grad) for a in v]
            for k, v in stacked.items()}


def _gpipe_forward(mesh: Mesh, axis: str, stage_net, p, l1_0, l2_0, feat, keep: bool):
    """Rank d's part of the GPipe forward.  Returns the last stage's
    outputs by microbatch (on the last rank) and, with ``keep``, each
    microbatch's (inputs, outputs) for the backward."""
    S, d = mesh.n(axis), mesh.index(axis)
    ranks = mesh.ranks(axis)
    M = l1_0.shape[0]
    dev = mesh.device
    outs, saved = {}, {}
    for t in range(M + S - 1):
        m = t - d
        if not 0 <= m < M:
            continue
        if d == 0:
            x1, x2, ft = (a[m].to(dev) for a in (l1_0, l2_0, feat))
        else:
            x1, x2, ft = (mesh.recv(a[m].to(dev), ranks[d - 1]) for a in (l1_0, l2_0, feat))
        if keep:
            x1, x2 = x1.requires_grad_(d > 0), x2.requires_grad_(d > 0)
        with torch.set_grad_enabled(keep):
            y1, y2 = _apply(stage_net, p, x1, x2, ft)
        if d < S - 1:
            for y in (y1, y2, ft):
                mesh.send(y.detach(), ranks[d + 1])
        else:
            outs[m] = (y1, y2)
        if keep:
            saved[m] = ((x1, x2), (y1, y2))
    return outs, saved


def pipeline_refine(mesh: Mesh, stage_net, stacked_params, l1_0, l2_0, feat,
                    axis: str = "stage") -> Tuple[torch.Tensor, torch.Tensor]:
    """M microbatches through S pipelined stages (S = the ``stage`` axis).
    ``l1_0``, ``l2_0``: [M, 1, C, h, w] stage-1 branch outputs; ``feat``:
    [M, 1, 128, h, w] trunk features (Caffe layout); ``stacked_params``:
    :func:`stack_stage_params` of S stages (rank d takes stage d).  Returns
    the last stage's (L1, L2) for every microbatch, [M, ...], on every rank."""
    S = mesh.n(axis)
    d = mesh.index(axis)
    p = _own_stage(stacked_params, d, mesh.device, False)
    l1_0, l2_0, feat = (torch.as_tensor(_np(a)) for a in (l1_0, l2_0, feat))
    with torch.no_grad():
        outs, _ = _gpipe_forward(mesh, axis, stage_net, p, l1_0, l2_0, feat, keep=False)
        shapes = [(l1_0.shape[0], 1, stage_net.blob_shapes[o][1], *l1_0.shape[-2:])
                  for o in OUTPUTS]
        res = [torch.zeros(s, device=mesh.device) for s in shapes]
        if d == S - 1:
            for m, ys in outs.items():
                for r, y in zip(res, ys):
                    r[m] = y
        last = mesh.ranks(axis)[S - 1]
        for r in res:
            mesh.broadcast(r, last)
    return res[0], res[1]


def _euclidean(o, t, M):
    return (torch.sum((o - t) ** 2)) / (2 * M)


def make_pp_train_step(mesh: Mesh, stage_net, M: int, lr: float = 0.01, axis: str = "stage"):
    """A training step through the GPipe schedule: ``step(stacked, l1, l2,
    feat, t1, t2) -> (loss, new stacked)`` with numpy or tensor inputs as
    :func:`pipeline_refine`'s and targets ``t1``, ``t2`` like its outputs.
    Loss: Caffe's EuclideanLoss on the last stage's two branches,
    (sum (o1 - t1)^2 + sum (o2 - t2)^2) / (2 M); backward through the
    reverse schedule; SGD ``p - lr * g`` on each rank's own stage."""
    S, d = mesh.n(axis), mesh.index(axis)
    ranks = mesh.ranks(axis)

    def step(stacked, l1, l2, feat, t1, t2):
        p = _own_stage(stacked, d, mesh.device, True)
        l1, l2, feat, t1, t2 = (torch.as_tensor(_np(a)) for a in (l1, l2, feat, t1, t2))
        outs, saved = _gpipe_forward(mesh, axis, stage_net, p, l1, l2, feat, keep=True)
        loss = torch.zeros((), device=mesh.device)
        # the backward schedule: the last stage first, microbatches in order
        for m in range(M):
            (x1, x2), (y1, y2) = saved[m]
            if d == S - 1:
                lm = (_euclidean(y1, t1[m].to(mesh.device), M)
                      + _euclidean(y2, t2[m].to(mesh.device), M))
                lm.backward()
                loss = loss + lm.detach()
            else:
                g1, g2 = (mesh.recv(y.detach(), ranks[d + 1]) for y in (y1, y2))
                torch.autograd.backward([y1, y2], [g1, g2])
            if d > 0:
                for x in (x1, x2):
                    mesh.send(x.grad, ranks[d - 1])
        mesh.broadcast(loss, ranks[S - 1])
        new = {}
        with torch.no_grad():
            for k, v in p.items():
                new[k] = [torch.stack(mesh.all_gather(a - lr * a.grad, axis)) for a in v]
        return float(loss), new

    return step


def monolithic_train_step(stage_net, S: int, lr: float = 0.01, device="cuda"):
    """The one-device reference of :func:`make_pp_train_step`: the same
    stacked weights run stage after stage, the same loss and SGD update."""

    def step(stacked, l1, l2, feat, t1, t2):
        ps = [_own_stage(stacked, t, device, True) for t in range(S)]
        l1, l2, feat, t1, t2 = (torch.as_tensor(_np(a)).to(device) for a in (l1, l2, feat, t1, t2))
        M = l1.shape[0]
        loss = torch.zeros((), device=device)
        for m in range(M):
            c1, c2 = l1[m], l2[m]
            for p in ps:
                c1, c2 = _apply(stage_net, p, c1, c2, feat[m])
            loss = loss + _euclidean(c1, t1[m], M) + _euclidean(c2, t2[m], M)
        loss.backward()
        with torch.no_grad():
            new = {k: [torch.stack([ps[t][k][j] - lr * ps[t][k][j].grad for t in range(S)])
                       for j in range(len(v))] for k, v in ps[0].items()}
        return float(loss.detach()), new

    return step
