"""The layer zoo's harness: one small net a case, run through the JAX
``api.Net`` (forward, then ``jax.grad`` of sum(top * diff) in its
``backward``) and through the port's ``core.net.Net`` on the CPU (forward,
then autograd in ``Net.backward``), from the same numpy-seeded inputs and the
same parameter blobs in Caffe's layout.

Tolerances, each stated where it is checked:
- forward: |port - jax| <= 1e-5 * max(1, |jax|) elementwise;
- integer tops (indices, accuracies, filtered counts): exactly equal;
- gradients of the inputs and of every parameter blob: |port - jax| <= 1e-4
  * the blob's largest |jax| (1e-6 when that is zero).

Also the user layer the ``Python`` type's cases load (``module:
"torch_zoo"``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

TOL_FWD = 1e-5
TOL_GRAD = 1e-4


@dataclass
class Case:
    """``layers``: the case's layer dicts (their inputs are the net's
    inputs); ``inputs``: {name: array}; ``int_tops``: tops compared exactly;
    ``no_grad``: inputs whose diffs are not compared (labels, indices);
    ``weights``: {layer: [blob, ...]} (default: seeded normals of the JAX
    blobs' Caffe shapes); ``grads``: False for types without a gradient."""

    id: str
    layers: List[Dict[str, Any]]
    inputs: Dict[str, np.ndarray]
    phase: str = "TEST"
    int_tops: Sequence[str] = ()
    no_grad: Sequence[str] = ()
    weights: Optional[Dict[str, List[np.ndarray]]] = None
    grads: bool = True
    tops: Optional[Sequence[str]] = None


def rnd(*shape, seed=0, scale=1.0, offset=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + offset).astype(np.float32)


def proto_of(case: Case) -> Dict[str, Any]:
    names = list(case.inputs)
    return {"name": case.id, "input": names,
            "input_shape": [{"dim": list(case.inputs[n].shape)} for n in names],
            "layer": case.layers}


def _tops(case: Case) -> List[str]:
    if case.tops is not None:
        return list(case.tops)
    return list(dict.fromkeys(t for l in case.layers for t in l.get("top", [])))


def _weights(jnet, case: Case) -> Dict[str, List[np.ndarray]]:
    if case.weights is not None:
        return case.weights
    rs = np.random.RandomState(17)
    return {impl.name: [(rs.randn(*pi.caffe_shape) * 0.5).astype(np.float32)
                        for pi in impl.params]
            for impl in jnet._net.impls if impl.params}


def _close(name, got, ref, tol_of):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref)
    tol = tol_of(ref)
    assert np.all(err <= tol), (name, float(err.max()), float(np.max(tol)))


def fwd_tol(ref):
    return TOL_FWD * np.maximum(1.0, np.abs(ref))


def grad_tol(ref):
    return TOL_GRAD * max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-6)


def run_case(case: Case):
    """Build both nets, compare every top and, unless ``grads`` is off, the
    gradients of every float input and parameter blob.  Returns (jax facade,
    port net, port tops)."""
    from caffe_rtpose_tpu import api as japi

    from caffe_rtpose_tpu_torch.core.net import Net

    proto = proto_of(case)
    jnet = japi.Net(proto, case.phase)
    weights = _weights(jnet, case)
    if weights:
        jnet._net.load_weights(weights)
        jnet._refresh_params()
    jnet.forward(**{k: v.copy() for k, v in case.inputs.items()})
    tnet = Net(proto, phase=case.phase, device="cpu")
    if weights:
        assert tnet.load_weights(weights) == len(weights)
    tops = _tops(case)
    feed = {k: torch.from_numpy(v.copy()) for k, v in case.inputs.items()}
    with torch.no_grad():
        got = {k: v.float().numpy() for k, v in tnet.forward(feed, outputs=tops).items()}
    for t in tops:
        ref = np.asarray(jnet.blobs[t].data)
        if t in case.int_tops:
            np.testing.assert_array_equal(got[t], ref, err_msg=t)
        else:
            _close(t, got[t], ref, fwd_tol)
    if not case.grads:
        return jnet, tnet, got
    rs = np.random.RandomState(5)
    diffs = {t: np.asarray(rs.randn(*np.shape(got[t])), np.float32) for t in tops
             if t not in case.int_tops}
    jin = jnet.backward(**diffs)
    tin, tparams = tnet.backward(feed, diffs)
    for name in case.inputs:
        if name in case.no_grad:
            continue
        _close(f"d{name}", tin[name].numpy(), jin[name], grad_tol)
    for name, blobs in jnet.params.items():
        for i, b in enumerate(blobs):
            _close(f"d{name}[{i}]", tparams[name][i].numpy(), b.diff, grad_tol)
    return jnet, tnet, got


class ScaleShiftLayer:
    """A Python layer: top = 2 * bottom + 1, its backward 2 * top diff."""

    def setup(self, bottom, top):
        self.k = float(self.param_str or 2.0)

    def reshape(self, bottom, top):
        top[0].reshape(*bottom[0].shape)

    def forward(self, bottom, top):
        top[0].data = self.k * bottom[0].data + 1.0

    def backward(self, top, propagate_down, bottom):
        bottom[0].diff = self.k * top[0].diff
