"""The loss layer types, Accuracy and Softmax of the port's registry
against JAX (``torch_zoo.run_case``: forward within 1e-5·max(1,|y|),
accuracies exactly, gradients within 1e-4 of each blob's largest), one
small net a case on the CPU; a loss top's diff is its loss weight's role."""

import numpy as np
import pytest

from torch_zoo import Case, rnd, run_case

LOGITS = rnd(6, 5, seed=1)
LABELS = np.array([0, 4, 2, 2, 1, 3], np.float32)
SPATIAL = rnd(2, 4, 3, 2, seed=2)
SP_LABELS = np.random.RandomState(3).randint(0, 4, (2, 1, 3, 2)).astype(np.float32)


def loss(t, bottoms, inputs, param=None, key=None, no_grad=("label",), **kw):
    layer = {"name": "l", "type": t, "bottom": bottoms, "top": ["loss"]}
    if param is not None:
        layer[key] = param
    return Case(f"{t}-{param}", [layer], inputs, no_grad=no_grad, **kw)


def softmax_loss(param=None, key=None, logits=LOGITS, labels=LABELS):
    return loss("SoftmaxWithLoss", ["x", "label"], {"x": logits, "label": labels}, param, key)


PROBS = np.random.RandomState(4).dirichlet(np.ones(5), 6).astype(np.float32)

CASES = [
    softmax_loss(),
    softmax_loss(logits=SPATIAL, labels=SP_LABELS),
    softmax_loss({"ignore_label": 2}, "loss_param"),
    softmax_loss({"normalization": 3}, "loss_param"),
    softmax_loss({"normalize": False}, "loss_param", logits=SPATIAL, labels=SP_LABELS),
    loss("EuclideanLoss", ["x", "t"], {"x": SPATIAL, "t": rnd(2, 4, 3, 2, seed=5)}, no_grad=()),
    loss("EuclideanmaskLoss", ["x", "t", "m"],
         {"x": SPATIAL, "t": rnd(2, 4, 3, 2, seed=5),
          "m": (np.random.RandomState(6).rand(2, 4, 1, 1) > 0.5).astype(np.float32)},
         no_grad=("m",)),
    loss("SigmoidCrossEntropyLoss", ["x", "t"],
         {"x": SPATIAL, "t": (rnd(2, 4, 3, 2, seed=7) > 0).astype(np.float32)}, no_grad=("t",)),
    loss("HingeLoss", ["x", "label"], {"x": LOGITS, "label": LABELS}),
    loss("HingeLoss", ["x", "label"], {"x": LOGITS, "label": LABELS}, {"norm": 2},
         "hinge_loss_param"),
    loss("MultinomialLogisticLoss", ["x", "label"], {"x": PROBS, "label": LABELS}),
    loss("ContrastiveLoss", ["a", "b", "y"],
         {"a": rnd(6, 3, seed=8), "b": rnd(6, 3, seed=9),
          "y": np.array([1, 0, 1, 0, 0, 1], np.float32)}, {"margin": 2.0},
         "contrastive_loss_param", no_grad=("y",)),
    loss("ContrastiveLoss", ["a", "b", "y"],
         {"a": rnd(6, 3, seed=8), "b": rnd(6, 3, seed=9),
          "y": np.array([1, 0, 1, 0, 0, 1], np.float32)},
         {"margin": 2.0, "legacy_version": True}, "contrastive_loss_param", no_grad=("y",)),
    loss("InfogainLoss", ["x", "label", "h"],
         {"x": PROBS, "label": LABELS, "h": np.abs(rnd(5, 5, seed=10))}),
    Case("Accuracy", [{"name": "l", "type": "Accuracy", "bottom": ["x", "label"],
                       "top": ["acc"], "accuracy_param": {"top_k": 2}}],
         {"x": LOGITS, "label": LABELS}, int_tops=("acc",), grads=False),
    Case("Accuracy-per-class-ignore",
         [{"name": "l", "type": "Accuracy", "bottom": ["x", "label"], "top": ["acc", "cls"],
           "accuracy_param": {"ignore_label": 1}}],
         {"x": SPATIAL, "label": SP_LABELS}, int_tops=("acc", "cls"), grads=False),
    Case("Softmax", [{"name": "l", "type": "Softmax", "bottom": ["x"], "top": ["y"]}],
         {"x": SPATIAL}),
    Case("Softmax-axis", [{"name": "l", "type": "Softmax", "bottom": ["x"], "top": ["y"],
                           "softmax_param": {"axis": 2}}], {"x": SPATIAL}),
]


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_loss_layer_matches_jax(case):
    run_case(case)


def test_infogain_from_a_source_file(tmp_path):
    """InfogainLoss with its H matrix from ``source`` (an .npy) equals the
    three-bottom form."""
    h = np.abs(rnd(5, 5, seed=10))
    np.save(tmp_path / "h.npy", h)
    run_case(loss("InfogainLoss", ["x", "label"], {"x": PROBS, "label": LABELS},
                  {"source": str(tmp_path / "h.npy")}, "infogain_loss_param"))
