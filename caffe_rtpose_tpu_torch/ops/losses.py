"""Loss ops with Caffe semantics (reference src/caffe/layers/*_loss_layer.cpp).

Counterpart of ``caffe_rtpose_tpu/ops/losses.py``, in plain torch and
differentiable by autograd.  Activations are logically NCHW (Caffe layout),
so a channel axis is axis 1 unless a caller says otherwise.  As in JAX, each
residual and every sum is taken in f32 whatever the inputs' dtype: a bf16
subtraction would round the residual that is then squared.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def euclidean(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """EuclideanLoss: sum((a - b)^2) / (2 N), N the batch
    (euclidean_loss_layer.cpp)."""
    diff = _f32(pred) - _f32(target)
    return torch.sum(diff * diff) / (2.0 * pred.shape[0])


def euclidean_masked(pred: torch.Tensor, target: torch.Tensor, mask_nc: torch.Tensor,
                     channel_axis: int = 1) -> torch.Tensor:
    """EuclideanmaskLoss (euclideanmask_loss_layer.cpp): a per-(sample,
    channel) 0/1 gate from ``mask_nc`` (N, C); the last ("background")
    channel always counts."""
    n, c = pred.shape[0], pred.shape[channel_axis]
    gate = (mask_nc.reshape(n, c) != 0).to(torch.float32)
    gate = torch.cat([gate[:, : c - 1], torch.ones_like(gate[:, :1])], dim=1)
    shape = [1] * pred.dim()
    shape[0], shape[channel_axis] = n, c
    diff = (_f32(pred) - _f32(target)) * gate.reshape(shape)
    return torch.sum(diff * diff) / (2.0 * n)


def softmax_cross_entropy(logits2d: torch.Tensor, labels: torch.Tensor,
                          ignore_label: Optional[int] = None, normalization: str = "VALID",
                          batch_size: int = 0) -> torch.Tensor:
    """SoftmaxWithLoss over flattened (M, C) logits and (M,) int labels;
    ``batch_size`` is the outer N before spatial flattening (BATCH_SIZE
    normalization, softmax_loss_layer.cpp outer_num_)."""
    m = logits2d.shape[0]
    logp = F.log_softmax(_f32(logits2d), dim=-1)
    lab = labels.to(torch.int64)
    if ignore_label is not None:
        valid = lab != ignore_label
        ll = torch.gather(logp, 1, torch.where(valid, lab, 0)[:, None])[:, 0]
        ll = torch.where(valid, ll, torch.zeros_like(ll))
        count = valid.sum()
    else:
        ll = torch.gather(logp, 1, lab[:, None])[:, 0]
        count = m
    total = -torch.sum(ll)
    if normalization == "NONE":
        return total
    if normalization == "FULL":
        return total / m
    if normalization == "BATCH_SIZE":
        return total / (batch_size or m)
    return total / torch.clamp(torch.as_tensor(count, device=total.device), min=1)


def sigmoid_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """SigmoidCrossEntropyLoss: per-element BCE summed, over the batch, in
    the stable form max(x, 0) - x t + log(1 + exp(-|x|))."""
    x, t = _f32(logits), _f32(targets)
    per = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.sum(per) / logits.shape[0]


def _topk_correct(logits2d: torch.Tensor, labels: torch.Tensor, top_k: int) -> torch.Tensor:
    """Per row: the true label is among the top-k predictions."""
    lab = labels.to(torch.int64)
    if top_k == 1:
        return torch.argmax(logits2d, dim=-1) == lab
    idx = torch.topk(logits2d, top_k, dim=-1).indices
    return torch.any(idx == lab[:, None], dim=-1)


def accuracy(logits2d: torch.Tensor, labels: torch.Tensor, top_k: int = 1,
             ignore_label: Optional[int] = None) -> torch.Tensor:
    correct = _topk_correct(logits2d, labels, top_k)
    if ignore_label is not None:
        valid = labels != ignore_label
        return (torch.sum(correct & valid).to(torch.float32)
                / torch.clamp(valid.sum(), min=1).to(torch.float32))
    return torch.mean(correct.to(torch.float32))


def accuracy_per_class(logits2d: torch.Tensor, labels: torch.Tensor, top_k: int = 1,
                       ignore_label: Optional[int] = None) -> torch.Tensor:
    """Per-class accuracy (accuracy_layer.cpp:95-101, second top):
    correct_c / seen_c, 0 for a class never seen."""
    c = logits2d.shape[-1]
    correct = _topk_correct(logits2d, labels, top_k)
    valid = labels != ignore_label if ignore_label is not None else torch.ones_like(correct)
    li = labels.to(torch.int64)
    seen = torch.zeros(c, dtype=torch.float32, device=logits2d.device).index_add_(
        0, li, valid.to(torch.float32))
    hits = torch.zeros(c, dtype=torch.float32, device=logits2d.device).index_add_(
        0, li, (correct & valid).to(torch.float32))
    return torch.where(seen == 0, torch.zeros_like(seen), hits / torch.clamp(seen, min=1.0))


def hinge(logits2d: torch.Tensor, labels: torch.Tensor, norm: str = "L1") -> torch.Tensor:
    n, c = logits2d.shape
    x = _f32(logits2d)
    onehot = F.one_hot(labels.to(torch.int64), c) > 0
    margins = torch.clamp(1.0 + torch.where(onehot, -x, x), min=0.0)
    if norm == "L2":
        return torch.sum(margins * margins) / n
    return torch.sum(margins) / n


def multinomial_logistic(probs2d: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    p = torch.gather(probs2d, 1, labels.to(torch.int64)[:, None])[:, 0]
    return -torch.sum(torch.log(torch.clamp(p, min=1e-20))) / probs2d.shape[0]


def contrastive(a: torch.Tensor, b: torch.Tensor, y: torch.Tensor, margin: float,
                legacy: bool) -> torch.Tensor:
    """ContrastiveLoss over (N, D) pairs with (N,) similarity labels."""
    d2 = torch.sum(torch.square(_f32(a - b)), dim=1)
    if legacy:
        dissim = torch.clamp(margin - d2, min=0.0)
    else:
        dissim = torch.square(torch.clamp(margin - torch.sqrt(torch.clamp(d2, min=1e-20)),
                                          min=0.0))
    yf = _f32(y).reshape(-1)
    return torch.sum(yf * d2 + (1 - yf) * dissim) / (2.0 * a.shape[0])


def infogain(probs2d: torch.Tensor, labels: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    rows = H[labels.to(torch.int64)]
    return -torch.sum(rows * torch.log(torch.clamp(probs2d, min=1e-20))) / probs2d.shape[0]
