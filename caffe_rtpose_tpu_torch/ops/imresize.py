"""ImResize: fused bicubic x-factor upsample + multi-scale averaging.

Reproduces the reference GPU kernel semantics exactly (reference
src/caffe/cpm/layers/imresize_layer.cu:98-155):

* per scale ``n``: ``padw = floor(W/2 * (1 - start_scale + n*scale_gap))``,
  the un-padded subregion is ``ow = W - 2*padw`` wide; sampling happens in
  subregion coordinates, then neighbor indices are shifted by the pad.
* source coordinate: ``x_on_ori = (x - (tw/ow/2 - 0.5)) * ow/tw``;
  ``x1 = int(x_on_ori + 1e-5)`` (C truncation) clamped to ``>= 0``; the four
  taps are clamped to the subregion and Catmull-Rom weighted with
  ``dx = x_on_ori - x1``.
* outputs of all scales are averaged.

The numpy matrix builders are copied bit for bit from
``caffe_rtpose_tpu/ops/imresize.py``: the hand-written peak-mask kernel
(``ops/nms_cuda.py``) reads its tap weights from the same matrices that the
plain PyTorch version multiplies by, so both see identical f32 weights.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def _cubic_weights(dx: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Catmull-Rom coefficients as used by cubic_interpolation
    (imresize_layer.cu:9-18): value = w0*v0 + w1*v1 + w2*v2 + w3*v3."""
    dx2 = dx * dx
    dx3 = dx2 * dx
    w0 = -0.5 * dx3 + dx2 - 0.5 * dx
    w1 = 1.5 * dx3 - 2.5 * dx2 + 1.0
    w2 = -1.5 * dx3 + 2.0 * dx2 + 0.5 * dx
    w3 = 0.5 * dx3 - 0.5 * dx2
    return w0, w1, w2, w3


def _axis_matrix(src_full: int, pad: int, target: int) -> np.ndarray:
    """Interpolation matrix A (target, src_full) for one axis of one scale."""
    osz = src_full - 2 * pad  # un-padded subregion size
    A = np.zeros((target, src_full), dtype=np.float64)
    t = np.arange(target, dtype=np.float64)
    offset = target / float(osz) / 2.0 - 0.5
    on_ori = (t - offset) * (float(osz) / target)
    # C truncation toward zero, then clamp to >= 0 (matches int(x+1e-5) for
    # the negative-fraction case at the left border)
    n1 = np.trunc(on_ori + 1e-5).astype(np.int64)
    n1 = np.maximum(n1, 0)
    n0 = np.where(n1 - 1 < 0, n1, n1 - 1)
    n2 = np.where(n1 + 1 >= osz, osz - 1, n1 + 1)
    n3 = np.where(n2 + 1 >= osz, osz - 1, n2 + 1)
    dx = on_ori - n1
    w0, w1, w2, w3 = _cubic_weights(dx)
    for nei, wgt in ((n0, w0), (n1, w1), (n2, w2), (n3, w3)):
        np.add.at(A, (np.arange(target), nei + pad), wgt)
    return A.astype(np.float32)


@lru_cache(maxsize=64)
def _matrices(
    H: int, W: int, th: int, tw: int, num_scales: int, start_scale: float, scale_gap: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked per-scale matrices: Ay (S, th, H), Ax (S, tw, W)."""
    Ays, Axs = [], []
    for n in range(num_scales):
        padw = int(np.floor(W / 2 * (1.0 - start_scale + n * scale_gap)))
        padh = int(np.floor(H / 2 * (1.0 - start_scale + n * scale_gap)))
        Ays.append(_axis_matrix(H, padh, th))
        Axs.append(_axis_matrix(W, padw, tw))
    return np.stack(Ays), np.stack(Axs)


def scale_pads(H: int, W: int, n: int, start_scale: float, scale_gap: float) -> Tuple[int, int]:
    """(padh, padw) of scale n (imresize_layer.cu:110-111)."""
    padw = int(np.floor(W / 2 * (1.0 - start_scale + n * scale_gap)))
    padh = int(np.floor(H / 2 * (1.0 - start_scale + n * scale_gap)))
    return padh, padw


def axis_weights_dense(coords: torch.Tensor, src_full: int, pad: int, target: int) -> torch.Tensor:
    """Dense bicubic tap weights for integer output coords given as a tensor.

    Returns (M, src_full) float32 such that ``weights @ src_axis`` equals the
    upsampled value along that axis — the on-device closed form of
    :func:`_axis_matrix` (same truncation/clamp/pad logic, evaluated in f32
    like the JAX version), used to read upsampled maps at data-dependent
    coordinates without materializing them.
    """
    osz = src_full - 2 * pad
    f32 = dict(dtype=torch.float32, device=coords.device)
    t = coords.to(torch.float32)
    offset = torch.tensor(target / float(osz) / 2.0 - 0.5, **f32)
    step = torch.tensor(float(osz) / target, **f32)
    on_ori = (t - offset) * step
    n1 = torch.trunc(on_ori + torch.tensor(1e-5, **f32)).to(torch.int32)
    n1 = torch.clamp_min(n1, 0)
    n0 = torch.where(n1 - 1 < 0, n1, n1 - 1)
    n2 = torch.where(n1 + 1 >= osz, torch.full_like(n1, osz - 1), n1 + 1)
    n3 = torch.where(n2 + 1 >= osz, torch.full_like(n2, osz - 1), n2 + 1)
    dx = on_ori - n1.to(torch.float32)
    dx2 = dx * dx
    dx3 = dx2 * dx
    w0 = -0.5 * dx3 + dx2 - 0.5 * dx
    w1 = 1.5 * dx3 - 2.5 * dx2 + 1.0
    w2 = -1.5 * dx3 + 2.0 * dx2 + 0.5 * dx
    w3 = 0.5 * dx3 - 0.5 * dx2
    iota = torch.arange(src_full, dtype=torch.int32, device=coords.device)[None, :]
    out = torch.zeros((coords.shape[0], src_full), **f32)
    for nei, wgt in ((n0, w0), (n1, w1), (n2, w2), (n3, w3)):
        out = out + wgt[:, None] * (iota == (nei + pad)[:, None]).to(torch.float32)
    return out


def imresize_average(
    x: torch.Tensor,
    target_h: int,
    target_w: int,
    start_scale: float,
    scale_gap: float,
) -> torch.Tensor:
    """x: (S, H, W, C) multi-scale feature maps (NHWC) -> (1, th, tw, C).

    Equivalent to ImResizeLayer::Forward_gpu followed by the implicit
    batch-1 output (imresize_layer.cpp:37).  Runs in f32; on CUDA the caller
    keeps TF32 off so the matmuls are full f32 like the JAX reference's
    ``Precision.HIGHEST``.
    """
    s, h, w, c = x.shape
    Ay_np, Ax_np = _matrices(h, w, target_h, target_w, s, float(start_scale), float(scale_gap))
    Ay = torch.from_numpy(Ay_np).to(x.device)  # (S, th, H)
    Ax = torch.from_numpy(Ax_np).to(x.device)  # (S, tw, W)
    xf = x.to(torch.float32)
    # per scale: out[y, x, c] = sum_h sum_w Ay[y,h] * src[h,w,c] * Ax[x,w]
    tmp = torch.einsum("syh,shwc->sywc", Ay, xf)
    out = torch.einsum("sxw,sywc->syxc", Ax, tmp)
    return torch.mean(out, dim=0, keepdim=True)
