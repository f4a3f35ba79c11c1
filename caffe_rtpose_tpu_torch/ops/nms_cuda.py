"""Fused bicubic part-channel upsample + peak stencil: the hand-written CUDA
kernel ``csrc/peak_mask.cu``, its wrapper and its plain PyTorch version.

Replaces ``caffe_rtpose_tpu/ops/nms_pallas.py::_mask_kernel_chan`` and
``::_mask_kernel`` (both reached through ``peak_mask_fused``): one Hopper
kernel covers the TPU's whole-frame and tiled forms.  It computes the
(C, th, tw) strict-peak mask of the scale-averaged bicubic upsample without
ever writing the upsampled maps.  On the card it is bound by its
18x368x656 i8 mask write plus the taps' FMAs; its design keeps U in shared
memory, out of device memory (see the source's header).

* :func:`peak_mask_fused` — the wrapper.  A CUDA tensor launches the kernel
  (or raises: there is no fallback); a CPU tensor goes to the plain version.
  ``launches`` counts kernel launches and nothing else.
* :func:`peak_mask_fused_reference` — the plain PyTorch version,
  ``find_peaks_mask(imresize_average(...))``: the CPU path, the tests'
  reference and the estimator's ``peak_kernel=False`` switch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from .imresize import _matrices, imresize_average
from .nms import find_peaks_mask

launches = 0  # kernel launches made by peak_mask_fused in this process

_tap_cache: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def _taps(dense: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(S, T, src) dense f32 interpolation matrices -> (S, T, 4) int32 source
    indices and f32 weights of each row's nonzero taps (ascending index,
    zero-padded)."""
    s, t, _ = dense.shape
    idx = np.zeros((s, t, 4), np.int32)
    wgt = np.zeros((s, t, 4), np.float32)
    for n in range(s):
        for r in range(t):
            nz = np.flatnonzero(dense[n, r])
            if len(nz) > 4:
                raise ValueError("bicubic row with more than 4 taps")
            idx[n, r, : len(nz)] = nz
            wgt[n, r, : len(nz)] = dense[n, r, nz]
    return idx, wgt


def _device_taps(h: int, w: int, th: int, tw: int, s: int, start_scale: float,
                 scale_gap: float, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Tap tables of one shape, uploaded once per device and cached."""
    key = (h, w, th, tw, s, start_scale, scale_gap, str(device))
    hit = _tap_cache.get(key)
    if hit is None:
        Ay, Ax = _matrices(h, w, th, tw, s, start_scale, scale_gap)
        arrays = (*_taps(Ay), *_taps(Ax))
        hit = tuple(torch.from_numpy(a).to(device) for a in arrays)
        _tap_cache[key] = hit
    return hit


def peak_mask_fused_reference(
    lowres: torch.Tensor,  # (S, h, w, C) part channels, NHWC
    target_hw: Tuple[int, int],
    start_scale: float,
    scale_gap: float,
    threshold: float,
) -> torch.Tensor:
    """Plain PyTorch version: (C, th, tw) bool mask through the full-res map."""
    th, tw = target_hw
    heat = imresize_average(lowres, th, tw, start_scale, scale_gap)[0].permute(2, 0, 1)
    return find_peaks_mask(heat, threshold)


def peak_mask_fused(
    lowres: torch.Tensor,  # (S, h, w, C) part channels, NHWC, any strides
    target_hw: Tuple[int, int],
    start_scale: float,
    scale_gap: float,
    threshold: float,
) -> torch.Tensor:
    """(C, th, tw) bool strict-peak mask of the scale-averaged bicubic
    upsample of ``lowres``; equal to :func:`peak_mask_fused_reference` up to
    f32 summation order (the kernel sums each pixel's taps in its own order,
    so a pixel within a rounding error of a tie may differ)."""
    global launches
    if lowres.device.type == "cpu":
        return peak_mask_fused_reference(lowres, target_hw, start_scale, scale_gap, threshold)
    if lowres.device.type != "cuda":
        raise ValueError(f"peak_mask_fused: unsupported device {lowres.device}")
    if lowres.dtype != torch.float32:
        raise TypeError(f"peak_mask_fused: expected float32, got {lowres.dtype}")
    if lowres.dim() != 4 or min(lowres.shape) < 1:
        raise ValueError(f"peak_mask_fused: expected (S, h, w, C), got {tuple(lowres.shape)}")
    s, h, w, c = lowres.shape
    th, tw = (int(v) for v in target_hw)
    if th < 1 or tw < 1 or c > 65535:
        raise ValueError(f"peak_mask_fused: unsupported target {target_hw} or {c} channels")
    if any(st < 0 for st in lowres.stride()):
        raise ValueError("peak_mask_fused: negative strides are not supported")

    from .. import _build

    lib = _build.load_kernels()
    smem = lib.crt_peak_mask_smem_bytes(w)
    if smem > 227 * 1024:
        raise ValueError(f"peak_mask_fused: low-res width {w} needs {smem} B of shared memory")
    yi, yw, xi, xw = _device_taps(h, w, th, tw, s, float(start_scale), float(scale_gap),
                                  lowres.device)
    out = torch.empty((c, th, tw), dtype=torch.int8, device=lowres.device)
    st = lowres.stride()
    with torch.cuda.device(lowres.device):
        stream = torch.cuda.current_stream(lowres.device).cuda_stream
        err = lib.crt_peak_mask(
            ctypes.c_void_p(lowres.data_ptr()), st[0], st[1], st[2], st[3],
            s, h, w, c, th, tw,
            ctypes.c_void_p(yi.data_ptr()), ctypes.c_void_p(yw.data_ptr()),
            ctypes.c_void_p(xi.data_ptr()), ctypes.c_void_p(xw.data_ptr()),
            1.0 / s, float(threshold), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"peak_mask kernel launch failed: {lib.crt_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return out != 0
