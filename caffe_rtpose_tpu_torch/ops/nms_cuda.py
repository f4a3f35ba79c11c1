"""Fused bicubic upsample + peak stencil: the hand-written CUDA kernels
``csrc/peak_mask.cu`` and ``csrc/upsample_peak_keys.cu``, their wrappers
and their plain PyTorch versions.

Both compute the scale-averaged bicubic upsample U of a low-res map in
shared memory, tile by tile, with the same code (``csrc/bicubic_tile.cuh``):

* :func:`peak_mask_fused` replaces ``caffe_rtpose_tpu/ops/nms_pallas.py::
  _mask_kernel_chan`` and ``::_mask_kernel`` (both reached through
  ``peak_mask_fused``): one Hopper kernel covers the TPU's whole-frame and
  tiled forms.  It writes only the (C, th, tw) strict-peak mask; bound by
  that 18x368x656 i8 write plus the taps' FMAs.  The realtime path's kernel.
* :func:`upsample_peak_keys` replaces ``nms_pallas.py::_kernel`` (reached
  through ``upsample_peak_keys``).  It writes U as f32 heat (C, th, tw) and,
  for the first ``key_channels`` channels, the strict-peak keys in
  :func:`..nms.block_keys`' horizontal-pair layout.  Bound by the heat
  write (55 MB a frame at COCO width).  The heatmap path's kernel.

Each wrapper launches its kernel for a CUDA tensor (or raises: there is no
fallback) and runs the plain version for a CPU tensor.  ``launches`` and
``upsample_launches`` count kernel launches and nothing else.  The plain
versions, :func:`peak_mask_fused_reference` and
:func:`upsample_peak_keys_reference`, are the CPU path, the tests'
reference and the estimator's ``peak_kernel=False`` switch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .imresize import _matrices, imresize_average
from .nms import block_keys, find_peaks_mask

launches = 0  # kernel launches made by peak_mask_fused in this process
upsample_launches = 0  # kernel launches made by upsample_peak_keys in this process

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


def _check_lowres(name: str, lowres: torch.Tensor, target_hw: Tuple[int, int]):
    """The kernels' input checks -> (S, h, w, C, th, tw)."""
    if lowres.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lowres.device}")
    if lowres.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {lowres.dtype}")
    if lowres.dim() != 4 or min(lowres.shape) < 1:
        raise ValueError(f"{name}: expected (S, h, w, C), got {tuple(lowres.shape)}")
    s, h, w, c = lowres.shape
    th, tw = (int(v) for v in target_hw)
    if th < 1 or tw < 1 or c > 65535:
        raise ValueError(f"{name}: unsupported target {target_hw} or {c} channels")
    if any(st < 0 for st in lowres.stride()):
        raise ValueError(f"{name}: negative strides are not supported")
    return s, h, w, c, th, tw


def _launch(name: str, entry: str, lowres: torch.Tensor, target_hw, start_scale: float,
            scale_gap: float, threshold: float, extra: tuple, outs: tuple) -> None:
    """Launch one kernel on the current stream of ``lowres``' device: the
    library, the shared-memory check, the tap tables and the strides.
    ``extra`` are the int arguments after (S, h, w, C, th, tw), ``outs`` the
    output tensors.  Raises if the launch fails."""
    from .. import _build

    s, h, w, c, th, tw = _check_lowres(name, lowres, target_hw)
    lib = _build.load_kernels()
    smem = lib.crt_tile_smem_bytes(w)
    if smem > 227 * 1024:
        raise ValueError(f"{name}: low-res width {w} needs {smem} B of shared memory")
    taps = _device_taps(h, w, th, tw, s, float(start_scale), float(scale_gap), lowres.device)
    st = lowres.stride()
    ptrs = lambda ts: [ctypes.c_void_p(t.data_ptr()) for t in ts]  # noqa: E731
    with torch.cuda.device(lowres.device):
        stream = torch.cuda.current_stream(lowres.device).cuda_stream
        err = getattr(lib, entry)(
            *ptrs([lowres]), st[0], st[1], st[2], st[3], s, h, w, c, th, tw, *extra,
            *ptrs(taps), 1.0 / s, float(threshold), *ptrs(outs), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.crt_cuda_error_string(err).decode()} ({err})")


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
    th, tw = (int(v) for v in target_hw)
    out = torch.empty((lowres.shape[-1], th, tw), dtype=torch.int8, device=lowres.device)
    _launch("peak_mask_fused", "crt_peak_mask", lowres, (th, tw), start_scale, scale_gap,
            threshold, (), (out,))
    launches += 1
    return out != 0


def upsample_peak_keys_reference(
    lowres: torch.Tensor,  # (S, h, w, C), NHWC
    target_hw: Tuple[int, int],
    start_scale: float,
    scale_gap: float,
    threshold: float,
    key_channels: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (heat (C, th, tw) f32, keys (K, th*(tw//2))
    int32) through ``imresize_average``, ``find_peaks_mask`` and
    ``block_keys``."""
    th, tw = target_hw
    kc = lowres.shape[-1] if key_channels is None else int(key_channels)
    heat = imresize_average(lowres, th, tw, start_scale, scale_gap)[0].permute(2, 0, 1).contiguous()
    return heat, block_keys(find_peaks_mask(heat[:kc], threshold), th, tw)


def upsample_peak_keys(
    lowres: torch.Tensor,  # (S, h, w, C), NHWC, any strides
    target_hw: Tuple[int, int],
    start_scale: float,
    scale_gap: float,
    threshold: float,
    key_channels: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scale-averaged bicubic upsample of all C channels as f32 heat
    (C, th, tw), and the strict-peak keys of the first ``key_channels``
    (default C) as (key_channels, th*(tw//2)) int32 in ``block_keys``'
    layout, ready for ``nms.peaks_from_keys(..., ordered=True)``.  Equal to
    :func:`upsample_peak_keys_reference` up to f32 summation order (heat
    within a few ulp; a key may differ only at a near-tie)."""
    global upsample_launches
    kc = lowres.shape[-1] if key_channels is None else int(key_channels)
    if not 0 <= kc <= lowres.shape[-1]:
        raise ValueError(f"upsample_peak_keys: key_channels {kc} outside 0..{lowres.shape[-1]}")
    if lowres.device.type == "cpu":
        return upsample_peak_keys_reference(lowres, target_hw, start_scale, scale_gap,
                                            threshold, kc)
    th, tw = (int(v) for v in target_hw)
    dev = lowres.device
    heat = torch.empty((lowres.shape[-1], th, tw), dtype=torch.float32, device=dev)
    keys = torch.empty((kc, th * (tw // 2)), dtype=torch.int32, device=dev)
    _launch("upsample_peak_keys", "crt_upsample_peak_keys", lowres, (th, tw), start_scale,
            scale_gap, threshold, (kc,), (heat, keys))
    upsample_launches += 1
    return heat, keys
