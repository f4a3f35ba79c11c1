"""Fused bicubic upsample + peak stencil: the hand-written CUDA kernels
``csrc/peak_mask.cu`` and ``csrc/upsample_peak_keys.cu``, their wrappers
and their plain PyTorch versions.

Both compute the scale-averaged bicubic upsample U of a low-res map in
shared memory, tile by tile, with the same per-pixel FMA order
(``csrc/bicubic_tile.cuh::tap_sum``), so they find the same peaks.  Each
tile stages only its source window, the low-res rows and columns its taps
reach per scale; the host computes the windows and the tiles' tap tables,
and the wrappers cache them per shape and device:

* :func:`peak_mask_fused` replaces ``caffe_rtpose_tpu/ops/nms_pallas.py::
  _mask_kernel_chan`` and ``::_mask_kernel`` (both reached through
  ``peak_mask_fused``): one Hopper kernel covers the TPU's whole-frame and
  tiled forms, and the batched grid ``jax.vmap`` makes of them: one launch
  takes the (F, S, h, w, C) maps of F frames.  A block serves one 32x64
  output tile for a group of 4 channels (:func:`tile_geometry`).  It
  writes only the (F, C, th, tw) strict-peak mask, as bool, four pixels a
  store; bound by that write (18x368x656 bytes a frame).  The realtime
  path's kernel.
* :func:`upsample_peak_keys` replaces ``nms_pallas.py::_kernel`` (reached
  through ``upsample_peak_keys``).  It writes U as f32 heat (C, th, tw) and,
  for the first ``key_channels`` channels, the strict-peak keys in
  :func:`..nms.block_keys`' horizontal-pair layout.  Bound by the heat
  write (55 MB a frame at COCO width).  A warp serves one 32-column x R-row
  tile of one channel (:func:`keys_geometry`, R from
  :func:`keys_tile_rows`) and its heat and key tiles leave in TMA bulk
  stores; a width whose rows are no multiple of 16 bytes for both outputs
  takes the direct store path instead (:func:`keys_store_path`).  The
  heatmap path's kernel.

Both kernels read the NMS threshold from an f32 scalar in device memory, as
the TPU kernels read ``th_ref``: the wrappers take a 0-d f32 tensor on the
map's device (what a captured CUDA graph passes, so that a new threshold
needs no new capture) or a Python float, which goes into a device scalar
cached per value.

Each kernel is a ``torch.library`` operator (``crt::peak_mask_fused``,
``crt::upsample_peak_keys``), so that ``torch.export`` records it as one
node of a program (``serving.py``) and the loaded program launches it.  An
operator dispatches on its tensor's device: the CUDA implementation is the
ctypes launch (or raises: there is no fallback), the CPU implementation the
plain version.  Its fake implementation gives the exact output shape, dtype
and strides.  Arguments are tensors and Python scalars; the tile geometry
is made inside the CUDA implementation.  The wrappers are thin calls of the
operators.  ``launches`` and ``upsample_launches`` count kernel launches (in
the CUDA implementations) and nothing else.  The plain versions,
:func:`peak_mask_fused_reference` and :func:`upsample_peak_keys_reference`,
are the CPU path, the tests' reference and the estimator's
``peak_kernel=False`` switch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.device import device_const
from .imresize import _matrices, imresize_average
from .nms import block_keys, find_peaks_mask

launches = 0  # kernel launches made by peak_mask_fused in this process
upsample_launches = 0  # kernel launches made by upsample_peak_keys in this process

# csrc/bicubic_tile.cuh (K1): output tile, channels a block serves, and the
# shared memory a block may take on the H100
TILE_Y, TILE_X, GROUP = 32, 64, 4
SMEM_BUDGET = 227 * 1024
# csrc/upsample_peak_keys.cu (K3): columns of a warp's tile (a pair a lane,
# in two row halves), warps a block, the tile heights the host chooses from
# (R + 2 extended rows a multiple of 16: the vertical pass's row steps)
KEYS_TILE_X, KEYS_WARPS = 32, 4
KEYS_ROWS = (30, 46)


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


def _windows(idx: np.ndarray, wgt: np.ndarray, tile: int) -> np.ndarray:
    """One axis' (S, T, 4) taps -> (S, n_tiles, 2) int32 [first, count]: the
    source indices that the nonzero taps of each tile's outputs reach, the
    tile's ``tile`` outputs and one more on each side (the peak test's
    halo)."""
    s, t, _ = idx.shape
    n = -(-t // tile)
    out = np.zeros((s, n, 2), np.int32)
    for i in range(n):
        lo, hi = max(i * tile - 1, 0), min((i + 1) * tile + 1, t)
        for sc in range(s):
            reach = idx[sc, lo:hi][wgt[sc, lo:hi] != 0]
            out[sc, i] = reach.min(), reach.max() - reach.min() + 1
    return out


def _smem_bytes(s: int, wh: int, ww: int) -> int:
    """csrc/bicubic_tile.cuh::tile_smem_bytes: tap tables, the window of
    GROUP channels, the vertical pass and the upsampled tile."""
    ext_y, ext_x = TILE_Y + 2, TILE_X + 2
    return 4 * (s * (ext_y + ext_x) * 8 + s * GROUP * wh * ww + ext_y * ww + ext_y * ext_x)


@dataclass(frozen=True)
class TileGeometry:
    """What the kernels read besides the map: tap tables (S, th, 4) and
    (S, tw, 4), windows (S, tiles_y, 2) and (S, tiles_x, 2) of [first,
    count], the widest window ``wh`` x ``ww`` and a block's shared memory."""

    ytap_idx: np.ndarray
    ytap_w: np.ndarray
    xtap_idx: np.ndarray
    xtap_w: np.ndarray
    ywin: np.ndarray
    xwin: np.ndarray
    wh: int
    ww: int
    smem: int


@lru_cache(maxsize=64)
def tile_geometry(h: int, w: int, th: int, tw: int, s: int, start_scale: float,
                  scale_gap: float) -> TileGeometry:
    Ay, Ax = _matrices(h, w, th, tw, s, float(start_scale), float(scale_gap))
    (yi, yw), (xi, xw) = _taps(Ay), _taps(Ax)
    ywin, xwin = _windows(yi, yw, TILE_Y), _windows(xi, xw, TILE_X)
    wh, ww = int(ywin[..., 1].max()), int(xwin[..., 1].max())
    return TileGeometry(yi, yw, xi, xw, ywin, xwin, wh, ww, _smem_bytes(s, wh, ww))


_geometry_cache: Dict[tuple, Tuple[TileGeometry, Tuple[torch.Tensor, ...]]] = {}


def _device_geometry(h: int, w: int, th: int, tw: int, s: int, start_scale: float,
                     scale_gap: float, device: torch.device):
    """:func:`tile_geometry` and its six tables on ``device``, uploaded once
    per shape and device and cached."""
    key = (h, w, th, tw, s, start_scale, scale_gap, str(device))
    hit = _geometry_cache.get(key)
    if hit is None:
        geo = tile_geometry(h, w, th, tw, s, start_scale, scale_gap)
        if geo.smem > SMEM_BUDGET:
            raise ValueError(f"upsample tile: a {geo.wh}x{geo.ww} source window at {s} scales "
                             f"needs {geo.smem} B of shared memory")
        arrays = (geo.ytap_idx, geo.ytap_w, geo.xtap_idx, geo.xtap_w, geo.ywin, geo.xwin)
        hit = geo, tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)
        _geometry_cache[key] = hit
    return hit


def keys_tile_rows(th: int) -> int:
    """K3's tile height R for ``th`` output rows: of :data:`KEYS_ROWS`, the
    one whose tiles compute the fewest rows (tiles x (R + 2), the halo rows
    included), the smaller on a tie: 46 at 368 (8 x 48 rows)."""
    return min(KEYS_ROWS, key=lambda r: (-(-th // r) * (r + 2), r))


def keys_tensor_maps(th: int, tw: int, channels: int, key_channels: int,
                     rows: int) -> Dict[str, Tuple[tuple, tuple, tuple]]:
    """The two TMA maps K3 encodes (csrc/upsample_peak_keys.cu::encode_map),
    name -> (dims fastest first, byte strides of dims 1 and 2, box): heat
    (tw, th, C) in boxes of one tile's 32 x R, keys (tw/2, th, kc) in boxes
    of its 16 pairs x R.  TMA takes a map whose strides are multiples of 16
    bytes; a box row of 32 f32 or 16 int32 is 128 or 64 bytes."""
    return {"heat": ((tw, th, channels), (tw * 4, th * tw * 4), (KEYS_TILE_X, rows, 1)),
            "keys": ((tw // 2, th, key_channels), (tw // 2 * 4, th * (tw // 2) * 4),
                     (KEYS_TILE_X // 2, rows, 1))}


def keys_store_path(th: int, tw: int) -> str:
    """How K3 stores a (th, tw) map: ``"tma"`` where both maps'
    (:func:`keys_tensor_maps`) strides are multiples of 16 bytes, tw % 8 ==
    0, which every COCO/MPI target (8x the low-res map) meets; else
    ``"direct"``, each lane storing its column with bounds checks."""
    maps = keys_tensor_maps(th, tw, 1, 1, keys_tile_rows(th))
    return "tma" if all(st % 16 == 0 for _, strides, _ in maps.values() for st in strides) \
        else "direct"


def _keys_smem_bytes(s: int, rows: int, wh: int, wp: int) -> int:
    """csrc/upsample_peak_keys.cu::keys_smem_bytes: per warp the heat box
    ((R+2) x 32), the halo columns (2 x (R+2)) and one region for Vt (wp
    columns of pitch R+6) and the windows (S x wh x wp), later the key box
    (R x 16), each rounded to 32 words; 4 warps."""
    r2 = rows + 2
    up = lambda n: -(-n // 32) * 32  # noqa: E731
    warp = r2 * KEYS_TILE_X + up(2 * r2) + up(max(rows * 16, wp * (r2 + 4) + s * wh * wp))
    return 4 * KEYS_WARPS * warp


def _tile_taps(idx: np.ndarray, wgt: np.ndarray, win: np.ndarray, starts: np.ndarray,
               pitch: int) -> Tuple[np.ndarray, np.ndarray]:
    """One axis' (S, T, 4) taps at the outputs ``starts`` (n_tiles, E) of
    each tile -> (S, n_tiles, E, 4) weights and offsets (the index relative
    to the tile's window ``win`` (S, n_tiles, 2), clamped into it, times
    ``pitch``); an output outside 0..T-1 gets zero weights, as the kernels'
    pad taps."""
    s, t, _ = idx.shape
    inside = (starts >= 0) & (starts < t)
    at = np.clip(starts, 0, t - 1)
    first, count = win[:, :, None, None, 0], win[:, :, None, None, 1]
    rel = np.where(inside[None, :, :, None], idx[:, at], first) - first
    w = np.where(inside[None, :, :, None], wgt[:, at], 0).astype(np.float32)
    return w, (np.clip(rel, 0, count - 1) * pitch).astype(np.int32)


@dataclass(frozen=True)
class KeysGeometry:
    """What K3 reads besides the map: the tile height ``rows`` (R) and grid,
    the windows (S, tiles_y, 2) and (S, tiles_x, 2) of [first, count], the
    widest window's rows ``wh`` and the window pitch ``wp`` (its widest
    columns rounded up to 4, for 16-byte loads), each extended row's 4 taps
    (S, tiles_y, R+2, 4) as weights and window offsets (relative row x wp),
    each tile column's 32 columns and two halo columns (x0-1, x0+32) as
    (S, tiles_x, 34, 4) weights and Vt offsets (relative column x (R+6), the
    pitch of the kernel's transposed vertical pass), and a block's shared
    memory."""

    rows: int
    tiles_y: int
    tiles_x: int
    ywin: np.ndarray
    xwin: np.ndarray
    wh: int
    wp: int
    ytap_w: np.ndarray
    ytap_off: np.ndarray
    xtap_w: np.ndarray
    xtap_off: np.ndarray
    smem: int


@lru_cache(maxsize=64)
def keys_geometry(h: int, w: int, th: int, tw: int, s: int, start_scale: float,
                  scale_gap: float, rows: Optional[int] = None) -> KeysGeometry:
    """K3's tiling of a (th, tw) target: R rows (:func:`keys_tile_rows`
    unless ``rows`` is given) by :data:`KEYS_TILE_X` columns."""
    r = keys_tile_rows(th) if rows is None else int(rows)
    if r < 14 or (r + 2) % 16:
        raise ValueError(f"upsample_peak_keys: tile rows {r}: R + 2 must be a multiple of 16")
    Ay, Ax = _matrices(h, w, th, tw, s, float(start_scale), float(scale_gap))
    (yi, yw), (xi, xw) = _taps(Ay), _taps(Ax)
    ywin, xwin = _windows(yi, yw, r), _windows(xi, xw, KEYS_TILE_X)
    wh, wp = int(ywin[..., 1].max()), -(-int(xwin[..., 1].max()) // 4) * 4
    ty, tx = ywin.shape[1], xwin.shape[1]
    ys = np.arange(ty)[:, None] * r - 1 + np.arange(r + 2)[None]
    xs = np.arange(tx)[:, None] * KEYS_TILE_X + np.r_[np.arange(KEYS_TILE_X), -1, KEYS_TILE_X][None]
    y_w, y_off = _tile_taps(yi, yw, ywin, ys, wp)
    x_w, x_off = _tile_taps(xi, xw, xwin, xs, r + 6)
    return KeysGeometry(r, ty, tx, ywin, xwin, wh, wp, y_w, y_off, x_w, x_off,
                        _keys_smem_bytes(s, r, wh, wp))


def _device_keys_geometry(h: int, w: int, th: int, tw: int, s: int, start_scale: float,
                          scale_gap: float, device: torch.device):
    """:func:`keys_geometry` and its six tables on ``device``, uploaded once
    per shape and device and cached."""
    key = ("keys", h, w, th, tw, s, start_scale, scale_gap, str(device))
    hit = _geometry_cache.get(key)
    if hit is None:
        geo = keys_geometry(h, w, th, tw, s, start_scale, scale_gap)
        if geo.smem > SMEM_BUDGET:
            raise ValueError(f"upsample_peak_keys: {th}x{tw} from {h}x{w} at {s} scales: "
                             f"{geo.rows}-row tiles over a {geo.wh}x{geo.wp} source window "
                             f"need {geo.smem} B of shared memory")
        arrays = (geo.ytap_w, geo.ytap_off, geo.xtap_w, geo.xtap_off, geo.ywin, geo.xwin)
        hit = geo, tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)
        _geometry_cache[key] = hit
    return hit


def vec4_loads(lowres: torch.Tensor) -> bool:
    """Whether K1 may stage the window of an (S, h, w, C) or
    (F, S, h, w, C) map with 16-byte loads: channel stride 1, the other
    strides (the frame stride too) and the base 16-byte aligned, C % 4 == 0."""
    st = lowres.stride()
    return (st[-1] == 1 and all(v % 4 == 0 for v in st[:-1]) and lowres.shape[-1] % 4 == 0
            and lowres.data_ptr() % 16 == 0)


def _check_lowres(name: str, lowres: torch.Tensor, target_hw: Tuple[int, int]):
    """The kernels' input checks on (F, S, h, w, C) -> (F, S, h, w, C, th, tw)."""
    if lowres.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lowres.device}")
    if lowres.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {lowres.dtype}")
    if lowres.dim() != 5 or min(lowres.shape) < 1:
        raise ValueError(f"{name}: expected (F, S, h, w, C), got {tuple(lowres.shape)}")
    f, s, h, w, c = lowres.shape
    th, tw = (int(v) for v in target_hw)
    if th < 1 or tw < 1 or -(-th // TILE_Y) > 65535 or f * -(-c // GROUP) > 65535:
        raise ValueError(f"{name}: unsupported target {target_hw} for {f} frames of {c} channels")
    if any(st < 0 for st in lowres.stride()):
        raise ValueError(f"{name}: negative strides are not supported")
    return f, s, h, w, c, th, tw


def threshold_scalar(threshold, device: torch.device) -> torch.Tensor:
    """The kernels' threshold argument: a 0-d f32 tensor on ``device`` as
    given, or a Python float in a device scalar cached per value."""
    if isinstance(threshold, torch.Tensor):
        if threshold.dim() != 0 or threshold.dtype != torch.float32 or threshold.device != device:
            raise ValueError(f"threshold: expected a 0-d float32 tensor on {device}, got "
                             f"{tuple(threshold.shape)} {threshold.dtype} on {threshold.device}")
        return threshold
    v = float(threshold)
    return device_const(("f32", v), lambda: torch.tensor(v, dtype=torch.float32), device)


def _pointers(*ts) -> list:
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.crt_cuda_error_string(err).decode()} ({err})")


def _launch_mask(lowres: torch.Tensor, th: int, tw: int, start_scale: float, scale_gap: float,
                 threshold, out: torch.Tensor) -> None:
    """Launch K1 on the current stream of ``lowres``' device (F, S, h, w,
    C): the library, the cached geometry and the strides.  Raises if the
    launch fails."""
    from .. import _build

    f, s, h, w, c, th, tw = _check_lowres("peak_mask_fused", lowres, (th, tw))
    thr = threshold_scalar(threshold, lowres.device)
    lib = _build.load_kernels()
    geo, tables = _device_geometry(h, w, th, tw, s, float(start_scale), float(scale_gap),
                                   lowres.device)
    with torch.cuda.device(lowres.device):
        err = lib.crt_peak_mask(*_pointers(lowres), *lowres.stride(), f, s, c, th, tw,
                                *_pointers(*tables), geo.wh, geo.ww, int(vec4_loads(lowres)),
                                1.0 / s, *_pointers(thr, out), _stream(lowres.device))
    _raise_on(lib, "peak_mask_fused", err)


def _launch_keys(lowres: torch.Tensor, th: int, tw: int, start_scale: float, scale_gap: float,
                 threshold, key_channels: int, heat: torch.Tensor, keys: torch.Tensor) -> None:
    """Launch K3 on the current stream of ``lowres``' device (S, h, w, C),
    on the store path :func:`keys_store_path` names.  Raises if the launch
    fails."""
    from .. import _build

    _, s, h, w, c, th, tw = _check_lowres("upsample_peak_keys", lowres[None], (th, tw))
    thr = threshold_scalar(threshold, lowres.device)
    lib = _build.load_kernels()
    geo, tables = _device_keys_geometry(h, w, th, tw, s, float(start_scale), float(scale_gap),
                                        lowres.device)
    if geo.tiles_y * geo.tiles_x * c >= 2 ** 31:
        raise ValueError(f"upsample_peak_keys: {geo.tiles_y}x{geo.tiles_x} tiles of {c} channels "
                         f"are more work items than the kernel counts")
    tma = keys_store_path(th, tw) == "tma"
    if tma and (heat.data_ptr() % 16 or keys.data_ptr() % 16):
        raise ValueError("upsample_peak_keys: TMA needs 16-byte-aligned outputs")
    with torch.cuda.device(lowres.device):
        err = lib.crt_upsample_peak_keys(
            *_pointers(lowres), *lowres.stride(), s, c, th, tw, key_channels, geo.rows,
            *_pointers(*tables), geo.wh, geo.wp, 1.0 / s, int(tma), *_pointers(thr, heat, keys),
            _stream(lowres.device))
    _raise_on(lib, "upsample_peak_keys", err)


def peak_mask_fused_reference(
    lowres: torch.Tensor,  # (F, S, h, w, C) or (S, h, w, C) part channels, NHWC
    target_hw: Tuple[int, int],
    start_scale: float,
    scale_gap: float,
    threshold,
) -> torch.Tensor:
    """Plain PyTorch version: the (F, C, th, tw) or (C, th, tw) bool mask
    through the full-res map, frame by frame; ``threshold`` a float or a
    0-d f32 tensor."""
    th, tw = target_hw
    if lowres.dim() == 5:
        return torch.stack([peak_mask_fused_reference(x, target_hw, start_scale, scale_gap,
                                                      threshold) for x in lowres])
    heat = imresize_average(lowres, th, tw, start_scale, scale_gap)[0].permute(2, 0, 1)
    return find_peaks_mask(heat, threshold)


@torch.library.custom_op("crt::peak_mask_fused", mutates_args=(), device_types="cuda")
def _peak_mask_op(lowres: torch.Tensor, th: int, tw: int, start_scale: float, scale_gap: float,
                  threshold: torch.Tensor) -> torch.Tensor:
    """K1 on (F, S, h, w, C) -> (F, C, th, tw) bool, one launch."""
    global launches
    out = torch.empty((lowres.shape[0], lowres.shape[-1], th, tw), dtype=torch.bool,
                      device=lowres.device)
    _launch_mask(lowres, th, tw, start_scale, scale_gap, threshold, out)
    launches += 1
    return out


@_peak_mask_op.register_kernel("cpu")
def _peak_mask_cpu(lowres, th, tw, start_scale, scale_gap, threshold):
    return peak_mask_fused_reference(lowres, (th, tw), start_scale, scale_gap, threshold)


@_peak_mask_op.register_fake
def _peak_mask_fake(lowres, th, tw, start_scale, scale_gap, threshold):
    return lowres.new_empty((lowres.shape[0], lowres.shape[-1], th, tw), dtype=torch.bool)


def peak_mask_fused(
    lowres: torch.Tensor,  # (F, S, h, w, C) or (S, h, w, C) part channels, NHWC, any strides
    target_hw: Tuple[int, int],
    start_scale: float,
    scale_gap: float,
    threshold,
) -> torch.Tensor:
    """(F, C, th, tw) bool strict-peak masks of the scale-averaged bicubic
    upsample of each frame of ``lowres`` in one launch ((C, th, tw) for an
    (S, h, w, C) map); equal to :func:`peak_mask_fused_reference` up to f32
    summation order (the kernel sums each pixel's taps in its own order, so
    a pixel within a rounding error of a tie may differ).  Calls the
    operator ``crt::peak_mask_fused``."""
    low5 = lowres if lowres.dim() == 5 else lowres[None]
    th, tw = (int(v) for v in target_hw)
    out = torch.ops.crt.peak_mask_fused(low5, th, tw, float(start_scale), float(scale_gap),
                                        threshold_scalar(threshold, lowres.device))
    return out if lowres.dim() == 5 else out[0]


def upsample_peak_keys_reference(
    lowres: torch.Tensor,  # (S, h, w, C), NHWC
    target_hw: Tuple[int, int],
    start_scale: float,
    scale_gap: float,
    threshold,
    key_channels: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (heat (C, th, tw) f32, keys (K, th*(tw//2))
    int32) through ``imresize_average``, ``find_peaks_mask`` and
    ``block_keys``."""
    th, tw = target_hw
    kc = lowres.shape[-1] if key_channels is None else int(key_channels)
    heat = imresize_average(lowres, th, tw, start_scale, scale_gap)[0].permute(2, 0, 1).contiguous()
    return heat, block_keys(find_peaks_mask(heat[:kc], threshold), th, tw)


@torch.library.custom_op("crt::upsample_peak_keys", mutates_args=(), device_types="cuda")
def _upsample_keys_op(lowres: torch.Tensor, th: int, tw: int, start_scale: float,
                      scale_gap: float, threshold: torch.Tensor,
                      key_channels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on (S, h, w, C) -> heat (C, th, tw) f32 and keys (K, th*(tw//2))
    int32, one launch."""
    global upsample_launches
    if lowres.dim() != 4:
        raise ValueError(f"upsample_peak_keys: expected (S, h, w, C), got {tuple(lowres.shape)}")
    dev = lowres.device
    heat = torch.empty((lowres.shape[-1], th, tw), dtype=torch.float32, device=dev)
    keys = torch.empty((key_channels, th * (tw // 2)), dtype=torch.int32, device=dev)
    _launch_keys(lowres, th, tw, start_scale, scale_gap, threshold, key_channels, heat, keys)
    upsample_launches += 1
    return heat, keys


@_upsample_keys_op.register_kernel("cpu")
def _upsample_keys_cpu(lowres, th, tw, start_scale, scale_gap, threshold, key_channels):
    return upsample_peak_keys_reference(lowres, (th, tw), start_scale, scale_gap, threshold,
                                        key_channels)


@_upsample_keys_op.register_fake
def _upsample_keys_fake(lowres, th, tw, start_scale, scale_gap, threshold, key_channels):
    return (lowres.new_empty((lowres.shape[-1], th, tw), dtype=torch.float32),
            lowres.new_empty((key_channels, th * (tw // 2)), dtype=torch.int32))


def upsample_peak_keys(
    lowres: torch.Tensor,  # (S, h, w, C), NHWC, any strides
    target_hw: Tuple[int, int],
    start_scale: float,
    scale_gap: float,
    threshold,
    key_channels: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scale-averaged bicubic upsample of all C channels as f32 heat
    (C, th, tw), and the strict-peak keys of the first ``key_channels``
    (default C) as (key_channels, th*(tw//2)) int32 in ``block_keys``'
    layout, ready for ``nms.peaks_from_keys(..., ordered=True)``.  Equal to
    :func:`upsample_peak_keys_reference` up to f32 summation order (heat
    within a few ulp; a key may differ only at a near-tie).  Calls the
    operator ``crt::upsample_peak_keys``."""
    kc = lowres.shape[-1] if key_channels is None else int(key_channels)
    if not 0 <= kc <= lowres.shape[-1]:
        raise ValueError(f"upsample_peak_keys: key_channels {kc} outside 0..{lowres.shape[-1]}")
    th, tw = (int(v) for v in target_hw)
    return torch.ops.crt.upsample_peak_keys(lowres, th, tw, float(start_scale),
                                            float(scale_gap),
                                            threshold_scalar(threshold, lowres.device), kc)
